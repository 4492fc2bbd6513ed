# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Reduced density matrices and energies from SCI wavefunctions.

Device replacement for PySCF's C-backed ``make_rdm1/1s/2/2s`` and
``spin_square`` (reference call sites ``fermion.py:517-524, 613-622``;
SURVEY.md N3).  Construction per channel:

* 1-RDMs: both endpoints live in the subspace, so the per-pair single
  excitation gathers are exact: ``dm1[p,q] = (E_pq c) . c``.
* opposite-spin 2-RDM block ``<E^a_pq E^b_rs>``: mixed intermediates stay in
  the product basis -> exact Gram of alpha/beta gathers (one matmul).
* same-spin blocks ``<a+_p a+_r a_s a_q>``: single-excitation intermediates
  can leave a *selected* string set, so these go through the two-hole
  (des-des) gather tables, whose intermediate set is closed by construction:
  ``dm2ss[p,q,r,s] = <F[(p,r)], F[(q,s)]>`` with ``F[(u,w)] = a_w a_u c`` —
  again one Gram matmul over the intermediate axis.

``E = sum h*dm1 + 1/2 sum (pq|rs) dm2[p,q,r,s]`` exactly as the reference
computes it (``fermion.py:619``).  The f64 entry point is how the
mixed-precision solver reaches <1e-8 Ha: Davidson runs f32, the final
Rayleigh/RDM energy is evaluated here in f64 (second-order accurate in the
f32 residual).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from . import linktab
from .hamiltonian import SCIBasis

__all__ = [
    "rdm1s",
    "rdm1",
    "rdm2_spin_summed",
    "rdm2s",
    "energy_from_rdms",
    "make_rdms",
]


def _qp_perm(norb: int) -> np.ndarray:
    p, q = np.divmod(np.arange(norb * norb), norb)
    return q * norb + p


@jax.jit
def _dm1s(ham: SCIBasis, c: jax.Array):
    """1-RDMs via row/column Gram matrices — O(M^2 N) flops, O(M^2) memory.

    ``dm1a[p,q] = sum_J sign_a[pq,J] * (c c^T)[src_a[pq,J], J]`` — the big
    per-pair gathers over the full amplitude matrix are never materialized.
    """
    norb = ham.norb
    m, n = c.shape
    prec = jax.lax.Precision.HIGHEST
    gram_rows = jnp.matmul(c, c.T, preferred_element_type=c.dtype, precision=prec)
    gram_cols = jnp.matmul(c.T, c, preferred_element_type=c.dtype, precision=prec)
    row_ids = jnp.arange(m, dtype=jnp.int32)[None, :]
    col_ids = jnp.arange(n, dtype=jnp.int32)[None, :]
    picked_a = gram_rows.reshape(-1)[ham.src_a * m + row_ids]
    picked_b = gram_cols.reshape(-1)[ham.src_b * n + col_ids]
    dm1a = jnp.sum(ham.sign_a.astype(c.dtype) * picked_a, axis=1).reshape(norb, norb)
    dm1b = jnp.sum(ham.sign_b.astype(c.dtype) * picked_b, axis=1).reshape(norb, norb)
    return dm1a, dm1b


@jax.jit
def _samespin_dm2_from_holes(src, sign, c_rows):
    """Gram of two-hole intermediates: c_rows is (n, X) for one spin axis.

    Returns (npair, npair) with entry [(p, r), (q, s)] = <a+p a+r a_s a_q>.
    """
    dt = c_rows.dtype
    f = sign.astype(dt)[:, :, None] * c_rows[src]  # (npair, K, X); clamped tables
    npair = f.shape[0]
    f_flat = f.reshape(npair, -1)
    return jnp.matmul(
        f_flat, f_flat.T, preferred_element_type=dt, precision=jax.lax.Precision.HIGHEST
    )


@partial(jax.jit, static_argnames=("col_block",))
def _samespin_dm2_from_holes_blocked(src, sign, c_rows, col_block: int):
    """Column-blocked :func:`_samespin_dm2_from_holes` — the (npair, K, X)
    intermediate never exists whole; Gram contributions accumulate per
    X-block in a ``fori_loop`` (X must be padded to a ``col_block`` multiple
    by the caller; zero-padded columns contribute nothing to the Gram)."""
    dt = c_rows.dtype
    npair = src.shape[0]
    x = c_rows.shape[1]
    sgn = sign.astype(dt)[:, :, None]

    def body(b, gram):
        c_blk = jax.lax.dynamic_slice(
            c_rows, (0, b * col_block), (c_rows.shape[0], col_block)
        )
        f = (sgn * c_blk[src]).reshape(npair, -1)
        return gram + jnp.matmul(
            f, f.T, preferred_element_type=dt, precision=jax.lax.Precision.HIGHEST
        )

    return jax.lax.fori_loop(
        0, x // col_block, body, jnp.zeros((npair, npair), dt)
    )


@partial(jax.jit, static_argnames=("row_block",))
def _dm2ab_pair_gram_blocked(src_a, sign_a, src_b, sign_b, c, row_block: int):
    """``pab[pq, rs] = sum_ij (E^a_pq c)[i,j] (E^b_rs c)[i,j]`` accumulated
    over alpha-row blocks, so no (npair, M, N) product-space buffer exists
    (the unblocked form needs two of them — 40 GB in f64 at 10^7
    determinants).  Tables must be padded along the alpha axis to a
    ``row_block`` multiple with sign 0 (clamped-table convention)."""
    dt = c.dtype
    npair = src_a.shape[0]
    m_pad = src_a.shape[1]
    n = c.shape[1]
    sgn_b = sign_b.astype(dt)[:, None, :]

    def body(b, pab):
        i0 = b * row_block
        src_blk = jax.lax.dynamic_slice(src_a, (0, i0), (npair, row_block))
        sgn_blk = jax.lax.dynamic_slice(sign_a, (0, i0), (npair, row_block))
        d_a = sgn_blk.astype(dt)[:, :, None] * c[src_blk]  # (npair, rb, n)
        c_blk = jax.lax.dynamic_slice(c, (i0, 0), (row_block, n))
        d_b = jnp.swapaxes(jnp.take(c_blk, src_b, axis=1), 0, 1) * sgn_b
        return pab + jnp.matmul(
            d_a.reshape(npair, -1),
            d_b.reshape(npair, -1).T,
            preferred_element_type=dt,
            precision=jax.lax.Precision.HIGHEST,
        )

    return jax.lax.fori_loop(
        0, m_pad // row_block, body, jnp.zeros((npair, npair), dt)
    )


def make_rdms(
    ham: SCIBasis,
    c: jax.Array,
    strs_a_packed: np.ndarray | None = None,
    strs_b_packed: np.ndarray | None = None,
    *,
    spin_resolved: bool = False,
    with_dm2: bool = True,
    block_bytes: int = 128 * 1024**2,
):
    """Compute 1-RDMs (and optionally 2-RDMs) of the state ``c`` (normalized here).

    ``strs_*_packed`` (host arrays) are required for 2-RDMs — the two-hole
    intermediate sets are enumerated from them once per call.

    When a per-pair intermediate ((npair, M, N) for the opposite-spin Gram,
    (npair, K, N) for the same-spin two-hole Grams) would exceed
    ``block_bytes``, its Gram accumulates over row/column blocks of at most
    ``block_bytes`` each — this is what carries ``solve_sci``'s
    energy-from-RDMs step to 10^7 determinants on a single device.  The tile
    must stay SMALL (default 128 MB): XLA may multi-buffer the loop-carried
    gather operands several times over, so a GB-scale tile transiently
    costs many GB of device memory.
    ``block_bytes=0`` forces blocking with the smallest tile (used by tests).

    Returns a dict with keys ``dm1a``, ``dm1b`` and, if ``with_dm2``:
    ``dm2`` (spin-summed) or ``dm2aa/dm2ab/dm2bb`` (``spin_resolved=True``).
    """
    norb = ham.norb
    npair = norb * norb
    c = c / jnp.linalg.norm(c)
    dm1a, dm1b = _dm1s(ham, c)
    out = {"dm1a": dm1a, "dm1b": dm1b}
    if not with_dm2:
        return out
    if strs_a_packed is None or strs_b_packed is None:
        raise ValueError("strs_a_packed/strs_b_packed are required for 2-RDMs.")

    m, n = ham.shape
    itemsize = jnp.dtype(c.dtype).itemsize

    def pick_block(total_rows: int, per_row_bytes: int) -> int:
        """Largest multiple-of-8 block with per-block buffer <= block_bytes
        (0 -> unblocked)."""
        if total_rows * per_row_bytes <= block_bytes:
            return 0
        blk = max(block_bytes, 1) // per_row_bytes
        return int(max(8, min(total_rows, (blk // 8) * 8 or 8)))

    row_block = pick_block(m, npair * n * itemsize)
    if row_block == 0:
        d_a = ham.gather_alpha(c).reshape(npair, -1)
        d_b = ham.gather_beta(c).reshape(npair, -1)
        pab = jnp.matmul(
            d_a, d_b.T, preferred_element_type=c.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
    else:
        m_pad = -(-m // row_block) * row_block
        pad = ((0, 0), (0, m_pad - m))
        pab = _dm2ab_pair_gram_blocked(
            jnp.pad(ham.src_a, pad),
            jnp.pad(ham.sign_a, pad),
            ham.src_b,
            ham.sign_b,
            jnp.pad(c, ((0, m_pad - m), (0, 0))),
            row_block,
        )
    perm = jnp.asarray(_qp_perm(norb))
    dm2ab = pab[perm].reshape(norb, norb, norb, norb)

    n_a, n_b = ham.nelec
    _, src_ha, sign_ha = linktab.build_desdes_tables(strs_a_packed, norb, n_a)
    _, src_hb, sign_hb = linktab.build_desdes_tables(strs_b_packed, norb, n_b)

    def samespin_gram(src, sign, c_rows):
        k = src.shape[1]
        x = c_rows.shape[1]
        blk = pick_block(x, src.shape[0] * k * itemsize)
        if blk == 0:
            return _samespin_dm2_from_holes(src, sign, c_rows)
        x_pad = -(-x // blk) * blk
        c_p = jnp.pad(c_rows, ((0, 0), (0, x_pad - x)))
        return _samespin_dm2_from_holes_blocked(src, sign, c_p, blk)

    gram_a = samespin_gram(src_ha, sign_ha, c)
    gram_b = samespin_gram(src_hb, sign_hb, jnp.swapaxes(c, 0, 1))
    # gram[(p, r), (q, s)] -> dm2ss[p, q, r, s]
    dm2aa = gram_a.reshape(norb, norb, norb, norb).transpose(0, 2, 1, 3)
    dm2bb = gram_b.reshape(norb, norb, norb, norb).transpose(0, 2, 1, 3)

    if spin_resolved:
        out["dm2aa"], out["dm2ab"], out["dm2bb"] = dm2aa, dm2ab, dm2bb
    else:
        out["dm2"] = dm2aa + dm2bb + dm2ab + jnp.transpose(dm2ab, (2, 3, 0, 1))
    return out


def rdm1s(ham: SCIBasis, c: jax.Array):
    r = make_rdms(ham, c, with_dm2=False)
    return r["dm1a"], r["dm1b"]


def rdm1(ham: SCIBasis, c: jax.Array):
    a, b = rdm1s(ham, c)
    return a + b


def rdm2_spin_summed(ham: SCIBasis, c: jax.Array, strs_a_packed, strs_b_packed):
    return make_rdms(ham, c, strs_a_packed, strs_b_packed)["dm2"]


def rdm2s(ham: SCIBasis, c: jax.Array, strs_a_packed, strs_b_packed):
    r = make_rdms(ham, c, strs_a_packed, strs_b_packed, spin_resolved=True)
    return r["dm2aa"], r["dm2ab"], r["dm2bb"]


def energy_from_rdms(h1e, eri, dm1, dm2):
    """``E = sum h*dm1 + 1/2 sum (pq|rs) dm2[p,q,r,s]`` (reference ``fermion.py:619``)."""
    return jnp.einsum("pq,pq->", jnp.asarray(h1e, dm1.dtype), dm1) + 0.5 * jnp.einsum(
        "pqrs,pqrs->", jnp.asarray(eri, dm2.dtype), dm2
    )
