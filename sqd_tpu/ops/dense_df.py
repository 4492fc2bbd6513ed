# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Fully-dense density-fitted matvec for large active spaces.

With the ERI pair matrix factored as ``V = L^T L`` (X, npair), the
cross-spin channel is EXACTLY

    sigma_ab = sum_x  Wa_x @ c @ Wb_x^T,
    Wa_x = sum_pq L[x, pq] * A_pq   (M, M) dense,
    Wb_x = sum_rs L[x, rs] * B_rs   (N, N) dense,

where ``A_pq[j, j'] = <j| E^a_pq |j'>`` restricted to the selected alpha set
(exact for the cross-spin channel: the alpha and beta operators act on
different spins, so no out-of-space intermediate appears — the same
decomposition the gather matvec uses, re-associated).  The same-spin
channels densify to single matrices ``H_aa (M, M)`` / ``H_bb (N, N)`` built
from the Slater-Condon neighbor lists.

The matvec is then pure batched matmul — no gathers at all:
``4 * X * M^2 * N`` FLOPs (M = N), vs the factored gather path's
``4 * X * npair * M * N`` plus its slice-count-bound alpha pick.  The dense
form does ``M / npair`` times MORE FLOPs but runs at matmul speed instead of
gather speed: at the [4Fe-4S]-class shape (M = N = 3168, npair = 1296,
X = 123) it is 15.6 TFLOP of batched matmul per matvec and no gathers.  It
LOSES below the crossover (production norb = 16 CASCI at 1.9e7
determinants: 44 TFLOP dense vs 5 TFLOP gathered), so it is strictly
opt-in via :func:`densify`.

Memory: ``wa``/``wb`` hold ``2 * X * M^2`` floats — the price of zero
gathers — EXCEPT in the identical-set (S_z = 0) case, where :func:`densify`
detects set equality modulo padding, builds ONE stack at the common padded
width and aliases ``wb``/``hbb`` (4.4 GB instead of 8.8 GB f32 at the
[4Fe-4S]-class shape).  Callers at larger M should stay on the gather path
or shard.

Spin-penalty operators (``spin_shift != 0``) are not supported here: the
mixed S^2 term's pair matrix is an involution (eigenvalues +-1, not PSD),
so it has no Cholesky factor — :func:`densify` raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .hamiltonian import SCIHamiltonian

__all__ = ["DenseDFOperator", "densify", "dense_df_matvec_flat"]

_BUILD_PAIR_CHUNK = 32  # one-hot build tiles: (chunk, M, M) ~ 1.2 GB at M=3168
_APPLY_X_CHUNK = 8  # matvec tiles: (chunk, M, N) ~ 320 MB at M=N=3168


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class DenseDFOperator:
    """Dense density-fitted projected Hamiltonian (see module docstring)."""

    wa: jax.Array  # (X, M, M)
    wb: jax.Array  # (X, N, N)
    haa: jax.Array  # (M, M) same-spin alpha (includes its diagonal channel)
    hbb: jax.Array  # (N, N) same-spin beta
    hdiag: jax.Array  # (M, N) — Davidson preconditioner (padded slots huge)
    # x-axis tile for the apply loop; 0 = unchunked single einsum, required
    # when wa/wb are SHARDED over x (a dynamic_slice along a sharded axis
    # would reshard every iteration) — GSPMD then turns the x-reduction into
    # one psum and the per-device footprint is (X/ndev, M, N).
    x_chunk: int = _APPLY_X_CHUNK

    def tree_flatten(self):
        return (self.wa, self.wb, self.haa, self.hbb, self.hdiag), (self.x_chunk,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, x_chunk=aux[0])

    @property
    def shape(self) -> tuple[int, int]:
        # hdiag carries the operator's true (M, N); wa/wb may be built at a
        # common square width >= max(M, N) (identical-set aliasing).
        return tuple(self.hdiag.shape)

    def matvec(self, c: jax.Array) -> jax.Array:
        """``sigma = (P H P) c`` — batched matmuls only, x-chunked.

        ``wa``/``wb`` may be built at a COMMON padded width larger than
        ``c``'s sides (the identical-set aliasing in :func:`densify` when the
        upstream row/column pads differ): the extra rows/columns of every
        dense factor are exactly zero (clamped tables), so zero-padding ``c``
        up and slicing the result back is exact.
        """
        dt = c.dtype
        m_in, n_in = c.shape
        m, n = self.wa.shape[1], self.wb.shape[1]
        if (m, n) != (m_in, n_in):
            c = jnp.pad(c, ((0, m - m_in), (0, n - n_in)))
        x_tot = self.wa.shape[0]
        with jax.default_matmul_precision("highest"):
            sigma = jnp.matmul(self.haa.astype(dt), c, preferred_element_type=dt)
            sigma = sigma + jnp.matmul(
                c, self.hbb.astype(dt).T, preferred_element_type=dt
            )
            if self.x_chunk == 0:
                t = jnp.einsum(
                    "xij,jk->xik", self.wa.astype(dt), c, preferred_element_type=dt
                )
                sigma = sigma + jnp.einsum(
                    "xik,xlk->il", t, self.wb.astype(dt), preferred_element_type=dt
                )
                if (m, n) != (m_in, n_in):
                    sigma = sigma[:m_in, :n_in]
                return sigma
            cx = min(self.x_chunk, x_tot)
            nchunk, rem = divmod(x_tot, cx)

            def body(i, sig):
                wa_c = jax.lax.dynamic_slice(
                    self.wa, (i * cx, 0, 0), (cx, m, m)
                ).astype(dt)
                wb_c = jax.lax.dynamic_slice(
                    self.wb, (i * cx, 0, 0), (cx, n, n)
                ).astype(dt)
                t = jnp.einsum(
                    "xij,jk->xik", wa_c, c, preferred_element_type=dt
                )
                return sig + jnp.einsum(
                    "xik,xlk->il", t, wb_c, preferred_element_type=dt
                )

            sigma = jax.lax.fori_loop(0, nchunk, body, sigma)
            if rem:
                wa_r = self.wa[nchunk * cx :].astype(dt)
                wb_r = self.wb[nchunk * cx :].astype(dt)
                t = jnp.einsum("xij,jk->xik", wa_r, c, preferred_element_type=dt)
                sigma = sigma + jnp.einsum(
                    "xik,xlk->il", t, wb_r, preferred_element_type=dt
                )
        if (m, n) != (m_in, n_in):
            sigma = sigma[:m_in, :n_in]
        return sigma


def dense_df_matvec_flat(op: DenseDFOperator, x: jax.Array) -> jax.Array:
    """Module-level flat matvec (stable jit cache key for the Davidson)."""
    m, n = op.shape
    return op.matvec(x.reshape(m, n)).reshape(-1)


_BUILD_COL_BLOCK = 512  # j-axis tiles of the W build (see _w_stack)


def _w_stack(src, sign, ell, dtype) -> jax.Array:
    """``W[x] = sum_pq L[x, pq] * A_pq`` via pair- and column-tiled matmuls.

    ``A_pq[j, :] = sign[pq, j] * e_{src[pq, j]}`` (clamped tables: invalid
    entries carry sign 0, so padded/absent excitations contribute nothing).
    Built on device: the inputs are the already-resident gather tables, and
    the one-hot einsum is ``2 * X * npair * M^2`` FLOPs of matmul — far
    cheaper than shipping the (X, M, M) result over a host link.

    The accumulation is tiled over BOTH the pair axis and the output string
    (j) axis, each tile written into ``W`` in place via dynamic_update_slice:
    the earlier pairs-only formulation materialized a full (X, M^2) addend
    plus the carried W per iteration — ~15 GB peak at the [4Fe-4S]-class
    shape (X=108, M=3163).  This form peaks at W + one (X, M, jb) block + (cp, M, jb) one-hots
    (~5.8 GB at the same shape).
    """
    npair, m = src.shape
    x_tot = ell.shape[0]
    cp = min(_BUILD_PAIR_CHUNK, npair)
    ell = ell.astype(dtype)
    sign_f = sign.astype(dtype)
    # pad the pair axis to a multiple of cp with sign-0 rows (clamped-table
    # convention: zero sign contributes nothing) — no remainder pass needed
    pad_p = (-npair) % cp
    if pad_p:
        src = jnp.concatenate([src, jnp.zeros((pad_p, m), src.dtype)], axis=0)
        sign_f = jnp.concatenate(
            [sign_f, jnp.zeros((pad_p, m), sign_f.dtype)], axis=0
        )
        ell = jnp.concatenate(
            [ell, jnp.zeros((x_tot, pad_p), ell.dtype)], axis=1
        )
    npair_p = npair + pad_p
    jb = min(_BUILD_COL_BLOCK, m)

    def block(j0, count):
        """(X, count, M) W-rows for table strings j in [j0, j0+count)."""

        def body(i, acc):
            p0 = i * cp
            src_c = jax.lax.dynamic_slice(src, (p0, j0), (cp, count))
            sgn_c = jax.lax.dynamic_slice(sign_f, (p0, j0), (cp, count))
            ell_c = jax.lax.dynamic_slice(ell, (0, p0), (x_tot, cp))
            onehot = jax.nn.one_hot(src_c, m, dtype=dtype)  # (cp, count, M)
            a_c = sgn_c[:, :, None] * onehot
            return acc + jnp.matmul(
                ell_c, a_c.reshape(cp, count * m), preferred_element_type=dtype
            )

        acc = jax.lax.fori_loop(
            0, npair_p // cp, body, jnp.zeros((x_tot, count * m), dtype)
        )
        return acc.reshape(x_tot, count, m)

    jnb, jrem = divmod(m, jb)

    def outer(t, w):
        return jax.lax.dynamic_update_slice(w, block(t * jb, jb), (0, t * jb, 0))

    with jax.default_matmul_precision("highest"):
        w = jax.lax.fori_loop(
            0, jnb, outer, jnp.zeros((x_tot, m, m), dtype)
        )
        if jrem:
            w = jax.lax.dynamic_update_slice(
                w, block(jnb * jb, jrem), (0, jnb * jb, 0)
            )
    return w


def _dense_samespin(idx, val, dtype) -> jax.Array:
    """Dense (M, M) same-spin matrix from the compacted neighbor lists."""
    m = idx.shape[0]
    rows = jnp.broadcast_to(jnp.arange(m, dtype=jnp.int32)[:, None], idx.shape)
    return (
        jnp.zeros((m, m), dtype)
        .at[rows, idx]
        .add(val.astype(dtype))
    )


def densify(
    ham: SCIHamiltonian, dtype=jnp.float32, *, x_chunk: int = _APPLY_X_CHUNK
) -> DenseDFOperator:
    """Build the dense density-fitted operator from a factored Hamiltonian.

    Requires ``ham.eri_chol`` (see ``build_sci_hamiltonian(eri_factor=...)``)
    and no fused spin penalty.  The build itself is device-side matmul work
    (~``2 * X * npair * (M^2 + N^2)`` FLOPs, one-time per subspace).
    """
    if ham.eri_chol is None:
        raise ValueError(
            "densify requires an ERI factor: build the Hamiltonian with "
            "eri_factor='auto' (PSD integrals) or pass an explicit factor"
        )
    if ham.spin_shift != 0.0:
        raise ValueError(
            "densify does not support the fused spin penalty (the S^2 mixed "
            "term's pair matrix is not PSD); solve with spin_shift=0"
        )
    ell = ham.eri_chol
    m, n = ham.src_a.shape[1], ham.src_b.shape[1]
    p = max(m, n)

    def _pad_cols(a):
        # zero columns = clamped inert entries (slot 0, sign 0)
        return a if a.shape[1] == p else jnp.pad(a, ((0, 0), (0, p - a.shape[1])))

    # Identical alpha/beta string sets (every S_z = 0 workflow, incl. the
    # [4Fe-4S] (27, 27) sector) make Wb == Wa and H_bb == H_aa: alias the
    # buffers and halve the dominant memory cost.  ``build_sci_hamiltonian`` pads the row
    # axis to x8 but the column axis to x128, so identical sets routinely
    # arrive with DIFFERENT padded widths — compare modulo the zero padding
    # and build once at the common width; the matvec pads/slices c around
    # the square factors (exact: padded factor rows/columns are all zero).
    # Without this, a (54e, 36o) 1e7-determinant build holds TWO ~4.4 GB
    # stacks plus the build transient.
    src_a, sign_a = _pad_cols(ham.src_a), _pad_cols(ham.sign_a)
    same_sets = ham.src_a.shape[0] == ham.src_b.shape[0] and bool(
        jnp.all(src_a == _pad_cols(ham.src_b))
        & jnp.all(sign_a == _pad_cols(ham.sign_b))
    )
    if same_sets:
        pad_r = ((0, p - ham.nbr_idx_a.shape[0]), (0, 0))
        haa = hbb = _dense_samespin(
            jnp.pad(ham.nbr_idx_a, pad_r), jnp.pad(ham.nbr_val_a, pad_r), dtype
        )
        # the W stack dominates device memory: allocate it last
        wa = wb = _w_stack(src_a, sign_a, ell, dtype)
    else:
        haa = _dense_samespin(ham.nbr_idx_a, ham.nbr_val_a, dtype)
        hbb = _dense_samespin(ham.nbr_idx_b, ham.nbr_val_b, dtype)
        wa = _w_stack(ham.src_a, ham.sign_a, ell, dtype)
        wb = _w_stack(ham.src_b, ham.sign_b, ell, dtype)
    return DenseDFOperator(
        wa=wa, wb=wb, haa=haa, hbb=hbb, hdiag=ham.hdiag.astype(dtype),
        x_chunk=x_chunk,
    )
