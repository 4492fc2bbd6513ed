# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Excitation gather tables for selected-CI Hamiltonian application.

Device replacement for PySCF's C link tables (reference delegates to
``pyscf.fci.selected_ci.kernel_fixed_space`` / ``contract_2e`` at
``fermion.py:513-515``; SURVEY.md N1).  Key observation: for a *fixed* orbital
pair ``(p, q)`` the single-excitation map ``|I> -> a+_p a_q |I>`` is injective
on the string set, so instead of per-string variable-length neighbor lists
(irregular, scatter-heavy) we build **dense per-pair gather tables**

    src[pq, J]  = index I such that  a+_p a_q |I> = sign * |J>   (or sentinel)
    sign[pq, J] in {-1, 0, +1}

so that the action of the spin-resolved excitation operator is a pure gather:

    (E_pq v)[J, :] = sign[pq, J] * v_padded[src[pq, J], :]

with a zero sentinel row at index ``n``.  No scatters anywhere — both the
``D[rs] = E_rs v`` build and the final ``sigma = sum_pq E_pq G[pq]`` reduce to
gathers + elementwise multiplies, and the two-electron contraction between
them is one big matmul (see :mod:`sqd_tpu.ops.hamiltonian`).

Everything here is jittable with static shapes: ``(norb^2, n)`` int32/int8
tables built by a vmapped branchless binary search over the packed string set.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from . import bitpack

__all__ = ["build_gather_tables", "occupancy_matrix", "pair_index_arrays"]


def pair_index_arrays(norb: int):
    """Static per-``norb`` constants describing all (p, q) operator pairs.

    Returns a dict of numpy arrays with leading dimension ``norb**2`` in
    ``pq = p * norb + q`` order (operator ``a+_p a_q``).
    """
    w = bitpack.num_words(norb)
    bits = bitpack.bit_masks(norb)  # (norb, W)
    prefix = bitpack.prefix_masks(norb)  # (norb+1, W)
    p_idx, q_idx = np.divmod(np.arange(norb * norb), norb)
    return {
        "bit_p": bits[p_idx],  # (npair, W)
        "bit_q": bits[q_idx],
        "below_p": prefix[p_idx],  # bits < p
        "below_q": prefix[q_idx],
        "q_lt_p": (q_idx < p_idx).astype(np.int32),
        "is_diag": (p_idx == q_idx),
        "num_words": w,
    }


@partial(jax.jit, static_argnames=("norb",))
def build_gather_tables(strs_sorted: jax.Array, norb: int):
    """Build (src, sign) gather tables for one spin sector.

    Args:
        strs_sorted: ``(n, W) uint32`` packed CI strings, sorted ascending,
            unique, all with the same Hamming weight.
        norb: Number of spatial orbitals (static).

    Returns:
        ``src``: ``(norb**2, n) int32`` — source string index, or ``n``
        (sentinel; reads a zero pad row) where the excitation leaves the set.
        ``sign``: ``(norb**2, n) int8`` — fermionic phase, 0 where invalid.
    """
    consts = pair_index_arrays(norb)
    n = strs_sorted.shape[0]
    bit_p = jnp.asarray(consts["bit_p"])  # (npair, W)
    bit_q = jnp.asarray(consts["bit_q"])
    below_p = jnp.asarray(consts["below_p"])
    below_q = jnp.asarray(consts["below_q"])
    q_lt_p = jnp.asarray(consts["q_lt_p"])
    is_diag = jnp.asarray(consts["is_diag"])

    def per_pair(bp, bq, belp, belq, qlp, diag):
        # J: all target strings (n, W)
        j = strs_sorted
        has_p = bitpack.jnp_popcount_rows(j & bp) > 0
        has_q = bitpack.jnp_popcount_rows(j & bq) > 0
        # diagonal pair (p == q): I = J, occupied-> sign +1
        # off-diagonal: valid iff p in J and q not in J; I = J ^ bp ^ bq
        i_cand = j ^ bp ^ bq
        valid_off = has_p & ~has_q
        src_off = bitpack.jnp_find_packed(strs_sorted, i_cand)
        # phase computed on I: remove q (parity below q in I), then add p
        # (parity below p in I - q). q is in I for valid off-diagonal pairs.
        s1 = bitpack.jnp_popcount_rows(i_cand & belq)
        s2 = bitpack.jnp_popcount_rows(i_cand & belp) - qlp
        sign_off = jnp.where((s1 + s2) % 2 == 0, 1, -1).astype(jnp.int8)

        src = jnp.where(diag, jnp.arange(n, dtype=jnp.int32), src_off.astype(jnp.int32))
        ok = jnp.where(diag, has_p, valid_off & (src_off >= 0))
        sign = jnp.where(ok, jnp.where(diag, jnp.int8(1), sign_off), jnp.int8(0))

        return src, sign

    src, sign = jax.vmap(per_pair)(bit_p, bit_q, below_p, below_q, q_lt_p, is_diag)
    return src, sign


def build_desdes_tables(strs_packed: np.ndarray, norb: int, nelec_spin: int):
    """Two-hole (annihilation-pair) gather tables for exact same-spin 2-RDMs.

    For the operator ``F[(u,w)] = a_w a_u c`` the intermediates live on the
    (nelec-2)-electron strings *reachable from the set* — a closed set, so the
    factorized same-spin 2-RDM ``<a+_p a+_r a_s a_q> = <F[(p,r)], F[(q,s)]>``
    is exact (unlike single-excitation intermediates, which can leave a
    selected set; cf. PySCF's des-des link tables, SURVEY.md N1/N3).

    Returns ``(inter_packed (K, W), src (norb^2, K) int32, sign (norb^2, K) int8)``
    with ``src[(u*norb+w), k]`` the index I such that ``I = K_k + u + w`` (or
    sentinel ``n``), and ``sign = <K|a_w a_u|I>``.
    """
    strs_packed = np.asarray(strs_packed)
    n, w_words = strs_packed.shape
    if nelec_spin < 2 or n == 0:
        inter = np.zeros((0, w_words), dtype=np.uint32)
        src = np.full((norb * norb, 0), 0, dtype=np.int32)
        sign = np.zeros((norb * norb, 0), dtype=np.int8)
        return inter, jnp.asarray(src), jnp.asarray(sign)

    # Host-side enumeration of the reachable two-hole set (once per solve) —
    # native C++ fused enumerate+sort+unique, with NumPy fallback inside.
    from .. import native

    inter = native.desdes_unique(strs_packed, nelec_spin)

    # Device-side gather tables over the intermediate set.
    consts = pair_index_arrays(norb)
    strs_d = jnp.asarray(strs_packed)
    inter_d = jnp.asarray(inter)
    prefix = jnp.asarray(bitpack.prefix_masks(norb))
    bit_u = jnp.asarray(consts["bit_p"])  # (npair, W): u = "p" slot
    bit_w = jnp.asarray(consts["bit_q"])  # w = "q" slot
    below_u = jnp.asarray(consts["below_p"])
    below_w = jnp.asarray(consts["below_q"])
    u_lt_w = jnp.asarray(consts["q_lt_p"] == 0) & ~jnp.asarray(consts["is_diag"])
    is_diag = jnp.asarray(consts["is_diag"])

    @jax.jit
    def build(inter_d):
        def per_pair(bu, bw, belu, belw, ultw, diag):
            k = inter_d
            free_u = bitpack.jnp_popcount_rows(k & bu) == 0
            free_w = bitpack.jnp_popcount_rows(k & bw) == 0
            i_cand = k | bu | bw
            src = bitpack.jnp_find_packed(strs_d, i_cand)
            # sign of <K|a_w a_u|I>: remove u from I (parity below u in I),
            # then remove w from I-u (parity below w in I, minus 1 if u < w).
            s1 = bitpack.jnp_popcount_rows(i_cand & belu)
            s2 = bitpack.jnp_popcount_rows(i_cand & belw) - ultw.astype(jnp.int32)
            sgn = jnp.where((s1 + s2) % 2 == 0, 1, -1).astype(jnp.int8)
            ok = free_u & free_w & (src >= 0) & ~diag
            return (
                jnp.where(ok, src, 0).astype(jnp.int32),  # clamped: sign 0 kills it
                jnp.where(ok, sgn, 0).astype(jnp.int8),
            )

        return jax.vmap(per_pair)(bit_u, bit_w, below_u, below_w, u_lt_w, is_diag)

    src, sign = build(inter_d)
    return inter, src, sign


@partial(jax.jit, static_argnames=("norb",))
def occupancy_matrix(strs: jax.Array, norb: int) -> jax.Array:
    """``(n, norb)`` occupation-number matrix (0/1 int32) from packed strings."""
    word_of = np.arange(norb) // bitpack.WORD_BITS
    shift_of = (np.arange(norb) % bitpack.WORD_BITS).astype(np.uint32)
    words = strs[:, word_of]  # (n, norb)
    return ((words >> jnp.asarray(shift_of)[None, :]) & 1).astype(jnp.int32)
