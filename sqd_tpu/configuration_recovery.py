# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Self-consistent configuration recovery, vectorized across all samples.

Device re-implementation of reference
``qiskit_addon_sqd/configuration_recovery.py``.  The reference repairs each
bitstring in a per-sample Python loop (``configuration_recovery.py:114-123``,
its hot loop #2); here the whole batch is repaired by one jitted kernel:

* per-bit flip probabilities are elementwise in (expected ratio, occupancy)
  with the same piecewise-linear form and ``eps = 0.01``
  (``configuration_recovery.py:131-178``);
* "flip exactly ``|n_diff|`` bits without replacement, p proportional to the
  flip probabilities" (``configuration_recovery.py:247-301``) becomes a
  per-row Gumbel-top-k rank-and-mask, which reproduces the distribution of
  ``rng.choice(replace=False, p=...)`` without any sequential draws;
* dedup + probability aggregation run over packed uint32 keys.

Behavioral deltas vs the reference (documented):
* Output rows are sorted by integer value rather than first-occurrence order
  (downstream consumers sort/unique anyway).
* If a row has fewer positive-probability candidate bits than ``|n_diff|``,
  the reference's ``rng.choice`` raises; this kernel flips every available
  candidate instead (the row keeps a Hamming violation, as it does in the
  reference when all flip probabilities are zero).
"""

from __future__ import annotations

import warnings
from collections.abc import Sequence
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .ops import bitpack
from .ops.sampling import rank_by_gumbel
from .subsampling import post_select_by_hamming_weight  # re-export for API parity

__all__ = ["post_select_by_hamming_weight", "recover_configurations"]

_EPS = 0.01


def recover_configurations(
    bitstring_matrix: np.ndarray,
    probabilities: Sequence[float] | np.ndarray,
    avg_occupancies: tuple[np.ndarray, np.ndarray],
    num_elec_a: int,
    num_elec_b: int,
    rand_seed: np.random.Generator | int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Refine bitstrings toward the target bipartite Hamming weight.

    Mirrors reference ``configuration_recovery.py:59-128``; see module
    docstring for the vectorization strategy.

    Args:
        bitstring_matrix: 2D bool array, one bitstring per row
            (``[b_N..b_0, a_N..a_0]`` column layout).
        probabilities: 1D probability distribution over the rows.
        avg_occupancies: Pair ``(occ_a, occ_b)`` of mean spin-up / spin-down
            orbital occupancies (orbital-index order).
        num_elec_a: Number of spin-up electrons.
        num_elec_b: Number of spin-down electrons.
        rand_seed: Seed or generator controlling randomness.

    Returns:
        The refined (deduplicated) bitstring matrix and updated probabilities.

    Raises:
        ValueError: The numbers of electrons must be non-negative integers.
    """
    occ_dims = len(np.array(avg_occupancies).shape)
    if occ_dims == 1:
        warnings.warn(
            "Passing avg_occupancies as a 1D array is deprecated. Pass a "
            "length-2 tuple containing the spin-up and spin-down occupancies "
            "respectively.",
            DeprecationWarning,
            stacklevel=2,
        )
        norb = bitstring_matrix.shape[1] // 2
        avg_occupancies = (np.flip(avg_occupancies[norb:]), np.flip(avg_occupancies[:norb]))

    if num_elec_a < 0 or num_elec_b < 0:
        raise ValueError("The numbers of electrons must be specified as non-negative integers.")

    rng = np.random.default_rng(rand_seed)
    key = jax.random.key(int(rng.integers(0, 2**63 - 1)))

    bs_mat = np.asarray(bitstring_matrix, dtype=bool)
    if bs_mat.size == 0:
        return bs_mat, np.asarray(probabilities, dtype=float)
    # Column-space occupancy vector: [occ_b reversed, occ_a reversed], matching
    # the reference's occs_array (configuration_recovery.py:113).
    occs_array = np.concatenate(
        (np.asarray(avg_occupancies[1])[::-1], np.asarray(avg_occupancies[0])[::-1])
    ).astype(np.float64)

    repaired = np.asarray(
        _recover_kernel(
            jnp.asarray(bs_mat),
            jnp.asarray(occs_array),
            key,
            hamming_left=int(num_elec_b),
            hamming_right=int(num_elec_a),
        )
    )

    # Deduplicate repaired strings, aggregating their probabilities.
    packed = bitpack.pack_bool_matrix(repaired)
    order = np.lexsort(tuple(packed[:, j] for j in range(packed.shape[1])))
    s = packed[order]
    probs_sorted = np.asarray(probabilities, dtype=float)[order]
    new_group = np.ones(len(s), dtype=bool)
    if len(s) > 1:
        new_group[1:] = np.any(s[1:] != s[:-1], axis=1)
    group_ids = np.cumsum(new_group) - 1
    freqs_out = np.zeros(group_ids[-1] + 1 if len(s) else 0, dtype=float)
    np.add.at(freqs_out, group_ids, probs_sorted)
    uniq = s[new_group]
    bs_mat_out = bitpack.unpack_to_bool_matrix(uniq, bs_mat.shape[1])
    freqs_out = np.abs(freqs_out) / np.sum(np.abs(freqs_out))
    return bs_mat_out, freqs_out


def _p_flip_0_to_1(ratio_exp, occ, eps=_EPS):
    """Probability of flipping a bit 0 -> 1 (vectorized reference ``:131-159``)."""
    below = occ * eps / jnp.where(ratio_exp > 0, ratio_exp, 1.0)
    slope = (1 - eps) / jnp.where(ratio_exp != 1.0, 1 - ratio_exp, 1.0)
    intercept = 1 - slope
    above = jnp.where(ratio_exp == 1.0, eps, occ * slope + intercept)
    return jnp.where(occ < ratio_exp, below, above)


def _p_flip_1_to_0(ratio_exp, occ, eps=_EPS):
    """Probability of flipping a bit 1 -> 0 (reference ``:162-178``)."""
    return _p_flip_0_to_1(1 - ratio_exp, 1 - occ, eps)


@partial(jax.jit, static_argnames=("hamming_left", "hamming_right"))
def _recover_kernel(bs_mat, occs_array, key, *, hamming_left: int, hamming_right: int):
    """Repair all rows at once; returns the corrected bool matrix."""
    n_rows, n_bits = bs_mat.shape
    half = n_bits // 2
    key_l, key_r = jax.random.split(key)

    def fix_half(bits, occs, target, subkey):
        # bits: (S, half) bool; occs: (half,) column-space occupancies
        ratio = target / half
        p = jnp.where(
            bits,
            _p_flip_1_to_0(ratio, occs[None, :]),
            _p_flip_0_to_1(ratio, occs[None, :]),
        )
        p = jnp.clip(p, 0.0, 1.0)
        any_p = jnp.any(p > 0, axis=1)  # reference's np.any(probs) gate
        n_diff = jnp.sum(bits, axis=1).astype(jnp.int32) - target
        # Candidates: occupied bits when over-weight, empty bits when under.
        over = n_diff > 0
        candidate = jnp.where(over[:, None], bits, ~bits) & (p > 0)
        logw = jnp.where(candidate, jnp.log(jnp.where(candidate, p, 1.0)), -jnp.inf)
        ranks, _ = rank_by_gumbel(subkey, logw)
        k = jnp.abs(n_diff)[:, None]
        flip = candidate & (ranks < k) & any_p[:, None] & (n_diff != 0)[:, None]
        return bits ^ flip

    left = fix_half(bs_mat[:, :half], occs_array[:half], hamming_left, key_l)
    right = fix_half(bs_mat[:, half:], occs_array[half:], hamming_right, key_r)
    return jnp.concatenate((left, right), axis=1)
