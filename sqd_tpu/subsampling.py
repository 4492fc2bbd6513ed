# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Postselection and batch subsampling of bitstring matrices.

Device re-implementation of reference L1 (``qiskit_addon_sqd/subsampling.py``).
The public surface is identical.  :func:`subsample` mirrors the reference's
host ``rng.choice`` semantics exactly (the orchestrator's bit-for-bit seeded
determinism rests on it); :func:`subsample_device` draws all batches at once
on device via Gumbel-top-k (:mod:`sqd_tpu.ops.sampling`) — same distribution,
different (device-PRNG) stream.
"""

from __future__ import annotations

import numpy as np

from .utils.deprecation import deprecate_func

__all__ = [
    "postselect_and_subsample",
    "postselect_by_hamming_right_and_left",
    "subsample",
    "subsample_device",
]


@deprecate_func(
    since="0.2.0",
    package_name="sqd-tpu",
    removal_timeline="no earlier than v0.4.0",
    additional_msg=("Instead, use the ``postselect_by_hamming_right_and_left`` function."),
)
def post_select_by_hamming_weight(
    bitstring_matrix: np.ndarray, *, hamming_right: int, hamming_left: int
) -> np.ndarray:
    """Mask of rows whose halves have the target Hamming weights.

    Deprecated since 0.12, matching the reference's warning contract
    (``configuration_recovery.py:26-56``); kept for API parity.
    """
    if hamming_left < 0 or hamming_right < 0:
        raise ValueError("Hamming weights must be non-negative integers.")
    num_bits = bitstring_matrix.shape[1]
    up_keepers = np.sum(bitstring_matrix[:, num_bits // 2 :], axis=1) == hamming_right
    down_keepers = np.sum(bitstring_matrix[:, : num_bits // 2], axis=1) == hamming_left
    return np.logical_and(up_keepers, down_keepers)


def postselect_by_hamming_right_and_left(
    bitstring_matrix: np.ndarray,
    probabilities: np.ndarray,
    *,
    hamming_right: int,
    hamming_left: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Keep rows with the target Hamming weight on each half; renormalize probabilities.

    Mirrors reference ``subsampling.py:96-144``.

    Raises:
        ValueError: Hamming weights must be non-negative integers.
        ValueError: The number of columns in ``bitstring_matrix`` must be even.
        ValueError: The number of elements in ``probabilities`` must equal the
            number of rows in ``bitstring_matrix``.
    """
    if hamming_left < 0 or hamming_right < 0:
        raise ValueError("Hamming weight must be specified with a non-negative integer.")
    n_bitstrings, n_bits = bitstring_matrix.shape
    if n_bits % 2:
        raise ValueError(f"The length of the bitstrings must be even. Instead, got {n_bits}.")
    if len(probabilities) != n_bitstrings:
        raise ValueError(
            "The number of elements in the probabilities array must match the "
            "number of rows in the bitstring matrix."
        )
    norb = n_bits // 2
    valid_right = np.sum(bitstring_matrix[:, norb:], axis=1) == hamming_right
    valid_left = np.sum(bitstring_matrix[:, :norb], axis=1) == hamming_left
    valid_indices = np.logical_and(valid_right, valid_left)

    bitstrings_post = bitstring_matrix[valid_indices]
    probs_post = np.asarray(probabilities, dtype=float)[valid_indices]
    probs_post = probs_post / np.sum(probs_post)
    return bitstrings_post, probs_post


def subsample(
    bitstring_matrix: np.ndarray,
    probabilities: np.ndarray,
    samples_per_batch: int,
    num_batches: int,
    rand_seed: np.random.Generator | int | None = None,
) -> list[np.ndarray]:
    """Draw batches of rows: without replacement within a batch, with replacement across.

    Mirrors reference ``subsampling.py:147-211``, including the degenerate case
    where ``samples_per_batch >= len(bitstring_matrix)`` returns identity copies.

    Raises:
        ValueError: The number of elements in ``probabilities`` must equal the
            number of rows in ``bitstring_matrix``.
        ValueError: Samples per batch and number of batches must be positive integers.
    """
    if bitstring_matrix.shape[0] < 1:
        return [np.array([])] * num_batches
    if len(probabilities) != bitstring_matrix.shape[0]:
        raise ValueError(
            "The number of elements in the probabilities array must match the "
            "number of rows in the bitstring matrix."
        )
    if samples_per_batch < 1:
        raise ValueError("Samples per batch must be specified with a positive integer.")
    if num_batches < 1:
        raise ValueError("The number of batches must be specified with a positive integer.")

    rng = np.random.default_rng(rand_seed)
    num_bitstrings = bitstring_matrix.shape[0]

    if samples_per_batch >= num_bitstrings:
        return [bitstring_matrix.copy() for _ in range(num_batches)]

    batches = []
    for _ in range(num_batches):
        indices = rng.choice(num_bitstrings, samples_per_batch, replace=False, p=probabilities)
        batches.append(bitstring_matrix[indices])
    return batches


def subsample_device(
    bitstring_matrix: np.ndarray,
    probabilities: np.ndarray,
    samples_per_batch: int,
    num_batches: int,
    key,
) -> list[np.ndarray]:
    """All batches drawn at once on device (Gumbel-top-k, no host loop).

    Same distribution as :func:`subsample` — ``num_batches`` independent
    weighted samples of ``samples_per_batch`` rows without replacement within
    a batch (:mod:`sqd_tpu.ops.sampling`) — but a different random stream
    (``jax.random`` key instead of the host generator), so it is a separate
    entry point rather than a flag on :func:`subsample`, whose bit-for-bit
    host-RNG parity the orchestrator's determinism contract depends on.
    """
    import jax
    import jax.numpy as jnp

    from .ops.sampling import gumbel_topk_indices

    if bitstring_matrix.shape[0] < 1:
        return [np.array([])] * num_batches
    if len(probabilities) != bitstring_matrix.shape[0]:
        raise ValueError(
            "The number of elements in the probabilities array must match the "
            "number of rows in the bitstring matrix."
        )
    if samples_per_batch < 1:
        raise ValueError("Samples per batch must be specified with a positive integer.")
    if num_batches < 1:
        raise ValueError("The number of batches must be specified with a positive integer.")
    if samples_per_batch >= bitstring_matrix.shape[0]:
        return [bitstring_matrix.copy() for _ in range(num_batches)]
    if int(np.count_nonzero(np.asarray(probabilities) > 0)) < samples_per_batch:
        # match host-path (rng.choice) semantics: sampling without replacement
        # cannot produce more rows than have positive probability
        raise ValueError("Fewer non-zero entries in p than size")

    p = jnp.asarray(probabilities, jnp.float32)
    logw = jnp.where(p > 0, jnp.log(jnp.where(p > 0, p, 1.0)), -jnp.inf)
    keys = jax.random.split(key, num_batches)
    idx = jax.vmap(lambda k: gumbel_topk_indices(k, logw, samples_per_batch))(keys)
    idx = np.asarray(idx)
    return [bitstring_matrix[idx[b]] for b in range(num_batches)]


@deprecate_func(
    since="0.2.0",
    package_name="sqd-tpu",
    removal_timeline="no earlier than v0.4.0",
    additional_msg=(
        "Instead, use the ``postselect_by_hamming_right_and_left`` and ``subsample`` functions."
    ),
)
def postselect_and_subsample(
    bitstring_matrix: np.ndarray,
    probabilities: np.ndarray,
    *,
    hamming_right: int,
    hamming_left: int,
    samples_per_batch: int,
    num_batches: int,
    rand_seed: np.random.Generator | int | None = None,
) -> list[np.ndarray]:
    """Postselect on bipartite Hamming weight, then subsample batches.

    Deprecated combination kept for parity with reference ``subsampling.py:24-93``.
    """
    num_bitstrings = len(bitstring_matrix)
    if num_bitstrings == 0:
        return [np.array([])] * num_batches
    if len(probabilities) != num_bitstrings:
        raise ValueError(
            "The number of elements in the probabilities array must match the "
            "number of rows in the bitstring matrix."
        )
    if hamming_left < 0 or hamming_right < 0:
        raise ValueError("Hamming weight must be specified with a non-negative integer.")

    rng = np.random.default_rng(rand_seed)
    mask_postsel = post_select_by_hamming_weight(
        bitstring_matrix, hamming_right=hamming_right, hamming_left=hamming_left
    )
    bs_mat_postsel = bitstring_matrix[mask_postsel]
    probs_postsel = np.abs(np.asarray(probabilities, dtype=float)[mask_postsel])
    if len(probs_postsel) == 0:
        return [np.array([])] * num_batches
    probs_postsel = probs_postsel / np.sum(probs_postsel)
    return subsample(bs_mat_postsel, probs_postsel, samples_per_batch, num_batches, rand_seed=rng)
