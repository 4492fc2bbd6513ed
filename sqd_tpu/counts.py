# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Sample ingestion: counts dictionaries / bit arrays -> bitstring matrices.

Device re-implementation of the reference layer L0
(``qiskit_addon_sqd/counts.py``).  The public surface is identical; the
implementation avoids per-sample Python loops by going through the packed
uint32 word representation (:mod:`sqd_tpu.ops.bitpack`) for dedup and integer
conversion.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from .ops import bitpack
from .primitives import BitArray

__all__ = [
    "counts_to_arrays",
    "bit_array_to_arrays",
    "generate_counts_uniform",
    "generate_bit_array_uniform",
    "generate_counts_bipartite_hamming",
    "normalize_counts_dict",
    "bitstring_matrix_to_integers",
]


def counts_to_arrays(counts: Mapping[str, float | int]) -> tuple[np.ndarray, np.ndarray]:
    """Convert a counts dictionary into a bitstring matrix and a probability array.

    Mirrors reference ``counts.py:24-42``.

    Args:
        counts: The counts dictionary to convert.

    Returns:
        - A 2D bool array; each row is one sampled bitstring (column 0 = MSB).
        - A 1D array of the probability with which each bitstring was sampled.
    """
    if not counts:
        return np.array([]), np.array([])
    prob_dict = normalize_counts_dict(counts)
    keys = list(prob_dict)
    # one bulk ASCII decode instead of a per-character Python loop
    bs_mat = (
        np.frombuffer("".join(keys).encode("ascii"), dtype=np.uint8).reshape(
            len(keys), len(keys[0])
        )
        == ord("1")
    )
    freq_arr = np.array(list(prob_dict.values()))
    return bs_mat, freq_arr


def bit_array_to_arrays(bit_array) -> tuple[np.ndarray, np.ndarray]:
    """Convert a bit array into a (deduplicated) bitstring matrix and probabilities.

    Mirrors reference ``counts.py:45-61`` but deduplicates via a packed-word
    lexicographic sort instead of ``np.unique(axis=0)`` on bools.

    Args:
        bit_array: A :class:`~sqd_tpu.primitives.BitArray` (or any object with
            ``array``/``num_bits``/``num_shots`` in the same packed layout,
            e.g. a Qiskit ``BitArray``).

    Returns:
        - A 2D bool array of unique sampled bitstrings, sorted ascending.
        - A 1D array of sample probabilities.
    """
    bool_array = np.unpackbits(bit_array.array, axis=-1)[..., -bit_array.num_bits :].astype(bool)
    packed = bitpack.pack_bool_matrix(bool_array)
    uniq, counts = bitpack.unique_packed(packed, return_counts=True)
    bitstrings = bitpack.unpack_to_bool_matrix(uniq, bit_array.num_bits)
    probs = counts / bit_array.num_shots
    return bitstrings, probs


def generate_counts_uniform(
    num_samples: int, num_bits: int, rand_seed: np.random.Generator | int | None = None
) -> dict[str, int]:
    """Generate a counts dictionary of uniformly random bitstrings.

    Mirrors reference ``counts.py:64-97`` in distribution, NOT in RNG stream:
    the vectorized implementation draws one uint8 matrix instead of
    per-sample floats, and returns keys in sorted-unique order rather than
    sample insertion order — same-seed outputs differ from the reference
    (and from pre-vectorization versions of this package).  Only the
    distribution is contractual.

    Raises:
        ValueError: ``num_samples`` and ``num_bits`` must be positive integers.
    """
    if num_samples < 1:
        raise ValueError("The number of samples must be specified with a positive integer.")
    if num_bits < 1:
        raise ValueError("The number of bits must be specified with a positive integer.")
    rng = np.random.default_rng(rand_seed)
    bits = rng.integers(0, 2, size=(num_samples, num_bits), dtype=np.uint8)
    return _count_rows(bits)


def _count_rows(bits: np.ndarray) -> dict[str, int]:
    """Bool/0-1 matrix -> {bitstring: multiplicity}, fully vectorized.

    Dedup runs on the packed-word representation; only the unique rows are
    ever stringified (one bulk ASCII encode, no per-bit Python loop).
    """
    n_bits = bits.shape[1]
    uniq, cnt = bitpack.unique_packed(
        bitpack.pack_bool_matrix(bits.astype(bool)), return_counts=True
    )
    ubits = bitpack.unpack_to_bool_matrix(uniq, n_bits)
    raw = (ubits.astype(np.uint8) + ord("0")).tobytes()
    return {
        raw[i * n_bits : (i + 1) * n_bits].decode("ascii"): int(c)
        for i, c in enumerate(cnt)
    }


def generate_bit_array_uniform(
    num_samples: int, num_bits: int, rand_seed: np.random.Generator | int | None = None
) -> BitArray:
    """Generate a bit array of uniformly random samples (reference ``counts.py:100-117``).

    Raises:
        ValueError: ``num_samples`` and ``num_bits`` must be positive integers.
    """
    if num_samples < 1:
        raise ValueError("The number of samples must be specified with a positive integer.")
    if num_bits < 1:
        raise ValueError("The number of bits must be specified with a positive integer.")
    rng = np.random.default_rng(rand_seed)
    return BitArray.from_bool_array(rng.integers(2, size=(num_samples, num_bits), dtype=bool))


def generate_counts_bipartite_hamming(
    num_samples: int,
    num_bits: int,
    *,
    hamming_right: int,
    hamming_left: int,
    rand_seed: np.random.Generator | int | None = None,
) -> dict[str, int]:
    """Generate counts with fixed Hamming weight on each half of the bitstrings.

    Mirrors reference ``counts.py:120-173`` in distribution, NOT in RNG
    stream: argsort-of-uniforms replaces per-sample ``rng.choice`` and keys
    come back in sorted-unique order, so same-seed outputs differ from the
    reference.  Only the distribution is contractual.

    Raises:
        ValueError: ``num_bits`` and ``num_samples`` must be positive integers.
        ValueError: Hamming weights must be specified as non-negative integers.
        ValueError: ``num_bits`` must be even.
    """
    if num_bits % 2 != 0:
        raise ValueError("The number of bits must be specified with an even integer.")
    if num_samples < 1:
        raise ValueError("The number of samples must be specified with a positive integer.")
    if num_bits < 1:
        raise ValueError("The number of bits must be specified with a positive integer.")
    if hamming_left < 0 or hamming_right < 0:
        raise ValueError("Hamming weights must be specified as non-negative integers.")

    rng = np.random.default_rng(rand_seed)
    half = num_bits // 2
    if hamming_left > half or hamming_right > half:
        # same surface the reference hits inside rng.choice(half, k, replace=False)
        raise ValueError("Cannot take a larger sample than population when 'replace=False'")

    def random_subsets(k: int) -> np.ndarray:
        # the k smallest of iid uniforms form a uniformly random k-subset;
        # one argsort replaces num_samples rng.choice calls
        return np.argsort(rng.random((num_samples, half)), axis=1)[:, :k]

    bits = np.zeros((num_samples, num_bits), dtype=np.uint8)
    np.put_along_axis(bits[:, :half], random_subsets(hamming_left), 1, axis=1)
    np.put_along_axis(bits[:, half:], random_subsets(hamming_right), 1, axis=1)
    return _count_rows(bits)


def normalize_counts_dict(counts: Mapping[str, float | int]) -> Mapping[str, float]:
    """Convert a counts dictionary into a probability dictionary (reference ``counts.py:176-183``)."""
    if not counts:
        return counts
    total_counts = sum(counts.values())
    return {bs: count / total_counts for bs, count in counts.items()}


def bitstring_matrix_to_integers(bitstring_matrix: np.ndarray) -> np.ndarray:
    """Convert a bitstring matrix to an array of integers.

    Matches the reference dtype policy (``counts.py:186-201``): plain ``int``
    results below 64 bits, Python unbounded integers (``object`` dtype) at
    >= 64 bits.  Internally vectorized through the packed-word representation.
    """
    bitstring_matrix = np.asarray(bitstring_matrix, dtype=bool)
    _, n_bits = bitstring_matrix.shape
    packed = bitpack.pack_bool_matrix(bitstring_matrix)
    return bitpack.unpack_to_ints(packed, nbits=n_bits)
