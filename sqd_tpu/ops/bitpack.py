# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Packed-word bitstring arrays — the device-side determinant representation.

The reference implementation (``qiskit_addon_sqd/counts.py:186-201``) represents
CI strings as ``int64`` scalars and silently switches to Python unbounded
integers (``object`` dtype) at >= 64 bits, and its JAX kernels are capped at 63
qubits (``qubit.py:62``).  Accelerators have no fast 64-bit integer path, so this
module instead packs every bitstring into ``ceil(nbits / 32)`` little-endian ``uint32``
words.  All device kernels (popcount, Hamming postselection, lexicographic
sort/unique, binary search) operate on the packed representation, which removes
the 63-bit cliff entirely.

Conventions
-----------
* A *bitstring matrix* (API surface, mirrors the reference) is a 2-D ``bool``
  array whose column 0 is the most-significant bit: row ``[b_{n-1}, ..., b_0]``.
* A *packed matrix* is ``(num_strings, num_words) uint32`` where word ``w``
  holds bits ``[32*w, 32*w + 32)`` — word 0 is least significant.  Bit ``j`` of
  the integer is the occupation of orbital ``j``.
* Integer (CI-string) form mirrors the reference: ``int64`` below 63 bits,
  Python unbounded integers (``object`` dtype) at >= 63 bits.
"""

from __future__ import annotations

import numpy as np

WORD_BITS = 32
_WORD_MASK = 0xFFFFFFFF


def num_words(nbits: int) -> int:
    """Number of 32-bit words required to hold ``nbits`` bits."""
    return max(1, -(-int(nbits) // WORD_BITS))


# ---------------------------------------------------------------------------
# bool matrix <-> packed words
# ---------------------------------------------------------------------------


def pack_bool_matrix(bool_mat: np.ndarray) -> np.ndarray:
    """Pack a bitstring matrix (column 0 = MSB) into ``(S, W) uint32`` words.

    Single contiguous ``np.packbits`` pass + a cheap per-row byte reversal.
    The naive formulation (reverse 2 GB of bool columns, zero-pad, pack
    little-order) cost 134 s at 5e7 x 40 on a single-core host; this one is
    memory-bound (~5 s): column c is global bit ``nbits-1-c``, so packing the
    ORIGINAL columns MSB-first yields the little-endian byte sequence of the
    words in reverse byte order.
    """
    bool_mat = np.asarray(bool_mat, dtype=bool)
    if bool_mat.ndim != 2:
        raise ValueError(f"Expected a 2D bool matrix. Got shape {bool_mat.shape}.")
    n_rows, nbits = bool_mat.shape
    w = num_words(nbits)
    pad_cols = w * WORD_BITS - nbits
    if pad_cols:
        padded = np.zeros((n_rows, w * WORD_BITS), dtype=bool)
        padded[:, pad_cols:] = bool_mat  # contiguous copy; left pad = high bits
        bool_mat = padded
    as_bytes = np.packbits(np.ascontiguousarray(bool_mat), axis=1, bitorder="big")
    rev = np.ascontiguousarray(as_bytes[:, ::-1])
    return rev.view("<u4").reshape(n_rows, w)


def unpack_to_bool_matrix(packed: np.ndarray, nbits: int) -> np.ndarray:
    """Inverse of :func:`pack_bool_matrix` (same byte-reversal formulation)."""
    packed = np.ascontiguousarray(np.asarray(packed, dtype=np.uint32))
    n_rows, w = packed.shape
    as_bytes = packed.astype("<u4", copy=False).view(np.uint8).reshape(n_rows, w * 4)
    rev = np.ascontiguousarray(as_bytes[:, ::-1])
    bits = np.unpackbits(rev, axis=1, bitorder="big")
    pad_cols = w * WORD_BITS - nbits
    out = bits[:, pad_cols:] if pad_cols else bits
    return out.astype(bool, copy=False)


# ---------------------------------------------------------------------------
# integer (CI-string) form <-> packed words
# ---------------------------------------------------------------------------


def pack_ints(ints: np.ndarray, nbits: int) -> np.ndarray:
    """Pack an array of (possibly unbounded Python) integers into uint32 words."""
    ints = np.asarray(ints)
    w = num_words(nbits)
    out = np.zeros((len(ints), w), dtype=np.uint32)
    if ints.dtype == object:
        for i, v in enumerate(ints):
            v = int(v)
            for j in range(w):
                out[i, j] = (v >> (WORD_BITS * j)) & _WORD_MASK
    else:
        vals = ints.astype(np.uint64)
        for j in range(w):
            out[:, j] = ((vals >> np.uint64(WORD_BITS * j)) & np.uint64(_WORD_MASK)).astype(
                np.uint32
            )
    return out


def unpack_to_ints(packed: np.ndarray, nbits: int | None = None) -> np.ndarray:
    """Packed words -> integer array (``int64`` below 63 bits, else ``object``).

    Mirrors the reference dtype policy at ``counts.py:190-195``.
    """
    packed = np.asarray(packed, dtype=np.uint32)
    n_rows, w = packed.shape
    if nbits is None:
        nbits = w * WORD_BITS
    if nbits < 64:  # up to 63 bits fits in int64 (mirrors counts.py:190-195)
        result = np.zeros(n_rows, dtype=np.int64)
        for j in range(w):
            result |= packed[:, j].astype(np.int64) << (WORD_BITS * j)
        return result
    result = np.zeros(n_rows, dtype=object)
    for j in range(w):
        result += np.array([int(v) << (WORD_BITS * j) for v in packed[:, j]], dtype=object)
    return result


def ints_to_packed(ints, nbits: int) -> np.ndarray:
    """Alias of :func:`pack_ints` accepting lists."""
    return pack_ints(np.asarray(ints, dtype=object if nbits >= 63 else np.int64), nbits)


# ---------------------------------------------------------------------------
# host-side packed-key algorithms (numpy)
# ---------------------------------------------------------------------------


def popcount(packed: np.ndarray) -> np.ndarray:
    """Per-row population count of a packed matrix."""
    packed = np.asarray(packed, dtype=np.uint32)
    return np.bitwise_count(packed).sum(axis=-1).astype(np.int64)


def _lex_order(packed: np.ndarray) -> np.ndarray:
    """Indices that sort rows ascending by integer value (LSW-first words)."""
    # np.lexsort treats the LAST key as primary; our most-significant word is
    # the last column, so pass columns in natural order.
    return np.lexsort(tuple(packed[:, j] for j in range(packed.shape[1])))


def sort_packed(packed: np.ndarray) -> np.ndarray:
    """Rows sorted ascending by integer value."""
    return packed[_lex_order(packed)]


def unique_packed(
    packed: np.ndarray, return_index: bool = False, return_counts: bool = False
):
    """Sorted unique rows of a packed matrix (+ optional first-occurrence index/counts)."""
    packed = np.asarray(packed, dtype=np.uint32)
    order = _lex_order(packed)
    s = packed[order]
    if len(s) == 0:
        keep = np.zeros(0, dtype=bool)
    else:
        keep = np.ones(len(s), dtype=bool)
        keep[1:] = np.any(s[1:] != s[:-1], axis=1)
    uniq = s[keep]
    results = [uniq]
    if return_index:
        # first occurrence in the *original* array order, matching np.unique
        starts = np.flatnonzero(keep)
        firsts = np.minimum.reduceat(order, starts) if len(s) else np.zeros(0, dtype=np.int64)
        results.append(firsts)
    if return_counts:
        starts = np.flatnonzero(keep)
        counts = np.diff(np.append(starts, len(s))) if len(s) else np.zeros(0, dtype=np.int64)
        results.append(counts)
    return results[0] if len(results) == 1 else tuple(results)


def searchsorted_packed(sorted_packed: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """``np.searchsorted`` over packed multi-word keys (left insertion point)."""
    sorted_packed = np.asarray(sorted_packed, dtype=np.uint32)
    queries = np.asarray(queries, dtype=np.uint32)
    # Big-endian byte view compares lexicographically == integer comparison
    # when the most-significant word comes first.
    w = sorted_packed.shape[1]
    keys = _void_view(sorted_packed[:, ::-1])
    q = _void_view(queries[:, ::-1])
    return np.searchsorted(keys.ravel(), q.ravel())


def find_packed(sorted_packed: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Index of each query row in ``sorted_packed`` or -1 if absent."""
    n = len(sorted_packed)
    pos = np.minimum(searchsorted_packed(sorted_packed, queries), max(n - 1, 0))
    if n == 0:
        return np.full(len(queries), -1, dtype=np.int64)
    hit = np.all(sorted_packed[pos] == queries, axis=1)
    return np.where(hit, pos, -1)


def _void_view(arr: np.ndarray) -> np.ndarray:
    """Rows as big-endian fixed-width byte blobs for lexicographic compare."""
    be = np.ascontiguousarray(arr.astype(">u4"))
    return be.view([("", f"V{be.shape[1] * 4}")]).ravel()


# ---------------------------------------------------------------------------
# device-side (JAX) packed-key kernels
# ---------------------------------------------------------------------------
# Imported lazily so this module stays importable without initializing JAX.


def jnp_popcount(words):
    """Population count of a uint32 array (SWAR, elementwise only)."""
    import jax.numpy as jnp

    x = words.astype(jnp.uint32)
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((x * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


def jnp_popcount_rows(packed):
    """Per-row popcount of a packed (..., W) uint32 array."""
    return jnp_popcount(packed).sum(axis=-1)


def jnp_lex_less(a, b):
    """Lexicographic a < b over trailing word axis (word 0 least significant)."""
    import jax.numpy as jnp

    w = a.shape[-1]
    lt = a[..., w - 1] < b[..., w - 1]
    eq = a[..., w - 1] == b[..., w - 1]
    for j in range(w - 2, -1, -1):
        lt = lt | (eq & (a[..., j] < b[..., j]))
        eq = eq & (a[..., j] == b[..., j])
    return lt


def jnp_lex_eq(a, b):
    import jax.numpy as jnp

    return jnp.all(a == b, axis=-1)


def jnp_sort_packed(packed, *payloads):
    """Sort rows of a packed matrix ascending; reorder payloads identically.

    Uses ``lax.sort`` with the words as multiple keys (most significant first),
    which maps onto the device's native multi-key sort.
    """
    import jax
    import jax.numpy as jnp

    w = packed.shape[1]
    keys = [packed[:, j] for j in range(w - 1, -1, -1)]
    operands = keys + list(payloads)
    out = jax.lax.sort(operands, num_keys=w)
    sorted_packed = jnp.stack([out[w - 1 - j] for j in range(w)], axis=1)
    return (sorted_packed, *out[w:]) if payloads else sorted_packed


def jnp_searchsorted_packed(sorted_packed, queries):
    """Vectorized branchless binary search over packed keys (left insertion)."""
    import jax
    import jax.numpy as jnp

    n = sorted_packed.shape[0]
    steps = max(1, int(np.ceil(np.log2(max(n, 1)))) + 1)

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) >> 1
        row = sorted_packed[mid]  # gather (Q, W)
        go_right = jnp_lex_less(row, queries)  # row < query -> search right
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
        return lo, hi

    q = queries.shape[0]
    lo = jnp.zeros((q,), dtype=jnp.int32)
    hi = jnp.full((q,), n, dtype=jnp.int32)
    lo, _ = jax.lax.fori_loop(0, steps, body, (lo, hi))
    return lo


def jnp_find_packed(sorted_packed, queries):
    """Index of each query in sorted rows, or -1 if absent (device)."""
    import jax.numpy as jnp

    n = sorted_packed.shape[0]
    pos = jnp.minimum(jnp_searchsorted_packed(sorted_packed, queries), max(n - 1, 0))
    hit = jnp_lex_eq(sorted_packed[pos], queries)
    return jnp.where(hit, pos, -1)


def prefix_masks(nbits: int) -> np.ndarray:
    """Static table ``prefix[k]`` = packed word mask of bits ``< k``.

    Used for excitation-sign (fermionic parity) computation:
    ``mask(lo, hi) = prefix[hi] ^ prefix[lo]`` selects bits in ``[lo, hi)``.
    """
    w = num_words(nbits)
    out = np.zeros((nbits + 1, w), dtype=np.uint32)
    for k in range(nbits + 1):
        full, rem = divmod(k, WORD_BITS)
        out[k, :full] = _WORD_MASK
        if rem:
            out[k, full] = (1 << rem) - 1
    return out


def bit_masks(nbits: int) -> np.ndarray:
    """Static table ``bit[p]`` = packed words with only bit ``p`` set."""
    w = num_words(nbits)
    out = np.zeros((nbits, w), dtype=np.uint32)
    for p in range(nbits):
        out[p, p // WORD_BITS] = np.uint32(1) << np.uint32(p % WORD_BITS)
    return out
