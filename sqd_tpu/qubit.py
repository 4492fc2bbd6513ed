# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Qubit-path SQD: Pauli-operator projection and subspace eigensolve.

Device re-implementation of reference ``qiskit_addon_sqd/qubit.py``.  The
public surface is identical (``solve_qubit``, ``project_operator_to_subspace``,
``matrix_elements_from_pauli``, ``sort_and_remove_duplicates``) with two
deliberate upgrades:

* no 63-qubit ceiling — bitstrings are packed uint32 words
  (the reference raises ``ValueError`` above 63 bits, ``qubit.py:62``);
* a matrix-free device path: :func:`solve_qubit_device` diagonalizes the
  projected operator with the jitted Davidson over per-term permutation
  tables, never materializing a sparse matrix (SURVEY.md N5 north star).
  ``solve_qubit`` itself keeps the reference's contract (explicit sparse
  matrix + ``scipy.sparse.linalg.eigsh`` with passthrough kwargs) so scipy
  options keep working verbatim.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix, spmatrix
from scipy.sparse.linalg import eigsh

import jax.numpy as jnp

from .ops import bitpack
from .ops.davidson import davidson_initial_guess
from .ops.pauli_proj import (
    ProjectedPauliOperator,
    build_projected_operator,
    connected_table,
    pauli_apply_flat,
    pauli_masks_to_packed,
)

__all__ = [
    "solve_qubit",
    "solve_qubit_device",
    "project_operator_to_subspace",
    "build_projected_operator",
    "sort_and_remove_duplicates",
    "matrix_elements_from_pauli",
]


def sort_and_remove_duplicates(bitstring_matrix: np.ndarray) -> np.ndarray:
    """Sort rows ascending by unsigned-integer value and drop duplicates.

    Mirrors reference ``qubit.py:147-164`` via the packed-word sort.
    """
    packed = bitpack.pack_bool_matrix(bitstring_matrix)
    uniq = bitpack.unique_packed(packed)
    return bitpack.unpack_to_bool_matrix(uniq, bitstring_matrix.shape[1])


def matrix_elements_from_pauli(
    bitstring_matrix: np.ndarray, pauli
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse matrix elements of one Pauli term in the subspace.

    Same contract as reference ``qubit.py:167-240``: for the (sorted, unique)
    rows of ``bitstring_matrix``, returns ``(amplitudes, rows, cols)`` such
    that ``A[rows[k], cols[k]] = amplitudes[k]``.  Unlike the reference there
    is no 63-qubit limit, and the input may be given directly in the
    framework's packed-word form — a ``(d, W)`` uint32 array of sorted unique
    rows — which skips materializing the ``d x nq`` bool matrix entirely
    (at the reference benchmark's d = 5e7, 40 qubits, that bool matrix is
    2 GB; the packed form is 400 MB).  For a fully device-resident per-term
    table (no host transfer at all) use
    :func:`sqd_tpu.ops.pauli_proj.pauli_term_table`.

    Args:
        bitstring_matrix: 2D bool array, rows sorted ascending by unsigned
            integer value and unique (see :func:`sort_and_remove_duplicates`),
            OR the equivalent packed uint32 word matrix.
        pauli: a :class:`sqd_tpu.primitives.Pauli` (or any object with boolean
            ``z``/``x`` arrays in qubit order, e.g. a Qiskit ``Pauli``).
    """
    is_packed = bitstring_matrix.dtype == np.uint32
    if is_packed:
        packed_h = np.asarray(bitstring_matrix)
        w = packed_h.shape[1]
    else:
        packed_h = None  # packing a d x nq bool matrix costs a multi-GB pass
        w = bitpack.num_words(bitstring_matrix.shape[1])
    zw, xw = pauli_masks_to_packed(np.asarray(pauli.z), np.asarray(pauli.x))
    d = len(bitstring_matrix)
    n_y = int(np.sum(np.asarray(pauli.z) & np.asarray(pauli.x)))
    phase = 1j**n_y

    from . import native

    def _sign(packed) -> np.ndarray:
        masked = packed & zw[None, :w]
        zcount = native.popcount_rows(masked)  # C++ popcount (NumPy fallback)
        return (1 - 2 * (zcount & 1)).astype(np.int8)

    if not np.asarray(xw[:w]).any():
        # DIAGONAL term (no X/Y component): every string connects to itself
        # — membership search is algebraically pointless (the reference runs
        # its full sorted isin even here; this is the benchmark's Z^40 case).
        if is_packed:
            res = native.pauli_diag_elements(packed_h, zw, phase)
        else:
            # bool column c is global bit nq-1-c: the per-column z mask is
            # the qubit-order mask reversed (bitpack.pack_bool_matrix layout)
            zsel = np.asarray(pauli.z, dtype=bool)[::-1].astype(np.uint8)
            res = native.pauli_diag_elements(bitstring_matrix, zsel, phase)
        if res is not None:
            return res
        if packed_h is None:
            packed_h = bitpack.pack_bool_matrix(bitstring_matrix)
        sign = _sign(packed_h)
        amplitudes = phase * sign.astype(np.complex128)
        rows = np.arange(d, dtype=np.int64)
        return amplitudes, rows, rows.copy()
    if packed_h is None:
        packed_h = bitpack.pack_bool_matrix(bitstring_matrix)

    # host radix-merge wins at small/medium d (no device sync); the device
    # involution-pairing kernel wins at large d (the host here may be few-core)
    col = native.connected_membership(packed_h, xw) if d <= 2_000_000 else None
    if col is not None:
        # host path: radix-merge membership (cache-friendly; the reference's
        # CPU np.isin(kind="sort") analog but ~4x faster) + native popcount
        keep = col >= 0
        sign = _sign(packed_h)
    else:
        from .ops.pauli_proj import connected_table_pair

        table_fn = connected_table_pair if d >= 1_000_000 else connected_table
        packed = jnp.asarray(packed_h)
        col_d, sign_d = table_fn(packed, jnp.asarray(zw), jnp.asarray(xw))
        col = np.asarray(col_d).astype(np.int64)
        sign = np.asarray(sign_d)
        keep = col < d
    rows = np.flatnonzero(keep)
    cols = col[rows].astype(np.int64)
    amplitudes = phase * sign[rows].astype(np.complex128)
    return amplitudes, rows, cols


def project_operator_to_subspace(
    bitstring_matrix: np.ndarray,
    hamiltonian,
    *,
    verbose: bool = False,
) -> spmatrix:
    """Project a Pauli sum onto the subspace as a ``scipy.sparse.coo_matrix``.

    API-parity with reference ``qubit.py:78-144`` (rows = input configuration,
    cols = connected configuration).  The per-term connected-element work runs
    on device; only the final COO assembly is on host.  For a fully
    matrix-free projected operator use
    :func:`sqd_tpu.ops.pauli_proj.build_projected_operator` instead.
    """
    d, _ = bitstring_matrix.shape
    operator = coo_matrix((d, d), dtype="complex128")
    for i, pauli in enumerate(hamiltonian.paulis):
        coefficient = complex(hamiltonian.coeffs[i])
        if verbose:  # pragma: no cover
            print(
                f"Projecting term {i + 1} out of {hamiltonian.size}: "
                f"{coefficient} * {pauli.to_label()} ..."
            )
        amplitudes, rows, cols = matrix_elements_from_pauli(bitstring_matrix, pauli)
        operator += coefficient * coo_matrix((amplitudes, (rows, cols)), (d, d))
    return operator


def solve_qubit(
    bitstring_matrix: np.ndarray,
    hamiltonian,
    *,
    verbose: bool = False,
    **scipy_kwargs,
) -> tuple[np.ndarray, np.ndarray]:
    """Eigenvalues/eigenvectors of the Hamiltonian projected into the subspace.

    Contract-parity with reference ``qubit.py:29-75``: the matrix is sorted /
    deduplicated here, projected (on device), and handed to
    ``scipy.sparse.linalg.eigsh`` with ``scipy_kwargs`` passed through.  For a
    single lowest eigenpair fully on device, use :func:`solve_qubit_device`.
    """
    bitstring_matrix = sort_and_remove_duplicates(bitstring_matrix)
    ham_proj = project_operator_to_subspace(bitstring_matrix, hamiltonian, verbose=verbose)
    if verbose:  # pragma: no cover
        print("Diagonalizing Hamiltonian in the subspace...")
    energies, eigenstates = eigsh(ham_proj, **scipy_kwargs)
    return energies, eigenstates


def solve_qubit_device(
    bitstring_matrix: np.ndarray,
    hamiltonian,
    *,
    k: int = 1,
    tol: float = 1e-8,
    max_subspace: int = 32,
    max_iterations: int = 300,
    dtype=None,
    coarse_dtype=jnp.float32,
):
    """Lowest eigenpair(s) of the projected operator, fully on device.

    Mixed precision mirrors the fermionic solver: a fast f32 Davidson runs to
    its noise floor, then the f64 Davidson polishes warm-started from that
    vector down to ``tol``.  Pass ``coarse_dtype=None`` (or ``dtype``) to force a
    single-precision-level solve.

    With ``k == 1`` (default) returns ``(energy, eigenvector, operator)``.
    With ``k > 1`` returns ``(energies, eigenvectors, operator)`` with
    ``energies`` ascending and ``eigenvectors`` of shape ``(d, k)`` (column
    convention matching ``scipy.sparse.linalg.eigsh`` / reference
    ``qubit.py:73``), computed by the on-device block Davidson
    (:func:`sqd_tpu.ops.davidson.davidson_lowest_k`).

    Like :func:`matrix_elements_from_pauli`, the subspace may be given as a
    ``(d, W)`` uint32 packed-word matrix instead of a bool matrix — at the
    reference benchmark's d = 5e7 / 40 qubits the bool form alone is 2 GB of
    host memory the packed form never materializes.  Memory: the operator is
    built with ``weights="auto"`` (bit-packed group weights + scan matvec at
    large d); plan device memory with
    :func:`sqd_tpu.ops.pauli_proj.estimate_operator_bytes` plus
    ``2 * max_subspace`` Davidson vectors of ``embedded_dim``.
    """
    if np.asarray(bitstring_matrix).dtype == np.uint32:
        packed = bitpack.unique_packed(np.asarray(bitstring_matrix))
    else:
        bitstring_matrix = sort_and_remove_duplicates(bitstring_matrix)
        packed = bitpack.pack_bool_matrix(bitstring_matrix)
    op = build_projected_operator(packed, hamiltonian.paulis, hamiltonian.coeffs)
    if k > 1:
        return _solve_qubit_device_k(
            op, k=k, tol=tol, max_subspace=max_subspace,
            max_iterations=max_iterations,
        )
    # Everything runs in REAL arithmetic: complex operators act on the
    # stacked real embedding [v_re; v_im] (see ProjectedPauliOperator), so
    # one real Davidson serves both cases.  ``dtype`` is accepted for
    # backward compatibility; complex requests map to the embedding.
    work_dtype = jnp.float64
    if dtype is not None and not jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating):
        work_dtype = jnp.dtype(dtype)
        coarse_dtype = None
    hd = op.hdiag
    if op.is_complex:
        hd = jnp.concatenate([hd, hd])  # embedded diagonal (Im(diag) = 0)
    hd = hd.astype(work_dtype)
    v0 = davidson_initial_guess(hd, work_dtype)
    # segmented Davidson: bounded device programs with host-visible progress
    # between segments (see davidson_ground_state_segmented); identical fixed
    # point at small d.
    from .ops.davidson import davidson_ground_state_segmented

    d_emb = int(hd.shape[0])
    run_coarse = coarse_dtype is not None and jnp.dtype(coarse_dtype) != work_dtype
    if run_coarse:
        cdt = jnp.float32 if coarse_dtype is None else jnp.dtype(coarse_dtype)
        scale = float(jnp.max(jnp.abs(hd))) if hd.size else 1.0
        eps = float(jnp.finfo(cdt).eps)
        coarse = davidson_ground_state_segmented(
            pauli_apply_flat,
            op,
            hd.astype(cdt),
            v0.astype(cdt),
            tol=max(tol, 32 * eps * max(1.0, scale)),
            max_subspace=max_subspace,
            max_iterations=max_iterations,
        )
        v0 = coarse.vector.astype(work_dtype)
    # bound the per-program work at large d: f64 matvecs cost several
    # times their f32 cost, so a 25-iteration segment is shortened there
    seg = max(2, min(25, int(30_000_000 // max(d_emb, 1))))
    res = davidson_ground_state_segmented(
        pauli_apply_flat,
        op,
        hd,
        v0,
        tol=tol,
        max_subspace=max_subspace,
        max_iterations=max_iterations,
        segment_iterations=seg,
    )
    vec = np.asarray(res.vector)
    if op.is_complex:
        d = op.dim
        vec = vec[:d] + 1j * vec[d:]
        nrm = np.linalg.norm(vec)
        if nrm > 0:
            vec = vec / nrm
    return float(res.theta), vec, op


def _solve_qubit_device_k(
    op: ProjectedPauliOperator, *, k: int, tol: float, max_subspace: int,
    max_iterations: int,
):
    """k lowest eigenpairs via the on-device block Davidson.

    For a complex operator the solve runs on the real embedding
    ``[[A, -B], [B, A]]`` where every eigenvalue of ``H = A + iB`` appears
    TWICE (eigenvectors ``[x; y]`` and ``[-y; x]`` both map to the same
    complex vector up to phase): we extract ``2k`` embedded pairs, map them
    back to complex vectors, orthonormalize, and run one small complex
    Rayleigh-Ritz to recover the k distinct pairs.
    """
    from .ops.davidson import davidson_initial_guess_k, davidson_lowest_k

    hd = op.hdiag
    if op.is_complex:
        hd = jnp.concatenate([hd, hd])
    hd = hd.astype(jnp.float64)
    k_embed = 2 * k if op.is_complex else k
    v0 = davidson_initial_guess_k(hd, k_embed, jnp.float64)
    res = davidson_lowest_k(
        pauli_apply_flat, op, hd, v0,
        k=k_embed, tol=tol,
        max_subspace=max(max_subspace, 2 * k_embed + 4),
        max_iterations=max_iterations,
    )
    vecs = np.asarray(res.vectors)
    if not op.is_complex:
        return np.asarray(res.thetas), vecs.T.copy(), op
    # complex recovery: unembed, orthonormalize, small Rayleigh-Ritz
    d = op.dim
    cvecs = vecs[:, :d] + 1j * vecs[:, d:]
    q, _ = np.linalg.qr(cvecs.T)  # (d, <=2k) orthonormal columns
    q = q[:, :k_embed]

    def h_complex(col):
        emb = jnp.concatenate(
            [jnp.asarray(col.real), jnp.asarray(col.imag)]
        ).astype(jnp.float64)
        out = np.asarray(pauli_apply_flat(op, emb))
        return out[:d] + 1j * out[d:]

    hq = np.stack([h_complex(q[:, i]) for i in range(q.shape[1])], axis=1)
    t = q.conj().T @ hq
    t = 0.5 * (t + t.conj().T)
    w, y = np.linalg.eigh(t)
    return w[:k], (q @ y[:, :k]), op
