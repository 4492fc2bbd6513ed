# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Fermionic SQD: the SCI solver stack and the self-consistent orchestrator.

Device re-implementation of the reference L2/L3/L4 layers
(``qiskit_addon_sqd/fermion.py``).  Where the reference delegates every solve
to PySCF's C selected-CI kernels + Davidson (``fermion.py:513-515``), here the
projected Hamiltonian is applied by gather/matmul kernels
(:mod:`sqd_tpu.ops.hamiltonian`), diagonalized by a jitted Davidson
(:mod:`sqd_tpu.ops.davidson`), and RDMs/energies are contracted on device
(:mod:`sqd_tpu.ops.rdm`).  The orchestrator control flow — postselect on
iteration 0, recover on later iterations, subsample, include/carryover string
merging, max_dim truncation, convergence on (energy, occupancies), amplitude
carryover — mirrors ``fermion.py:149-425`` exactly, and ``sci_solver``
remains the pluggable parallelism seam (``fermion.py:161-165``).

Precision strategy (BASELINE target <1e-8 Ha): the Davidson iterations run in
a configurable ``solver_dtype`` (f32 by default above 200k determinants), and
the returned energy is always evaluated in f64 — equivalent to
the reference's energy-from-RDMs policy (``fermion.py:519-524``) and
second-order accurate in the Krylov residual.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, cast

import numpy as np

import jax
import jax.numpy as jnp

from .configuration_recovery import recover_configurations
from .counts import bit_array_to_arrays, bitstring_matrix_to_integers
from .ops import bitpack, rdm as rdm_ops
from .ops.davidson import davidson_ground_state, davidson_initial_guess
from .ops import hamiltonian as hamiltonian_ops
from .ops.hamiltonian import (
    SCIBasis,
    build_sci_basis,
    build_sci_hamiltonian,
    sci_matvec_flat,
)
from .subsampling import postselect_by_hamming_right_and_left, subsample

__all__ = [
    "SCIState",
    "SCIResult",
    "diagonalize_fermionic_hamiltonian",
    "solve_sci_batch",
    "solve_sci",
    "solve_fermion",
    "optimize_orbitals",
    "rotate_integrals",
    "bitstring_matrix_to_ci_strs",
    "enlarge_batch_from_transitions",
]


# ---------------------------------------------------------------------------
# state / result containers (API parity: fermion.py:44-146)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SCIState:
    """The amplitudes and determinants describing a quantum state.

    Mirrors reference ``fermion.py:44-126`` including ``.npz`` save/load
    interoperability.
    """

    amplitudes: np.ndarray
    """``M x N`` amplitude matrix over (``ci_strs_a`` x ``ci_strs_b``)."""

    ci_strs_a: np.ndarray
    """The alpha determinants (integer CI strings, ascending)."""

    ci_strs_b: np.ndarray
    """The beta determinants."""

    norb: int
    """The number of spatial orbitals."""

    nelec: tuple[int, int]
    """The numbers of alpha and beta electrons."""

    def __post_init__(self):
        object.__setattr__(self, "amplitudes", np.asarray(self.amplitudes))
        if self.amplitudes.shape != (len(self.ci_strs_a), len(self.ci_strs_b)):
            raise ValueError(
                f"'amplitudes' shape must be ({len(self.ci_strs_a)}, {len(self.ci_strs_b)}) "
                f"but got {self.amplitudes.shape}"
            )

    def save(self, filename):
        """Save the SCIState object to an .npz file.

        The layout is reference-compatible for < 63 orbitals (int64 CI-string
        arrays).  Above that the reference would store Python-object arrays
        (unloadable without pickling); we store the packed uint32 words
        instead under ``ci_strs_*_packed``.
        """
        if np.asarray(self.ci_strs_a).dtype == object or np.asarray(self.ci_strs_b).dtype == object:
            np.savez(
                filename,
                amplitudes=self.amplitudes,
                ci_strs_a_packed=bitpack.pack_ints(np.asarray(self.ci_strs_a), self.norb),
                ci_strs_b_packed=bitpack.pack_ints(np.asarray(self.ci_strs_b), self.norb),
                norb=self.norb,
                nelec=self.nelec,
            )
        else:
            np.savez(
                filename,
                amplitudes=self.amplitudes,
                ci_strs_a=self.ci_strs_a,
                ci_strs_b=self.ci_strs_b,
                norb=self.norb,
                nelec=self.nelec,
            )

    @classmethod
    def load(cls, filename):
        """Load an SCIState object from an .npz file (either layout)."""
        with np.load(filename) as data:
            norb = int(data["norb"])
            if "ci_strs_a_packed" in data:
                strs_a = bitpack.unpack_to_ints(data["ci_strs_a_packed"], norb)
                strs_b = bitpack.unpack_to_ints(data["ci_strs_b_packed"], norb)
            else:
                strs_a = data["ci_strs_a"]
                strs_b = data["ci_strs_b"]
            return cls(
                data["amplitudes"],
                strs_a,
                strs_b,
                norb=norb,
                nelec=tuple(data["nelec"]),
            )

    def _basis(self) -> SCIBasis:
        """Gather-table-only basis view (no integrals) for RDM/spin queries.

        Cached on the (frozen) instance: repeated ``rdm()`` / ``spin_square()``
        / ``orbital_occupancies()`` calls reuse one table build.
        """
        cached = getattr(self, "_basis_cache", None)
        if cached is None:
            norb = int(self.norb)
            pa = bitpack.pack_ints(np.asarray(self.ci_strs_a), norb)
            pb = bitpack.pack_ints(np.asarray(self.ci_strs_b), norb)
            cached = build_sci_basis(pa, pb, norb, self.nelec)
            object.__setattr__(self, "_basis_cache", cached)
        return cached

    def rdm(self, rank: int = 1, spin_summed: bool = False) -> np.ndarray:
        """Compute the rank-1 or rank-2 reduced density matrix."""
        basis = self._basis()
        c = jnp.asarray(self.amplitudes, jnp.float64)
        norb = int(self.norb)
        if rank == 1:
            dm1a, dm1b = rdm_ops.rdm1s(basis, c)
            if spin_summed:
                return np.asarray(dm1a + dm1b)
            return np.stack([np.asarray(dm1a), np.asarray(dm1b)])
        if rank == 2:
            pa = bitpack.pack_ints(np.asarray(self.ci_strs_a), norb)
            pb = bitpack.pack_ints(np.asarray(self.ci_strs_b), norb)
            if spin_summed:
                return np.asarray(rdm_ops.rdm2_spin_summed(basis, c, pa, pb))
            return tuple(np.asarray(x) for x in rdm_ops.rdm2s(basis, c, pa, pb))
        raise NotImplementedError(
            f"Computing the rank {rank} reduced density matrix is currently not supported."
        )

    def spin_square(self) -> float:
        """Expectation value of total spin squared."""
        basis = self._basis()
        return float(basis.spin_square(jnp.asarray(self.amplitudes, jnp.float64)))

    def orbital_occupancies(self) -> tuple[np.ndarray, np.ndarray]:
        """Average orbital occupancies (diagonals of the spin-resolved 1-RDMs)."""
        dm = self.rdm(rank=1, spin_summed=False)
        return np.diagonal(dm[0]).copy(), np.diagonal(dm[1]).copy()


@dataclass(frozen=True)
class SCIResult:
    """Result of an SCI calculation (reference ``fermion.py:129-146``)."""

    energy: float
    """The SCI energy."""

    sci_state: SCIState
    """The SCI state."""

    orbital_occupancies: tuple[np.ndarray, np.ndarray]
    """The average orbital occupancies."""

    rdm1: np.ndarray | None = None
    """Spin-summed 1-particle reduced density matrix."""

    rdm2: np.ndarray | None = None
    """Spin-summed 2-particle reduced density matrix."""


# ---------------------------------------------------------------------------
# string utilities
# ---------------------------------------------------------------------------


def _strings_to_packed(strs, norb: int) -> np.ndarray:
    arr = np.asarray(strs, dtype=object if norb >= 63 else np.int64)
    return bitpack.pack_ints(arr, norb)


def _hamming_of_first(strs) -> int:
    return bin(int(strs[0])).count("1")


def bitstring_matrix_to_ci_strs(
    bitstring_matrix: np.ndarray, open_shell: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Split bitstring rows into (spin-up, spin-down) integer determinants.

    Mirrors reference ``fermion.py:794-825``: the left half of each row is the
    spin-down (beta) configuration, the right half spin-up (alpha); with
    ``open_shell=False`` both halves are merged into one shared sorted set so
    the subspace is spin-exchange symmetric
    (cf. ``docs/guides/select_open_closed_shell.ipynb``).
    """
    norb = bitstring_matrix.shape[1] // 2
    strs_left = np.unique(bitstring_matrix_to_integers(bitstring_matrix[:, :norb]))
    strs_right = np.unique(bitstring_matrix_to_integers(bitstring_matrix[:, norb:]))
    if not open_shell:
        strs_left = strs_right = np.union1d(strs_left, strs_right)
    return strs_right, strs_left


def _popcounts(strs: np.ndarray) -> np.ndarray:
    """Vectorized per-string popcount (native kernel for machine ints)."""
    if strs.dtype == object or (strs.size and int(strs.min()) < 0):
        # object dtype (>= 64 orbitals: unbounded Python ints) or malformed
        # negative input — pack_ints would reinterpret negatives as
        # two's-complement (-1 -> 64 bits); count magnitude bits instead so
        # the hamming-weight mismatch error reports the same weights the
        # reference's bin(int(s)).count("1") would.
        return np.fromiter(
            (abs(int(s)).bit_count() for s in strs), dtype=np.int64, count=len(strs)
        )
    from . import native
    from .ops import bitpack

    return native.popcount_rows(bitpack.pack_ints(strs, 64))


def _check_ci_strs(ci_strs) -> tuple[np.ndarray, np.ndarray]:
    """Validate uniform Hamming weight per spin; return sorted unique arrays.

    Matches the validation of reference ``fermion.py:865-887`` (same error
    text, first offending index reported) without its per-string Python loop.
    """
    out = []
    for label, strs in zip(("up", "down"), ci_strs):
        strs = np.asarray(strs)
        counts = _popcounts(strs)
        ham0 = int(counts[0])
        bad = np.nonzero(counts != ham0)[0]
        if bad.size:
            i = int(bad[0])
            raise ValueError(
                f"Spin-{label} CI string in index 0 has hamming weight {ham0}, but CI "
                f"string in index {i} has hamming weight {int(counts[i])}."
            )
        out.append(np.sort(np.unique(strs)))
    return out[0], out[1]


def _unique_with_order_preserved(vals: np.ndarray) -> np.ndarray:
    """Unique values keeping first-occurrence order (reference ``fermion.py:428-432``)."""
    _, indices = np.unique(vals, return_index=True)
    indices.sort()
    return vals[indices]


# ---------------------------------------------------------------------------
# fixed-subspace solves (replaces pyscf kernel_fixed_space; SURVEY.md N1/N2)
# ---------------------------------------------------------------------------


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def solve_sci(
    ci_strings: tuple[np.ndarray, np.ndarray],
    one_body_tensor: np.ndarray,
    two_body_tensor: np.ndarray,
    norb: int,
    nelec: tuple[int, int],
    *,
    spin_sq: float | None = None,
    shift: float = 0.1,
    solver_dtype=None,
    tol: float = 1e-6,
    max_subspace: int = 24,
    max_cycle: int = 200,
    pad_bucket: int = 32,
    refine_iterations: int | None = None,
    table_cache=None,
    with_rdms: bool = True,
    matvec_strategy: str = "gather",
    eri_factor: np.ndarray | str | None = "auto",
    **kwargs,
) -> SCIResult:
    """Diagonalize the Hamiltonian in the subspace spanned by the CI strings.

    API-parity entry point for reference ``fermion.py:476-534``; the solver
    internals replace PySCF's ``kernel_fixed_space``.

    Args:
        ci_strings: pair (strings_a, strings_b) of integer CI-string arrays
            whose Cartesian product spans the subspace.
        one_body_tensor / two_body_tensor: Hamiltonian integrals (chemist).
        norb: number of spatial orbitals.
        nelec: (n_alpha, n_beta).
        spin_sq: optional target S^2 — imposed as the penalty
            ``H + shift * (S^2 - spin_sq)`` (PySCF ``fix_spin_`` analog); the
            returned energy is always recomputed from RDMs, mirroring the
            reference's policy (``fermion.py:509-524``).
        shift: penalty strength.
        solver_dtype: dtype of the Davidson iterations.  ``None`` picks f64
            below 200k determinants and f32 (+ f64 RDM energy) above.
        tol: Davidson residual tolerance (scaled by the hdiag magnitude).
        max_subspace / max_cycle: Krylov buffer rows / matvec budget.
        pad_bucket: if > 0, round each spin dimension up to this multiple so
            XLA reuses compiled programs across iterations.
        refine_iterations: extra f64 Davidson iterations warm-started from the
            working-dtype solution — drives the residual (and hence the
            second-order energy error) below the f32 floor when the solve ran
            in f32; irrelevant when ``solver_dtype`` is already f64.
            ``None`` (default) resolves to 6 for f32 solves and 0 for f64:
            an f32-converged vector's occupancies carry noise above the
            orchestrator's default ``occupancies_tol = 1e-5`` at >=1e5
            determinants (first-order in the residual), so the default must
            not allow false convergence; pass 0 explicitly to opt out.
        with_rdms: attach the spin-summed 2-RDM to the result (default, the
            reference contract).  The same-spin 2-RDM Grams run over
            ``n_strings * C(n_elec, 2)`` two-hole intermediates, which
            dominates everything else at high filling (e.g. 27 electrons in
            36 orbitals: ~350 intermediates per string); energy and
            occupancies never need it — pass ``False`` to skip (``rdm2`` is
            then ``None``; ``rdm1`` and occupancies are always computed).
        matvec_strategy: ``"gather"`` (default) iterates with the gather-table
            matvec; ``"dense_df"`` iterates with the zero-gather dense
            density-fitted operator (:mod:`sqd_tpu.ops.dense_df`) — the
            matmul-only form for large active spaces (npair > 256, PSD
            integrals, no spin penalty).  Final energies/RDMs always come
            from the exact f64 operator either way.  Note f64 refinement
            also runs through the exact (gather) operator — at very large
            norb each refine iteration costs a dense-ERI f64 matvec, so
            consider ``refine_iterations=0`` there and rely on the exact
            f64 energy evaluation (first-order-accurate in the residual).
        eri_factor: forwarded to :func:`build_sci_hamiltonian` — ``"auto"``
            (default) attaches a pivoted-Cholesky factor when npair > 256
            and the integrals are PSD; an explicit ``(X, norb^2)`` array
            forces a factor at any size (enables ``"dense_df"`` below the
            auto threshold); ``None`` disables factoring.
        **kwargs: ignored extras for signature compatibility.

    Returns:
        An :class:`SCIResult` with f64 energy, state, occupancies and RDMs.
    """
    strs_a, strs_b = _check_ci_strs(ci_strings)
    norb = int(one_body_tensor.shape[0])
    pa = _strings_to_packed(strs_a, norb)
    pb = _strings_to_packed(strs_b, norb)
    m, n = len(strs_a), len(strs_b)
    dim = m * n
    if solver_dtype is None:
        solver_dtype = jnp.float64 if dim <= 200_000 else jnp.float32
    if refine_iterations is None:
        refine_iterations = 0 if jnp.dtype(solver_dtype) == jnp.float64 else 6

    pad_to = None
    if pad_bucket:
        pad_to = (_round_up(m, pad_bucket), _round_up(n, pad_bucket))

    ham64 = build_sci_hamiltonian(
        pa,
        pb,
        one_body_tensor,
        two_body_tensor,
        norb,
        nelec,
        spin_shift=0.0 if spin_sq is None else float(shift),
        spin_target=0.0 if spin_sq is None else float(spin_sq),
        dtype=jnp.float64,
        pad_to=pad_to,
        table_cache=table_cache,
        eri_factor=eri_factor,
    )
    ham = ham64.astype(solver_dtype)
    mp, np_ = ham.shape
    hd_flat = ham.hdiag.reshape(-1)
    v0 = davidson_initial_guess(hd_flat, solver_dtype)
    # scale the residual tolerance to the spectrum and dtype
    scale = float(jnp.max(jnp.abs(jnp.where(jnp.abs(hd_flat) > 1e20, 0.0, hd_flat))))
    eps = float(jnp.finfo(solver_dtype).eps)
    tol_eff = max(tol, 32 * eps * max(1.0, scale))
    if matvec_strategy == "dense_df":
        if spin_sq is not None:
            raise ValueError(
                "matvec_strategy='dense_df' does not support the fused spin "
                "penalty (non-PSD mixed term); use spin_sq=None"
            )
        if ham64.eri_chol is None:
            raise ValueError(
                "matvec_strategy='dense_df' requires a PSD ERI factor — "
                "needs npair > 256 and symmetric PSD two_body_tensor "
                "(see build_sci_hamiltonian(eri_factor=...))"
            )
        from .ops.davidson import davidson_ground_state_segmented
        from .ops.dense_df import dense_df_matvec_flat, densify

        dense_op = densify(ham64, dtype=solver_dtype)
        # segmented: dense_df targets shapes whose matvec costs seconds,
        # so the solve runs as bounded device programs
        # (see davidson_ground_state_segmented)
        result = davidson_ground_state_segmented(
            dense_df_matvec_flat,
            dense_op,
            hd_flat,
            v0,
            tol=tol_eff,
            max_subspace=max_subspace,
            max_iterations=max_cycle,
        )
    elif matvec_strategy == "gather":
        result = davidson_ground_state(
            sci_matvec_flat,
            ham,
            hd_flat,
            v0,
            tol=tol_eff,
            max_subspace=max_subspace,
            max_iterations=max_cycle,
        )
    else:
        raise ValueError(f"unknown matvec_strategy {matvec_strategy!r}")
    vec_flat = result.vector.astype(jnp.float64)
    if refine_iterations > 0 and solver_dtype != jnp.float64:
        result64 = davidson_ground_state(
            sci_matvec_flat,
            ham64,
            ham64.hdiag.reshape(-1),
            vec_flat,
            tol=tol,
            max_subspace=max_subspace,
            max_iterations=refine_iterations,
        )
        vec_flat = result64.vector
    vec_pad = vec_flat.reshape(mp, np_)
    vec_pad = vec_pad / jnp.linalg.norm(vec_pad)

    # f64 RDMs -> occupancies (reference policy, fermion.py:517-524).
    # Padded rows/columns are exactly zero, so the padded gather tables give
    # the same RDMs as an unpadded rebuild would.
    rdms = rdm_ops.make_rdms(ham64, vec_pad, pa if with_rdms else None,
                             pb if with_rdms else None, with_dm2=with_rdms)
    dm1 = np.asarray(rdms["dm1a"] + rdms["dm1b"])
    dm2 = np.asarray(rdms["dm2"]) if with_rdms else None
    occupancies = (
        np.diagonal(np.asarray(rdms["dm1a"])).copy(),
        np.diagonal(np.asarray(rdms["dm1b"])).copy(),
    )
    # Bare-H energy as the f64 Rayleigh quotient of the exact operator; it
    # agrees with energy_from_rdms to machine precision (covered by tests)
    # and is also available when the 2-RDM is skipped (with_rdms=False).
    energy = float(
        hamiltonian_ops.expectation_value(
            ham64, vec_pad.reshape(-1), spin_penalty=False
        )
    )

    sci_state = SCIState(
        amplitudes=np.asarray(vec_pad[:m, :n]),
        ci_strs_a=strs_a,
        ci_strs_b=strs_b,
        norb=norb,
        nelec=tuple(int(x) for x in nelec),
    )
    return SCIResult(energy, sci_state, orbital_occupancies=occupancies, rdm1=dm1, rdm2=dm2)


def solve_sci_excited(
    ci_strings: tuple[np.ndarray, np.ndarray],
    one_body_tensor: np.ndarray,
    two_body_tensor: np.ndarray,
    norb: int,
    nelec: tuple[int, int],
    *,
    k: int,
    spin_sq: float | None = None,
    shift: float = 0.1,
    solver_dtype=jnp.float64,
    tol: float = 1e-7,
    max_subspace: int = 32,
    max_cycle: int = 400,
    pad_bucket: int = 32,
) -> list[SCIResult]:
    """The k lowest eigenstates of the projected Hamiltonian (block Davidson).

    Excited-state counterpart of :func:`solve_sci` — what the reference can
    only reach through the qubit path's ``eigsh(..., k=...)`` kwargs
    (``/root/reference/qiskit_addon_sqd/qubit.py:73``); here the fermionic
    stack gets it natively via
    :func:`sqd_tpu.ops.davidson.davidson_lowest_k`.  Returns ``k``
    :class:`SCIResult`\\ s in ascending energy order, each with its own bare-H
    f64 energy, occupancies and RDMs.
    """
    from .ops.davidson import davidson_initial_guess_k, davidson_lowest_k

    strs_a, strs_b = _check_ci_strs(ci_strings)
    norb = int(one_body_tensor.shape[0])
    pa = _strings_to_packed(strs_a, norb)
    pb = _strings_to_packed(strs_b, norb)
    m, n = len(strs_a), len(strs_b)
    pad_to = None
    if pad_bucket:
        pad_to = (_round_up(m, pad_bucket), _round_up(n, pad_bucket))
    ham64 = build_sci_hamiltonian(
        pa, pb, one_body_tensor, two_body_tensor, norb, nelec,
        spin_shift=0.0 if spin_sq is None else float(shift),
        spin_target=0.0 if spin_sq is None else float(spin_sq),
        dtype=jnp.float64, pad_to=pad_to,
    )
    ham = ham64.astype(solver_dtype)
    mp, np_ = ham.shape
    hd_flat = ham.hdiag.reshape(-1)
    scale = float(jnp.max(jnp.abs(jnp.where(jnp.abs(hd_flat) > 1e20, 0.0, hd_flat))))
    eps = float(jnp.finfo(solver_dtype).eps)
    tol_eff = max(tol, 32 * eps * max(1.0, scale))
    v0 = davidson_initial_guess_k(hd_flat, k, solver_dtype)
    res = davidson_lowest_k(
        sci_matvec_flat, ham, hd_flat, v0,
        k=k, tol=tol_eff, max_subspace=max(max_subspace, 2 * k + 6),
        max_iterations=max_cycle,
    )
    out: list[SCIResult] = []
    for i in range(k):
        vec_pad = res.vectors[i].astype(jnp.float64).reshape(mp, np_)
        vec_pad = vec_pad / jnp.linalg.norm(vec_pad)
        rdms = rdm_ops.make_rdms(ham64, vec_pad, pa, pb)
        dm1 = np.asarray(rdms["dm1a"] + rdms["dm1b"])
        dm2 = np.asarray(rdms["dm2"])
        occupancies = (
            np.diagonal(np.asarray(rdms["dm1a"])).copy(),
            np.diagonal(np.asarray(rdms["dm1b"])).copy(),
        )
        energy = float(
            hamiltonian_ops.expectation_value(
                ham64, vec_pad.reshape(-1), spin_penalty=False
            )
        )
        state = SCIState(
            amplitudes=np.asarray(vec_pad[:m, :n]),
            ci_strs_a=strs_a,
            ci_strs_b=strs_b,
            norb=norb,
            nelec=tuple(int(x) for x in nelec),
        )
        out.append(
            SCIResult(energy, state, orbital_occupancies=occupancies, rdm1=dm1, rdm2=dm2)
        )
    return out


def solve_sci_batch(
    ci_strings: list[tuple[np.ndarray, np.ndarray]],
    one_body_tensor: np.ndarray,
    two_body_tensor: np.ndarray,
    norb: int,
    nelec: tuple[int, int],
    *,
    spin_sq: float | None = None,
    **kwargs,
) -> list[SCIResult]:
    """Diagonalize the Hamiltonian in a list of subspaces (reference ``fermion.py:435-473``).

    This default implementation runs sequentially on the local device; for
    mesh-sharded batch execution see
    :func:`sqd_tpu.parallel.batch_solver.solve_sci_batch_sharded`, which is a
    drop-in replacement through the ``sci_solver`` seam.
    """
    return [
        solve_sci(
            ci_strs,
            one_body_tensor,
            two_body_tensor,
            norb=norb,
            nelec=nelec,
            spin_sq=spin_sq,
            **kwargs,
        )
        for ci_strs in ci_strings
    ]


def solve_fermion(
    bitstring_matrix: tuple[np.ndarray, np.ndarray] | np.ndarray,
    /,
    hcore: np.ndarray,
    eri: np.ndarray,
    *,
    open_shell: bool = False,
    spin_sq: float | None = None,
    shift: float = 0.1,
    **kwargs,
) -> tuple[float, SCIState, tuple[np.ndarray, np.ndarray], float]:
    """Approximate the ground state in the subspace defined by sampled configurations.

    API-parity entry point for reference ``fermion.py:537-637``.

    Args:
        bitstring_matrix: either a 2D bool bitstring matrix (rows
            ``[b_N..b_0, a_N..a_0]``) or a pair of integer CI-string arrays.
        hcore: one-electron integrals.
        eri: two-electron integrals (chemist convention).
        open_shell: keep the two halves' configurations separate if True;
            otherwise use their union for both spins.
        spin_sq: optional target S^2 (penalty method).
        shift: penalty level shift.
        **kwargs: solver options forwarded to :func:`solve_sci`.

    Returns:
        (energy, SCIState, (occ_a, occ_b), spin_squared)
    """
    if isinstance(bitstring_matrix, tuple):
        ci_strs = bitstring_matrix
    else:
        ci_strs = bitstring_matrix_to_ci_strs(bitstring_matrix, open_shell=open_shell)
    ci_strs = _check_ci_strs(ci_strs)
    num_up = _hamming_of_first(ci_strs[0])
    num_dn = _hamming_of_first(ci_strs[1])
    norb = hcore.shape[0]

    result = solve_sci(
        ci_strs,
        hcore,
        eri,
        norb=norb,
        nelec=(num_up, num_dn),
        spin_sq=spin_sq,
        shift=shift,
        **kwargs,
    )
    spin_squared = result.sci_state.spin_square()
    return result.energy, result.sci_state, result.orbital_occupancies, spin_squared


# ---------------------------------------------------------------------------
# the SQD orchestrator (reference fermion.py:149-425)
# ---------------------------------------------------------------------------


def diagonalize_fermionic_hamiltonian(
    one_body_tensor: np.ndarray,
    two_body_tensor: np.ndarray,
    bit_array,
    samples_per_batch: int,
    norb: int,
    nelec: tuple[int, int],
    *,
    num_batches: int = 1,
    energy_tol: float = 1e-8,
    occupancies_tol: float = 1e-5,
    max_iterations: int = 100,
    sci_solver: Callable[..., list[SCIResult]] | None = None,
    symmetrize_spin: bool = False,
    max_dim: int | tuple[int, int] | None = None,
    include_configurations=None,
    initial_occupancies: tuple[np.ndarray, np.ndarray] | None = None,
    carryover_threshold: float = 1e-4,
    callback: Callable[[list[SCIResult]], None] | None = None,
    seed: int | np.random.Generator | None = None,
    solver_options: dict | None = None,
    checkpoint_path=None,
    resume: bool = True,
) -> SCIResult:
    """Run sample-based quantum diagonalization (SQD) to convergence.

    Control flow mirrors the reference main entry point
    (``fermion.py:149-425``): each configuration-recovery iteration
    postselects (iteration 0) or statistically repairs (later iterations) the
    raw samples, subsamples ``num_batches`` batches, assembles per-batch CI
    strings (requested configurations first, then carryover, then samples in
    descending marginal-count order; order-preserving dedup; ``max_dim``
    truncation; ascending sort), diagonalizes every batch through
    ``sci_solver``, takes the best (lowest-energy) batch, and stops when both
    the energy and the occupancies have converged.  CI strings whose
    amplitude exceeds ``carryover_threshold`` are carried into the next
    iteration's subspace.

    Args:
        one_body_tensor / two_body_tensor: Hamiltonian integrals.
        bit_array: sampled bitstrings (a :class:`sqd_tpu.primitives.BitArray`
            or Qiskit ``BitArray``), layout ``[b_N..b_0, a_N..a_0]``.
        samples_per_batch: bitstrings per subsampled batch.
        norb: number of spatial orbitals.
        nelec: (n_alpha, n_beta).
        num_batches: batches per recovery iteration.
        energy_tol / occupancies_tol: joint convergence thresholds.
        max_iterations: recovery-iteration limit.
        sci_solver: pluggable batch solver (the parallelism seam); defaults to
            :func:`solve_sci_batch` on the local device.
        symmetrize_spin: merge alpha/beta string sets each iteration
            (requires ``n_alpha == n_beta``).
        max_dim: per-spin subspace dimension cap (int or (a, b) pair).
        include_configurations: configurations always included, either one
            list for both spins or an (alpha, beta) pair.
        initial_occupancies: optional initial occupancy guess (skips the
            iteration-0 postselection path).
        carryover_threshold: amplitude threshold for string carryover.
        callback: called with the full batch-result list each iteration.
        seed: PRNG seed or generator.
        solver_options: extra kwargs passed to the default solver (ignored if
            ``sci_solver`` is provided).
        checkpoint_path: if given, the full loop state (iteration counter,
            RNG state, occupancies, carryover strings, best result) is saved
            there after every iteration (see :mod:`sqd_tpu.utils.checkpoint`).
        resume: when ``checkpoint_path`` exists and ``resume`` is true, the
            loop continues bit-for-bit from the saved state.

    Returns:
        The best (lowest-energy) :class:`SCIResult` seen.

    Raises:
        ValueError: invalid iteration count / spin-symmetrization setup, or
            no valid bitstrings and no ``initial_occupancies``.
    """
    if max_iterations < 1:
        raise ValueError("Maximum number of iterations must be at least 1.")

    n_alpha, n_beta = nelec
    if symmetrize_spin and n_alpha != n_beta:
        raise ValueError(
            "Spin symmetrization is only possible if the numbers of alpha and beta "
            f"electrons are equal. Instead, got {n_alpha} and {n_beta}."
        )

    if max_dim is None:
        max_dim_a = max_dim_b = None
    elif isinstance(max_dim, tuple):
        max_dim_a, max_dim_b = max_dim
    else:
        max_dim_a = max_dim_b = max_dim
    if symmetrize_spin and max_dim_a != max_dim_b:
        raise ValueError(
            "When requesting spin symmetrization, the maximum dimension must be "
            "the same for both spin alpha and spin beta. "
            f"Instead, got {max_dim_a} and {max_dim_b}"
        )

    if include_configurations is None:
        include_a = np.array([], dtype=np.int64)
        include_b = np.array([], dtype=np.int64)
    elif isinstance(include_configurations, tuple):
        include_a, include_b = include_configurations
    else:
        include_a = include_b = include_configurations
    include_a = np.unique(np.asarray(include_a))
    include_b = np.unique(np.asarray(include_b))

    rng = np.random.default_rng(seed)
    current_occupancies = initial_occupancies
    best_result: SCIResult | None = None
    current_energy: float | None = None
    if sci_solver is None:
        opts = dict(solver_options or {})
        if "table_cache" not in opts:
            # reuse the set-independent per-string table halves across
            # iterations (string sets overlap heavily through carryover)
            from .ops.table_cache import TableCache

            opts["table_cache"] = TableCache()
        sci_solver = lambda cs, h1, h2, no, ne: solve_sci_batch(  # noqa: E731
            cs, h1, h2, no, ne, **opts
        )

    str_dtype = object if norb >= 63 else np.int64
    carryover_strings_a = np.array([], dtype=str_dtype)
    carryover_strings_b = np.array([], dtype=str_dtype)
    start_iteration = 0

    if checkpoint_path is not None and resume:
        import os

        from .utils.checkpoint import load_loop_state

        if os.path.exists(checkpoint_path):
            ckpt = load_loop_state(checkpoint_path)
            start_iteration = ckpt.iteration + 1
            rng.bit_generator.state = ckpt.rng_state
            current_occupancies = ckpt.current_occupancies
            carryover_strings_a = ckpt.carryover_strings_a
            carryover_strings_b = ckpt.carryover_strings_b
            current_energy = ckpt.current_energy
            blob = ckpt.best_state_blob
            state = SCIState(
                amplitudes=blob["amplitudes"],
                ci_strs_a=bitpack.unpack_to_ints(blob["strs_a_packed"], norb),
                ci_strs_b=bitpack.unpack_to_ints(blob["strs_b_packed"], norb),
                norb=norb,
                nelec=tuple(int(x) for x in nelec),
            )
            # Reattach the RDMs an uninterrupted run would carry on its best
            # result (downstream consumers like orbital optimization rely on
            # them); one-time cost at resume.
            best_result = SCIResult(
                ckpt.best_energy,
                state,
                orbital_occupancies=ckpt.best_occupancies,
                rdm1=state.rdm(rank=1, spin_summed=True),
                rdm2=state.rdm(rank=2, spin_summed=True),
            )

    raw_bitstrings, raw_probs = bit_array_to_arrays(bit_array)

    for iteration in range(start_iteration, max_iterations):
        if current_occupancies is None:
            bitstrings, probs = postselect_by_hamming_right_and_left(
                raw_bitstrings, raw_probs, hamming_right=n_alpha, hamming_left=n_beta
            )
            if not bitstrings.size:
                raise ValueError(
                    "The input bit array did not contain any valid bitstrings. "
                    "Either pass a bit array that contains at least one valid bitstring "
                    "(with the correct right and left Hamming weights), or specify a "
                    "value for initial_occupancies."
                )
        else:
            bitstrings, probs = recover_configurations(
                raw_bitstrings, raw_probs, current_occupancies, n_alpha, n_beta, rand_seed=rng
            )

        subsamples = subsample(
            bitstrings,
            probs,
            samples_per_batch=samples_per_batch,
            num_batches=num_batches,
            rand_seed=rng,
        )

        ci_strings = []
        for samples in subsamples:
            samples_a, counts_a = np.unique(
                bitstring_matrix_to_integers(samples[:, norb:]), return_counts=True
            )
            samples_b, counts_b = np.unique(
                bitstring_matrix_to_integers(samples[:, :norb]), return_counts=True
            )
            if symmetrize_spin:
                merged = np.concatenate((samples_a, samples_b))
                counts = np.concatenate((counts_a, counts_b))
                merged = merged[np.argsort(counts)[::-1]]
                strs = np.concatenate((include_a, include_b, carryover_strings_a, merged))
                strs_a = strs_b = _unique_with_order_preserved(strs)[:max_dim_a]
            else:
                samples_a = samples_a[np.argsort(counts_a)[::-1]]
                samples_b = samples_b[np.argsort(counts_b)[::-1]]
                strs_a = np.concatenate((include_a, carryover_strings_a, samples_a))
                strs_b = np.concatenate((include_b, carryover_strings_b, samples_b))
                strs_a = _unique_with_order_preserved(strs_a)[:max_dim_a]
                strs_b = _unique_with_order_preserved(strs_b)[:max_dim_b]
            strs_a = np.sort(strs_a)
            strs_b = np.sort(strs_b)
            ci_strings.append((strs_a, strs_b))

        results = sci_solver(ci_strings, one_body_tensor, two_body_tensor, norb, nelec)

        if callback is not None:
            callback(results)

        best_result_in_batch = min(results, key=lambda result: result.energy)
        if best_result is None or best_result_in_batch.energy < best_result.energy:
            best_result = best_result_in_batch

        if (
            current_energy is not None
            and abs(current_energy - best_result_in_batch.energy) < energy_tol
            and np.linalg.norm(
                np.ravel(current_occupancies)
                - np.ravel(best_result_in_batch.orbital_occupancies),
                ord=np.inf,
            )
            < occupancies_tol
        ):
            break
        current_result = best_result_in_batch
        current_energy = current_result.energy
        current_occupancies = current_result.orbital_occupancies

        # carry over CI strings attached to large-amplitude configurations
        sci_state = current_result.sci_state
        flattened = sci_state.amplitudes.reshape(-1)
        absolute_vals = np.abs(flattened)
        order = np.argsort(absolute_vals)
        cut = np.searchsorted(absolute_vals, carryover_threshold, sorter=order)
        kept = order[cut:]
        _, n_strings_b = sci_state.amplitudes.shape
        alpha_indices, beta_indices = np.divmod(kept, n_strings_b)
        alpha_indices = np.unique(alpha_indices)
        beta_indices = np.unique(beta_indices)
        carryover_strings_a = sci_state.ci_strs_a[alpha_indices]
        carryover_strings_b = sci_state.ci_strs_b[beta_indices]
        weights_a = np.sum(np.abs(sci_state.amplitudes[alpha_indices]) ** 2, axis=1)
        weights_b = np.sum(np.abs(sci_state.amplitudes[:, beta_indices]) ** 2, axis=0)
        if symmetrize_spin:
            merged = np.concatenate((carryover_strings_a, carryover_strings_b))
            weights = np.concatenate((weights_a, weights_b))
            merged = merged[np.argsort(weights)[::-1]]
            merged = _unique_with_order_preserved(merged)
            carryover_strings_a = carryover_strings_b = merged
        else:
            carryover_strings_a = carryover_strings_a[np.argsort(weights_a)[::-1]]
            carryover_strings_b = carryover_strings_b[np.argsort(weights_b)[::-1]]

        if checkpoint_path is not None:
            from .utils.checkpoint import LoopCheckpoint, save_loop_state

            best_state = best_result.sci_state
            blob = {
                "amplitudes": np.asarray(best_state.amplitudes),
                "strs_a_packed": bitpack.pack_ints(
                    np.asarray(best_state.ci_strs_a), norb
                ),
                "strs_b_packed": bitpack.pack_ints(
                    np.asarray(best_state.ci_strs_b), norb
                ),
            }
            save_loop_state(
                checkpoint_path,
                LoopCheckpoint(
                    iteration=iteration,
                    rng_state=rng.bit_generator.state,
                    current_occupancies=current_occupancies,
                    carryover_strings_a=carryover_strings_a,
                    carryover_strings_b=carryover_strings_b,
                    best_energy=best_result.energy,
                    best_state_blob=blob,
                    best_occupancies=best_result.orbital_occupancies,
                    current_energy=current_energy,
                    norb=norb,
                ),
            )

    return cast(SCIResult, best_result)


# ---------------------------------------------------------------------------
# orbital optimization + excitation augmentation (reference fermion.py:640-977)
# ---------------------------------------------------------------------------


def _antisymmetric_matrix_from_upper_tri(k_flat, k_dim: int):
    """Anti-symmetric matrix from its flattened strict upper triangle."""
    rows, cols = jnp.triu_indices(k_dim, k=1)
    k = jnp.zeros((k_dim, k_dim), dtype=k_flat.dtype)
    k = k.at[rows, cols].set(k_flat)
    return k - k.T


def rotate_integrals(
    hcore: np.ndarray, eri: np.ndarray, k_flat: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Similarity-transform the integrals by ``U = expm(K(k_flat))``.

    Mirrors reference ``fermion.py:754-791`` but runs the matrix exponential
    and the 4-index rotation on device (``jax.scipy.linalg.expm`` + einsum,
    SURVEY.md N6).  ``eri`` is expected in the same index convention the
    caller uses downstream (the transform is basis-covariant).
    """
    norb = hcore.shape[0]
    num_params = (norb**2 - norb) // 2
    if len(k_flat) != num_params:
        raise ValueError(
            f"k_flat must specify the upper triangle of the transform matrix. "
            f"k_flat length is {len(k_flat)}. Expected {num_params}."
        )
    h_rot, eri_rot = _rotate_integrals_jit(
        jnp.asarray(hcore, jnp.float64),
        jnp.asarray(eri, jnp.float64),
        jnp.asarray(k_flat, jnp.float64),
    )
    return np.asarray(h_rot), np.asarray(eri_rot)


@jax.jit
def _rotate_integrals_jit(hcore, eri, k_flat):
    # precision-pinned: integral transforms at a reduced-precision default
    # (TF32 on the GPU) corrupt every downstream energy at the 1e-3 level
    with jax.default_matmul_precision("highest"):
        k = _antisymmetric_matrix_from_upper_tri(k_flat, hcore.shape[0])
        u = jax.scipy.linalg.expm(k)
        h_rot = u.T @ hcore @ u
        eri_rot = jnp.einsum("pqrs,pi,qj,rk,sl->ijkl", eri, u, u, u, u, optimize=True)
        return h_rot, eri_rot


def _rotated_energy(dm1, dm2, hcore, eri, k_flat):
    """Energy of fixed RDMs under rotated integrals (autodiff target).

    The reference differentiates the same contraction with JAX
    (``fermion.py:911-933``); here the whole SGD loop is fused on device.
    """
    with jax.default_matmul_precision("highest"):
        k = _antisymmetric_matrix_from_upper_tri(k_flat, hcore.shape[0])
        u = jax.scipy.linalg.expm(k)
        h_rot = u.T @ hcore @ u
        eri_rot = jnp.einsum("pqrs,pi,qj,rk,sl->ijkl", eri, u, u, u, u)
        return jnp.sum(dm1 * h_rot) + 0.5 * jnp.sum(dm2 * eri_rot)


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("num_steps",))
def _sgd_momentum_orbital_step(dm1, dm2, hcore, eri, k_flat, learning_rate, momentum, num_steps: int):
    """``num_steps`` of SGD-with-momentum on the rotation parameters, fused on device."""
    grad_fn = jax.grad(_rotated_energy, argnums=4)

    def body(_, carry):
        k, vel = carry
        g = grad_fn(dm1, dm2, hcore, eri, k)
        vel = learning_rate * g + momentum * vel
        return k - vel, vel

    k_final, _ = jax.lax.fori_loop(0, num_steps, body, (k_flat, jnp.zeros_like(k_flat)))
    return k_final


def optimize_orbitals(
    bitstring_matrix: tuple[np.ndarray, np.ndarray] | np.ndarray,
    /,
    hcore: np.ndarray,
    eri: np.ndarray,
    k_flat: np.ndarray,
    *,
    open_shell: bool = False,
    spin_sq: float = 0.0,
    num_iters: int = 10,
    num_steps_grad: int = 10_000,
    learning_rate: float = 0.01,
    momentum: float = 0.9,
    **kwargs,
) -> tuple[float, np.ndarray, tuple[np.ndarray, np.ndarray]]:
    """Optimize an orbital rotation to lower the SCI ground-state energy.

    Mirrors reference ``fermion.py:640-751``: alternate (1) rotate integrals
    by ``expm(K)``, (2) solve SCI in the fixed subspace, (3) descend the
    RDM-contracted rotated-energy surface with SGD+momentum — except the
    gradient loop is a single fused ``lax.fori_loop`` on device rather than
    ``num_steps_grad`` separate jit calls.

    Args:
        bitstring_matrix: bitstring matrix or (strings_a, strings_b) pair.
        hcore / eri: integrals (chemist convention).
        k_flat: flattened strict upper triangle of the antisymmetric generator.
        open_shell: see :func:`bitstring_matrix_to_ci_strs`.
        spin_sq: target S^2 enforced via penalty during the solves.
        num_iters: outer alternation count.
        num_steps_grad: SGD steps per outer iteration.
        learning_rate: SGD learning rate.
        momentum: SGD momentum (the reference hardcodes 0.9).
        **kwargs: solver options forwarded to :func:`solve_sci`.

    Returns:
        (energy from the last solve, optimized k_flat, (occ_a, occ_b)).
    """
    norb = hcore.shape[0]
    num_params = (norb**2 - norb) // 2
    if len(k_flat) != num_params:
        raise ValueError(
            f"k_flat must specify the upper triangle of the transform matrix. "
            f"k_flat length is {len(k_flat)}. Expected {num_params}."
        )
    if isinstance(bitstring_matrix, tuple):
        ci_strs = bitstring_matrix
    else:
        ci_strs = bitstring_matrix_to_ci_strs(bitstring_matrix, open_shell=open_shell)
    ci_strs = _check_ci_strs(ci_strs)
    num_up = _hamming_of_first(ci_strs[0])
    num_dn = _hamming_of_first(ci_strs[1])

    k_flat = jnp.asarray(k_flat, jnp.float64)
    hcore_d = jnp.asarray(hcore, jnp.float64)
    # physicist ordering for the rotation path, mirroring fermion.py:718-724
    eri_phys = jnp.asarray(np.transpose(np.asarray(eri), (0, 2, 3, 1)), jnp.float64)

    energy = 0.0
    avg_occupancy: tuple[np.ndarray, np.ndarray] = (np.zeros(norb), np.zeros(norb))
    for _ in range(num_iters):
        h_rot, eri_rot_phys = _rotate_integrals_jit(hcore_d, eri_phys, k_flat)
        eri_rot_chem = np.asarray(jnp.transpose(eri_rot_phys, (0, 3, 1, 2)))
        result = solve_sci(
            ci_strs,
            np.asarray(h_rot),
            eri_rot_chem,
            norb=norb,
            nelec=(num_up, num_dn),
            spin_sq=spin_sq,
            **kwargs,
        )
        energy = result.energy
        avg_occupancy = result.orbital_occupancies
        dm2_chem = result.rdm2
        dm2_phys = jnp.asarray(np.transpose(dm2_chem, (0, 2, 3, 1)), jnp.float64)
        k_flat = _sgd_momentum_orbital_step(
            jnp.asarray(result.rdm1, jnp.float64),
            dm2_phys,
            hcore_d,
            eri_phys,
            k_flat,
            learning_rate,
            momentum,
            num_steps_grad,
        )

    return energy, np.asarray(k_flat), avg_occupancy


# ---------------------------------------------------------------------------
# excitation augmentation (reference fermion.py:828-851, 936-977)
# ---------------------------------------------------------------------------


def _transition_str_to_bool(string_rep: np.ndarray):
    """Parse transition-operator strings into (diag, create, annihilate) masks.

    Characters per mode: identity ``I``, creation ``+``, annihilation ``-``,
    number ``n`` (reference ``fermion.py:955-977``).
    """
    string_rep = np.asarray(string_rep)
    diag = np.logical_or(string_rep == "I", string_rep == "n")
    create = np.logical_or(string_rep == "+", string_rep == "n")
    annihilate = np.logical_or(string_rep == "-", string_rep == "n")
    return diag, create, annihilate


@jax.jit
def apply_excitations(bitstring_matrix, diag, create, annihilate):
    """Apply each transition operator to each bitstring (vmap x vmap).

    Returns (augmented matrices, legality mask) of shapes
    ``(n_ops, n_samples, n_bits)`` / ``(n_ops, n_samples)``.
    """

    def one(bits, d, c, a):
        new_bits = bits == d
        create_ok = jnp.all(d | ~(bits & c))
        annihilate_ok = jnp.all(~(~bits & a))
        return new_bits, create_ok & annihilate_ok

    over_samples = jax.vmap(one, in_axes=(0, None, None, None))
    over_ops = jax.vmap(over_samples, in_axes=(None, 0, 0, 0))
    return over_ops(bitstring_matrix, diag, create, annihilate)


def enlarge_batch_from_transitions(
    bitstring_matrix: np.ndarray, transition_operators: np.ndarray
) -> np.ndarray:
    """Augment a configuration batch by applying transition operators.

    Mirrors reference ``fermion.py:828-851``: every operator is applied to
    every sample; illegal applications (creating on an occupied mode or
    annihilating an empty one) are dropped.
    """
    diag, create, annihilate = _transition_str_to_bool(transition_operators)
    if diag.ndim == 1:
        diag, create, annihilate = diag[None], create[None], annihilate[None]
    augmented, mask = apply_excitations(
        jnp.asarray(np.asarray(bitstring_matrix, dtype=bool)),
        jnp.asarray(diag),
        jnp.asarray(create),
        jnp.asarray(annihilate),
    )
    augmented = np.asarray(augmented)
    mask = np.asarray(mask)
    return augmented.reshape(-1, augmented.shape[-1])[mask.reshape(-1)]
