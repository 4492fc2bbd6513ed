# (C) 2026. Licensed under the Apache License, Version 2.0.
"""One large solve with the DETERMINANT (alpha-row) axis sharded over the mesh.

:mod:`sqd_tpu.parallel.sharded_solve` splits the ``norb^2`` excitation-pair
axis but replicates the amplitude grid and every Krylov buffer — the dimension
ceiling stays one device's memory.  Here the ``(M, N)`` amplitude matrix itself is
sharded along M: each device owns ``M/ndev`` alpha rows of the amplitudes,
the Krylov basis/image buffers (the dominant memory: ``max_subspace x M x N``),
the per-row gather tables, and the diagonal.  The Davidson driver completes
every inner product / norm / Gram entry with a ``lax.psum`` over the mesh axis
(:func:`sqd_tpu.ops.davidson.davidson_ground_state` ``axis_name``), and the
matvec's only communication is ONE ``all_gather`` of the current direction
(``M*N`` elements) per application, riding ICI:

* cross-spin ``sum_rs E^b_rs [eri @ E^a c]``: alpha gathers read arbitrary
  GLOBAL rows (excitations connect strings on other devices) — they index the
  all-gathered ``c``; the pair contraction and beta column gathers are then
  purely row-local.
* same-spin alpha neighbor lists also index global rows (all-gathered ``c``);
  same-spin beta is column-local.
* the fused spin penalty's mixed term rides the local pair gathers.

SURVEY.md §7 step 7 (2-D sharding of the amplitude grid); the reference's
scale-out story is swapping in an MPI program
(``docs/guides/integrate_dice_solver.ipynb``).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import bitpack, rdm as rdm_ops
from ..ops.davidson import davidson_ground_state, davidson_initial_guess
from ..ops.hamiltonian import build_sci_hamiltonian, expectation_value
from .distributed import host_local, replicate_to_host
from .mesh import default_mesh

__all__ = ["solve_sci_rowsharded", "solve_sci_batch_rowsharded"]

_AXIS = "row"


def _rowsharded_matvec(op, x):
    """H applied to the local alpha-row shard of the flat direction vector.

    Gather orientation follows
    ``ops.hamiltonian.__matvec_blocked_beta_first_rowmajor``: XLA gathers
    pay per slice — a ``take_along_axis`` over the last axis issues 4-BYTE
    slices, so every beta pick here runs against the TRANSPOSED intermediate
    (slices of ``m_loc * 4`` bytes instead).
    """
    m_loc, n = op["hdiag"].shape
    dt = x.dtype
    c_loc = x.reshape(m_loc, n)
    # the one collective: assemble the full current direction (M, N)
    c_full = jax.lax.all_gather(c_loc, _AXIS, axis=0, tiled=True)
    npair = op["eri_t"].shape[0]
    with jax.default_matmul_precision("highest"):
        # cross-spin for the local alpha rows (global row gathers)
        d = op["sign_a"].astype(dt)[:, :, None] * c_full[op["src_a"]]
        g = jnp.matmul(
            op["eri_t"].astype(dt), d.reshape(npair, -1), preferred_element_type=dt
        ).reshape(npair, m_loc, n)
        g_t = jnp.transpose(g, (0, 2, 1)).reshape(npair * n, m_loc)
        rows = op["src_b"].astype(jnp.int32) + (
            jnp.arange(npair, dtype=jnp.int32)[:, None] * n
        )
        picked_t = jnp.take(g_t, rows.reshape(-1), axis=0).reshape(npair, n, m_loc)
        sigma = jnp.einsum("pj,pji->ij", op["sign_b"].astype(dt), picked_t)
        # same-spin alpha: local output rows, neighbor rows are global
        sigma = sigma + jnp.einsum(
            "jl,jln->jn", op["nbr_val_a"].astype(dt), c_full[op["nbr_idx_a"]]
        )
        # same-spin beta: neighbor columns as rows of the transposed local c
        ct_loc = c_loc.T  # (n, m_loc)
        sigma = sigma + jnp.einsum(
            "kl,klm->mk", op["nbr_val_b"].astype(dt), ct_loc[op["nbr_idx_b"]]
        )
        if "src_b_qp" in op:
            d_t = jnp.transpose(d, (0, 2, 1)).reshape(npair * n, m_loc)
            rows_qp = op["src_b_qp"].astype(jnp.int32) + (
                jnp.arange(npair, dtype=jnp.int32)[:, None] * n
            )
            picked_m = jnp.take(d_t, rows_qp.reshape(-1), axis=0).reshape(
                npair, n, m_loc
            )
            mixed = jnp.einsum("pj,pji->ij", op["sign_b_qp"].astype(dt), picked_m)
            shift = op["spin_shift"].astype(dt)
            const = op["spin_const"].astype(dt)  # sz(sz+1) + n_b - spin_target
            sigma = sigma + shift * (const * c_loc - mixed)
    return sigma.reshape(-1)


def _sharded_initial_guess(hdiag_loc, axis_name):
    """Mesh-aware variant of :func:`davidson_initial_guess`.

    The local shard may consist ENTIRELY of padding rows (huge diagonal), so
    both the reference point (global min) and the normalization must complete
    over the mesh axis — the local formula would produce inf - inf = NaN.
    """
    finite = jnp.where(jnp.abs(hdiag_loc) > 1e20, jnp.inf, hdiag_loc)
    local_min = jnp.min(finite)
    lo = jax.lax.pmin(local_min, axis_name)
    spread = 1.0 / (finite - lo + 1.0)  # padding rows -> 1/inf = 0
    nrm = jnp.sqrt(jax.lax.psum(jnp.sum(spread * spread), axis_name))
    v0 = spread / nrm * 0.2
    spiked = v0.at[jnp.argmin(finite)].add(1.0)
    return jnp.where(local_min == lo, spiked, v0)


def _solve_inside(op, tol, max_subspace, max_cycle):
    hdiag = op["hdiag"].reshape(-1)
    v0 = _sharded_initial_guess(hdiag, _AXIS).astype(hdiag.dtype)
    res = davidson_ground_state(
        _rowsharded_matvec,
        op,
        hdiag,
        v0,
        tol=tol,
        max_subspace=max_subspace,
        max_iterations=max_cycle,
        axis_name=_AXIS,
    )
    return res.vector, res.iterations, res.converged, res.residual_norm


def _refine_inside(op, v0, tol, max_subspace, max_cycle):
    """Warm-started f64 polish of the coarse solution (same sharding)."""
    hdiag = op["hdiag"].reshape(-1)
    res = davidson_ground_state(
        _rowsharded_matvec,
        op,
        hdiag,
        v0.astype(hdiag.dtype),
        tol=tol,
        max_subspace=max_subspace,
        max_iterations=max_cycle,
        axis_name=_AXIS,
    )
    return res.vector


def solve_sci_rowsharded(
    ci_strings,
    one_body_tensor,
    two_body_tensor,
    norb: int,
    nelec,
    *,
    spin_sq=None,
    shift: float = 0.1,
    mesh=None,
    solver_dtype=jnp.float32,
    tol: float = 1e-5,
    max_subspace: int = 24,
    max_cycle: int = 200,
    refine_iterations: int | None = None,
    with_rdms: bool = False,
):
    """Diagonalize ONE subspace with the alpha-determinant axis sharded.

    Same contract as :func:`sqd_tpu.fermion.solve_sci` (including the fused
    ``shift * (S^2 - spin_sq)`` penalty steering, the bare-H final energy,
    and — for f32 solves — a warm-started f64 Davidson polish before RDMs /
    occupancies, so the ``sci_solver`` seam cannot converge-by-noise on
    ``occupancies_tol``).  Intended for subspaces whose Krylov workspace
    exceeds one chip.
    """
    import math

    from ..fermion import SCIResult, SCIState, _check_ci_strs

    if mesh is None:
        mesh = default_mesh(_AXIS)
    elif _AXIS not in mesh.axis_names:
        from jax.sharding import Mesh

        mesh = Mesh(mesh.devices.reshape(-1), (_AXIS,))
    ndev = mesh.devices.size
    if refine_iterations is None:
        refine_iterations = 0 if jnp.dtype(solver_dtype) == jnp.float64 else 6
    strs_a, strs_b = _check_ci_strs(ci_strings)
    pa = bitpack.pack_ints(np.asarray(strs_a, dtype=object if norb >= 63 else np.int64), norb)
    pb = bitpack.pack_ints(np.asarray(strs_b, dtype=object if norb >= 63 else np.int64), norb)
    m, n = len(strs_a), len(strs_b)
    # every device gets the same row count; lcm keeps the count divisible by
    # ndev even after build_sci_hamiltonian re-rounds large M to a multiple
    # of 8 for sublane alignment
    step = math.lcm(ndev, 8)
    m_pad = -(-m // step) * step

    with_spin = spin_sq is not None
    ham64 = build_sci_hamiltonian(
        pa, pb, one_body_tensor, two_body_tensor, norb, nelec,
        spin_shift=float(shift) if with_spin else 0.0,
        spin_target=float(spin_sq) if with_spin else 0.0,
        dtype=jnp.float64, pad_to=(m_pad, n), col_block=0,
    )
    m_pad, n_pad = ham64.shape
    npair = norb * norb

    specs = {
        "src_a": P(None, _AXIS),
        "sign_a": P(None, _AXIS),
        "src_b": P(),
        "sign_b": P(),
        "nbr_idx_a": P(_AXIS),
        "nbr_val_a": P(_AXIS),
        "nbr_idx_b": P(),
        "nbr_val_b": P(),
        "eri_t": P(),
        "hdiag": P(_AXIS),
        "src_b_qp": P(),
        "sign_b_qp": P(),
        "spin_shift": P(),
        "spin_const": P(),
    }

    def _make_op(dtype):
        op = {
            "src_a": ham64.src_a,  # (npair, M) -> row-sharded axis 1
            "sign_a": ham64.sign_a,
            "src_b": ham64.src_b,  # (npair, N) replicated
            "sign_b": ham64.sign_b,
            "nbr_idx_a": ham64.nbr_idx_a,  # (M, La) row-sharded axis 0
            "nbr_val_a": ham64.nbr_val_a.astype(dtype),
            "nbr_idx_b": ham64.nbr_idx_b,  # (N, Lb) replicated
            "nbr_val_b": ham64.nbr_val_b.astype(dtype),
            "eri_t": ham64.eri_t.astype(dtype),
            "hdiag": ham64.hdiag.astype(dtype),  # (M, N) row-sharded axis 0
        }
        if with_spin:
            p_idx, q_idx = np.divmod(np.arange(npair), norb)
            perm = q_idx * norb + p_idx
            n_a, n_b = (int(x) for x in nelec)
            sz = 0.5 * (n_a - n_b)
            op["src_b_qp"] = ham64.src_b[jnp.asarray(perm)]
            op["sign_b_qp"] = ham64.sign_b[jnp.asarray(perm)]
            op["spin_shift"] = jnp.asarray(float(shift), jnp.float64)
            op["spin_const"] = jnp.asarray(
                sz * sz + sz + n_b - float(spin_sq), jnp.float64
            )
        # multi-process: host round-trip before the global-mesh device_put
        return {
            k: jax.device_put(host_local(v), NamedSharding(mesh, specs[k]))
            for k, v in op.items()
        }

    op = _make_op(solver_dtype)
    op_specs = {k: specs[k] for k in op}
    # the flat direction vector is the row-sharded (M, N) grid flattened:
    # P(_AXIS) on the flat axis == row sharding because N divides the shard.
    solve = jax.jit(
        jax.shard_map(
            partial(
                _solve_inside, tol=tol, max_subspace=max_subspace, max_cycle=max_cycle
            ),
            mesh=mesh,
            in_specs=(op_specs,),
            out_specs=(P(_AXIS), P(), P(), P()),
            check_vma=False,
        )
    )
    vec, iters, converged, rnorm = solve(op)
    if refine_iterations > 0 and jnp.dtype(solver_dtype) != jnp.float64:
        # f64 polish: an f32-converged vector's occupancies carry ~1e-4 noise
        # at >=1e5 determinants — above the orchestrator's occupancies_tol
        # (same rationale as solve_sci's refine_iterations default)
        del op
        op64 = _make_op(jnp.float64)
        refine = jax.jit(
            jax.shard_map(
                partial(
                    _refine_inside,
                    tol=tol,
                    max_subspace=max_subspace,
                    max_cycle=refine_iterations,
                ),
                mesh=mesh,
                in_specs=(op_specs, P(_AXIS)),
                out_specs=P(_AXIS),
                check_vma=False,
            )
        )
        vec = refine(op64, vec)
    if jax.process_count() > 1:
        # multi-host: the row-sharded vector spans non-addressable devices —
        # replicate + localize so the epilogue (f64 energy, RDMs) runs
        # redundantly-but-identically per process on local arrays.  Single
        # process keeps the device-resident sharded vector (no round-trip).
        vec = jnp.asarray(replicate_to_host(vec, mesh))
    # bare-H energy on the full vector (chunk-accumulated; ham64 padding rows
    # are exactly zero in vec, so the padded evaluation is the true energy)
    bare64 = ham64
    if with_spin:
        import dataclasses

        bare64 = dataclasses.replace(ham64, spin_shift=0.0, spin_target=0.0)
    energy = float(expectation_value(bare64, jnp.asarray(vec)))

    amplitudes = np.asarray(vec).reshape(m_pad, n_pad)[:m, :n]
    nrm = np.linalg.norm(amplitudes)
    if nrm > 0:
        amplitudes = amplitudes / nrm
    state = SCIState(
        amplitudes=amplitudes,
        ci_strs_a=strs_a,
        ci_strs_b=strs_b,
        norb=norb,
        nelec=tuple(int(x) for x in nelec),
    )
    rdms = rdm_ops.make_rdms(
        ham64, jnp.asarray(vec, jnp.float64).reshape(m_pad, n_pad), pa, pb,
        with_dm2=with_rdms,
    )
    occ = (
        np.diagonal(np.asarray(rdms["dm1a"])).copy(),
        np.diagonal(np.asarray(rdms["dm1b"])).copy(),
    )
    rdm1 = rdm2 = None
    if with_rdms:
        rdm1 = np.asarray(rdms["dm1a"] + rdms["dm1b"])
        rdm2 = np.asarray(rdms["dm2"])
    return SCIResult(
        energy, state, orbital_occupancies=occ, rdm1=rdm1, rdm2=rdm2
    )


def solve_sci_batch_rowsharded(
    ci_strings,
    one_body_tensor,
    two_body_tensor,
    norb: int,
    nelec,
    **kwargs,
):
    """``sci_solver``-seam adapter: row-sharded solves, one batch at a time.

    For subspaces so large that a single solve needs the whole mesh, the
    batches cannot run concurrently across devices (that is
    :func:`~sqd_tpu.parallel.batch_solver.solve_sci_batch_sharded`'s regime);
    instead each batch solve uses EVERY device's memory.  Drop into
    ``diagonalize_fermionic_hamiltonian(..., sci_solver=...)`` directly.
    """
    return [
        solve_sci_rowsharded(
            cs, one_body_tensor, two_body_tensor, norb, nelec, **kwargs
        )
        for cs in ci_strings
    ]
