# (C) 2026. Licensed under the Apache License, Version 2.0.
"""One large solve with the (alpha x beta) amplitude grid sharded in 2-D.

:mod:`~sqd_tpu.parallel.row_sharded` shards the alpha axis but ``all_gather``s
the FULL ``(M, N)`` direction vector into every device per matvec — its
transient activation memory and ICI volume still scale with the total
dimension.  Here the mesh is 2-D (``row`` x ``col``): each device owns an
``(M/nr, N/nc)`` block of the amplitudes, the Krylov workspace (the dominant
memory) is ``1/ndev`` per device, and **no device ever holds the full
direction vector**.  Per matvec the communication is exactly three
collectives, none of them amplified by the ``norb^2`` excitation-pair axis:

* ``all_gather`` over ``row``  -> column panel ``(M, Nc)``   [alpha gathers
  read arbitrary global rows at local columns];
* ``all_gather`` over ``col``  -> row panel ``(Mr, N)``      [same-spin beta
  neighbor gathers read arbitrary global columns at local rows];
* one ``psum_scatter`` over ``col`` of an ``(Mr, N)`` partial — the
  cross-spin beta pick ``sigma[i,j] += sign_b[pq,j] * g[pq, i, src_b[pq,j]]``
  is computed by the device that OWNS column ``src_b[pq, j]`` of ``g`` (a
  clamped reverse table derived on-device from the replicated ``src_b``), and
  the contributions for each output column are then summed and scattered home.

This is SURVEY.md §7 step 7's end state (2-D sharding of the amplitude grid
with ICI collectives) — the [4Fe-4S]-scale 1e7-1e8-determinant enabler.  The
reference's only scale-out story is swapping its solver for an MPI program
(``docs/guides/integrate_dice_solver.ipynb``).

Memory accounting per device (f32, D = M*N total determinants):
Krylov ``2 * max_subspace * D/ndev``; amplitudes/diagonal ``D/ndev``; panels
``D/nr + D/nc`` transient; cross-spin intermediates ``2 * npair * D/ndev``
plus one ``(npair/norb, Mr, N)`` pair-block stream buffer.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import bitpack, rdm as rdm_ops
from ..ops.davidson import davidson_ground_state
from ..ops.hamiltonian import build_sci_hamiltonian, expectation_value
from .distributed import host_local, replicate_to_host
from .row_sharded import _sharded_initial_guess

__all__ = ["solve_sci_gridsharded", "default_grid_mesh"]

_AXES = ("row", "col")


def default_grid_mesh(devices=None) -> Mesh:
    """Near-square 2-D mesh over the available devices."""
    devices = np.asarray(jax.devices() if devices is None else devices)
    ndev = devices.size
    nr = 1
    for k in range(int(math.isqrt(ndev)), 0, -1):
        if ndev % k == 0:
            nr = k
            break
    return Mesh(devices.reshape(nr, ndev // nr), _AXES)


def _gridsharded_matvec(op, x):
    """H applied to the local (Mr, Nc) block of the direction vector."""
    mr, ncl = op["hdiag"].shape
    dt = x.dtype
    c_loc = x.reshape(mr, ncl)
    # two panel all-gathers: nothing here ever materializes the full (M, N)
    c_colpanel = jax.lax.all_gather(c_loc, "row", axis=0, tiled=True)  # (M, Nc)
    c_rowpanel = jax.lax.all_gather(c_loc, "col", axis=1, tiled=True)  # (Mr, N)
    npair = op["eri_t"].shape[0]
    n_total = c_rowpanel.shape[1]
    col0 = jax.lax.axis_index("col") * ncl
    with_spin = "src_b_qp" in op
    with jax.default_matmul_precision("highest"):
        # cross-spin, alpha-first: local (npair, Mr, Nc) intermediates
        d = op["sign_a"].astype(dt)[:, :, None] * c_colpanel[op["src_a"]]
        g = jnp.matmul(
            op["eri_t"].astype(dt), d.reshape(npair, -1), preferred_element_type=dt
        ).reshape(npair, mr, ncl)

        # clamped reverse tables: this device contributes the (pq, j) terms
        # whose source column lives in its local block of g / d
        loc = op["src_b"].astype(jnp.int32) - col0
        valid = (loc >= 0) & (loc < ncl)
        loc = jnp.where(valid, loc, 0)
        w_b = jnp.where(valid, op["sign_b"], 0).astype(dt)  # (npair, N)
        if with_spin:
            loc_qp = op["src_b_qp"].astype(jnp.int32) - col0
            valid_qp = (loc_qp >= 0) & (loc_qp < ncl)
            loc_qp = jnp.where(valid_qp, loc_qp, 0)
            w_bqp = jnp.where(valid_qp, op["sign_b_qp"], 0).astype(dt)

        # stream the (Mr, N) partials over pair blocks so the transient stays
        # (npb, Mr, N) instead of (npair, Mr, N).  Picks run against the
        # TRANSPOSED intermediates: XLA gathers pay per slice (see
        # ops.hamiltonian), so the slices must be (Mr * 4)-byte rows, never
        # 4-byte elements.
        nblk = max(1, int(round(math.sqrt(npair))))
        while npair % nblk:
            nblk -= 1
        npb = npair // nblk
        offs = jnp.arange(npb, dtype=jnp.int32)[:, None] * ncl

        def blk(i, acc):
            sl = (i * npb, 0, 0)
            g_blk = jax.lax.dynamic_slice(g, sl, (npb, mr, ncl))
            g_t = jnp.transpose(g_blk, (0, 2, 1)).reshape(npb * ncl, mr)
            w_blk = jax.lax.dynamic_slice(w_b, (i * npb, 0), (npb, n_total))
            l_blk = jax.lax.dynamic_slice(loc, (i * npb, 0), (npb, n_total))
            picked = jnp.take(g_t, (l_blk + offs).reshape(-1), axis=0).reshape(
                npb, n_total, mr
            )
            acc = acc.at[0].add(jnp.einsum("pj,pji->ij", w_blk, picked))
            if with_spin:
                d_blk = jax.lax.dynamic_slice(d, sl, (npb, mr, ncl))
                d_t = jnp.transpose(d_blk, (0, 2, 1)).reshape(npb * ncl, mr)
                wq_blk = jax.lax.dynamic_slice(w_bqp, (i * npb, 0), (npb, n_total))
                lq_blk = jax.lax.dynamic_slice(loc_qp, (i * npb, 0), (npb, n_total))
                picked_m = jnp.take(
                    d_t, (lq_blk + offs).reshape(-1), axis=0
                ).reshape(npb, n_total, mr)
                acc = acc.at[1].add(jnp.einsum("pj,pji->ij", wq_blk, picked_m))
            return acc

        nchan = 2 if with_spin else 1
        partial_ = jax.lax.fori_loop(
            0, nblk, blk, jnp.zeros((nchan, mr, n_total), dt)
        )
        # ONE collective completes both cross-spin and the penalty's mixed term
        scattered = jax.lax.psum_scatter(
            partial_, "col", scatter_dimension=2, tiled=True
        )
        sigma = scattered[0]
        if with_spin:
            shift = op["spin_shift"].astype(dt)
            const = op["spin_const"].astype(dt)  # sz(sz+1) + n_b - spin_target
            sigma = sigma + shift * (const * c_loc - scattered[1])
        # same-spin alpha: local output rows, neighbor rows global
        sigma = sigma + jnp.einsum(
            "jl,jln->jn", op["nbr_val_a"].astype(dt), c_colpanel[op["nbr_idx_a"]]
        )
        # same-spin beta: local output columns, neighbor columns read as rows
        # of the transposed row panel (contiguous Mr-slices)
        sigma = sigma + jnp.einsum(
            "kl,klm->mk",
            op["nbr_val_b"].astype(dt),
            c_rowpanel.T[op["nbr_idx_b"]],
        )
    return sigma.reshape(-1)


def _solve_inside(op, tol, max_subspace, max_cycle):
    hdiag = op["hdiag"].reshape(-1)
    v0 = _sharded_initial_guess(hdiag, _AXES).astype(hdiag.dtype)
    res = davidson_ground_state(
        _gridsharded_matvec,
        op,
        hdiag,
        v0,
        tol=tol,
        max_subspace=max_subspace,
        max_iterations=max_cycle,
        axis_name=_AXES,
    )
    mr, ncl = op["hdiag"].shape
    return res.vector.reshape(mr, ncl), res.iterations, res.converged, res.residual_norm


def _refine_inside(op, v0, tol, max_subspace, max_cycle):
    """Warm-started f64 polish of the coarse solution (same sharding)."""
    hdiag = op["hdiag"].reshape(-1)
    res = davidson_ground_state(
        _gridsharded_matvec,
        op,
        hdiag,
        v0.reshape(-1).astype(hdiag.dtype),
        tol=tol,
        max_subspace=max_subspace,
        max_iterations=max_cycle,
        axis_name=_AXES,
    )
    mr, ncl = op["hdiag"].shape
    return res.vector.reshape(mr, ncl)


def solve_sci_gridsharded(
    ci_strings,
    one_body_tensor,
    two_body_tensor,
    norb: int,
    nelec,
    *,
    spin_sq=None,
    shift: float = 0.1,
    mesh: Mesh | None = None,
    solver_dtype=jnp.float32,
    tol: float = 1e-5,
    max_subspace: int = 24,
    max_cycle: int = 200,
    refine_iterations: int | None = None,
    with_rdms: bool = False,
):
    """Diagonalize ONE subspace with the amplitude grid sharded in 2-D.

    Same contract as :func:`sqd_tpu.fermion.solve_sci` (fused spin penalty,
    bare-H final energy, f64 polish after f32 solves).  Intended for
    subspaces whose direction vector — not just the Krylov workspace — must
    be distributed.
    """
    from ..fermion import SCIResult, SCIState, _check_ci_strs

    if mesh is None:
        mesh = default_grid_mesh()
    if tuple(mesh.axis_names) != _AXES:
        mesh = Mesh(np.asarray(mesh.devices).reshape(-1), ("flat",))
        mesh = default_grid_mesh(mesh.devices)
    nr, nc = mesh.devices.shape
    if refine_iterations is None:
        refine_iterations = 0 if jnp.dtype(solver_dtype) == jnp.float64 else 6
    strs_a, strs_b = _check_ci_strs(ci_strings)
    pa = bitpack.pack_ints(np.asarray(strs_a, dtype=object if norb >= 63 else np.int64), norb)
    pb = bitpack.pack_ints(np.asarray(strs_b, dtype=object if norb >= 63 else np.int64), norb)
    m, n = len(strs_a), len(strs_b)
    # row/col counts divisible by the mesh even after the builder's
    # sublane/lane re-rounding (multiples of 8 and 128 respectively)
    step_m = math.lcm(nr, 8)
    step_n = math.lcm(nc, 128)
    m_pad = -(-m // step_m) * step_m
    n_pad = -(-n // step_n) * step_n

    with_spin = spin_sq is not None
    ham64 = build_sci_hamiltonian(
        pa, pb, one_body_tensor, two_body_tensor, norb, nelec,
        spin_shift=float(shift) if with_spin else 0.0,
        spin_target=float(spin_sq) if with_spin else 0.0,
        dtype=jnp.float64, pad_to=(m_pad, n_pad), col_block=0,
    )
    m_pad, n_pad = ham64.shape
    npair = norb * norb

    specs = {
        "src_a": P(None, "row"),
        "sign_a": P(None, "row"),
        "src_b": P(),  # replicated: source of the on-device reverse tables
        "sign_b": P(),
        "nbr_idx_a": P("row"),
        "nbr_val_a": P("row"),
        "nbr_idx_b": P("col"),
        "nbr_val_b": P("col"),
        "eri_t": P(),
        "hdiag": P("row", "col"),
        "src_b_qp": P(),
        "sign_b_qp": P(),
        "spin_shift": P(),
        "spin_const": P(),
    }

    def _make_op(dtype):
        op = {
            "src_a": ham64.src_a,
            "sign_a": ham64.sign_a,
            "src_b": ham64.src_b,
            "sign_b": ham64.sign_b,
            "nbr_idx_a": ham64.nbr_idx_a,
            "nbr_val_a": ham64.nbr_val_a.astype(dtype),
            "nbr_idx_b": ham64.nbr_idx_b,
            "nbr_val_b": ham64.nbr_val_b.astype(dtype),
            "eri_t": ham64.eri_t.astype(dtype),
            "hdiag": ham64.hdiag.astype(dtype),
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
    solve = jax.jit(
        jax.shard_map(
            partial(
                _solve_inside, tol=tol, max_subspace=max_subspace, max_cycle=max_cycle
            ),
            mesh=mesh,
            in_specs=(op_specs,),
            out_specs=(P("row", "col"), P(), P(), P()),
            check_vma=False,
        )
    )
    vec, iters, converged, rnorm = solve(op)
    if refine_iterations > 0 and jnp.dtype(solver_dtype) != jnp.float64:
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
                in_specs=(op_specs, P("row", "col")),
                out_specs=P("row", "col"),
                check_vma=False,
            )
        )
        vec = refine(op64, vec)

    # result processing on the full grid (host-side sizes are fine here)
    bare64 = ham64
    if with_spin:
        import dataclasses

        bare64 = dataclasses.replace(ham64, spin_shift=0.0, spin_target=0.0)
    # multi-host: replicate + localize (every process gets the full copy for
    # the redundant-but-identical host-side epilogue); single-process: one
    # host materialization, as before
    vec_host = replicate_to_host(vec, mesh)
    vec_full = jnp.asarray(vec_host)
    energy = float(expectation_value(bare64, vec_full.reshape(-1)))

    amplitudes = vec_host[:m, :n]
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
        ham64, vec_full.astype(jnp.float64), pa, pb, with_dm2=with_rdms
    )
    occ = (
        np.diagonal(np.asarray(rdms["dm1a"])).copy(),
        np.diagonal(np.asarray(rdms["dm1b"])).copy(),
    )
    rdm1 = rdm2 = None
    if with_rdms:
        rdm1 = np.asarray(rdms["dm1a"] + rdms["dm1b"])
        rdm2 = np.asarray(rdms["dm2"])
    return SCIResult(energy, state, orbital_occupancies=occ, rdm1=rdm1, rdm2=rdm2)
