# (C) 2026. Licensed under the Apache License, Version 2.0.
"""One large Davidson solve sharded across the device mesh.

The reference's only intra-solve parallelism is OpenMP threading inside
PySCF's C kernels (SURVEY.md §2.3 "tensor parallel analog"); its cluster
answer is an external MPI program.  Here a *single* selected-CI solve scales
over the mesh natively: the ``norb^2`` excitation-pair axis of the cross-spin
channel is sharded, each device gathers and contracts its pair block, and the
ERI contraction moves between pair shards as a blockwise ``psum`` ring
(volume = one G tensor per matvec, over the device interconnect).  Amplitude vectors stay
replicated (they are small compared to the per-pair intermediates), so the
Davidson driver itself runs unmodified inside ``shard_map``.

Memory per device drops from ``npair * M * N`` to ``npair/n_dev * M * N``,
which is what lifts the 1e7-determinant configs ([4Fe-4S], BASELINE config 5)
onto a multi-device mesh.  The fused spin penalty works sharded too: the
qp-permuted beta tables it needs are sharded along the same pair axis.
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
from .mesh import default_mesh

__all__ = ["solve_sci_distributed"]

_AXIS = "pair"


def _sharded_matvec(op, x):
    """Cross-spin + same-spin application with the pair axis sharded.

    ``op`` is a dict of *local* shards (leading pair axis already split by
    shard_map); ``x`` is the replicated flat vector.
    """
    ndev = jax.lax.axis_size(_AXIS)
    my = jax.lax.axis_index(_AXIS)
    m = op["nbr_idx_a"].shape[0]
    n = op["nbr_idx_b"].shape[0]
    npair_loc = op["src_a"].shape[0]
    dt = x.dtype
    c = x.reshape(m, n)

    with jax.default_matmul_precision("highest"):
        # local alpha gathers: D_loc[pq, :, :] for my pair block
        d_loc = op["sign_a"].astype(dt)[:, :, None] * c[op["src_a"]]
        d_flat = d_loc.reshape(npair_loc, m * n)

        # blockwise-psum contraction: G'[rs] = sum_pq (pq|rs) D[pq].
        # Device d owns G' rows [d*P, (d+1)*P); in round d every device
        # contributes eri_t[rows(d), cols(my)] @ D_loc and the psum lands the
        # full row block on everyone — device d keeps it.
        eri_t = op["eri_t"].astype(dt)  # full (npair, npair), replicated
        g_loc = jnp.zeros_like(d_flat)
        col0 = (my * npair_loc).astype(jnp.int32)
        for d in range(ndev):
            eri_blk = jax.lax.dynamic_slice(
                eri_t, (jnp.int32(d * npair_loc), col0), (npair_loc, npair_loc)
            )
            partial_g = jnp.matmul(eri_blk, d_flat, preferred_element_type=dt)
            summed = jax.lax.psum(partial_g, _AXIS)
            g_loc = jnp.where(my == d, summed, g_loc)

        # local beta scatter of my G' rows, then global sum.  Picks run
        # against the TRANSPOSED intermediate: XLA gathers pay per slice (see
        # ops.hamiltonian), so the slices must be (m*4)-byte rows, never
        # 4-byte elements.
        g_t = g_loc.reshape(npair_loc, m, n).transpose(0, 2, 1).reshape(
            npair_loc * n, m
        )
        rows = op["src_b"].astype(jnp.int32) + (
            jnp.arange(npair_loc, dtype=jnp.int32)[:, None] * n
        )
        picked = jnp.take(g_t, rows.reshape(-1), axis=0).reshape(npair_loc, n, m)
        sigma = jnp.einsum("pj,pji->ij", op["sign_b"].astype(dt), picked)
        sigma = jax.lax.psum(sigma, _AXIS)

        # same-spin neighbor lists (replicated, cheap)
        picked_a = c[op["nbr_idx_a"]]
        sigma = sigma + jnp.einsum("jl,jln->jn", op["nbr_val_a"].astype(dt), picked_a)
        sigma = sigma + jnp.einsum(
            "kl,klm->mk", op["nbr_val_b"].astype(dt), c.T[op["nbr_idx_b"]]
        )
    return sigma.reshape(-1)


def _sharded_matvec_spin(op, x):
    """:func:`_sharded_matvec` + fused spin penalty ``shift * (S^2 - ss)``.

    The mixed term ``sum_pq E^a_pq E^b_qp`` needs, for each local pq block,
    the beta gather tables of the *transposed* pair qp — those are just data,
    so ``src_b_qp``/``sign_b_qp`` (the qp-permuted tables) are sharded along
    the same pair axis at build time, keeping the whole term shard-local up
    to one psum.
    """
    sigma = _sharded_matvec(op, x)
    m = op["nbr_idx_a"].shape[0]
    n = op["nbr_idx_b"].shape[0]
    dt = x.dtype
    c = x.reshape(m, n)
    with jax.default_matmul_precision("highest"):
        d_loc = op["sign_a"].astype(dt)[:, :, None] * c[op["src_a"]]
        npair_loc = d_loc.shape[0]
        d_t = d_loc.transpose(0, 2, 1).reshape(npair_loc * n, m)
        rows = op["src_b_qp"].astype(jnp.int32) + (
            jnp.arange(npair_loc, dtype=jnp.int32)[:, None] * n
        )
        picked = jnp.take(d_t, rows.reshape(-1), axis=0).reshape(npair_loc, n, m)
        mixed = jnp.einsum("pj,pji->ij", op["sign_b_qp"].astype(dt), picked)
        mixed = jax.lax.psum(mixed, _AXIS)
        shift = op["spin_shift"].astype(dt)
        const = op["spin_const"].astype(dt)  # sz(sz+1) + n_b - spin_target
        penalty = shift * (const * c - mixed)
    return sigma + penalty.reshape(-1)


def _solve_inside(op32, hdiag, tol, max_subspace, max_cycle, mv=None):
    mv = mv or _sharded_matvec
    v0 = davidson_initial_guess(hdiag, hdiag.dtype)
    res = davidson_ground_state(
        mv,
        op32,
        hdiag,
        v0,
        tol=tol,
        max_subspace=max_subspace,
        max_iterations=max_cycle,
    )
    vec = res.vector.astype(jnp.float64)
    vec = vec / jnp.linalg.norm(vec)
    # The final energy is computed OUTSIDE the shard_map by the caller via
    # the f64 expectation_value of the exact unsharded operator.
    return vec, res.iterations, res.converged, res.residual_norm


def solve_sci_distributed(
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
    tol: float = 1e-4,
    max_subspace: int = 32,
    max_cycle: int = 200,
    with_rdms: bool = False,
):
    """Diagonalize ONE subspace with the pair axis sharded over the mesh.

    Same contract as :func:`sqd_tpu.fermion.solve_sci` (including the fused
    ``shift * (S^2 - spin_sq)`` penalty); intended for subspaces too large
    for a single chip.
    """
    from ..fermion import SCIResult, SCIState, _check_ci_strs

    if mesh is None:
        mesh = default_mesh(_AXIS)
    elif _AXIS not in mesh.axis_names:
        # caller handed us a mesh laid out for another axis name (e.g. the
        # batch mesh); the pair-sharded solve is 1-D, so flatten and rename
        from jax.sharding import Mesh

        mesh = Mesh(mesh.devices.reshape(-1), (_AXIS,))
    ndev = mesh.devices.size
    strs_a, strs_b = _check_ci_strs(ci_strings)
    pa = bitpack.pack_ints(np.asarray(strs_a, dtype=object if norb >= 63 else np.int64), norb)
    pb = bitpack.pack_ints(np.asarray(strs_b, dtype=object if norb >= 63 else np.int64), norb)
    npair = norb * norb
    if npair % ndev:
        raise ValueError(f"norb^2 = {npair} must divide evenly over {ndev} devices.")

    ham64 = build_sci_hamiltonian(
        pa, pb, one_body_tensor, two_body_tensor, norb, nelec,
        dtype=jnp.float64, col_block=0,
    )
    m, n = ham64.shape

    with_spin = spin_sq is not None

    def op_dict(ham, dtype):
        out = {
            "src_a": ham.src_a,
            "sign_a": ham.sign_a,
            "src_b": ham.src_b,
            "sign_b": ham.sign_b,
            "nbr_idx_a": ham.nbr_idx_a,
            "nbr_val_a": ham.nbr_val_a.astype(dtype),
            "nbr_idx_b": ham.nbr_idx_b,
            "nbr_val_b": ham.nbr_val_b.astype(dtype),
            "eri_t": ham.eri_t.astype(dtype),
        }
        if with_spin:
            p_idx, q_idx = np.divmod(np.arange(npair), norb)
            perm = q_idx * norb + p_idx
            n_a, n_b = (int(x) for x in nelec)
            sz = 0.5 * (n_a - n_b)
            out["src_b_qp"] = ham.src_b[jnp.asarray(perm)]
            out["sign_b_qp"] = ham.sign_b[jnp.asarray(perm)]
            out["spin_shift"] = jnp.asarray(float(shift), jnp.float64)
            out["spin_const"] = jnp.asarray(
                sz * sz + sz + n_b - float(spin_sq), jnp.float64
            )
        return out

    specs = {
        "src_a": P(_AXIS),
        "sign_a": P(_AXIS),
        "src_b": P(_AXIS),
        "sign_b": P(_AXIS),
        "nbr_idx_a": P(),
        "nbr_val_a": P(),
        "nbr_idx_b": P(),
        "nbr_val_b": P(),
        "eri_t": P(),
        "src_b_qp": P(_AXIS),
        "sign_b_qp": P(_AXIS),
        "spin_shift": P(),
        "spin_const": P(),
    }

    op32 = op_dict(ham64, solver_dtype)
    hdiag = ham64.hdiag.reshape(-1).astype(solver_dtype)

    def place(op):
        return {k: jax.device_put(v, NamedSharding(mesh, specs[k])) for k, v in op.items()}

    op32 = place(op32)
    hdiag = jax.device_put(hdiag, NamedSharding(mesh, P()))

    op_specs = {k: specs[k] for k in op32}
    in_specs = (op_specs, P())
    solve = jax.jit(
        jax.shard_map(
            partial(
                _solve_inside,
                tol=tol,
                max_subspace=max_subspace,
                max_cycle=max_cycle,
                mv=_sharded_matvec_spin if with_spin else _sharded_matvec,
            ),
            mesh=mesh,
            in_specs=in_specs,
            out_specs=(P(), P(), P(), P()),
            check_vma=False,
        )
    )
    vec, iters, converged, rnorm = solve(op32, hdiag)
    # Bare-H energy (the spin penalty only steers the iteration; same policy
    # as the reference's energy-from-RDMs, fermion.py:509-524), as the f64
    # Rayleigh quotient of the exact operator.
    energy = float(expectation_value(ham64, jnp.asarray(vec)))
    amplitudes = np.asarray(vec).reshape(m, n)

    state = SCIState(
        amplitudes=amplitudes,
        ci_strs_a=strs_a,
        ci_strs_b=strs_b,
        norb=norb,
        nelec=tuple(int(x) for x in nelec),
    )
    rdms = rdm_ops.make_rdms(
        ham64, jnp.asarray(amplitudes, jnp.float64), pa, pb, with_dm2=with_rdms
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
