# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Mesh-sharded batch diagonalization — the device answer to the ``sci_solver`` seam.

The reference documents that the per-iteration batch diagonalizations are
embarrassingly parallel and leaves scaling to a swap-in MPI program
(``qiskit-addon-dice-solver``; reference ``fermion.py:161-165,204-207``,
``docs/guides/integrate_dice_solver.ipynb``; SURVEY.md N10/§2.3).  Here the
same seam is filled natively: every batch's Hamiltonian is padded to a common
bucket shape, the per-batch operator pytrees are stacked along a leading axis,
and one jitted, vmapped Davidson solve runs with that axis sharded across the
device mesh — one (or more) batch per chip, XLA/ICI handling placement.  The
convergence check / best-batch argmin back on host is O(num_batches) scalars.

Drop-in usage::

    from sqd_tpu.parallel import solve_sci_batch_sharded
    result = diagonalize_fermionic_hamiltonian(..., sci_solver=solve_sci_batch_sharded)
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..ops import bitpack, rdm as rdm_ops
from ..ops.davidson import davidson_ground_state, davidson_initial_guess
from ..ops.hamiltonian import build_sci_hamiltonian, expectation_value, sci_matvec_flat
from .mesh import batch_sharding, default_mesh

__all__ = ["solve_sci_batch_sharded"]


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@partial(jax.jit, static_argnames=("tol", "max_subspace", "max_cycle"))
def _solve_one(ham32, ham64, tol: float, max_subspace: int, max_cycle: int):
    """Davidson in the working dtype + f64 Rayleigh refinement for one batch."""
    hd = ham32.hdiag.reshape(-1)
    v0 = davidson_initial_guess(hd)
    res = davidson_ground_state(
        sci_matvec_flat,
        ham32,
        hd,
        v0,
        tol=tol,
        max_subspace=max_subspace,
        max_iterations=max_cycle,
    )
    m, n = ham64.shape
    vec = res.vector.astype(jnp.float64)
    vec = vec / jnp.linalg.norm(vec)
    # Final energy policy (mirrors solve_sci / the reference's
    # energy-from-RDMs, fermion.py:509-524): the BARE Hamiltonian expectation
    # — the spin penalty only steers the iteration — as the f64 Rayleigh
    # quotient of the exact operator.
    energy = expectation_value(ham64, vec, spin_penalty=False)
    # spin-resolved occupancies from the exact single-excitation gathers
    rdms = rdm_ops.make_rdms(ham64, vec.reshape(m, n), with_dm2=False)
    occ_a = jnp.diagonal(rdms["dm1a"])
    occ_b = jnp.diagonal(rdms["dm1b"])
    return energy, vec.reshape(m, n), occ_a, occ_b, res.iterations, res.converged


def solve_sci_batch_sharded(
    ci_strings,
    one_body_tensor,
    two_body_tensor,
    norb,
    nelec,
    *,
    spin_sq=None,
    shift: float = 0.1,
    mesh=None,
    solver_dtype=jnp.float32,
    tol: float = 1e-6,
    max_subspace: int = 24,
    max_cycle: int = 200,
    pad_bucket: int = 64,
    with_rdms: bool = False,
    **kwargs,
):
    """Diagonalize every batch subspace concurrently across the device mesh.

    Signature-compatible with :func:`sqd_tpu.fermion.solve_sci_batch`
    (reference ``fermion.py:435-473``); see module docstring.

    Args:
        ci_strings: list of (strings_a, strings_b) integer arrays.
        one_body_tensor / two_body_tensor: integrals (chemist convention).
        norb, nelec: orbital / electron counts.
        spin_sq / shift: optional S^2 penalty (as in :func:`solve_sci`).
        mesh: a 1-D ``jax.sharding.Mesh``; defaults to all local devices.
        solver_dtype: Davidson working dtype (f32 default; the energy is
            always refined in f64).
        tol / max_subspace / max_cycle: Davidson controls.
        pad_bucket: common padding granularity for the stacked shapes.
        with_rdms: also attach spin-summed 1-/2-RDMs to each result
            (host-side post-pass; off by default in the hot loop).

    Returns:
        List of :class:`~sqd_tpu.fermion.SCIResult`, one per batch.
    """
    from ..fermion import SCIResult, SCIState, _check_ci_strs

    if mesh is None:
        mesh = default_mesh()
    n_dev = mesh.devices.size

    checked = [_check_ci_strs(cs) for cs in ci_strings]
    n_batches = len(checked)
    m_pad = _round_up(max(len(a) for a, _ in checked), pad_bucket)
    n_pad = _round_up(max(len(b) for _, b in checked), pad_bucket)

    hams64 = []
    packed = []
    for strs_a, strs_b in checked:
        pa = bitpack.pack_ints(np.asarray(strs_a, dtype=object if norb >= 63 else np.int64), norb)
        pb = bitpack.pack_ints(np.asarray(strs_b, dtype=object if norb >= 63 else np.int64), norb)
        packed.append((pa, pb))
        hams64.append(
            build_sci_hamiltonian(
                pa,
                pb,
                one_body_tensor,
                two_body_tensor,
                norb,
                nelec,
                spin_shift=0.0 if spin_sq is None else float(shift),
                spin_target=0.0 if spin_sq is None else float(spin_sq),
                dtype=jnp.float64,
                pad_to=(m_pad, n_pad),
            )
        )
    # neighbor-list widths differ per batch: pad to the common max (inert)
    la = max(h.nbr_idx_a.shape[1] for h in hams64)
    lb = max(h.nbr_idx_b.shape[1] for h in hams64)
    import dataclasses

    def widen(h):
        def pad_tab(idx, val, width):
            extra = width - idx.shape[1]
            if extra == 0:
                return idx, val
            # clamped-table convention: zero index + zero value is inert
            return (
                jnp.pad(idx, ((0, 0), (0, extra))),
                jnp.pad(val, ((0, 0), (0, extra))),
            )

        ia, va = pad_tab(h.nbr_idx_a, h.nbr_val_a, la)
        ib, vb = pad_tab(h.nbr_idx_b, h.nbr_val_b, lb)
        return dataclasses.replace(h, nbr_idx_a=ia, nbr_val_a=va, nbr_idx_b=ib, nbr_val_b=vb)

    hams64 = [widen(h) for h in hams64]

    # pad batch count to a device multiple (replicas of the last batch)
    total = _round_up(n_batches, n_dev)
    hams64 = hams64 + [hams64[-1]] * (total - n_batches)
    stacked64 = jax.tree.map(lambda *xs: jnp.stack(xs), *hams64)
    stacked32 = stacked64.astype(solver_dtype)

    # multi-host: device_put onto a global mesh takes process-local (host)
    # inputs, each process passing the same global value
    from .distributed import host_local, replicate_to_host

    shard = batch_sharding(mesh)
    stacked64 = jax.device_put(jax.tree.map(host_local, stacked64), shard)
    stacked32 = jax.device_put(jax.tree.map(host_local, stacked32), shard)

    solve = jax.jit(
        jax.vmap(lambda h32, h64: _solve_one(h32, h64, tol, max_subspace, max_cycle)),
        out_shardings=shard,
    )
    energies, vecs, occ_as, occ_bs, iters, conv = solve(stacked32, stacked64)
    # every process needs every batch's result (the orchestrator's host-side
    # carryover/convergence epilogue runs redundantly-but-identically per
    # process): replicate before readback
    energies = replicate_to_host(energies, mesh)
    occ_as = replicate_to_host(occ_as, mesh)
    occ_bs = replicate_to_host(occ_bs, mesh)
    vecs = replicate_to_host(vecs, mesh)

    results = []
    for i, (strs_a, strs_b) in enumerate(checked):
        m, n = len(strs_a), len(strs_b)
        amp = vecs[i, :m, :n]
        nrm = np.linalg.norm(amp)
        amp = amp / nrm if nrm > 0 else amp
        state = SCIState(
            amplitudes=amp,
            ci_strs_a=strs_a,
            ci_strs_b=strs_b,
            norb=norb,
            nelec=tuple(int(x) for x in nelec),
        )
        rdm1 = rdm2 = None
        if with_rdms:
            pa, pb = packed[i]
            rdms = rdm_ops.make_rdms(
                hams64[i], jnp.asarray(vecs[i], jnp.float64), pa, pb
            )
            rdm1 = np.asarray(rdms["dm1a"] + rdms["dm1b"])
            rdm2 = np.asarray(rdms["dm2"])
        results.append(
            SCIResult(
                float(energies[i]),
                state,
                orbital_occupancies=(occ_as[i].copy(), occ_bs[i].copy()),
                rdm1=rdm1,
                rdm2=rdm2,
            )
        )
    return results
