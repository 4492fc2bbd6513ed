# (C) 2026. Licensed under the Apache License, Version 2.0.
"""[4Fe-4S]-class problem shapes: 54 electrons in 36 spatial orbitals.

BASELINE.md config 5 names this envelope ("[4Fe-4S] (54e,36o), 10^6-10^7
determinants, batches sharded over a device mesh").  Iron integrals are
outside this image's basis data, so the electronic structure here is
synthetic — what these tests pin is the *machinery* at the config's shape:

* 36 orbitals cross the one-word packing boundary (36 > 32 -> two uint32
  words per string), exercising every multiword table/kernel path;
* nelec = (27, 27) strings cannot be enumerated (C(36,27) ~ 9.4e7 per spin),
  so subspaces are sampled — the selected-CI regime the config describes;
* batches solved concurrently over the 8-device mesh must agree with the
  sequential solver exactly.

The 10^7-determinant run at this shape is the ``dense_df_1e7`` phase of
``chip_smoke.py`` and the last section of ``bench.py`` (one GPU; the batch
axis is the mesh dimension validated here and in
``__graft_entry__.dryrun_multichip``).
"""

from __future__ import annotations

import numpy as np

from sqd_tpu import fermion
from sqd_tpu.parallel.batch_solver import solve_sci_batch_sharded
from sqd_tpu.parallel.mesh import default_mesh

NORB = 36
NELEC = (27, 27)


def _random_strings(rng, n: int) -> np.ndarray:
    """n distinct 27-of-36 strings connected by single-excitation chains.

    Uniformly random 27-of-36 strings typically differ by >2 orbitals —
    a nearly diagonal (disconnected) projected Hamiltonian on which distinct
    solvers legitimately converge to different isolated blocks.  A walk of
    single excitations from the aufbau string keeps the subspace connected,
    which is also how physical SQD samples look."""
    hf = (1 << NELEC[0]) - 1
    out = {hf}
    frontier = [hf]
    while len(out) < n:
        base = frontier[rng.integers(len(frontier))]
        occ = [p for p in range(NORB) if (base >> p) & 1]
        virt = [p for p in range(NORB) if not (base >> p) & 1]
        new = base ^ (1 << occ[rng.integers(len(occ))]) ^ (1 << virt[rng.integers(len(virt))])
        if new not in out:
            out.add(new)
            frontier.append(new)
            if len(frontier) > 16:
                frontier.pop(0)
    return np.array(sorted(out), dtype=np.int64)


def _synthetic_integrals(rng):
    h1 = rng.normal(size=(NORB, NORB))
    h1 = (h1 + h1.T) / 2 - 2.0 * np.eye(NORB)
    eri = rng.normal(size=(NORB,) * 4) * 0.05
    eri = eri + eri.transpose(1, 0, 2, 3)
    eri = eri + eri.transpose(0, 1, 3, 2)
    eri = eri + eri.transpose(2, 3, 0, 1)
    return h1, eri / 8


def test_fe4s4_class_batches_sharded_vs_sequential():
    rng = np.random.default_rng(44)
    h1, eri = _synthetic_integrals(rng)
    # the per-matvec eri_t matmul is O(norb^4 * dim) — 16 strings/spin keeps
    # the 8 sequential f64 solves affordable on the CPU mesh
    ci_strings = []
    for _ in range(8):  # one batch per virtual device
        ci_strings.append((_random_strings(rng, 16), _random_strings(rng, 16)))

    # with_rdms=False: at 27-electron filling the same-spin 2-RDM Grams run
    # over ~350 two-hole intermediates PER STRING — dominating a shape test
    # that only pins energies/occupancies (see solve_sci docstring).
    # f64 both sides: this pins the 36-orbital MACHINERY (mixed-precision
    # noise policy is covered by test_parallel/test_f32_noise on milder
    # spectra; this synthetic one spans ~100 Ha).
    import jax.numpy as jnp

    seq = fermion.solve_sci_batch(
        ci_strings, h1, eri, NORB, NELEC, with_rdms=False, solver_dtype=jnp.float64
    )
    par = solve_sci_batch_sharded(
        ci_strings, h1, eri, NORB, NELEC, mesh=default_mesh(), pad_bucket=8,
        solver_dtype=jnp.float64,
    )
    assert len(par) == 8
    for s, p in zip(seq, par):
        assert abs(s.energy - p.energy) < 1e-7, (s.energy, p.energy)
        np.testing.assert_allclose(
            np.ravel(s.orbital_occupancies), np.ravel(p.orbital_occupancies), atol=1e-6
        )
        # 54 electrons actually present in every occupancy vector
        occ_a, occ_b = p.orbital_occupancies
        assert abs(np.sum(occ_a) - 27.0) < 1e-6
        assert abs(np.sum(occ_b) - 27.0) < 1e-6


def test_fe4s4_class_single_solve_contract():
    """One larger open-subspace solve at the 36-orbital shape: f64 energy
    re-evaluation agrees with the Davidson eigenvalue, packed strings survive
    the SCIState round-trip."""
    rng = np.random.default_rng(45)
    h1, eri = _synthetic_integrals(rng)
    strs = (_random_strings(rng, 48), _random_strings(rng, 48))
    # tol=1e-5: every matvec pays the fixed O(norb^4 * dim) eri_t matmul, so
    # iteration count is the lever; the assertions below only need ~1e-8
    # energy accuracy (second order in the residual)
    res = fermion.solve_sci(
        strs, h1, eri, NORB, NELEC, solver_dtype=np.float64, with_rdms=False, tol=1e-5
    )
    assert res.rdm2 is None and res.rdm1 is not None
    assert np.isfinite(res.energy)
    # the state's packed strings reproduce the inputs after save/load
    state = res.sci_state
    np.testing.assert_array_equal(np.asarray(state.ci_strs_a), strs[0])
    np.testing.assert_array_equal(np.asarray(state.ci_strs_b), strs[1])
    # variational sanity: selected-CI energy upper-bounds a larger subspace's
    bigger = (
        np.unique(np.concatenate([strs[0], _random_strings(rng, 32)])),
        strs[1],
    )
    res2 = fermion.solve_sci(
        bigger, h1, eri, NORB, NELEC, solver_dtype=np.float64, with_rdms=False, tol=1e-5
    )
    assert res2.energy <= res.energy + 1e-8


def test_large_norb_col_block_memory_cap():
    """Auto col_block must shrink below 128 lanes when npair is huge.

    At (36o, 1e7 dets) a 128-column floor would make each blocked-matvec
    step allocate 3 x 2.1 GB (npair, 128, m) temporaries; the cap shrinks
    cb so one buffer stays under ~576 MB.  The
    production norb=16 shapes (572 MB at 1.9e7 dets) must KEEP cb=128.
    """
    from sqd_tpu.ops.hamiltonian import _auto_col_block

    # [4Fe-4S]-class: (36o, 3168 x 3168 = 1e7 dets) -> sub-128, 8-aligned
    cb = _auto_col_block(36 * 36, 3168, 3168)
    assert 8 <= cb < 128 and cb % 8 == 0, cb
    assert 36 * 36 * 3168 * cb <= 144 * 1024 * 1024

    # production N2/6-31G CASCI shape: (16o, 4368 x 4480) -> exactly 128
    assert _auto_col_block(16 * 16, 4368, 4480) == 128

    # 1e6-det bench shape: (16o, 1000 x 1024) fits unblocked
    assert _auto_col_block(16 * 16, 1000, 1024) == 0

    # blocked matvec exactness at a sub-128 col_block (norb=36, small dims)
    import jax.numpy as jnp

    from sqd_tpu.ops import bitpack
    from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian

    rng = np.random.default_rng(9)
    h1, eri = _synthetic_integrals(rng)
    sa, sb = _random_strings(rng, 40), _random_strings(rng, 48)
    pa, pb = bitpack.pack_ints(sa, NORB), bitpack.pack_ints(sb, NORB)
    full = build_sci_hamiltonian(
        pa, pb, h1, eri, NORB, NELEC, dtype=jnp.float64, col_block=0,
        pad_to=(40, 48),
    )
    blk = build_sci_hamiltonian(
        pa, pb, h1, eri, NORB, NELEC, dtype=jnp.float64, col_block=8,
        pad_to=(40, 48),
    )
    c = jnp.asarray(rng.normal(size=(40, 48)))
    np.testing.assert_allclose(
        np.asarray(blk.matvec(c)), np.asarray(full.matvec(c)), atol=1e-12
    )
