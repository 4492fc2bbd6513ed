# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Dense density-fitted matvec == gather matvec (the matmul-only large-norb path)."""

import numpy as np
import pytest

import jax.numpy as jnp

from sqd_tpu.ops import bitpack, dense_fci
from sqd_tpu.ops.dense_df import dense_df_matvec_flat, densify
from sqd_tpu.ops.davidson import davidson_ground_state, davidson_initial_guess
from sqd_tpu.ops.hamiltonian import (
    build_sci_hamiltonian,
    pivoted_cholesky_pairs,
    sci_matvec_flat,
)


def _problem(norb, nelec, m, n, seed=1, rank=None):
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    rank = rank or 3 * norb
    ch = rng.normal(size=(rank, norb, norb)) * (0.4 / np.sqrt(rank))
    ch = (ch + ch.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", ch, ch)
    sa = np.sort(rng.choice(dense_fci.all_hamming_strings(norb, nelec[0]), m, replace=False))
    sb = np.sort(rng.choice(dense_fci.all_hamming_strings(norb, nelec[1]), n, replace=False))
    return h1, eri, bitpack.pack_ints(sa, norb), bitpack.pack_ints(sb, norb)


@pytest.mark.parametrize("m,n", [(30, 30), (25, 40)])
def test_dense_df_matvec_matches_gather_f64(m, n):
    norb, nelec = 9, (4, 5)
    h1, eri, pa, pb = _problem(norb, nelec, m, n, seed=3)
    ell = pivoted_cholesky_pairs(eri, norb)
    ham = build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, eri_factor=ell)
    op = densify(ham, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    c = jnp.asarray(rng.normal(size=ham.shape))
    s_gather = np.asarray(ham.matvec(c))  # f64 path ignores the factor: exact
    s_dense = np.asarray(op.matvec(c))
    # only the factorization error (~1e-13 relative) separates them
    np.testing.assert_allclose(s_dense, s_gather, atol=1e-10 * np.abs(s_gather).max())


def test_dense_df_matvec_f32():
    norb, nelec = 10, (5, 5)
    h1, eri, pa, pb = _problem(norb, nelec, 40, 40, seed=5)
    ell = pivoted_cholesky_pairs(eri, norb)
    ham = build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, eri_factor=ell)
    op = densify(ham, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    c = jnp.asarray(rng.normal(size=ham.shape).astype(np.float32))
    s_gather = np.asarray(ham.astype(jnp.float32).matvec(c), np.float64)
    s_dense = np.asarray(op.matvec(c), np.float64)
    assert np.abs(s_dense - s_gather).max() < 3e-5 * np.abs(s_gather).max()


def test_dense_df_with_padding():
    """Clamped padded tables must stay inert through the one-hot build."""
    norb, nelec = 9, (4, 4)
    h1, eri, pa, pb = _problem(norb, nelec, 20, 20, seed=7)
    ell = pivoted_cholesky_pairs(eri, norb)
    ham = build_sci_hamiltonian(
        pa, pb, h1, eri, norb, nelec, eri_factor=ell, pad_to=(24, 32)
    )
    op = densify(ham, dtype=jnp.float64)
    rng = np.random.default_rng(2)
    c = np.zeros(ham.shape)
    c[:20, :20] = rng.normal(size=(20, 20))
    s_gather = np.asarray(ham.matvec(jnp.asarray(c)))
    s_dense = np.asarray(op.matvec(jnp.asarray(c)))
    np.testing.assert_allclose(s_dense, s_gather, atol=1e-10 * np.abs(s_gather).max())
    # padded outputs are exactly zero on both paths
    assert np.all(s_dense[20:, :] == 0) and np.all(s_dense[:, 20:] == 0)


def test_dense_df_davidson_ground_state():
    """Full solve through the dense operator lands on the gather solve."""
    norb, nelec = 10, (5, 5)
    h1, eri, pa, pb = _problem(norb, nelec, 36, 36, seed=11)
    ell = pivoted_cholesky_pairs(eri, norb)
    ham = build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, eri_factor=ell)
    op = densify(ham, dtype=jnp.float64)
    hd = op.hdiag.reshape(-1)
    v0 = davidson_initial_guess(hd, jnp.float64)
    r_dense = davidson_ground_state(
        dense_df_matvec_flat, op, hd, v0, tol=1e-9, max_subspace=20, max_iterations=200
    )
    hd_g = ham.hdiag.reshape(-1)
    r_gather = davidson_ground_state(
        sci_matvec_flat, ham, hd_g, davidson_initial_guess(hd_g, jnp.float64),
        tol=1e-9, max_subspace=20, max_iterations=200,
    )
    assert abs(float(r_dense.theta) - float(r_gather.theta)) < 1e-8


def test_segmented_davidson_matches_unsegmented():
    """Bounded-program restarts land on the same eigenpair (same tol)."""
    from sqd_tpu.ops.davidson import davidson_ground_state_segmented

    norb, nelec = 10, (5, 5)
    h1, eri, pa, pb = _problem(norb, nelec, 36, 36, seed=11)
    ell = pivoted_cholesky_pairs(eri, norb)
    ham = build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, eri_factor=ell)
    op = densify(ham, dtype=jnp.float64)
    hd = op.hdiag.reshape(-1)
    v0 = davidson_initial_guess(hd, jnp.float64)
    r_full = davidson_ground_state(
        dense_df_matvec_flat, op, hd, v0, tol=1e-9, max_subspace=20, max_iterations=200
    )
    r_seg = davidson_ground_state_segmented(
        dense_df_matvec_flat, op, hd, v0, tol=1e-9, max_subspace=20,
        max_iterations=200, segment_iterations=7,
    )
    assert bool(r_seg.converged)
    assert abs(float(r_seg.theta) - float(r_full.theta)) < 1e-8
    assert int(r_seg.iterations) <= 200


def test_densify_aliases_wb_for_identical_sets():
    """sa == sb (S_z = 0 sector): Wb must alias Wa, not duplicate it."""
    norb, nelec = 9, (4, 4)
    h1, eri, pa, _ = _problem(norb, nelec, 25, 25, seed=17)
    ell = pivoted_cholesky_pairs(eri, norb)
    ham = build_sci_hamiltonian(pa, pa, h1, eri, norb, nelec, eri_factor=ell)
    op = densify(ham, dtype=jnp.float64)
    assert op.wb is op.wa
    rng = np.random.default_rng(4)
    c = jnp.asarray(rng.normal(size=ham.shape))
    np.testing.assert_allclose(
        np.asarray(op.matvec(c)),
        np.asarray(ham.matvec(c)),
        atol=1e-10 * float(jnp.abs(ham.matvec(c)).max()),
    )


def test_densify_aliases_wb_across_mismatched_pads():
    """Identical sets padded to DIFFERENT widths (the builder's x8-row vs
    x128-column rounding at large shapes) must still alias Wb == Wa, with the
    matvec padding/slicing c around the square factors exactly.  Regression:
    the (54e, 36o) 1e7-det bench arrived as (npair, 3168) vs (npair, 3200)
    tables and silently built BOTH ~4.4 GB stacks."""
    norb, nelec = 9, (4, 4)
    h1, eri, pa, _ = _problem(norb, nelec, 25, 25, seed=19)
    ell = pivoted_cholesky_pairs(eri, norb)
    ham = build_sci_hamiltonian(
        pa, pa, h1, eri, norb, nelec, eri_factor=ell, pad_to=(32, 40)
    )
    assert ham.src_a.shape != ham.src_b.shape  # the mismatch under test
    op = densify(ham, dtype=jnp.float64)
    assert op.wb is op.wa and op.hbb is op.haa
    assert op.wa.shape[1] == 40 and op.shape == (32, 40)
    rng = np.random.default_rng(6)
    c = np.zeros(ham.shape)
    c[:25, :25] = rng.normal(size=(25, 25))
    s_gather = np.asarray(ham.matvec(jnp.asarray(c)))
    s_dense = np.asarray(op.matvec(jnp.asarray(c)))
    assert s_dense.shape == s_gather.shape
    np.testing.assert_allclose(s_dense, s_gather, atol=1e-10 * np.abs(s_gather).max())
    # the full flat solve goes through the same pad/slice path
    hd = op.hdiag.reshape(-1)
    v0 = davidson_initial_guess(hd, jnp.float64)
    r_dense = davidson_ground_state(
        dense_df_matvec_flat, op, hd, v0, tol=1e-9, max_subspace=20, max_iterations=200
    )
    hd_g = ham.hdiag.reshape(-1)
    r_gather = davidson_ground_state(
        sci_matvec_flat, ham, hd_g, davidson_initial_guess(hd_g, jnp.float64),
        tol=1e-9, max_subspace=20, max_iterations=200,
    )
    assert abs(float(r_dense.theta) - float(r_gather.theta)) < 1e-8


def test_solve_sci_dense_df_strategy():
    """Public API route: solve_sci(matvec_strategy='dense_df') == gather."""
    from sqd_tpu.fermion import solve_sci

    norb, nelec = 17, (3, 3)
    rng = np.random.default_rng(21)
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    ch = rng.normal(size=(3 * norb, norb, norb)) * (0.4 / np.sqrt(3 * norb))
    ch = (ch + ch.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", ch, ch)
    all_s = dense_fci.all_hamming_strings(norb, 3)
    sa = np.sort(rng.choice(all_s, 25, replace=False))
    sb = np.sort(rng.choice(all_s, 25, replace=False))
    r_dense = solve_sci((sa, sb), h1, eri, norb, nelec, spin_sq=None,
                        matvec_strategy="dense_df")
    r_gather = solve_sci((sa, sb), h1, eri, norb, nelec, spin_sq=None)
    assert abs(r_dense.energy - r_gather.energy) < 1e-8
    np.testing.assert_allclose(
        r_dense.orbital_occupancies[0], r_gather.orbital_occupancies[0], atol=1e-6
    )

    with pytest.raises(ValueError, match="spin"):
        solve_sci((sa, sb), h1, eri, norb, nelec, spin_sq=0.0,
                  matvec_strategy="dense_df")
    eri_bad = rng.normal(size=(norb,) * 4)
    eri_bad = eri_bad + eri_bad.transpose(1, 0, 2, 3)
    eri_bad = eri_bad + eri_bad.transpose(0, 1, 3, 2)
    eri_bad = eri_bad + eri_bad.transpose(2, 3, 0, 1)
    with pytest.raises(ValueError, match="PSD"):
        solve_sci((sa, sb), h1, eri_bad, norb, nelec, spin_sq=None,
                  matvec_strategy="dense_df")
    with pytest.raises(ValueError, match="matvec_strategy"):
        solve_sci((sa, sb), h1, eri, norb, nelec, matvec_strategy="bogus")


def test_densify_requires_factor_and_no_penalty():
    norb, nelec = 8, (4, 4)
    h1, eri, pa, pb = _problem(norb, nelec, 15, 15, seed=13)
    ham = build_sci_hamiltonian(pa, pb, h1, eri, norb, nelec, eri_factor=None)
    with pytest.raises(ValueError, match="factor"):
        densify(ham)
    ell = pivoted_cholesky_pairs(eri, norb)
    ham_pen = build_sci_hamiltonian(
        pa, pb, h1, eri, norb, nelec, eri_factor=ell, spin_shift=0.2
    )
    with pytest.raises(ValueError, match="spin penalty"):
        densify(ham_pen)
