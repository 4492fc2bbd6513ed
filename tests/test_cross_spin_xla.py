# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The XLA cross-spin matvec paths at a padded (48 x 128) shape vs the dense oracle.

Every strategy ``SCIHamiltonian.matvec`` can dispatch to — the unblocked
full path, the alpha-first two-pass blocked path and both beta-first
single-pass variants — with and without the fused spin penalty, on
generic (non-Hubbard) integrals and a padded subspace whose padding must
stay inert.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from sqd_tpu.models.hubbard import hubbard_integrals
from sqd_tpu.ops import bitpack, dense_fci
from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian

NORB, NELEC = 8, (3, 3)
M, N = 48, 40  # padded to (48, 128)


def _sym2(rng, norb):
    a = rng.normal(size=(norb, norb))
    return (a + a.T) / 2


def _sym4(rng, norb):
    e = rng.normal(size=(norb,) * 4)
    e = e + e.transpose(1, 0, 2, 3)
    e = e + e.transpose(0, 1, 3, 2)
    e = e + e.transpose(2, 3, 0, 1)
    return e / 8


@pytest.fixture(scope="module")
def problem():
    h1, eri = hubbard_integrals(NORB, u=4.0)
    # make the integrals generic (break Hubbard sparsity)
    rng = np.random.default_rng(3)
    h1 = h1 + 0.05 * _sym2(rng, NORB)
    eri = eri + 0.05 * _sym4(rng, NORB)
    allstr = dense_fci.all_hamming_strings(NORB, 3)
    sel_a = np.sort(rng.choice(allstr, M, replace=False))
    sel_b = np.sort(rng.choice(allstr, N, replace=False))
    ham = build_sci_hamiltonian(
        bitpack.pack_ints(sel_a, NORB), bitpack.pack_ints(sel_b, NORB), h1, eri,
        NORB, NELEC, dtype=jnp.float64, pad_to=(48, 128), col_block=32,
    )
    h_dense = dense_fci.build_dense_hamiltonian(sel_a, sel_b, h1, eri)
    s2_dense = dense_fci.build_dense_s2(sel_a, sel_b, NORB)
    v = rng.normal(size=(M, N))
    return ham, h_dense, s2_dense, v


_PATHS = {
    "full": lambda h, c: h._matvec_full(c),
    "blocked_alpha_first": lambda h, c: h._matvec_blocked(c),
    "blocked_beta_first": lambda h, c: h._SCIHamiltonian__matvec_blocked_beta_first(c),
    "blocked_beta_first_rowmajor": (
        lambda h, c: h._SCIHamiltonian__matvec_blocked_beta_first_rowmajor(c)
    ),
}


@pytest.mark.parametrize("shift", [0.0, 0.35])
@pytest.mark.parametrize("path", list(_PATHS))
def test_cross_spin_path_matches_dense(problem, path, shift):
    ham, h_dense, s2_dense, v = problem
    ham = dataclasses.replace(ham, spin_shift=shift, spin_target=2.0 if shift else 0.0)
    assert ham.shape == (48, 128)
    c = np.zeros(ham.shape)
    c[:M, :N] = v
    out = np.asarray(_PATHS[path](ham, jnp.asarray(c)))
    flat = v.reshape(-1)
    want = h_dense @ flat
    if shift:
        want = want + shift * (s2_dense @ flat - 2.0 * flat)
    np.testing.assert_allclose(out[:M, :N], want.reshape(M, N), atol=1e-10)
    # padded determinants stay exactly zero
    assert np.all(out[M:, :] == 0) and np.all(out[:, N:] == 0)


def test_f32_dispatch_matches_dense(problem):
    """``matvec`` in f32 picks the blocked path here and keeps f32 accuracy."""
    ham, h_dense, _, v = problem
    ham32 = ham.astype(jnp.float32)
    assert ham32.col_block and ham32.shape[1] > ham32.col_block
    c = np.zeros(ham.shape, np.float32)
    c[:M, :N] = v
    out = np.asarray(ham32.matvec(jnp.asarray(c)), np.float64)[:M, :N]
    want = (h_dense @ v.reshape(-1)).reshape(M, N)
    assert np.linalg.norm(out - want) / np.linalg.norm(want) < 1e-5
