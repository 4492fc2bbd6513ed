# (C) 2026. Licensed under the Apache License, Version 2.0.
"""The host-NumPy f64 oracle (sqd_tpu.ops.host_oracle) vs the dense FCI oracle."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from sqd_tpu.ops import bitpack, dense_fci
from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian
from sqd_tpu.ops.host_oracle import host_matvec, host_rayleigh_quotient


def _problem(pad_to=None):
    rng = np.random.default_rng(17)
    norb = 6
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    chol = rng.normal(size=(10, norb, norb)) * 0.3
    chol = (chol + chol.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", chol, chol)
    allstr = dense_fci.all_hamming_strings(norb, 3)
    sel_a = np.sort(rng.choice(allstr, 13, replace=False))
    sel_b = np.sort(rng.choice(allstr, 11, replace=False))
    ham = build_sci_hamiltonian(
        bitpack.pack_ints(sel_a, norb), bitpack.pack_ints(sel_b, norb), h1, eri,
        norb, (3, 3), dtype=jnp.float64, pad_to=pad_to,
    )
    return ham, dense_fci.build_dense_hamiltonian(sel_a, sel_b, h1, eri), rng


@pytest.mark.parametrize("pad_to", [None, (16, 32)])
def test_host_matvec_matches_dense(pad_to):
    ham, h_dense, rng = _problem(pad_to)
    v = rng.normal(size=(13, 11))
    for row_block in (4, 64):
        out = host_matvec(ham, v, row_block=row_block)
        assert out.shape == ham.shape
        np.testing.assert_allclose(out[:13, :11], (h_dense @ v.reshape(-1)).reshape(13, 11),
                                   atol=1e-11)
        assert np.all(out[13:, :] == 0) and np.all(out[:, 11:] == 0)


def test_host_rayleigh_quotient_matches_dense():
    ham, h_dense, rng = _problem((16, 32))
    evals, evecs = np.linalg.eigh(h_dense)
    assert host_rayleigh_quotient(ham, evecs[:, 0].reshape(13, 11)) == pytest.approx(
        evals[0], abs=1e-11
    )
    v = rng.normal(size=(13, 11))
    want = v.reshape(-1) @ h_dense @ v.reshape(-1) / (v.reshape(-1) @ v.reshape(-1))
    assert host_rayleigh_quotient(ham, v) == pytest.approx(want, abs=1e-11)
    with pytest.raises(ValueError, match="spin_shift"):
        host_matvec(dataclasses.replace(ham, spin_shift=0.1), v)
