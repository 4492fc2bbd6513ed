# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Real-molecule validation: integral engine, RHF, CASCI vs published energies.

The two numerical pins come straight from the reference's executed guides:

* N2/6-31G at 1.0 A: RHF total energy -108.835236570774 Ha
  (``/root/reference/docs/guides/integrate_dice_solver.ipynb`` cell-1 output)
  — 12 significant digits, so it pins basis data + all AO integrals + SCF.
* N2/STO-3G at 1.09768 A, CAS(8o, 10e): total energy -107.652521 Ha
  (``/root/reference/docs/guides/quickstart.ipynb`` cell-6 output) — pins the
  frozen-core transform and the production SCI solver on real chemistry.
"""

from __future__ import annotations

import numpy as np
import pytest
import scipy.linalg

from sqd_tpu.chem import (
    Molecule,
    active_space_integrals,
    ao_integrals,
    nuclear_repulsion,
    rhf,
)

N2_631G_RHF = -108.835236570774  # integrate_dice_solver.ipynb cell 1
N2_631G_CASCI = -109.046671778080  # integrate_dice_solver.ipynb cell 1
N2_STO3G_CASCI = -107.652521  # quickstart.ipynb cell 6 (6 decimals printed)


@pytest.fixture(scope="module")
def n2_sto3g():
    mol = Molecule([("N", (0, 0, 0)), ("N", (0, 0, 1.09768))], basis="sto-3g")
    return rhf(mol)


@pytest.fixture(scope="module")
def n2_631g():
    mol = Molecule([("N", (0, 0, 0)), ("N", (1.0, 0, 0))], basis="6-31g")
    return rhf(mol)


def test_h_atom_one_electron_energy():
    # textbook value for the STO-3G hydrogen ground state
    mol = Molecule([("H", (0, 0, 0))], basis="sto-3g")
    S, T, V, _ = ao_integrals(mol)
    w = scipy.linalg.eigh(T + V, S, eigvals_only=True)
    assert abs(w[0] - (-0.46658185)) < 1e-7


def test_integral_symmetries():
    mol = Molecule([("N", (0, 0, 0)), ("H", (0.9, 0.15, -0.2))], basis="sto-3g", charge=1)
    S, T, V, eri = ao_integrals(mol)
    n = mol.nao
    np.testing.assert_allclose(S, S.T, atol=1e-14)
    np.testing.assert_allclose(T, T.T, atol=1e-14)
    np.testing.assert_allclose(V, V.T, atol=1e-12)
    assert np.allclose(np.diag(S), 1.0, atol=1e-12)  # normalized AOs
    # chemist-notation 8-fold symmetry
    np.testing.assert_allclose(eri, eri.transpose(1, 0, 2, 3), atol=1e-12)
    np.testing.assert_allclose(eri, eri.transpose(0, 1, 3, 2), atol=1e-12)
    np.testing.assert_allclose(eri, eri.transpose(2, 3, 0, 1), atol=1e-12)
    # (pq|rs) as a matrix over pair indices is PSD (Coulomb metric)
    w = np.linalg.eigvalsh(eri.reshape(n * n, n * n))
    assert w.min() > -1e-10


def test_translation_rotation_invariance():
    ref = rhf(Molecule([("N", (0, 0, 0)), ("N", (0, 0, 1.09768))], basis="sto-3g"))
    # same molecule, shifted and pointed along a skew axis
    d = np.array([0.63, -0.74, 0.23])
    d = d / np.linalg.norm(d) * 1.09768
    moved = rhf(Molecule([("N", (1.0, -2.0, 0.5)), ("N", tuple(np.array([1.0, -2.0, 0.5]) + d))], basis="sto-3g"))
    assert abs(ref.e_tot - moved.e_tot) < 1e-9


def test_n2_631g_rhf_pin(n2_631g):
    assert n2_631g.converged
    assert abs(n2_631g.e_tot - N2_631G_RHF) < 1e-9


def test_n2_sto3g_rhf_ground_solution(n2_sto3g):
    # The core-guess DIIS saddle sits at -106.766097; the ground SCF solution
    # (reached via the frontier-rotation escape) is 0.73 Ha below it.
    assert n2_sto3g.converged
    assert abs(n2_sto3g.e_tot - (-107.495887833)) < 1e-8


def test_hf_determinant_matches_rhf(n2_631g):
    # CAS energy of the single Hartree-Fock determinant == RHF total energy:
    # pins active_space_integrals (h1_eff, ecore) independently of basis data
    from sqd_tpu.fermion import solve_sci

    h1, eri, ecore = active_space_integrals(n2_631g, ncas=16, nelecas=10)
    hf = np.array([(1 << 5) - 1], dtype=np.int64)
    res = solve_sci((hf, hf), h1, eri, 16, (5, 5))
    assert abs(res.energy + ecore - n2_631g.e_tot) < 1e-10


def test_n2_sto3g_casci_pin(n2_sto3g):
    # reproduce the reference quickstart's exact FCI energy with the
    # production solver over the full CAS(8o,10e) determinant space
    from sqd_tpu.fermion import solve_sci
    from sqd_tpu.ops.dense_fci import all_hamming_strings

    h1, eri, ecore = active_space_integrals(n2_sto3g, ncas=8, nelecas=10)
    strs = all_hamming_strings(8, 5)
    res = solve_sci((strs, strs), h1, eri, 8, (5, 5), tol=1e-10)
    e_tot = res.energy + ecore
    assert abs(e_tot - N2_STO3G_CASCI) < 5e-7  # pin printed to 6 decimals
    # spin-resolved occupancies sum to the electron counts
    occ_a, occ_b = res.orbital_occupancies
    assert abs(occ_a.sum() - 5) < 1e-8
    assert abs(occ_b.sum() - 5) < 1e-8


def test_no_core_ecore_is_nuclear_repulsion(n2_sto3g):
    h1, eri, ecore = active_space_integrals(n2_sto3g, ncas=10, nelecas=14)
    assert abs(ecore - nuclear_repulsion(n2_sto3g.mol)) < 1e-12
    assert h1.shape == (10, 10)


def test_error_paths():
    with pytest.raises(ValueError, match="Unknown basis"):
        Molecule([("H", (0, 0, 0))], basis="nope")
    with pytest.raises(ValueError, match="No 'sto-3g' data for element 'Ne'"):
        Molecule([("Ne", (0, 0, 0))], basis="sto-3g")
    with pytest.raises(ValueError, match="even electron count"):
        rhf(Molecule([("H", (0, 0, 0))], basis="sto-3g"))
    mf = rhf(Molecule([("H", (0, 0, 0)), ("H", (0, 0, 0.74))], basis="sto-3g"))
    with pytest.raises(ValueError, match="exceeds"):
        active_space_integrals(mf, ncas=9, nelecas=2)
    with pytest.raises(ValueError, match="must be even"):
        active_space_integrals(mf, ncas=1, nelecas=1)
