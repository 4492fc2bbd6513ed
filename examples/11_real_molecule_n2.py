# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Quickstart on a real molecule: N2/STO-3G from raw geometry to the FCI energy.

Port of the reference quickstart
(``/root/reference/docs/guides/quickstart.ipynb``) with one upgrade: the
molecular integrals come from the built-in Gaussian-integral engine
(:mod:`sqd_tpu.chem`) instead of PySCF, so the whole pipeline — geometry ->
RHF -> CASCI active space -> uniform samples -> SQD loop -> exact FCI energy
-107.652521 Ha — runs inside this framework.
"""

import numpy as np


def main():
    from sqd_tpu.chem import Molecule, active_space_integrals, rhf
    from sqd_tpu.counts import generate_bit_array_uniform
    from sqd_tpu.fermion import SCIResult, diagonalize_fermionic_hamiltonian

    # --- Hamiltonian: N2 at the experimental bond length ------------------------
    mol = Molecule([("N", (0.0, 0.0, 0.0)), ("N", (0.0, 0.0, 1.09768))], basis="sto-3g")
    mf = rhf(mol)
    print(f"RHF energy: {mf.e_tot:.9f} Ha (converged={mf.converged})")

    # CAS(8 orbitals, 10 electrons): freeze the two 1s cores, keep all valence
    num_orbitals = 8
    h1, eri, ecore = active_space_integrals(mf, ncas=num_orbitals, nelecas=10)
    nelec = (5, 5)
    print(f"Spatial orbitals: {num_orbitals}\nQubits: {num_orbitals * 2}\nElectrons (alpha, beta): {nelec}")

    # --- simulate QPU samples: uniformly-random bitstrings ----------------------
    rng = np.random.default_rng(24)
    bit_array = generate_bit_array_uniform(10_000, num_orbitals * 2, rand_seed=rng)
    print(f"Generated {bit_array.num_shots} uniformly-random, {bit_array.num_bits}-qubit samples.")

    # --- SQD loop ----------------------------------------------------------------
    EXACT = -107.652521  # exact FCI energy printed by the reference quickstart

    result_history: list[list[SCIResult]] = []


    def callback(results: list[SCIResult]):
        result_history.append(results)
        iteration = len(result_history)
        print(f"Iteration {iteration}")
        for i, result in enumerate(results):
            e_tot = result.energy + ecore
            print(f"  Subsample {i}")
            print(f"    Energy: {e_tot:.6f}")
            print(f"    Subspace dimension: {np.prod(result.sci_state.amplitudes.shape)}")
            print(f"    Error vs exact: {e_tot - EXACT:.6f} Ha")


    result = diagonalize_fermionic_hamiltonian(
        h1,
        eri,
        bit_array,
        samples_per_batch=50,
        norb=num_orbitals,
        nelec=nelec,
        occupancies_tol=1e-7,
        max_iterations=30,
        symmetrize_spin=True,
        callback=callback,
        seed=np.random.default_rng(32),
    )

    e_final = result.energy + ecore
    print(f"\nFinal SQD energy:  {e_final:.6f} Ha")
    print(f"Published exact:   {EXACT:.6f} Ha")
    assert abs(e_final - EXACT) < 5e-7


if __name__ == "__main__":
    main()
