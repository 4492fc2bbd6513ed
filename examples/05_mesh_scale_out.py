# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Scale SQD batches over a device mesh (the reference's Dice-solver scenario).

Mirrors docs/guides/integrate_dice_solver.ipynb: the reference swaps in an
MPI-based C++ solver through the ``sci_solver`` seam to parallelize the
embarrassingly-parallel batch diagonalizations.  Here the same seam takes
the mesh-sharded native solver: every batch Hamiltonian is stacked and one
jitted, vmapped Davidson runs with the batch axis sharded across devices.

Run with a virtual mesh on CPU:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/05_mesh_scale_out.py
"""

import numpy as np

import jax

from sqd_tpu import BitArray, diagonalize_fermionic_hamiltonian
from sqd_tpu.models.hubbard import hubbard_integrals
from sqd_tpu.ops import dense_fci
from sqd_tpu.parallel import solve_sci_batch_sharded


def main():
    print(f"devices: {jax.devices()}")
    norb, nelec = 6, (3, 3)
    h1, eri = hubbard_integrals(norb, u=4.0)

    strs = dense_fci.all_hamming_strings(norb, nelec[0])
    h_dense = dense_fci.build_dense_hamiltonian(strs, strs, h1, eri)
    evals, evecs = np.linalg.eigh(h_dense)
    probs = np.abs(evecs[:, 0]) ** 2
    probs /= probs.sum()

    rng = np.random.default_rng(0)
    n = len(strs)
    draws = rng.choice(n * n, size=5000, p=probs)
    rows = []
    for d in draws:
        sa, sb = int(strs[d // n]), int(strs[d % n])
        row = np.zeros(2 * norb, dtype=bool)
        for p in range(norb):
            if (sb >> p) & 1:
                row[norb - 1 - p] = True
            if (sa >> p) & 1:
                row[2 * norb - 1 - p] = True
        rows.append(row)
    bit_array = BitArray.from_bool_array(np.array(rows))

    result = diagonalize_fermionic_hamiltonian(
        h1,
        eri,
        bit_array,
        samples_per_batch=40,
        norb=norb,
        nelec=nelec,
        num_batches=len(jax.devices()),  # one batch per device
        max_iterations=4,
        seed=7,
        sci_solver=solve_sci_batch_sharded,  # <- the parallelism seam
    )
    print(f"SQD energy (mesh-sharded batches): {result.energy:.8f}")
    print(f"exact:                             {evals[0]:.8f}")


if __name__ == "__main__":
    main()
