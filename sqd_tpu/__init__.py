# (C) 2026. Licensed under the Apache License, Version 2.0.
"""sqd_tpu — an accelerator-native framework for sample-based quantum diagonalization.

A from-scratch JAX/XLA re-design of the capabilities of
``qiskit-addon-sqd`` (reference v0.12.1): noisy quantum-computer samples are
repaired by statistical configuration recovery, subsampled into batches, and
the molecular Hamiltonian is projected into the sampled determinant subspace
and diagonalized — with every hot path (bitstring kernels, selected-CI
Hamiltonian application, Davidson/Lanczos eigensolvers, RDM contraction)
running on device, and independent batch diagonalizations sharded across a
device mesh.

Public modules (mirroring the reference's five-module surface):

* :mod:`sqd_tpu.counts` — sample ingestion and synthetic generators.
* :mod:`sqd_tpu.subsampling` — Hamming postselection and batch subsampling.
* :mod:`sqd_tpu.configuration_recovery` — vectorized configuration recovery.
* :mod:`sqd_tpu.fermion` — SCI solver stack and the SQD orchestrator.
* :mod:`sqd_tpu.qubit` — Pauli-operator projection and subspace eigensolve.

Plus device-side layers with no reference counterpart:

* :mod:`sqd_tpu.ops` — packed-bitstring, link-table, matvec, Davidson kernels.
* :mod:`sqd_tpu.parallel` — device-mesh sharding of batch diagonalizations.
* :mod:`sqd_tpu.models` — Hamiltonian builders (Hubbard, Heisenberg, FCIDUMP).
"""

from jax import config as _jax_config

# Like the reference (fermion.py:41, qubit.py:26), enable 64-bit types: CI
# arithmetic needs exact integers and the final energies are refined in f64.
_jax_config.update("jax_enable_x64", True)

__version__ = "0.3.1"

from .counts import (  # noqa: E402,F401
    bit_array_to_arrays,
    bitstring_matrix_to_integers,
    counts_to_arrays,
    generate_bit_array_uniform,
    generate_counts_bipartite_hamming,
    generate_counts_uniform,
    normalize_counts_dict,
)
from .configuration_recovery import recover_configurations  # noqa: E402,F401
from .subsampling import (  # noqa: E402,F401
    postselect_and_subsample,
    postselect_by_hamming_right_and_left,
    subsample,
)
from .fermion import (  # noqa: E402,F401
    SCIResult,
    SCIState,
    bitstring_matrix_to_ci_strs,
    diagonalize_fermionic_hamiltonian,
    enlarge_batch_from_transitions,
    optimize_orbitals,
    rotate_integrals,
    solve_fermion,
    solve_sci,
    solve_sci_batch,
)
from .primitives import BitArray, Pauli, SparsePauliOp  # noqa: E402,F401
from . import qubit  # noqa: E402,F401
