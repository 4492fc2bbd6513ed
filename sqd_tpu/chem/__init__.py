# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Real-molecule input layer: Gaussian integrals, RHF, CASCI active spaces.

The PySCF stand-in for this framework — enough quantum chemistry to validate
the device solvers on the reference's actual molecular benchmarks (N2 at
STO-3G/6-31G) without any external chemistry package in the image.
"""

from .active_space import active_space_integrals, mo_eri
from .integrals import Molecule, ao_integrals, nuclear_repulsion
from .scf import RHFResult, rhf
from .scf_open import ROHFResult, UHFResult, rohf, uhf

__all__ = [
    "Molecule",
    "RHFResult",
    "ROHFResult",
    "UHFResult",
    "active_space_integrals",
    "ao_integrals",
    "mo_eri",
    "nuclear_repulsion",
    "rhf",
    "rohf",
    "uhf",
]
