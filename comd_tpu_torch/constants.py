"""Physical constants and unit conversions.

Units (identical to the reference CoMD convention, src-mpi/constants.h:1-41):
  - time in femtoseconds (fs)
  - length in Angstroms (Angs)
  - energy in electron volts (eV)
  - mass in eV * fs^2 / Ang^2 (converted from amu on input)
"""

AMU_IN_KILOGRAMS = 1.660538921e-27
FS_IN_SECONDS = 1.0e-15
ANGS_IN_METERS = 1.0e-10
EV_IN_JOULES = 1.602176565e-19

#: 1 amu expressed in internal mass units (eV fs^2 / Ang^2).
AMU_TO_INTERNAL_MASS = (
    AMU_IN_KILOGRAMS * ANGS_IN_METERS * ANGS_IN_METERS
    / (FS_IN_SECONDS * FS_IN_SECONDS * EV_IN_JOULES)
)

#: Boltzmann constant in eV/K (src-mpi/constants.h:33).
KB_EV = 8.6173324e-5

#: Hartree -> eV (src-mpi/constants.h:36).
HARTREE_TO_EV = 27.21138505

#: Bohr -> Angstrom (src-mpi/constants.h:39).
BOHR_TO_ANGS = 0.52917721092
