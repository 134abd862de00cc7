"""Lennard-Jones 12-6 potential for Cu (reference: src-mpi/ljForce.c:101-120).

Copy of comd_tpu.potentials.lj (same fields, defaults and ``describe``
lines), so both packages hold the same parameters.  Parameters from Wolf &
Phillpot (sigma = 2.315 A, epsilon = 0.167 eV) with the POT_SHIFT = 1.0
energy shift so U(rCut) = 0 (ljForce.c:83, 166-167).  The pair arithmetic
lives in ops/force_lj.py and the CUDA kernel (csrc/stencil.cu); this module
is parameters only.

Cutoff: 2.5 sigma by default, the value behind the documented cohesive
energy -1.243619295058 (CoMD.c:896); ``--ljCutoffFactor 5`` selects the
reference fork's 5 sigma (ljForce.c:114), whose T = 0 cohesive energy is
-1.406590686466 eV/atom and whose commensurate cells hold ~256 atoms.
"""
from __future__ import annotations

import dataclasses

from ..constants import AMU_TO_INTERNAL_MASS

POT_SHIFT = 1.0


@dataclasses.dataclass(frozen=True)
class LjPotential:
    name: str = "Cu"
    atomic_no: int = 29
    sigma: float = 2.315                  # Angstrom
    epsilon: float = 0.167                # eV
    mass: float = 63.55 * AMU_TO_INTERNAL_MASS
    lat: float = 3.615                    # Angstrom
    lattice_type: str = "FCC"
    cutoff: float = 2.5 * 2.315           # 2.5 * sigma (see module docstring)

    @property
    def s6(self) -> float:
        return self.sigma ** 6

    @property
    def e_shift(self) -> float:
        """POT_SHIFT * rCut6 * (rCut6 - 1), ljForce.c:166-167."""
        r_cut2 = self.cutoff * self.cutoff
        r_cut6 = self.s6 / (r_cut2 * r_cut2 * r_cut2)
        return POT_SHIFT * r_cut6 * (r_cut6 - 1.0)

    def describe(self) -> list[tuple[str, str]]:
        return [
            ("Potential type", "Lennard-Jones"),
            ("Species name", self.name),
            ("Atomic number", str(self.atomic_no)),
            ("Mass", f"{self.mass / AMU_TO_INTERNAL_MASS:g} amu"),
            ("Lattice Type", self.lattice_type),
            ("Lattice spacing", f"{self.lat:g} Angstroms"),
            ("Cutoff", f"{self.cutoff:g} Angstroms"),
            ("Epsilon", f"{self.epsilon:g} eV"),
            ("Sigma", f"{self.sigma:g} Angstroms"),
        ]


def init_lj_pot(cutoff_factor: float = 2.5) -> LjPotential:
    """``cutoff_factor``: cutoff in units of sigma.  2.5 (default) matches
    the upstream CoMD golden; 5.0 is the reference fork's ljForce.c:114."""
    return LjPotential(cutoff=cutoff_factor * LjPotential.sigma)
