"""Embedded Atom Model potential: table readers and parameters.

Implements the DYNAMO funcfl/setfl file formats exactly as the reference
readers do (src-mpi/eam.c:680-872), including the Z(r) -> phi(r) electrostatic
conversion with Hartree*Bohr units for funcfl and the r*phi(r) -> phi(r)
division for setfl, and the linear extrapolation for phi at r=0.

Copied from comd_tpu.potentials.eam so both packages read identical tables
and fit identical Chebyshev coefficients.  The three-pass force algorithm
itself (pair phi + density accumulation, embedding term, embedding force
with the mid-force dfEmbed halo fill; eam.c:44-86) lives in
ops/force_eam.py.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

from ..constants import AMU_TO_INTERNAL_MASS, HARTREE_TO_EV, BOHR_TO_ANGS
from .tables import InterpTable


@dataclasses.dataclass(frozen=True)
class EamPotential:
    name: str
    atomic_no: int
    mass: float          # internal units
    lat: float
    lattice_type: str
    cutoff: float
    phi: InterpTable     # pair potential phi(r)
    rho: InterpTable     # electron density rho(r)
    f: InterpTable       # embedding energy F(rhobar)

    # Chebyshev fit range for the fused evaluator (interp_impl 'cheb').
    # r < CHEB_R_LO clamps (constant energy, repulsive force) -- 2.0 A is
    # 6+ thermal sigma below the Cu nearest-neighbor distance.
    CHEB_R_LO = 2.0

    @functools.cached_property
    def cheb_pair(self):
        """Shared-basis fit of (phi, rho): one basis recurrence feeds all
        four pair-pass outputs (tables.ChebFused)."""
        from .tables import make_cheb_fused
        return make_cheb_fused({"phi": self.phi, "rho": self.rho},
                               self.CHEB_R_LO, self.cutoff)

    def describe(self) -> list[tuple[str, str]]:
        return [
            ("Potential type", "EAM"),
            ("Species name", self.name),
            ("Atomic number", str(self.atomic_no)),
            ("Mass", f"{self.mass / AMU_TO_INTERNAL_MASS:g} amu"),
            ("Lattice type", self.lattice_type),
            ("Lattice spacing", f"{self.lat:g} Angstroms"),
            ("Cutoff", f"{self.cutoff:g} Angstroms"),
        ]


def _read_floats(tokens: list[str], n: int, pos: int) -> tuple[np.ndarray, int]:
    vals = np.array([float(t) for t in tokens[pos:pos + n]], dtype=np.float64)
    assert vals.shape == (n,), f"expected {n} values, got {vals.shape}"
    return vals, pos + n


def read_funcfl(path: str) -> EamPotential:
    """funcfl single-element format (eam.c:802-872).

    Layout: comment line; ``elem amass lat latType``; ``nrho drho nr dr
    rcutoff``; F(rhobar) nrho values; Z(r) nr values; rho(r) nr values.
    phi(r) = Z(r)^2/r * hartreeToEv*bohrToAngs; phi(0) linearly extrapolated.
    """
    with open(path) as fh:
        lines = fh.read().splitlines()
    name = lines[0].split()[0][:2]
    hdr = lines[1].split()
    atomic_no, mass, lat, lattice_type = (
        int(hdr[0]), float(hdr[1]), float(hdr[2]), hdr[3])
    hdr = lines[2].split()
    n_rho, d_rho, n_r, d_r, cutoff = (
        int(hdr[0]), float(hdr[1]), int(hdr[2]), float(hdr[3]), float(hdr[4]))

    tokens = " ".join(lines[3:]).split()
    pos = 0
    f_vals, pos = _read_floats(tokens, n_rho, pos)
    z_vals, pos = _read_floats(tokens, n_r, pos)
    rho_vals, pos = _read_floats(tokens, n_r, pos)

    x0 = 0.0
    r = x0 + np.arange(n_r) * d_r
    phi_vals = z_vals.copy()
    phi_vals[1:] = z_vals[1:] * z_vals[1:] / r[1:] * (HARTREE_TO_EV * BOHR_TO_ANGS)
    phi_vals[0] = phi_vals[1] + (phi_vals[1] - phi_vals[2])

    return EamPotential(
        name=name, atomic_no=atomic_no, mass=mass * AMU_TO_INTERNAL_MASS,
        lat=lat, lattice_type=lattice_type, cutoff=cutoff,
        phi=InterpTable.from_data(n_r, x0, d_r, phi_vals),
        rho=InterpTable.from_data(n_r, x0, d_r, rho_vals),
        f=InterpTable.from_data(n_rho, x0, d_rho, f_vals),
    )


def read_setfl(path: str) -> EamPotential:
    """setfl single-element format (eam.c:680-757).

    Layout: 3 comment lines; ``ntypes ...``; ``nrho drho nr dr rcutoff``;
    per-type header + F + rho blocks; then r*phi(r) blocks.  Restricted to
    one element, like the reference (notAlloyReady, eam.c:702-703).
    """
    with open(path) as fh:
        lines = fh.read().splitlines()
    n_elems = int(lines[3].split()[0])
    if n_elems != 1:
        raise ValueError("setfl files with multiple species are not supported "
                         "(reference parity: eam.c:881-887)")
    hdr = lines[4].split()
    n_rho, d_rho, n_r, d_r, cutoff = (
        int(hdr[0]), float(hdr[1]), int(hdr[2]), float(hdr[3]), float(hdr[4]))
    hdr = lines[5].split()
    atomic_no, mass, lat, lattice_type = (
        int(hdr[0]), float(hdr[1]), float(hdr[2]), hdr[3])

    tokens = " ".join(lines[6:]).split()
    pos = 0
    f_vals, pos = _read_floats(tokens, n_rho, pos)
    rho_vals, pos = _read_floats(tokens, n_r, pos)
    rphi_vals, pos = _read_floats(tokens, n_r, pos)

    x0 = 0.0
    r = x0 + np.arange(n_r) * d_r
    phi_vals = rphi_vals.copy()
    phi_vals[1:] = rphi_vals[1:] / r[1:]
    phi_vals[0] = phi_vals[1] + (phi_vals[1] - phi_vals[2])

    return EamPotential(
        name=lines[0].split()[0][:2] if lines[0].split() else "Cu",
        atomic_no=atomic_no, mass=mass * AMU_TO_INTERNAL_MASS,
        lat=lat, lattice_type=lattice_type, cutoff=cutoff,
        phi=InterpTable.from_data(n_r, x0, d_r, phi_vals),
        rho=InterpTable.from_data(n_r, x0, d_r, rho_vals),
        f=InterpTable.from_data(n_rho, x0, d_rho, f_vals),
    )


def init_eam_pot(pot_dir: str, pot_name: str, pot_type: str) -> EamPotential:
    path = os.path.join(pot_dir, pot_name)
    if pot_type == "setfl":
        return read_setfl(path)
    if pot_type == "funcfl":
        return read_funcfl(path)
    raise ValueError(f"potential type {pot_type!r} not supported")
