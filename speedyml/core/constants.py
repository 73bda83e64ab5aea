"""Physical constants for the dynamical core and physics.

Re-design of the constants in the reference SPEEDY-ML model
(reference: src/mod_dyncon0.f90, src/mod_dyncon1.f90).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PhysicalConstants:
    """Planetary and thermodynamic constants (reference: mod_dyncon1.f90:12-29)."""

    rearth: float = 6.371e6      # Earth radius [m]
    omega: float = 7.292e-5      # rotation rate [1/s]
    grav: float = 9.81           # gravity [m/s^2]
    akap: float = 2.0 / 7.0      # R/cp
    cp: float = 1004.0           # specific heat of dry air [J/kg/K]

    @property
    def rgas(self) -> float:
        return self.akap * self.cp


@dataclasses.dataclass(frozen=True)
class DynamicsConstants:
    """Reference-atmosphere / diffusion constants (reference: mod_dyncon0.f90)."""

    gamma: float = 6.0       # ref. temperature lapse rate [-dT/dz, K/km]
    hscale: float = 7.5      # ref. scale height for pressure [km]
    hshum: float = 2.5       # ref. scale height for specific humidity [km]
    refrh1: float = 0.7      # ref. relative humidity of near-surface air
    thd: float = 2.4         # max damping time [h] for del^8 diffusion of T, vor
    thdd: float = 2.4        # max damping time [h] for del^8 diffusion of div
    thds: float = 12.0       # max damping time [h] for del^2 stratospheric diffusion
    tdrs: float = 24.0 * 30.0  # damping time [h] for stratospheric zonal-wind drag
    npowhd: int = 4          # power of Laplacian in horizontal diffusion


PHYS = PhysicalConstants()
DYN = DynamicsConstants()
