"""SPPT: stochastically perturbed parametrization tendencies.

Re-design of the reference's spectral AR(1) noise module
(src/mod_sppt.f90, after Palmer et al. 2009): the AR(1) state is an explicit
carry (no module globals), randomness comes from a threaded jax.random key
(deterministic, splittable — SURVEY.md section 5.2), and the per-step update
+ spectral->grid transform is one fused jittable function.

Usage:
    sppt = Sppt(dy)                       # precompute sigma / phi / mu
    state = sppt.init(key)                # first AR(1) sample
    state, pattern = sppt.step(state, key)    # (kx, il, ix) in [-1, 1]
    tend_perturbed = tend * (1 + pattern * mu[:, None, None])
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.constants import PHYS


class SpptState(NamedTuple):
    spec: jax.Array    # (kx, mx, 2, nx) AR(1) spectral state


class Sppt:
    # decorrelation time [h], length scale [m], grid-space stddev
    TIME_DECORR = 6.0
    LEN_DECORR = 5.0e5
    STDDEV = 0.33

    def __init__(self, dy, mu=None):
        self.dy = dy
        cfg = dy.config
        self.mu = np.ones(cfg.kx) if mu is None else np.asarray(mu)
        # time autocorrelation per step (mod_sppt.f90:29)
        self.phi = float(np.exp(-(24.0 / cfg.nsteps) / self.TIME_DECORR))
        # wavenumber-wise sigma (mod_sppt.f90:73-79)
        rearth = PHYS.rearth
        n = np.arange(1, cfg.ntrun + 1)
        f0 = np.sum((2 * n + 1) * np.exp(
            -0.5 * (self.LEN_DECORR / rearth) ** 2 * n * (n + 1)))
        f0 = np.sqrt(self.STDDEV ** 2 * (1 - self.phi ** 2) / (2 * f0))
        el2 = np.asarray(dy.T.el2)            # (mx, 1, nx), l(l+1)/a^2
        np_dtype = np.float64 if dy.dtype == jnp.float64 else np.float32
        self.sigma = np.asarray(
            f0 * np.exp(-0.25 * self.LEN_DECORR ** 2 * el2), np_dtype)

    def _noise(self, key, shape):
        eta = jax.random.normal(key, shape, self.dy.dtype)
        return jnp.clip(eta, -10.0, 10.0)     # mod_sppt.f90:63-66

    def init(self, key) -> SpptState:
        cfg = self.dy.config
        eta = self._noise(key, (cfg.kx, cfg.mx, 2, cfg.nx))
        spec = (1 - self.phi ** 2) ** (-0.5) * self.sigma * eta
        return SpptState(spec=spec)

    def step(self, state: SpptState, key):
        """One AR(1) step; returns (new_state, grid pattern (kx, il, ix)
        clipped to [-1, 1])."""
        cfg = self.dy.config
        eta = self._noise(key, (cfg.kx, cfg.mx, 2, cfg.nx))
        spec = self.phi * state.spec + self.sigma * eta
        grid = self.dy.T.spec_to_grid(spec)
        return SpptState(spec=spec), jnp.clip(grid, -1.0, 1.0)
