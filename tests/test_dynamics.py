"""Dry dynamical core tests.

The correctness gates: stability and physical sanity of the
T30L8 dry core over 100+ steps from a reference-atmosphere rest start, with
mountain orography (the continent_boundary fixture). With no physics, an
at-rest state over *flat* terrain is an exact steady state up to roundoff;
with orography the flow must spin up gravity waves that stay bounded under
the semi-implicit scheme.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from speedyml.core.config import ModelConfig
from speedyml.dynamics.core import Dycore
from speedyml.dynamics.initial import rest_state
from speedyml.dynamics.implicit import geopotential


@pytest.fixture(scope="module")
def dy_flat():
    return Dycore(ModelConfig(dtype="float64"))


@pytest.fixture(scope="module")
def dy_orog(continent_boundary):
    return Dycore(ModelConfig(dtype="float64"), orog=continent_boundary.orog)


def global_stats(dy, state):
    """Area-mean surface pressure [hPa] and mass-weighted mean T [K]."""
    T = dy.T
    psg = np.exp(np.asarray(T.spec_to_grid(state.ps[0]))) * 1013.0
    tg = np.asarray(T.spec_to_grid(state.t[0]))
    wt_full = np.concatenate([dy.tables.wt, dy.tables.wt[::-1]]) / 2.0
    area_mean = lambda g: float((g.mean(axis=-1) * wt_full).sum(axis=-1).mean())
    return area_mean(psg), area_mean(tg.mean(axis=0))


class TestRestState:
    def test_initial_profile(self, dy_orog):
        s = rest_state(dy_orog)
        ps_mean, t_mean = global_stats(dy_orog, s)
        assert 940 < ps_mean < 1020      # mountains lower the mean sfc pressure
        assert 230 < t_mean < 290

    def test_flat_rest_is_steady(self, dy_flat):
        """Over flat terrain with no physics, rest is an exact fixed point."""
        s0 = rest_state(dy_flat)
        forcing = dy_flat.zero_forcing()
        s = dy_flat.stepone(s0, forcing)
        s = dy_flat.run_steps(s, forcing, 20)
        # winds remain at rest to near machine precision
        assert float(jnp.abs(s.vor).max()) < 1e-12
        assert float(jnp.abs(s.div).max()) < 1e-10
        np.testing.assert_allclose(np.asarray(s.ps[0]), np.asarray(s0.ps[0]),
                                   atol=1e-10)


class TestDryCore100Steps:
    def test_stability_and_conservation(self, dy_orog):
        """100 dry leapfrog steps over mountains: bounded, conservative."""
        s = rest_state(dy_orog)
        forcing = dy_orog.zero_forcing()
        ps0, t0 = global_stats(dy_orog, s)
        s = dy_orog.stepone(s, forcing)
        s = dy_orog.run_steps(s, forcing, 100)
        assert not np.isnan(np.asarray(s.t)).any()

        ps1, t1 = global_stats(dy_orog, s)
        # the (0,0) coefficient of log-ps is exactly conserved
        # (psdt(0,0)=0 each step, dyn_grtend.f90:103); mean pressure itself
        # drifts only through the nonlinearity of exp(log-ps)
        np.testing.assert_allclose(float(np.asarray(s.ps[0][0, 0, 0])),
                                   float(np.asarray(rest_state(dy_orog).ps[0][0, 0, 0])),
                                   rtol=1e-12)
        assert abs(ps1 - ps0) < 0.1  # hPa
        # dry adiabatic core with del^8 diffusion: mean T moves only slightly
        assert abs(t1 - t0) < 1.0

        # physical bounds on the grid
        T = dy_orog.T
        tg = np.asarray(T.spec_to_grid(s.t[0]))
        ug, vg = dy_orog.T.uv_grid(s.vor[0], s.div[0])
        assert 150 < tg.min() and tg.max() < 350
        assert np.abs(np.asarray(ug)).max() < 150
        assert np.abs(np.asarray(vg)).max() < 150

    def test_longer_run_no_blowup(self, dy_orog):
        """One simulated day (96 steps more) stays bounded."""
        s = rest_state(dy_orog)
        forcing = dy_orog.zero_forcing()
        s = dy_orog.stepone(s, forcing)
        s = dy_orog.run_steps(s, forcing, 192)
        tg = np.asarray(dy_orog.T.spec_to_grid(s.t[0]))
        assert not np.isnan(tg).any()
        assert 150 < tg.min() and tg.max() < 350


class TestGeopotential:
    def test_hydrostatic_balance_at_rest(self, dy_orog):
        """phi at the surface-most level sits above the surface geopotential."""
        s = rest_state(dy_orog)
        phi = geopotential(s.t[0], dy_orog.phis, dy_orog.vg_jnp)
        phig = np.asarray(dy_orog.T.spec_to_grid(phi))
        phis_g = np.asarray(dy_orog.phis0_grid)
        assert (phig[-1] >= phis_g - 1e-6).all()
        # geopotential increases with height
        assert (np.diff(phig[::-1], axis=0) > 0).all()


class TestBf16GridCompute:
    """Opt-in reduced-precision grid-space tendency path
    (ModelConfig.grid_compute='bfloat16'): must stay stable and track the
    full-precision trajectory closely over a day. Precision-critical
    differences (T - tref, dtref) are computed before the downcast."""

    def test_one_day_tracks_f32(self, continent_boundary):
        bd = continent_boundary
        dy16 = Dycore(ModelConfig(grid_compute="bfloat16"), orog=bd.orog)
        dy32 = Dycore(ModelConfig(), orog=bd.orog)
        tgs = {}
        for tag, dy in (("bf16", dy16), ("f32", dy32)):
            s = dy.stepone(rest_state(dy), dy.zero_forcing())
            s = dy.run_steps(s, dy.zero_forcing(), 96)
            tg = np.asarray(dy.T.spec_to_grid(s.t[0]))
            assert np.isfinite(tg).all()
            tgs[tag] = tg
        d = tgs["bf16"] - tgs["f32"]
        # gravity-wave spin-up from rest over mountains reaches tens of
        # kelvin anomalies; the reduced-precision path must stay within a
        # small fraction of a kelvin of the full-precision trajectory
        assert np.sqrt((d ** 2).mean()) < 0.2
        assert np.abs(d).max() < 2.0
