"""Full-physics model tests: stability and climate sanity.

With no Fortran toolchain available, the correctness gates are physical:
bounded fields over multi-day integrations, sensible global-mean energetics,
positive precipitation, and conservation of the log-ps spectral mean.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from speedyml.core.config import ModelConfig
from speedyml.model import Speedy

@pytest.fixture(scope="module")
def model(continent_boundary):
    m = Speedy(ModelConfig(dtype="float64"), boundary=continent_boundary)
    m.initialize(year=1981, month=1)
    return m


def area_mean(m, g):
    wt_full = np.concatenate([m.dy.tables.wt, m.dy.tables.wt[::-1]]) / 2.0
    return float((g.mean(axis=-1) * wt_full).sum(axis=-1))


class TestClimatology:
    def test_boundary_fields_sane(self, model):
        c = model.clim
        assert 0.0 <= c.fmask.min() and c.fmask.max() <= 1.0
        assert c.sst12.min() >= 100.0 and c.sst12.max() < 320.0
        assert c.stl12.min() >= 150.0 and c.stl12.max() < 350.0
        assert (c.sice12 >= 0).all() and (c.sice12 <= 1).all()
        # the test continent's 5 km mountain survives preprocessing
        assert c.orog.max() > 4000.0

    def test_coupler_init(self, model):
        cs = model.coupler
        assert 200.0 < cs.sst_am.min() and cs.sst_am.max() < 310.0
        assert 200.0 < cs.stl_am.min() and cs.stl_am.max() < 330.0


class TestDiurnalTisr:
    """Hourly-resolved TISR fed to the reservoirs (mpires.f90:1676-1710):
    its daily mean must equal solar()'s fsol so train- and predict-time TISR
    statistics agree."""

    def _lats(self):
        lat = np.deg2rad(np.linspace(-87.0, 87.0, 48))
        return np.sin(lat), np.cos(lat)

    def test_daily_mean_matches_fsol(self):
        from speedyml.physics.constants import PP
        from speedyml.physics.radiation import diurnal_tisr, solar

        slat, clat = self._lats()
        for tyear in (0.0, 0.25, 0.45, 0.75):
            fsol = solar(tyear, 4.0 * PP.solc, slat, clat)
            hours = np.arange(0, 24, 0.05)
            acc = np.zeros((48, 96))
            for h in hours:
                acc += diurnal_tisr(tyear, h, slat, clat, 96)
            mean = (acc / len(hours)).mean(axis=1)      # diurnal+zonal mean
            np.testing.assert_allclose(mean, fsol, rtol=2e-3, atol=1e-3)

    def test_noon_peak_and_night_zero(self):
        from speedyml.physics.radiation import diurnal_tisr

        slat, clat = self._lats()
        t12 = diurnal_tisr(0.5, 12.0, slat, clat, 96)
        eq = t12[24]
        assert eq.argmax() == 0          # solar noon at Greenwich at 12 UTC
        assert eq[48] == 0.0             # antipode is night
        t00 = diurnal_tisr(0.5, 0.0, slat, clat, 96)
        assert t00[24].argmax() == 48    # noon at the date line at 00 UTC
        assert (t00 >= 0.0).all()


class TestFullPhysicsRun:
    def test_three_days_stable(self, model):
        acc = model.run_days(3)
        g = model.grid_view()
        assert not np.isnan(g["t"]).any()
        assert 150.0 < g["t"].min() and g["t"].max() < 350.0
        assert np.abs(g["u"]).max() < 150.0
        assert g["ps"].min() > 400.0 and g["ps"].max() < 1120.0
        # humidity within physical range (g/kg); small spectral negatives OK
        assert g["q"].min() > -2.0 and g["q"].max() < 35.0

        # precipitation exists and is non-negative in the daily mean
        precip = np.asarray(acc.precip)
        assert precip.max() > 0.0
        assert precip.min() >= -1e-10

        # global radiative balance within plausible range after spin-up days
        tsr = area_mean(model, np.asarray(acc.tsr))
        olr = area_mean(model, np.asarray(acc.olr))
        assert 150.0 < tsr < 400.0
        assert 150.0 < olr < 350.0

    def test_winds_spin_up(self, model):
        """After a few days from rest, jets must develop (u > 5 m/s)."""
        g = model.grid_view()
        assert np.abs(g["u"]).max() > 5.0

    def test_mean_logps_im_zero(self, model):
        s = model.state
        # imaginary slot of the zonal-mean coefficient stays exactly zero
        assert abs(float(np.asarray(s.ps[0][0, 1, 0]))) < 1e-12
