"""Quantitative per-scheme physics oracles.

Each test pins a conservation identity or closed-form value that a sign,
indexing, or unit error in a single scheme would break — the quantitative
complement to tests/test_physics.py's stability checks:

  * qsat vs the analytic formula + literature anchors (phy_shtorh.f90:36-56)
  * convection: column moist-static-energy + water closure (phy_convmf.f90)
  * large-scale condensation: latent heating = L * moisture sink
  * SW: TOA net input = column absorption + surface absorption
  * LW: column absorption = surface net upward - OLR
  * surface energy balance closure over sea and land (phy_suflux.f90)
  * global water budget over a multi-day full-model run: E - P = dW/dt
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from speedyml.physics.constants import PP, make_fband, make_sigma_tables

KX, IL, IX = 8, 6, 8


def _sigma_tables():
    # reference half levels (mod_dyncon1-style T30L8 distribution)
    hsg = np.array([0.000, 0.050, 0.140, 0.260, 0.420, 0.600, 0.770,
                    0.900, 1.000])
    return make_sigma_tables(hsg)


def _columns(seed=0):
    """Physically plausible (kx, il, ix) columns."""
    rng = np.random.default_rng(seed)
    st = _sigma_tables()
    sig = st.sig
    psa = 1.0 + 0.05 * rng.normal(size=(IL, IX))
    # temperature: warm surface, cold top, small noise
    tprof = 210.0 + 85.0 * sig**0.8
    ta = (tprof[:, None, None]
          + 3.0 * rng.normal(size=(KX, IL, IX))).astype(np.float64)
    from speedyml.physics.humidity import rel_hum
    pres = sig[:, None, None] * psa[None]
    rh = np.clip(0.5 + 0.35 * rng.normal(size=(KX, IL, IX)), 0.02, 1.15)
    rh[:2] = 0.01
    _, qsat = rel_hum(jnp.zeros((KX, IL, IX)), jnp.asarray(ta),
                      jnp.asarray(pres))
    qa = rh * np.asarray(qsat)
    return st, jnp.asarray(psa), jnp.asarray(ta), jnp.asarray(qa), \
        jnp.asarray(np.asarray(qsat)), jnp.asarray(rh)


class TestQsat:
    def test_analytic_formula(self):
        """qsat_gkg == the August-Roche-Magnus form with SPEEDY constants,
        computed independently with math.exp (phy_shtorh.f90:36-56)."""
        from speedyml.physics.humidity import qsat_gkg

        for t, p in ((300.0, 1.0), (273.16, 1.0), (250.0, 0.5),
                     (220.0, 0.2), (310.0, 1.05)):
            if t >= 273.16:
                e = 6.108e-3 * math.exp(17.269 * (t - 273.16) / (t - 35.86))
            else:
                e = 6.108e-3 * math.exp(21.875 * (t - 273.16) / (t - 7.66))
            want = 622.0 * e / (p - 0.378 * e)
            got = float(qsat_gkg(jnp.asarray(t), jnp.asarray(p)))
            assert abs(got - want) < 1e-6 * want, (t, p, got, want)

    def test_literature_anchors(self):
        """Magnitude anchors that catch unit errors: ~3.8 g/kg at 0C/1000hPa,
        ~22 g/kg at 300K/1000hPa (Wallace & Hobbs tables)."""
        from speedyml.physics.humidity import qsat_gkg

        q0 = float(qsat_gkg(jnp.asarray(273.16), jnp.asarray(1.0)))
        q300 = float(qsat_gkg(jnp.asarray(300.0), jnp.asarray(1.0)))
        assert 3.6 < q0 < 4.0, q0
        assert 21.0 < q300 < 24.0, q300
        # monotone in T, decreasing in p
        assert q300 > q0
        assert float(qsat_gkg(jnp.asarray(300.0), jnp.asarray(0.8))) > q300


class TestConvectionClosure:
    def test_mse_and_water_closure(self):
        """convmf's flux differences must telescope: column water change
        = -precnv and moist static energy is conserved
        (sum dfse = alhc * precnv), phy_convmf.f90 detrainment design."""
        from speedyml.physics.convection import convmf

        st, psa, ta, qa, qsat, rh = _columns(1)
        phig = jnp.cumsum(jnp.ones_like(ta) * 1500.0, axis=0)[::-1]
        se = PP.cp * ta + phig
        itop, cbmf, precnv, dfse, dfqa = convmf(st, psa, se, qa, qsat)
        precnv = np.asarray(precnv)
        assert precnv.max() > 0.0, "no convection triggered: test is vacuous"
        col_q = np.asarray(jnp.sum(dfqa, axis=0))
        col_se = np.asarray(jnp.sum(dfse, axis=0))
        scale = max(precnv.max(), 1e-12)
        np.testing.assert_allclose(col_q, -precnv, atol=1e-8 * scale)
        np.testing.assert_allclose(col_se, PP.alhc * precnv,
                                   atol=1e-8 * PP.alhc * scale)


class TestLscondClosure:
    def test_latent_heating_matches_moisture_sink(self):
        """Away from the dqmax cap, dtlsc = -(alhc/cp) dqlsc level by level,
        and precls equals the column moisture sink (phy_lscond.f90)."""
        from speedyml.physics.condensation import lscond

        st, psa, ta, qa, qsat, rh = _columns(2)
        qa = qa * 1.4          # force supersaturation vs rhref somewhere
        itop0 = jnp.full((IL, IX), KX, jnp.int32)
        itop, precls, dtlsc, dqlsc = lscond(st, psa, qa, qsat, itop0)
        precls = np.asarray(precls)
        assert precls.max() > 0.0, "no condensation: test is vacuous"

        # column budget: precls = -sum_k dsig*p0/g * dqlsc * psa
        pfact = st.dsig * PP.p0 / PP.gg
        want = -np.asarray(
            jnp.sum(jnp.asarray(pfact)[:, None, None] * dqlsc, axis=0)) \
            * np.asarray(psa)
        np.testing.assert_allclose(precls, want, rtol=1e-6,
                                   atol=1e-9 * precls.max())

        # level-wise energy consistency where the cap is slack
        dql = np.asarray(dqlsc)
        dtl = np.asarray(dtlsc)
        cap = 10.0 * st.sig[:, None, None] ** 2 \
            / (PP.trlsc * 3600.0) * np.asarray(psa) ** 2
        slack = (-dql) < 0.99 * cap
        lhs = dtl[slack]
        rhs = (PP.alhc / PP.cp) * (-dql[slack])
        np.testing.assert_allclose(lhs, rhs, rtol=1e-6, atol=1e-12)


class TestRadiationConservation:
    def _sw(self, seed=3):
        from speedyml.physics.radiation import SolarFields, radsw

        st, psa, ta, qa, qsat, rh = _columns(seed)
        rng = np.random.default_rng(seed)
        lat = np.linspace(-75, 75, IL)
        slat = np.sin(np.deg2rad(lat))
        clat = np.cos(np.deg2rad(lat))
        from speedyml.physics.radiation import sol_oz
        sol = sol_oz(0.4, slat, clat)
        sol = SolarFields(*(jnp.asarray(f) for f in sol))
        icltop = jnp.asarray(rng.integers(2, KX, size=(IL, IX)), jnp.int32)
        cloudc = jnp.asarray(rng.uniform(0, 1, size=(IL, IX)))
        clstr = jnp.asarray(rng.uniform(0, 0.3, size=(IL, IX)))
        alb = jnp.asarray(rng.uniform(0.05, 0.7, size=(IL, IX)))
        out = radsw(st, sol, psa, qa, icltop, cloudc, clstr, alb)
        return st, psa, ta, out

    def test_sw_column_conservation(self):
        """Net TOA input = atmospheric absorption + net surface absorption
        (every reflection/transmission in radsw must be accounted)."""
        st, psa, ta, out = self._sw()
        tsr = np.asarray(out.tsr)
        assert tsr.max() > 100.0
        lhs = tsr
        rhs = np.asarray(jnp.sum(out.dfabs, axis=0)) + np.asarray(out.ssr)
        np.testing.assert_allclose(lhs, rhs, rtol=1e-6,
                                   atol=1e-6 * tsr.max())
        # absorbed SW is non-negative in every layer
        assert float(jnp.min(out.dfabs)) > -1e-8 * tsr.max()

    def test_lw_column_conservation(self):
        """Column LW absorption = net surface upward LW - OLR
        (radlw down+up passes, incl. the epslw corrections)."""
        from speedyml.physics.radiation import radlw_down, radlw_up

        st, psa, ta, out = self._sw(4)
        slrd, dfabs, flux_bands, st4a1, st4a2 = radlw_down(
            st, out.tau2_lw, ta)
        ts = ta[KX - 1] + 2.0                    # a plausible skin temp
        fsfcu = PP.emisfc * PP.sbc * ts**4
        slr, olr, dfabs = radlw_up(st, out.tau2_lw, out.stratc, ta, ts,
                                   slrd, fsfcu, flux_bands, dfabs,
                                   st4a1, st4a2)
        lhs = np.asarray(jnp.sum(dfabs, axis=0))
        rhs = np.asarray(slr) - np.asarray(olr)
        scale = float(np.abs(np.asarray(olr)).max())
        assert scale > 100.0
        np.testing.assert_allclose(lhs, rhs, atol=1e-6 * scale)

    def test_olr_physical_range(self):
        """OLR magnitude anchor (Earth ~ 240 W/m2; broad band here)."""
        from speedyml.physics.radiation import radlw_down, radlw_up

        st, psa, ta, out = self._sw(5)
        slrd, dfabs, flux_bands, st4a1, st4a2 = radlw_down(
            st, out.tau2_lw, ta)
        ts = ta[KX - 1] + 1.0
        fsfcu = PP.emisfc * PP.sbc * ts**4
        _, olr, _ = radlw_up(st, out.tau2_lw, out.stratc, ta, ts, slrd,
                             fsfcu, flux_bands, dfabs, st4a1, st4a2)
        olr = np.asarray(olr)
        assert 100.0 < olr.mean() < 350.0, olr.mean()


class TestSurfaceEnergyBalance:
    def _suflux(self, fmask_val, seed=6):
        from speedyml.physics.surface import sflset, suflux

        st, psa, ta, qa, qsat, rh = _columns(seed)
        rng = np.random.default_rng(seed)
        lat = np.linspace(-75, 75, IL)
        clat = jnp.asarray(np.cos(np.deg2rad(lat)))
        phi0 = jnp.asarray(np.maximum(
            0.0, 500.0 * PP.gg * rng.normal(size=(IL, IX))))
        forog = jnp.asarray(sflset(np.asarray(phi0)))
        ua = jnp.asarray(5.0 * rng.normal(size=(KX, IL, IX)))
        va = jnp.asarray(5.0 * rng.normal(size=(KX, IL, IX)))
        phig = jnp.cumsum(jnp.ones_like(ta) * 1500.0, axis=0)[::-1] \
            + phi0[None]
        fmask = jnp.full((IL, IX), fmask_val)
        tland = ta[KX - 1] + 1.5
        tsea = ta[KX - 1] + 0.5
        swav = jnp.full((IL, IX), 0.6)
        ssrd = jnp.asarray(rng.uniform(50, 400, size=(IL, IX)))
        slrd = jnp.asarray(rng.uniform(200, 420, size=(IL, IX)))
        alb_l = jnp.full((IL, IX), 0.2)
        alb_s = jnp.full((IL, IX), 0.07)
        snowc = jnp.zeros((IL, IX))
        fx = suflux(st, clat, forog, psa, ua, va, ta, qa, rh, phig, phi0,
                    fmask, tland, tsea, swav, ssrd, slrd, alb_l, alb_s,
                    snowc)
        return fx, dict(ssrd=ssrd, slrd=slrd, alb_l=alb_l, alb_s=alb_s,
                        tland=tland, tsea=tsea)

    def test_sea_balance_closure(self):
        """hfluxn_s = SW absorbed + LW down - LW up - SHF - L*E exactly
        (phy_suflux.f90 sea branch)."""
        fx, d = self._suflux(0.0)
        slru_s = PP.emisfc * PP.sbc * np.asarray(d["tsea"]) ** 4
        want = (np.asarray(d["ssrd"]) * (1.0 - np.asarray(d["alb_s"]))
                + np.asarray(d["slrd"])
                - (slru_s + np.asarray(fx.shf_s)
                   + PP.alhc * np.asarray(fx.evap_s)))
        np.testing.assert_allclose(np.asarray(fx.hfluxn_s), want,
                                   rtol=1e-6, atol=1e-6)

    def test_land_balance_closure(self):
        """After the skin-temperature solve, the full land balance closes:
        SW + LWd - LWu - SHF - L*E - G = 0 with G = hfluxn_l (the
        linearized system is solved exactly)."""
        fx, d = self._suflux(1.0)
        resid = (np.asarray(d["ssrd"]) * (1.0 - np.asarray(d["alb_l"]))
                 + np.asarray(d["slrd"])
                 - np.asarray(fx.slru) - np.asarray(fx.shf)
                 - PP.alhc * np.asarray(fx.evap)
                 - np.asarray(fx.hfluxn_l))
        scale = float(np.asarray(d["ssrd"]).max())
        np.testing.assert_allclose(resid, 0.0, atol=1e-6 * scale)


class TestGlobalWaterBudget:
    @pytest.fixture(scope="class")
    def model(self):
        from speedyml.core.config import ModelConfig
        from speedyml.model import Speedy

        m = Speedy(ModelConfig(dtype="float64"))
        m.initialize(year=1981, month=1)
        m.run_days(2)          # leave the rest state
        return m

    def _column_water(self, m):
        """Global-mean column water [g/m^2] from the current state."""
        import jax

        T = m.dy.T
        st = m.st

        @jax.jit
        def cw(state):
            f = state.at_level(0)
            qg = jnp.maximum(T.spec_to_grid(f.tr[0]), 0.0)   # g/kg
            psg = jnp.exp(T.spec_to_grid(f.ps))
            dsig = jnp.asarray(st.dsig, qg.dtype)[:, None, None]
            # q [g/kg] x column air mass [kg/m^2] = column water [g/m^2]
            return jnp.sum(qg * dsig, axis=0) * psg * PP.p0 / PP.gg

        w = np.asarray(cw(m.state))
        wt_full = np.concatenate([m.dy.tables.wt, m.dy.tables.wt[::-1]]) / 2.0
        return float((w.mean(axis=-1) * wt_full).sum(axis=-1))

    def test_evap_minus_precip_closes(self, model):
        """Global mean E - P over 2 days matches the column-water change to
        ~15% of P (residual: spectral advection aliasing + q>=0 clamp)."""
        m = model
        wt_full = np.concatenate([m.dy.tables.wt, m.dy.tables.wt[::-1]]) / 2.0

        def gmean(g):
            return float((np.asarray(g).mean(axis=-1) * wt_full).sum(-1))

        w0 = self._column_water(m)
        ndays = 2
        e_sum, p_sum = 0.0, 0.0
        for _ in range(ndays):
            acc = m.run_day()
            e_sum += gmean(acc.evap)
            p_sum += gmean(acc.precip)
        w1 = self._column_water(m)

        seconds = ndays * 86400.0
        dw_dt = (w1 - w0) / seconds        # g/m^2/s... w is g/m^2
        e_mean = e_sum / ndays
        p_mean = p_sum / ndays
        assert p_mean > 0.0 and e_mean > 0.0
        resid = dw_dt - (e_mean - p_mean)
        assert abs(resid) < 0.15 * max(p_mean, e_mean), (
            dw_dt, e_mean, p_mean, resid)
