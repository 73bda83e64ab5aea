"""Synthetic ENSO SST-anomaly forcing (coupler.anomaly) + the anomaly-gate
recalibration it requires (reservoir.slab.training_anomaly_std).

The forcing is the zero-egress stand-in for the observed SST anomalies the
reference trains its slab-ocean reservoir on (mod_io.f90:2731-2812,
mpires.f90:1676-1710); these tests pin determinism, the sea-mask/ice
behaviour of the imposition, and the gate arithmetic."""

from types import SimpleNamespace

import numpy as np

from speedyml.core.calendar import ModelDate
from speedyml.coupler.anomaly import (SyntheticEnso, apply_sst_anomaly,
                                      enso_pattern)

LAT = np.linspace(-87.0, 87.0, 48)
LON = np.arange(96) * 3.75


def test_pattern_sea_mask_and_center():
    fmask = np.ones((48, 96))
    fmask[:, :10] = 0.0                     # "land" strip
    p = enso_pattern(LAT, LON, fmask)
    assert np.all(p[:, :10] == 0.0)
    # warm core near (0N, 215E), inside Nino-3.4
    iy, ix = np.unravel_index(np.argmax(p), p.shape)
    assert abs(LAT[iy]) < 5.0 and 190.0 <= LON[ix] <= 240.0
    assert 0.9 < p.max() <= 1.0
    assert p.min() < -0.1                   # west-Pacific cold pole


def test_index_deterministic_and_ramped():
    e1 = SyntheticEnso(LAT, LON, np.ones((48, 96)), seed=3)
    e2 = SyntheticEnso(LAT, LON, np.ones((48, 96)), seed=3)
    d = ModelDate(1984, 7, 11, 18)
    assert e1.index(d) == e2.index(d)
    assert e1.index(ModelDate(1981, 12, 1, 0)) == 0.0    # before t0
    # different seeds differ (AR component)
    e3 = SyntheticEnso(LAT, LON, np.ones((48, 96)), seed=4)
    assert e1.index(d) != e3.index(d)
    # ENSO-like scale over the training record
    idx = np.array([e1.index_at(e1.h0 + 24.0 * k) for k in range(1600)])
    assert 0.5 < idx.std() < 1.5
    assert np.abs(idx).max() < 3.5


def test_apply_preserves_ice_blend():
    """Imposition mirrors sea2atm's ice blending: zero anomaly leaves
    sst_am exactly at the daily-update value; a warm-pool anomaly moves
    only open water."""
    il, ix = 48, 96
    cs = SimpleNamespace(
        sstcl_ob=np.full((il, ix), 290.0),
        sice_am=np.zeros((il, ix)),
        tice_am=np.full((il, ix), 260.0),
        sst_am=None)
    cs.sice_am[:4] = 1.0                    # polar ice row
    apply_sst_anomaly(cs, np.zeros((il, ix)))
    base = cs.sst_am.copy()
    assert np.allclose(base[:4], 260.0)     # fully ice -> tice
    assert np.allclose(base[4:], 290.0)

    anom = np.zeros((il, ix))
    anom[24, 57] = 1.5                      # equatorial point
    apply_sst_anomaly(cs, anom)
    assert np.isclose(cs.sst_am[24, 57], 291.5)
    assert np.allclose(cs.sst_am[:4], 260.0)          # ice unchanged


def test_training_anomaly_std_gate_scale():
    """training_anomaly_std recovers the imposed anomaly's std over open
    water and zeroes ice-capable cells (the gate must not license the
    prognostic-ice deviation as an SST anomaly)."""
    from speedyml.reservoir.slab import training_anomaly_std

    il, ix, T = 8, 12, 200
    clim = SimpleNamespace(
        sst12=np.full((12, il, ix), 290.0),
        sice12=np.zeros((12, il, ix)))
    clim.sice12[:, :2] = 0.5                # icy rows 0-1
    rng = np.random.default_rng(0)
    hours = np.arange(T) * 6.0 + 100000.0
    series = np.full((T, il, ix), 290.0)
    series[:, :2] = 280.0                   # blended-ice rows
    sig = rng.normal(size=T)
    series[:, 5, 7] += 0.8 * sig            # imposed anomaly, std 0.8
    std = training_anomaly_std(clim, hours, series, subsample=1)
    assert np.isclose(std[5, 7], 0.8 * sig.std(), rtol=1e-6)
    assert np.all(std[:2] == 0.0)           # ice rows zeroed
    assert np.all(std[2:5] < 1e-9)


def test_calibrate_gate_merges_training_scale():
    """calibrate_gate(anom_std) = max(open-loop residual, training anomaly
    scale): a skilful model trained on large anomalies keeps a gate wide
    enough to feed them back."""
    from speedyml.core.config import ReservoirConfig
    from speedyml.hybrid.experiment import transform_and_pack
    from speedyml.reservoir.slab import train_ocean
    from tests.test_hybrid import (_small_layout, _small_rcfg,
                                   _synthetic_truth)

    L = _small_layout()
    rcfg = _small_rcfg(timestep_slab=24, slab_nodes=200,
                       slab_noise_std=0.02, sst_variance_threshold=0.2)
    atmo, logp, precip, sst, tisr = _synthetic_truth(L, 400, seed=5)
    gv = transform_and_pack(L, atmo, logp, precip, sst, tisr,
                            rcfg.precip_epsilon)
    om = train_ocean(L, rcfg, gv, seed=6)
    tstd = np.full((L.il, L.ix), 2.5)
    grid, ol_rms, p_rms = om.calibrate_gate(gv, L, train_anom_std=tstd)
    assert np.all(om.anom_std >= 2.5 - 1e-12)
    # compose_sst now admits +-3 K anomalies at active cores
    ncore = L.resy * L.resx
    clim_g = np.full((L.il, L.ix), 290.0)
    pred = np.full((om.ol.R, om.ol.n_out), 293.0)   # +3 K everywhere
    out = om.compose_sst(pred, clim_g, L)
    g0 = L.gv_sizes["sst"][0]
    tgt = om.ol.target_index[:, :ncore] - g0
    act_cells = tgt[om.active].reshape(-1)
    if len(act_cells):
        assert np.all(out.reshape(-1)[act_cells] > 292.9)


def test_enso_regime_closed_loop_sustains_anomalies():
    """End-to-end miniature of the coupled-variability regime: truth SST carries a slow oscillatory anomaly, the slab
    ocean is trained on it with the train-anomaly-recalibrated gate, and
    the closed fastloop (atmosphere reservoir + weekly ocean feedback)
    SUSTAINS the variability instead of collapsing to climatology."""
    import jax.numpy as jnp

    from speedyml.core.calendar import ModelDate
    from speedyml.hybrid.experiment import train_hybrid, transform_and_pack
    from speedyml.hybrid.fastloop import ScanHybridRunner
    from speedyml.reservoir.slab import train_ocean, weekly_ocean_inputs
    from tests.test_hybrid import (_small_layout, _small_rcfg,
                                   _synthetic_truth)

    L = _small_layout()
    rcfg = _small_rcfg(timestep_slab=24, slab_nodes=400,
                       slab_noise_std=0.02, sst_variance_threshold=0.2)
    T = 640
    atmo, logp, precip, sst, tisr = _synthetic_truth(L, T, seed=11)
    # constant-climatology SST + slow oscillatory anomaly in a patch
    # (period 160 steps = 40 ocean weeks; amplitude 2 K)
    clim = np.full((L.il, L.ix), 290.0)
    patch = np.zeros((L.il, L.ix))
    patch[2:5, 3:9] = 1.0
    t = np.arange(T)
    osc = 2.0 * np.sin(2 * np.pi * t / 160.0)
    sst = clim[None] + osc[:, None, None] * patch[None]
    gv = transform_and_pack(L, atmo, logp, precip, sst, tisr,
                            rcfg.precip_epsilon)

    hm = train_hybrid(L, rcfg, gv, None, seed=9)
    om = train_ocean(L, rcfg, gv, seed=6)
    train_anom_std = (sst - clim[None]).std(axis=0)
    om.calibrate_gate(gv, L, train_anom_std=train_anom_std)
    # gate admits the trained anomaly scale (3x std ~ 4.2 K in the patch)
    assert float(om.anom_std[3, 5]) > 1.0

    spw = om.steps_per_week
    gv_w = weekly_ocean_inputs(gv, spw, L)
    x_ocean = om.synchronize(gv_w)
    x = hm.synchronize(gv[-40:])
    s = L.gv_sizes
    last = gv[-1]
    atmo0 = last[s["atmo3d"][0]:s["atmo3d"][1]].reshape(4, L.kx, L.il, L.ix)
    logp0 = last[s["logp"][0]:s["logp"][1]].reshape(L.il, L.ix)
    pr0 = last[s["precip"][0]:s["precip"][1]].reshape(L.il, L.ix)
    anom0 = sst[-1] - clim

    class _Scan(ScanHybridRunner):
        def _host_step_fields(self, date):
            return dict(sst_clim=clim, tisr=np.zeros((L.il, L.ix)))

    runner = _Scan(hm, None)
    runner._np_dtype = np.float64
    n = 15 * spw                       # 15 closed-loop ocean weeks
    out = runner.run(x, atmo0, logp0, pr0, ModelDate(1999, 1, 1, 0), n,
                     ocean=om, x_ocean=x_ocean, sst_anom0=anom0)
    assert not out["aborted"]
    fed = out["sst"][:, 3, 5] - 290.0          # patch-core anomaly series
    imposed_std = osc.std()
    # variability sustained at the imposed scale (not collapsed to clim)
    assert fed.std() > 0.3 * imposed_std, (fed.std(), imposed_std)
    # and the anomaly persists across week boundaries (nonzero far out)
    assert np.abs(fed[-spw:]).max() > 0.2
