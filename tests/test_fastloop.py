"""Device-resident chunked prediction loop (hybrid.fastloop) vs the
per-step HybridRunner.

The scan loop replaces the reference's per-step file/MPI prediction cycle
(mpires.f90:218-804) at the LOOP level; these tests pin that the chunked
program reproduces the per-step composition: same boundary-condition
climatology path, same hybrid-SST gate + ice blending + qcorh forcing,
same reservoir step, same weekly ocean feedback."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speedyml.core.calendar import ModelDate
from speedyml.core.config import ModelConfig, ReservoirConfig
from speedyml.domain.decomposition import build_layout
from speedyml.domain.standardize import Standardizer
from speedyml.hybrid.experiment import (HybridModel, HybridRunner,
                                        train_hybrid, transform_and_pack)
from speedyml.hybrid.fastloop import ScanHybridRunner
from speedyml.hybrid.forecast import SpeedyForecaster
from speedyml.model import Speedy
from speedyml.reservoir.generate import generate_esn

QMIN = 1e-6


@pytest.fixture(scope="module")
def setup():
    sp = Speedy(ModelConfig(dtype="float64"))
    sp.initialize(year=1982, month=1)
    radang_deg = np.degrees(np.asarray(sp.dy.tables.radang))
    L = build_layout(radang_deg=radang_deg)
    rng = np.random.default_rng(0)
    params = generate_esn(0, L.R, L.n_in, L.n_out, n_model=L.n_out,
                          m_target=L.n_in, deg=4)
    na = L.n_out + params.win.shape[1]
    # tiny random readout around PHYSICAL means: multi-step closed-loop
    # equivalence needs outputs that stay inside the safety gate, unlike
    # the single-step test_composed fixture
    params = params._replace(wout=jnp.asarray(
        0.003 * rng.normal(size=(L.R, L.n_out, na)), jnp.float32))

    from speedyml.hybrid.state_io import extract
    gs = jax.tree.map(np.asarray, extract(sp.dy, sp.state, level=0))
    atmo = np.stack([gs.t, gs.u, gs.v, np.maximum(gs.q, QMIN)]).astype(
        np.float32)
    logp = gs.logp.astype(np.float32)
    pr_t = np.zeros_like(logp)

    from speedyml.coupler.daily import init_coupler_state
    from speedyml.domain.decomposition import pack_global
    cs = init_coupler_state(sp.clim, ModelDate(1982, 1, 15, 0))
    gv0 = np.asarray(pack_global(
        L, jnp.asarray(atmo), jnp.asarray(logp), jnp.asarray(pr_t),
        jnp.maximum(jnp.asarray(cs.sst_am, jnp.float32), 272.0),
        jnp.zeros((L.il, L.ix), jnp.float32)))
    stz = Standardizer(
        in_mean=jnp.asarray(gv0[L.input_index], jnp.float32),
        in_std=jnp.asarray(5.0 * np.ones((L.R, L.n_in)), jnp.float32),
        out_mean=jnp.asarray(gv0[L.target_index], jnp.float32),
        out_std=jnp.asarray(np.ones((L.R, L.n_out)), jnp.float32))
    hm = HybridModel(layout=L, params=params, stz=stz,
                     rcfg=ReservoirConfig(), ml_only=False)
    x0 = jnp.asarray(rng.normal(size=(L.R, params.n)) * 0.1, jnp.float32)
    return sp, hm, atmo, logp, pr_t, x0


def test_fastloop_matches_runner_dry(setup):
    """4 chunked steps (K=2) == 4 per-step runner steps, dry window."""
    sp, hm, atmo, logp, pr_t, x0 = setup
    date0 = ModelDate(1982, 1, 15, 0)
    n = 4

    fc = SpeedyForecaster(sp, hours=hm.rcfg.timestep, physics=False)
    ref = HybridRunner(hm, fc).run(x0, atmo, logp, pr_t,
                                   ModelDate(1982, 1, 15, 0), n)
    fast = ScanHybridRunner(hm, sp, physics=False, chunk=2).run(
        x0, atmo, logp, pr_t, date0, n)

    assert not fast["aborted"] and not ref["aborted"]
    assert fast["atmo"].shape == ref["atmo"].shape
    # boundary fields enter at f64 in both paths (x64 model); remaining
    # deltas are f32 rounding in the packed supervector path
    np.testing.assert_allclose(fast["sst"], ref["sst"], atol=1e-8)
    np.testing.assert_allclose(fast["atmo"], ref["atmo"], rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(fast["logp"], ref["logp"], rtol=3e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(fast["x"]), np.asarray(ref["x"]),
                               rtol=3e-4, atol=1e-4)
    d = fast["date"]
    assert (d.iyear, d.imonth, d.iday, d.ihour) == (1982, 1, 16, 0)


def test_fastloop_full_physics_executes(setup):
    """Full-physics chunked program runs, stays safe/finite, and tracks the
    per-step runner closely (f64 window; convection triggers can flip only
    at f64 rounding scale)."""
    sp, hm, atmo, logp, pr_t, x0 = setup
    n = 2
    fc = SpeedyForecaster(sp, hours=hm.rcfg.timestep, physics=True)
    ref = HybridRunner(hm, fc).run(x0, atmo, logp, pr_t,
                                   ModelDate(1982, 1, 15, 0), n)
    fast = ScanHybridRunner(hm, sp, physics=True, chunk=2).run(
        x0, atmo, logp, pr_t, ModelDate(1982, 1, 15, 0), n)
    assert not fast["aborted"]
    assert np.all(np.isfinite(fast["atmo"]))
    np.testing.assert_allclose(fast["atmo"], ref["atmo"], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(fast["precip_mm"], ref["precip_mm"],
                               atol=5e-3)


def _ocean_setup():
    from speedyml.reservoir.slab import train_ocean
    from tests.test_hybrid import (_small_layout, _small_rcfg,
                                   _synthetic_truth)

    L = _small_layout()
    rcfg = _small_rcfg(timestep_slab=24, slab_nodes=400,
                       slab_noise_std=0.02, sst_variance_threshold=0.2)
    T = 600
    atmo, logp, precip, sst, tisr = _synthetic_truth(L, T, seed=22)
    gv = transform_and_pack(L, atmo, logp, precip, sst, tisr,
                            rcfg.precip_epsilon)
    hm = train_hybrid(L, rcfg, gv, None, seed=9)
    om = train_ocean(L, rcfg, gv, seed=6)
    x = hm.synchronize(gv[-40:])
    s = L.gv_sizes
    last = gv[-1]
    atmo0 = last[s["atmo3d"][0]:s["atmo3d"][1]].reshape(4, L.kx, L.il, L.ix)
    logp0 = last[s["logp"][0]:s["logp"][1]].reshape(L.il, L.ix)
    pr0 = last[s["precip"][0]:s["precip"][1]].reshape(L.il, L.ix)
    sst_last = last[s["sst"][0]:s["sst"][1]].reshape(L.il, L.ix)
    return L, hm, om, x, atmo0, logp0, pr0, sst_last


def test_fastloop_ocean_matches_runner():
    """ml_only + weekly ocean feedback: the chunked loop reproduces the
    per-step runner across two week boundaries (anomaly semantics, gate,
    compose_sst, accumulator phase)."""
    L, hm, om, x, atmo0, logp0, pr0, sst_last = _ocean_setup()
    clim = sst_last.astype(np.float64)

    class _Runner(HybridRunner):
        def _sst_tisr(self, date):
            return clim.copy(), np.zeros((L.il, L.ix))

    class _Scan(ScanHybridRunner):
        def _host_step_fields(self, date):
            return dict(sst_clim=clim, tisr=np.zeros((L.il, L.ix)))

    n = 8     # two "weeks" at timestep_slab=24h -> spw=4
    ref = _Runner(hm, None, clim=object(), dy=object()).run(
        x, atmo0, logp0, pr0, ModelDate(1999, 1, 1, 0), n, ocean=om,
        sst_anom0=np.zeros_like(clim))
    fast = _Scan(hm, None)
    fast._np_dtype = np.float64          # match the runner's host-f64 path
    out = fast.run(x, atmo0, logp0, pr0, ModelDate(1999, 1, 1, 0), n,
                   ocean=om, sst_anom0=np.zeros_like(clim))

    assert out["sst"].shape == ref["sst"].shape
    np.testing.assert_allclose(out["sst"], ref["sst"], atol=1e-5)
    np.testing.assert_allclose(out["atmo"], ref["atmo"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(out["x_ocean"]),
                               np.asarray(ref["x_ocean"]), atol=1e-5)
    # the week boundary actually moved the feedback
    assert not np.allclose(out["sst"][5], out["sst"][0])


def test_fastloop_checkpoint_resume(tmp_path):
    """Chunk-boundary checkpoints resume through HybridRunner.resume_from
    (shared format), including the ocean state."""
    L, hm, om, x, atmo0, logp0, pr0, sst_last = _ocean_setup()
    clim = sst_last.astype(np.float64)

    class _Scan(ScanHybridRunner):
        def _host_step_fields(self, date):
            return dict(sst_clim=clim, tisr=np.zeros((L.il, L.ix)))

    ck = str(tmp_path / "fast.ckpt.npz")
    fast = _Scan(hm, None)
    fast._np_dtype = np.float64
    full = fast.run(x, atmo0, logp0, pr0, ModelDate(1999, 1, 1, 0), 8,
                    ocean=om, sst_anom0=np.zeros_like(clim))
    part = fast.run(x, atmo0, logp0, pr0, ModelDate(1999, 1, 1, 0), 4,
                    ocean=om, sst_anom0=np.zeros_like(clim),
                    checkpoint_path=ck, checkpoint_every=4)

    class _Runner(HybridRunner):
        def _sst_tisr(self, date):
            return clim.copy(), np.zeros((L.il, L.ix))

    res = _Runner(hm, None, clim=object(), dy=object()).resume_from(
        ck, 4, ocean=om)
    np.testing.assert_allclose(res["atmo"], full["atmo"][4:], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(res["sst"], full["sst"][4:], atol=1e-5)


def _stub_scan(hm, L, clim, chunk, tisr_spike_at=None):
    """ml_only ScanHybridRunner with stubbed boundary fields; optionally
    returns a huge TISR at one global step index (abort-test forcing)."""
    calls = {"n": 0}

    class _Scan(ScanHybridRunner):
        def _host_step_fields(self, date):
            i = calls["n"]
            calls["n"] += 1
            tisr = np.zeros((L.il, L.ix))
            if tisr_spike_at is not None and i == tisr_spike_at:
                tisr = np.full((L.il, L.ix), 1e6)
            return dict(sst_clim=clim, tisr=tisr)

    s = _Scan(hm, None, chunk=chunk)
    s._np_dtype = np.float64
    return s


def test_fastloop_stream_mode():
    """stream=True: every step reaches the writer, host keeps only summary
    stats, and the summary agrees with the kept-trajectory run (long
    runs must not accumulate the trajectory in RAM)."""
    L, hm, om, x, atmo0, logp0, pr0, sst_last = _ocean_setup()
    clim = sst_last.astype(np.float64)
    n = 8

    kept = _stub_scan(hm, L, clim, chunk=4).run(
        x, atmo0, logp0, pr0, ModelDate(1999, 1, 1, 0), n)

    writes = []

    class _W:
        def append(self, atmo, logp, precip_mm=None, sst=None):
            writes.append((atmo.copy(), sst.copy()))

    out = _stub_scan(hm, L, clim, chunk=4).run(
        x, atmo0, logp0, pr0, ModelDate(1999, 1, 1, 0), n,
        writer=_W(), stream=True)

    assert out["atmo"] is None              # dropped, not kept
    assert out["steps_done"] == n
    assert len(writes) == n
    s = out["summary"]
    assert s["steps"] == n
    ka = kept["atmo"]
    assert np.isclose(s["t_min"], ka[:, 0].min())
    assert np.isclose(s["t_max"], ka[:, 0].max())
    assert np.isclose(s["u_min"], ka[:, 1].min())
    assert np.isclose(s["sst_max"], kept["sst"].max())
    assert np.isclose(
        s["sst_drift_K"], np.abs(kept["sst"][-1] - kept["sst"][0]).max())
    # the streamed steps are the same trajectory
    np.testing.assert_allclose(writes[-1][0], ka[-1], rtol=1e-6)


def test_fastloop_abort_semantics():
    """Mid-chunk safety abort: steps_done/date/trajectory truncate AT the
    abort step, reservoir state is withheld, and the returned last state is
    the last SAFE step (not the carry, which can be up to K-1 steps past
    the abort)."""
    L, hm, om, x, atmo0, logp0, pr0, sst_last = _ocean_setup()
    clim = sst_last.astype(np.float64)
    n, j = 8, 5                              # abort at global step index 5

    s = _stub_scan(hm, L, clim, chunk=8, tisr_spike_at=j)
    s._ml_safe_fn = lambda a, lp, xs: xs.tisr.max() < 1e5
    out = s.run(x, atmo0, logp0, pr0, ModelDate(1999, 1, 1, 0), n)

    assert out["aborted"]
    assert out["steps_done"] == j
    assert len(out["atmo"]) == j             # unsafe step never surfaces
    assert out["x"] is None                  # only exists at chunk ends
    d = out["date"]                          # date0 + j * 6 h
    assert (d.iyear, d.imonth, d.iday, d.ihour) == (1999, 1, 2, 6)
    np.testing.assert_allclose(out["atmo_last"], out["atmo"][-1])
    assert np.all(np.isfinite(out["atmo_last"]))


def test_fastloop_checkpoint_absolute_step(tmp_path):
    """Checkpoints from a resumed run carry ABSOLUTE steps (step0 +
    progress), so retry-with-resume integrates the right remaining
    length."""
    from speedyml.io.checkpoint import load_prediction

    L, hm, om, x, atmo0, logp0, pr0, sst_last = _ocean_setup()
    clim = sst_last.astype(np.float64)
    ck = str(tmp_path / "abs.ckpt.npz")
    _stub_scan(hm, L, clim, chunk=4).run(
        x, atmo0, logp0, pr0, ModelDate(1999, 1, 1, 0), 4,
        checkpoint_path=ck, checkpoint_every=4, step0=100)
    st = load_prediction(ck)
    assert st["step"] == 104


def test_fastloop_precip_debias_output_only():
    """precip_debias shifts ONLY the written mm (lognormal output
    correction); the trajectory/feedback state is bit-identical."""
    L, hm, om, x, atmo0, logp0, pr0, sst_last = _ocean_setup()
    clim = sst_last.astype(np.float64)
    base = _stub_scan(hm, L, clim, chunk=4).run(
        x, atmo0, logp0, pr0, ModelDate(1999, 1, 1, 0), 4)
    s = _stub_scan(hm, L, clim, chunk=4)
    d = np.full((L.il, L.ix), 0.5)
    s.precip_debias = d
    out = s.run(x, atmo0, logp0, pr0, ModelDate(1999, 1, 1, 0), 4)
    np.testing.assert_allclose(out["atmo"], base["atmo"], rtol=0, atol=0)
    eps = hm.rcfg.precip_epsilon
    base_log = np.log1p(base["precip_mm"] / eps)
    expect = eps * np.expm1(np.maximum(base_log - d, 0.0))
    np.testing.assert_allclose(out["precip_mm"], expect, rtol=1e-6)
    assert np.all(out["precip_mm"] <= base["precip_mm"] + 1e-12)
