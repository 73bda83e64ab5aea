"""Composed end-to-end sharded hybrid step (parallel.composed) vs the
single-device step, on the virtual 8-device CPU mesh.

This pins the one-program replacement for the reference's per-step MPI
cycle (mpires.f90:218-804): pack -> lat-sharded SPEEDY window -> pack
forecast -> region-sharded ESN -> scatter, all in one jit. The tight
equivalence uses the DRY window (full-physics windows are numerically
sensitive to compilation context — discrete convection triggers amplify
f32/f64 reassociation noise; the per-step physics equivalence is pinned
separately in test_spatial.py); a physics smoke test checks the full
program executes and stays finite/safe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from speedyml.core.config import ModelConfig, ReservoirConfig
from speedyml.domain.decomposition import build_layout, pack_global
from speedyml.domain.standardize import Standardizer
from speedyml.hybrid.experiment import HybridModel
from speedyml.hybrid.forecast import SpeedyForecaster
from speedyml.hybrid.state_io import GridState
from speedyml.model import Speedy
from speedyml.parallel.composed import ComposedHybridStep
from speedyml.reservoir.generate import generate_esn

QMIN = 1e-6


@pytest.fixture(scope="module")
def setup():
    sp = Speedy(ModelConfig(dtype="float64"))
    sp.initialize(year=1982, month=1)
    radang_deg = np.degrees(np.asarray(sp.dy.tables.radang))
    L = build_layout(radang_deg=radang_deg)
    rng = np.random.default_rng(0)
    # a small random readout is enough for program equivalence — training
    # quality is pinned elsewhere (test_hybrid)
    params = generate_esn(0, L.R, L.n_in, L.n_out, n_model=L.n_out,
                          m_target=L.n_in, deg=4)
    na = L.n_out + params.win.shape[1]
    params = params._replace(wout=jnp.asarray(
        0.02 * rng.normal(size=(L.R, L.n_out, na)), jnp.float32))
    stz = Standardizer(
        in_mean=jnp.asarray(rng.normal(size=(L.R, L.n_in)) * 0.1,
                            jnp.float32),
        in_std=jnp.asarray(1.0 + 0.1 * rng.random((L.R, L.n_in)),
                           jnp.float32),
        out_mean=jnp.asarray(rng.normal(size=(L.R, L.n_out)) * 0.1,
                             jnp.float32),
        out_std=jnp.asarray(1.0 + 0.1 * rng.random((L.R, L.n_out)),
                            jnp.float32))
    hm = HybridModel(layout=L, params=params, stz=stz,
                     rcfg=ReservoirConfig(), ml_only=False)

    # physical-ish initial fields from the spun-up model state
    from speedyml.hybrid.state_io import extract
    gs = jax.tree.map(np.asarray, extract(sp.dy, sp.state, level=0))
    atmo = np.stack([gs.t, gs.u, gs.v, np.maximum(gs.q, QMIN)]).astype(
        np.float32)
    logp = gs.logp.astype(np.float32)
    pr_t = np.zeros_like(logp)
    sst = np.asarray(sp.coupler.sst_am, np.float32)
    tisr = np.abs(np.asarray(sp.surf.fsol, np.float32))[:, None] * \
        np.ones((1, sp.config.ix), np.float32)
    x0 = jnp.asarray(rng.normal(size=(L.R, params.n)) * 0.1, jnp.float32)
    return sp, hm, atmo, logp, pr_t, sst, tisr, x0


def _single_device_step(sp, hm, atmo, logp, pr_t, sst, tisr, x0,
                        physics: bool):
    """The reference composition: separate window jit + hm.step jit."""
    L = hm.layout
    eps = hm.rcfg.precip_epsilon
    ss = jnp.maximum(jnp.asarray(sst, jnp.float32), 272.0)
    ti = jnp.maximum(jnp.asarray(tisr, jnp.float32), 0.0)
    gv = pack_global(L, jnp.asarray(atmo), jnp.asarray(logp),
                     jnp.asarray(pr_t), ss, ti)
    fc = SpeedyForecaster(sp, hours=hm.rcfg.timestep, physics=physics)
    win = jax.jit(fc._window_fn())
    gs = GridState(t=atmo[0], u=atmo[1], v=atmo[2],
                   q=np.maximum(atmo[3], 0.0), logp=logp)
    res = win(gs, sp.surf, sp.forcing)
    f_atmo = jnp.stack([res.gs.t, res.gs.u, res.gs.v,
                        jnp.maximum(res.gs.q, QMIN)]).astype(jnp.float32)
    f_pr = jnp.log1p(jnp.maximum(res.precip_mm, 0.0) / eps).astype(
        jnp.float32)
    model_gv = pack_global(L, f_atmo, res.gs.logp.astype(jnp.float32),
                           f_pr, ss, ti)
    x1, atmo1, logp1, pr1 = hm.step(x0, gv, model_gv)
    return (np.asarray(x1), np.asarray(atmo1), np.asarray(logp1),
            np.asarray(pr1), bool(res.safe))


def test_composed_matches_single_device_dry(setup):
    sp, hm, atmo, logp, pr_t, sst, tisr, x0 = setup
    mesh = Mesh(np.array(jax.devices()[:8]), ("mp",))
    comp = ComposedHybridStep(hm, sp, mesh, physics=False)
    surf_sh = comp.shard_surface(sp.surf)
    xc, ac, lc, pc, safe_c = comp.step(x0, atmo, logp, pr_t, sst, tisr,
                                       surf_sh, sp.forcing)
    xr, ar, lr, pr, safe_r = _single_device_step(
        sp, hm, atmo, logp, pr_t, sst, tisr, x0, physics=False)
    assert bool(np.asarray(safe_c)) == safe_r
    # outputs are f32 (readout/scatter path): tolerances are f32 rounding
    # noise on O(100) fields, not algorithmic differences
    np.testing.assert_allclose(np.asarray(ac), ar, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(np.asarray(lc), lr, rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(pc), pr, rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(xc), xr, rtol=3e-4, atol=1e-4)


def test_ensemble_step_matches_per_member(setup):
    """EnsembleHybrid (vmapped full hybrid step) must reproduce E
    independent single-member steps (dry window; same compilation-context
    rationale as above)."""
    from speedyml.hybrid.ensemble import EnsembleHybrid

    sp, hm, atmo, logp, pr_t, sst, tisr, x0 = setup
    rng = np.random.default_rng(7)
    E = 2
    atmo_e = np.stack([atmo, atmo + 0.1 * rng.normal(
        size=atmo.shape).astype(np.float32)])
    logp_e = np.stack([logp, logp])
    pr_e = np.stack([pr_t, pr_t])
    x_e = jnp.stack([x0, x0 * 0.5])

    fc = SpeedyForecaster(sp, hours=hm.rcfg.timestep, physics=False)
    eh = EnsembleHybrid(hm, fc)
    xe1, ae1, le1, pe1, safe = eh.step(x_e, atmo_e, logp_e, pr_e, sst,
                                       tisr, sp.surf, sp.forcing)
    assert bool(np.asarray(safe).all())
    for m in range(E):
        xr, ar, lr, pr, safe_r = _single_device_step(
            sp, hm, atmo_e[m], logp_e[m], pr_e[m], sst, tisr, x_e[m],
            physics=False)
        np.testing.assert_allclose(np.asarray(ae1[m]), ar, rtol=3e-4,
                                   atol=3e-4)
        np.testing.assert_allclose(np.asarray(le1[m]), lr, rtol=3e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(xe1[m]), xr, rtol=3e-4,
                                   atol=1e-4)


def test_composed_full_physics_matches_single_device(setup):
    """Full-physics composed step vs the single-device composition,
    NUMERICALLY: with the f64 window model the
    discrete convection/condensation triggers only flip at f64 rounding
    scale, so the sharded program must track the reference composition to
    f32 output rounding."""
    sp, hm, atmo, logp, pr_t, sst, tisr, x0 = setup
    mesh = Mesh(np.array(jax.devices()[:8]), ("mp",))
    comp = ComposedHybridStep(hm, sp, mesh, physics=True)
    surf_sh = comp.shard_surface(sp.surf)
    xc, ac, lc, pc, safe = comp.step(x0, atmo, logp, pr_t, sst, tisr,
                                     surf_sh, sp.forcing)
    assert bool(np.asarray(safe))
    for a in (xc, ac, lc, pc):
        assert np.all(np.isfinite(np.asarray(a)))
    assert float(jnp.min(pc)) >= 0.0
    # region sharding survived the program
    assert "mp" in str(xc.sharding)
    xr, ar, lr, pr, safe_r = _single_device_step(
        sp, hm, atmo, logp, pr_t, sst, tisr, x0, physics=True)
    assert safe_r
    np.testing.assert_allclose(np.asarray(ac), ar, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(lc), lr, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(pc), pr, rtol=2e-3, atol=5e-3)
    np.testing.assert_allclose(np.asarray(xc), xr, rtol=2e-3, atol=1e-3)
