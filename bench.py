"""Benchmark: T30L8 throughput per chip.

Prints ONE JSON line. Primary metric (BASELINE.json north star): grid-points
per second per chip of the FULL HYBRID STEP — reference-scale batched ESN
prediction (1152 regions, n=5760 nodes, wout 1152x136x5896) + the 6-hour
SPEEDY window with full physics + pack/standardize/scatter — the production
inner loop (mpires.f90:218-804 + mod_reservoir.f90:1418-1489 combined).
When trained weights exist (data/refscale_weights.nc) the step runs them
with the real standardizer and a live precip feedback loop; otherwise
random weights at identical shapes/sparsity time the same program.

Every stage runs in its own SUBPROCESS (`python bench.py --stage NAME`),
so an out-of-memory failure in one stage cannot poison the allocations of
the next. Stages print incremental `STAGE_JSON {...}` lines that the
orchestrator merges into bench_partial.json as they arrive — a crash in ANY
stage can never erase an already-measured number. The ensemble sweep is
sized from the device's memory limit and the compiled step's per-member
bytes; if an E still runs out of memory, the subprocess dies alone and the
failure is recorded as the measured ceiling.

Secondary metrics: ensemble-batched hybrid step (f32 + bf16-wout sweeps with
window-vs-ESN attribution at the best width), production fastloop s/step,
dry-core ensemble figures (f32/bf16), and a reference-scale training-block
timing. The model runs on the aquaplanet boundary (io.boundary).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

WEIGHTS_PATH = "data/refscale_weights.nc"
PARTIAL_PATH = "bench_partial.json"


def emit(d: dict):
    """Incremental stage output: one JSON line the orchestrator merges
    immediately (a later crash cannot erase it)."""
    print("STAGE_JSON " + json.dumps(d), flush=True)


# ========================================================================
# measurement functions
# ========================================================================

def bench_dry_core(cfg_dtype="float32", grid_compute="float32",
                   ens_list=(64, 128), nsteps_chunk=96, nchunks=4):
    import jax
    import jax.numpy as jnp

    from speedyml.core.config import ModelConfig
    from speedyml.dynamics.core import Dycore
    from speedyml.dynamics.initial import rest_state

    cfg = ModelConfig(dtype=cfg_dtype, grid_compute=grid_compute)
    dy = Dycore(cfg)                  # flat aquaplanet surface
    state0 = dy.stepone(rest_state(dy), dy.zero_forcing())
    forcing = dy.zero_forcing()
    gp = cfg.ix * cfg.il * cfg.kx

    def measure(ens):
        def step_one(s):
            return dy.step(s, forcing, 1, 1, "delt2")

        def run_chunk(s):
            def body(ss, _):
                return jax.vmap(step_one)(ss), None
            s, _ = jax.lax.scan(body, s, None, length=nsteps_chunk)
            return s

        state = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (ens,) + x.shape) + 0.0,
            state0)
        run = jax.jit(run_chunk)
        state = run(state)
        jax.block_until_ready(state.ps)
        t0 = time.perf_counter()
        for _ in range(nchunks):
            state = run(state)
        jax.block_until_ready(state.ps)
        dt = time.perf_counter() - t0
        return ens * nsteps_chunk * nchunks * gp / dt

    best, best_ens = 0.0, 0
    for ens in ens_list:
        gps = measure(ens)
        if gps > best:
            best, best_ens = gps, ens
    return best, best_ens


def _random_hm(L, rcfg, m=6000, deg=6, gv=None):
    """HybridModel with random reference-scale parameters (timing-only:
    real shapes, sparsity, and production circulant topology).

    When `gv` (a packed global state vector from the real initial state) is
    given, the standardizer is anchored to it — out_mean is the physical
    state and the tiny random readout perturbs around it — so closed-loop
    programs (fastloop) stay inside the safety bounds and time the full
    steady-state production loop instead of aborting a few steps in. The
    compiled program and all shapes are identical either way; only constant
    values differ."""
    import jax.numpy as jnp

    from speedyml.domain.standardize import Standardizer
    from speedyml.hybrid.experiment import HybridModel
    from speedyml.reservoir.esn import EsnParams
    from speedyml.reservoir.generate import ring_shifts

    R, n_in, n_out = L.R, L.n_in, L.n_out
    n = (m // n_in) * n_in
    rng = np.random.default_rng(0)
    na = n + n_out
    shifts = ring_shifts(n, deg)
    a_idx = ((np.arange(n, dtype=np.int64)[None, :, None] + shifts) % n)
    params = EsnParams(
        a_idx=jnp.asarray(np.broadcast_to(a_idx, (R, n, deg)), jnp.int32),
        a_val=jnp.asarray(rng.normal(size=(R, n, deg)) * 0.05, jnp.float32),
        win=jnp.asarray(rng.uniform(-0.5, 0.5, size=(R, n)), jnp.float32),
        # 1e-4: keeps the closed-loop readout perturbation ~0.01 sigma per
        # step (timing is content-independent; stability is not)
        wout=jnp.asarray(rng.normal(size=(R, n_out, na)) * 1e-4, jnp.float32),
        node_map=jnp.asarray(np.arange(n) // (n // n_in), jnp.int32),
        leakage=1.0,
        a_shift=jnp.asarray(shifts))
    if gv is None:
        stz = Standardizer(
            in_mean=jnp.zeros((R, n_in), jnp.float32),
            in_std=jnp.ones((R, n_in), jnp.float32),
            out_mean=jnp.zeros((R, n_out), jnp.float32),
            out_std=jnp.ones((R, n_out), jnp.float32))
    else:
        gv = np.asarray(gv, np.float64)
        # per-element std from per-SECTION physical scales (a snapshot has
        # no variability; a uniform floor puts ~0.05 kg/kg of noise in q
        # and 60-sigma precip entries in mv — both trip the window's
        # safety flag). atmo3d is var-major blocks of kx*ngp (decomposition
        # gv layout): T,u,v 5 (6-h tendency scale), q 1e-3.
        gv_std = np.empty(L.gv_len)
        a0, _ = L.gv_sizes["atmo3d"]
        blk = L.kx * L.il * L.ix
        for v, sd in enumerate((5.0, 5.0, 5.0, 1e-3)):
            gv_std[a0 + v * blk:a0 + (v + 1) * blk] = sd
        for name, sd in (("logp", 0.01), ("precip", 1.0), ("sst", 1.0),
                         ("tisr", 50.0), ("ohtc", 1.0)):
            s0, s1 = L.gv_sizes.get(name, (0, 0))
            gv_std[s0:s1] = sd
        stz = Standardizer(
            in_mean=jnp.asarray(gv[L.input_index], jnp.float32),
            in_std=jnp.asarray(gv_std[L.input_index], jnp.float32),
            out_mean=jnp.asarray(gv[L.target_index], jnp.float32),
            out_std=jnp.asarray(gv_std[L.target_index], jnp.float32))
    return HybridModel(layout=L, params=params, stz=stz, rcfg=rcfg,
                       ml_only=False)


_CACHE = {}


def _speedy_and_hm(grid_compute="float32", force_random=False):
    """Build (speedy, hm, trained, gs0): trained weights when available."""
    import jax

    from speedyml.core.config import ModelConfig, ReservoirConfig
    from speedyml.domain.decomposition import build_layout
    from speedyml.hybrid.state_io import extract
    from speedyml.model import Speedy

    cfg = ModelConfig(dtype="float32", grid_compute=grid_compute)
    sp = Speedy(cfg)
    sp.initialize(year=1982, month=1)
    sp.run_days(2)                       # non-trivial state
    gs0 = jax.tree.map(jax.numpy.asarray, extract(sp.dy, sp.state, level=0))

    key = "hm_random" if force_random else "hm"
    if key not in _CACHE:
        radang_deg = np.degrees(np.asarray(sp.dy.tables.radang))
        trained = False
        hm = None
        if not force_random and os.path.exists(WEIGHTS_PATH):
            try:
                from speedyml.io.weights import load_model
                hm = load_model(WEIGHTS_PATH, radang_deg=radang_deg)
                trained = not hm.ml_only
            except Exception as e:
                print(f"# weights load failed ({e!r}); random params",
                      file=sys.stderr)
        if hm is None or hm.ml_only:
            import jax.numpy as jnp

            from speedyml.domain.decomposition import pack_global
            L = build_layout(radang_deg=radang_deg)
            atmo = jnp.stack([gs0.t, gs0.u, gs0.v,
                              jnp.maximum(gs0.q, 1e-6)])
            zero2d = jnp.zeros((cfg.il, cfg.ix), jnp.float32)
            gv0 = pack_global(
                L, atmo, gs0.logp, zero2d,
                jnp.asarray(np.asarray(sp.coupler.sst_am), jnp.float32),
                zero2d + 300.0)
            hm = _random_hm(L, ReservoirConfig(), gv=np.asarray(gv0))
        _CACHE[key] = (hm, trained)
    return sp, _CACHE[key][0], _CACHE[key][1], gs0


def bench_hybrid_step(n_steps=16, grid_compute="float32",
                      wout_dtype="float32", force_random=False,
                      r2_program=False):
    """Full hybrid step, single trajectory (the reference's operating mode,
    parallelmain.f90:206-273): window + pack + standardize + ESN + scatter,
    with live precip feedback into the next step's supervector."""
    import jax
    import jax.numpy as jnp

    from speedyml.domain.decomposition import pack_global, scatter_outputs
    from speedyml.domain.standardize import (standardize_in, standardize_out,
                                             unstandardize_out)
    from speedyml.hybrid.forecast import SpeedyForecaster
    from speedyml.hybrid.state_io import GridState
    from speedyml.reservoir.esn import predict_step

    sp, hm, trained, gs0 = _speedy_and_hm(grid_compute, force_random)
    L = hm.layout
    cfg = sp.config
    params = hm.params
    stz = hm.stz
    if r2_program:
        # the r2 bench variant (regression attribution): identity stats +
        # zero precip input every step (no live feedback)
        import jax.numpy as _jnp
        from speedyml.domain.standardize import Standardizer as _Stz
        stz = _Stz(in_mean=_jnp.zeros((L.R, L.n_in), _jnp.float32),
                   in_std=_jnp.ones((L.R, L.n_in), _jnp.float32),
                   out_mean=_jnp.zeros((L.R, L.n_out), _jnp.float32),
                   out_std=_jnp.ones((L.R, L.n_out), _jnp.float32))
    if wout_dtype != "float32":
        from speedyml.reservoir.esn import cast_wout
        params = cast_wout(params, jnp.dtype(wout_dtype))
    eps = hm.rcfg.precip_epsilon

    fc = SpeedyForecaster(sp, hours=6, physics=True)
    surf, forcing, _, _ = fc._surf_forcing(sp.date)
    win_fn = fc._window_fn()
    idx = jnp.asarray(L.input_index)
    tidx = jnp.asarray(L.target_index)

    @jax.jit
    def hybrid_step(params, stz, x, gs, precip_t, surf, forcing, sst, tisr):
        res = win_fn(gs, surf, forcing)
        f_atmo = jnp.stack([res.gs.t, res.gs.u, res.gs.v,
                            jnp.maximum(res.gs.q, 1e-6)])
        f_pr = jnp.log1p(jnp.maximum(res.precip_mm, 0.0) / eps)
        model_gv = pack_global(L, f_atmo, res.gs.logp, f_pr, sst, tisr)
        atmo = jnp.stack([gs.t, gs.u, gs.v, jnp.maximum(gs.q, 1e-6)])
        gv = pack_global(L, atmo, gs.logp, precip_t, sst, tisr)
        u = standardize_in(stz, gv[idx])
        mv = standardize_out(stz, model_gv[tidx])
        x, out_std = predict_step(params, x, u, mv)
        out = unstandardize_out(stz, out_std)
        a2, logp2, pr2 = scatter_outputs(L, out)
        gs2 = GridState(t=a2[0], u=a2[1], v=a2[2],
                       q=jnp.maximum(a2[3], 1e-6), logp=logp2)
        return x, gs2, jnp.maximum(pr2, 0.0)

    import jax.numpy as jnp2
    sst = jnp2.asarray(np.asarray(sp.coupler.sst_am), jnp2.float32)
    tisr = jnp2.asarray(np.full((cfg.il, cfg.ix), 300.0), jnp2.float32)
    x = jnp2.zeros((L.R, params.win.shape[1]), jnp2.float32)
    pr_t = jnp2.zeros((cfg.il, cfg.ix), jnp2.float32)

    zero_pr = jnp2.zeros((cfg.il, cfg.ix), jnp2.float32)
    x, gs, pr_t = hybrid_step(params, stz, x, gs0, pr_t, surf, forcing,
                              sst, tisr)
    jax.block_until_ready(gs.t)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        x, gs, pr_t = hybrid_step(params, stz, x, gs,
                                  zero_pr if r2_program else pr_t, surf,
                                  forcing, sst, tisr)
    jax.block_until_ready(gs.t)
    dt = time.perf_counter() - t0
    gp = cfg.ix * cfg.il * cfg.kx
    return n_steps * gp / dt, dt / n_steps, trained


def _ensemble_setup(grid_compute="bfloat16", wout_dtype="float32"):
    import jax.numpy as jnp

    from speedyml.hybrid.ensemble import EnsembleHybrid
    from speedyml.hybrid.forecast import SpeedyForecaster

    sp, hm, trained, gs0 = _speedy_and_hm(grid_compute)
    if wout_dtype != "float32":
        import dataclasses as _dc
        from speedyml.reservoir.esn import cast_wout
        hm = _dc.replace(hm, params=cast_wout(hm.params,
                                              jnp.dtype(wout_dtype)))
        # free the f32 bank: keeping both copies resident lowers the bf16
        # sweep's memory ceiling below the f32 one
        _CACHE.pop("hm", None)
    fc = SpeedyForecaster(sp, hours=6, physics=True)
    surf, forcing, _, _ = fc._surf_forcing(sp.date)
    eh = EnsembleHybrid(hm, fc)
    sst = np.asarray(sp.coupler.sst_am, np.float32)
    tisr = np.full((sp.config.il, sp.config.ix), 300.0, np.float32)
    return sp, hm, fc, eh, gs0, surf, forcing, sst, tisr


def _ensemble_members(setup, E):
    """(x_e, atmo_e, logp_e, pr_e): E perturbed copies of the bench state."""
    import jax.numpy as jnp

    sp, hm, fc, eh, gs0, surf, forcing, sst, tisr = setup
    rng = np.random.default_rng(1)
    atmo = np.stack([np.asarray(gs0.t), np.asarray(gs0.u),
                     np.asarray(gs0.v),
                     np.maximum(np.asarray(gs0.q), 1e-6)])
    atmo_e = (atmo[None] + 0.01 * rng.normal(
        size=(E,) + atmo.shape)).astype(np.float32)
    logp_e = np.broadcast_to(np.asarray(gs0.logp), (E,) + gs0.logp.shape
                             ).astype(np.float32).copy()
    pr_e = np.zeros_like(logp_e)
    x_e = jnp.zeros((E, hm.layout.R, hm.params.win.shape[1]), jnp.float32)
    return x_e, atmo_e, logp_e, pr_e


def ensemble_budget(setup) -> int:
    """Widest ensemble that fits the device: its memory limit
    (memory_stats()["bytes_limit"]) over the per-member bytes of the
    compiled step, measured as the difference of the step's memory analysis
    at E=2 and E=1 (arguments, outputs and temporaries)."""
    import jax
    import jax.numpy as jnp

    sp, hm, fc, eh, gs0, surf, forcing, sst, tisr = setup
    if eh._fn is None:
        eh._fn = eh._build()
    idx, tidx = hm._maps()
    ss = jnp.asarray(np.maximum(sst, 272.0), jnp.float32)
    ti = jnp.asarray(np.maximum(tisr, 0.0), jnp.float32)

    def step_bytes(E):
        ma = eh._fn.lower(hm.params, hm.stz, idx, tidx,
                          *_ensemble_members(setup, E), ss, ti, surf,
                          forcing).compile().memory_analysis()
        return (ma.argument_size_in_bytes + ma.output_size_in_bytes
                + ma.temp_size_in_bytes)

    one, two = step_bytes(1), step_bytes(2)
    per_member = max(two - one, 1)
    limit = jax.devices()[0].memory_stats()["bytes_limit"]
    return max(int((limit - (one - per_member)) // per_member), 1)


def measure_ensemble_E(setup, E, n_steps=4):
    """One ensemble width: E x gridpoints x steps / s (the climate-ensemble
    mode: the whole hybrid step vmapped over E members)."""
    import jax

    sp, hm, fc, eh, gs0, surf, forcing, sst, tisr = setup
    cfg = sp.config
    gp = cfg.ix * cfg.il * cfg.kx
    x_e, atmo_e, logp_e, pr_e = _ensemble_members(setup, E)
    out = eh.step(x_e, atmo_e, logp_e, pr_e, sst, tisr, surf, forcing)
    jax.block_until_ready(out[1])
    t0 = time.perf_counter()
    x_e, a_e, l_e, p_e = out[0], out[1], out[2], out[3]
    for _ in range(n_steps):
        x_e, a_e, l_e, p_e, _safe = eh.step(x_e, a_e, l_e, p_e, sst,
                                            tisr, surf, forcing)
    jax.block_until_ready(a_e)
    dt = time.perf_counter() - t0
    return E * n_steps * gp / dt


def measure_ensemble_attribution(E, n_steps=4, grid_compute="bfloat16"):
    """Component attribution at width E (where the ensemble step
    saturates): vmapped SPEEDY window alone vs the ESN exchange alone
    (pack + standardize + advance/readout + scatter, weights broadcast)."""
    import jax
    import jax.numpy as jnp

    from speedyml.domain.decomposition import pack_global, scatter_outputs
    from speedyml.domain.standardize import (standardize_in, standardize_out,
                                             unstandardize_out)
    from speedyml.hybrid.forecast import SpeedyForecaster
    from speedyml.hybrid.state_io import GridState
    from speedyml.reservoir.esn import predict_step

    sp, hm, trained, gs0 = _speedy_and_hm(grid_compute)
    fc = SpeedyForecaster(sp, hours=6, physics=True)
    surf, forcing, _, _ = fc._surf_forcing(sp.date)
    L = hm.layout
    idx = jnp.asarray(L.input_index)
    tidx = jnp.asarray(L.target_index)
    win = fc._window_fn()
    rng = np.random.default_rng(1)
    atmo = np.stack([np.asarray(gs0.t), np.asarray(gs0.u),
                     np.asarray(gs0.v),
                     np.maximum(np.asarray(gs0.q), 1e-6)])
    atmo_e = jnp.asarray((atmo[None] + 0.01 * rng.normal(
        size=(E,) + atmo.shape)).astype(np.float32))
    logp_e = jnp.asarray(np.broadcast_to(
        np.asarray(gs0.logp), (E,) + gs0.logp.shape).astype(np.float32))
    pr_e = jnp.zeros_like(logp_e)
    ssj = jnp.asarray(np.asarray(sp.coupler.sst_am, np.float32))
    tij = jnp.asarray(np.full((sp.config.il, sp.config.ix), 300.0,
                              np.float32))

    def _win_member(a, lp):
        gs = GridState(t=a[0], u=a[1], v=a[2],
                       q=jnp.maximum(a[3], 1e-6), logp=lp)
        r = win(gs, surf, forcing)
        return r.gs.t

    win_e = jax.jit(jax.vmap(_win_member))
    jax.block_until_ready(win_e(atmo_e, logp_e))
    t0 = time.perf_counter()
    for _ in range(n_steps):
        _w = win_e(atmo_e, logp_e)
    jax.block_until_ready(_w)
    dt_w = (time.perf_counter() - t0) / n_steps

    # weights/stats enter as jit ARGUMENTS (HybridModel._build_step
    # contract) — closing over the 3.4 GB bank would embed it in the
    # compiled program
    def _esn_member(params, stz, x, a, lp, pt):
        gv = pack_global(L, a, lp, pt, ssj, tij)
        u = standardize_in(stz, gv[idx])
        mv = standardize_out(stz, gv[tidx])
        x, out_std = predict_step(params, x, u, mv)
        out = unstandardize_out(stz, out_std)
        a2, lp2, pr2 = scatter_outputs(L, out)
        return x, a2
    esn_e = jax.jit(jax.vmap(_esn_member,
                             in_axes=(None, None, 0, 0, 0, 0)))
    x_e = jnp.zeros((E, L.R, hm.params.win.shape[1]), jnp.float32)
    xe, ae = esn_e(hm.params, hm.stz, x_e, atmo_e, logp_e, pr_e)
    jax.block_until_ready(ae)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        xe, ae = esn_e(hm.params, hm.stz, xe, atmo_e, logp_e, pr_e)
    jax.block_until_ready(ae)
    dt_e = (time.perf_counter() - t0) / n_steps
    return dt_w, dt_e


def bench_fastloop(n_chunks=3, chunk=28):
    """Production chunked prediction loop (hybrid.fastloop): seconds per
    hybrid step of a full-physics K-step scanned chunk, steady state
    (first chunk = compile, excluded)."""
    from speedyml.core.calendar import ModelDate
    from speedyml.hybrid.fastloop import ScanHybridRunner

    sp, hm, trained, gs0 = _speedy_and_hm("float32")
    r = ScanHybridRunner(hm, sp, physics=True, chunk=chunk)
    import jax.numpy as jnp
    atmo = np.stack([np.asarray(gs0.t), np.asarray(gs0.u),
                     np.asarray(gs0.v),
                     np.maximum(np.asarray(gs0.q), 1e-6)]).astype(np.float32)
    logp = np.asarray(gs0.logp, np.float32)
    x0 = jnp.zeros((hm.layout.R, hm.params.win.shape[1]), jnp.float32)
    date0 = ModelDate(1982, 1, 3, 0)
    # compile + 1 chunk
    r.run(x0, atmo, logp, None, date0, chunk)
    t0 = time.perf_counter()
    out = r.run(x0, atmo, logp, None, date0, n_chunks * chunk)
    dt = time.perf_counter() - t0
    steps = len(out["atmo"]) if out["atmo"] is not None else n_chunks * chunk
    return dt / max(steps, 1), bool(out["aborted"])


_TRAIN_BLOCK_SRC = r"""
import time, numpy as np
import jax
import jax.numpy as jnp
from speedyml.utils.compile_cache import enable_compile_cache
enable_compile_cache()
from speedyml.core.config import ReservoirConfig
from speedyml.reservoir.generate import generate_esn
from speedyml.reservoir.training import (drive_and_accumulate, drive_discard,
                                         init_normal_eq, ridge_solve_device)

Rb, n_in, n_out, T, chunk = 8, 576, 136, 2048, 256
rcfg = ReservoirConfig()
params = generate_esn(0, Rb, n_in, n_out, n_model=n_out, m_target=6000)
rng = np.random.default_rng(0)
u = jnp.asarray(rng.normal(size=(T, Rb, n_in)), jnp.float32)
y = jnp.asarray(rng.normal(size=(T, Rb, n_out)), jnp.float32)
m = jnp.asarray(rng.normal(size=(T, Rb, n_out)), jnp.float32)
key = jax.random.PRNGKey(0)

def block():
    x = jnp.zeros((Rb, params.n), jnp.float32)
    x = drive_discard(params, x, u[:40], noise_mag=0.2, rng_key=key)
    acc = init_normal_eq(params, n_out)._replace(x=x)
    acc = drive_and_accumulate(params, acc, u[40:-1], y[41:], m[41:],
                               noise_mag=0.2, rng_key=key, chunk=chunk)
    w = ridge_solve_device(acc, n_out, rcfg.beta_res, rcfg.beta_model)
    return w

w = jax.block_until_ready(block())      # compile + first run
t0 = time.perf_counter()
w = jax.block_until_ready(block())
dt = time.perf_counter() - t0
print(f"TRAIN_BLOCK_S {dt:.3f} T {T}")
"""


def bench_train_block():
    """One 8-region reference-scale training block (state loop +
    compensated accumulation + device-f64 ridge solve) in a subprocess;
    returns (seconds_per_block, samples)."""
    try:
        r = subprocess.run([sys.executable, "-c", _TRAIN_BLOCK_SRC],
                           capture_output=True, text=True, timeout=1200,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        for line in r.stdout.splitlines():
            if line.startswith("TRAIN_BLOCK_S"):
                parts = line.split()
                return float(parts[1]), int(parts[3])
        print(f"# train block bench failed: {r.stdout[-200:]} "
              f"{r.stderr[-400:]}", file=sys.stderr)
    except Exception as e:
        print(f"# train block bench error: {e!r}", file=sys.stderr)
    return None, None


# ========================================================================
# stages (each runs in its own subprocess; emit() after EVERY measurement)
# ========================================================================

def stage_hybrid():
    """Primary metric + dtype variants, trained weights when present."""
    gps, step_s, trained = bench_hybrid_step()
    emit({"hybrid_ms_per_step": round(step_s * 1e3, 2),
          "hybrid_weights": "trained" if trained else "random",
          "_gps_float32": round(gps, 1)})
    for name, kw in (("bf16", dict(grid_compute="bfloat16")),
                     ("bf16_wout", dict(wout_dtype="bfloat16")),
                     ("bf16_both", dict(grid_compute="bfloat16",
                                        wout_dtype="bfloat16"))):
        try:
            g, s, _ = bench_hybrid_step(**kw)
            emit({f"hybrid_ms_per_step_{name}": round(s * 1e3, 2),
                  f"_gps_{name}": round(g, 1)})
        except Exception as e:
            emit({f"hybrid_ms_per_step_{name}_error": repr(e)[:120]})


def stage_hybrid_random():
    """Regression attribution: same program with random
    weights isolates weight-content effects; the r2-style program (identity
    stats + zero precip) isolates the program change since r2."""
    _, s_rand, _ = bench_hybrid_step(force_random=True)
    emit({"hybrid_ms_per_step_random_weights": round(s_rand * 1e3, 2)})
    _, s_r2, _ = bench_hybrid_step(force_random=True, r2_program=True)
    emit({"hybrid_ms_per_step_r2_program": round(s_r2 * 1e3, 2)})


def stage_fastloop():
    fl_s, fl_aborted = bench_fastloop()
    emit({"fastloop_s_per_step": round(fl_s, 3),
          "fastloop_aborted": fl_aborted})


def stage_ensemble(wout_dtype):
    """E sweep, ascending, within one process: per-E results emit() as they
    land, and the FIRST failure ends the stage immediately (nothing is
    measured after an out-of-memory failure)."""
    setup = _ensemble_setup(wout_dtype=wout_dtype)
    wout_bytes = int(np.prod(setup[1].params.wout.shape)) * (
        2 if wout_dtype == "bfloat16" else 4)
    e_max = ensemble_budget(setup)
    ens_list = sorted({e for e in (16, 32, 48, 64, 80, 96, 128)
                       if e < e_max} | {e_max})
    tag = "bf16_wout" if wout_dtype == "bfloat16" else "f32"
    emit({f"ensemble_{tag}_budget_E_max": e_max,
          f"ensemble_{tag}_bank_gb": round(wout_bytes / 2**30, 2)})
    best, best_E = 0.0, 0
    for E in ens_list:
        try:
            gps = measure_ensemble_E(setup, E)
        except Exception as e:
            emit({f"ensemble_{tag}_sweep_{E}": "OOM",
                  f"ensemble_{tag}_oom_detail": repr(e)[:80]})
            break                 # allocator is poisoned; exit the stage
        emit({f"ensemble_{tag}_sweep_{E}": round(gps, 1)})
        if gps > best:
            best, best_E = gps, E
    emit({f"ensemble_{tag}_best_gps": round(best, 1),
          f"ensemble_{tag}_best_E": best_E})


def stage_ens_attr(E):
    dt_w, dt_e = measure_ensemble_attribution(E)
    emit({"ensemble_window_ms_at_best_E": round(dt_w * 1e3, 2),
          "ensemble_esn_ms_at_best_E": round(dt_e * 1e3, 2),
          "ensemble_attr_E": E})


def stage_drycore():
    dry_f32, e32 = bench_dry_core(grid_compute="float32")
    emit({"dry_core_f32": round(dry_f32, 1), "_dry_ens_f32": e32})
    dry_bf16, e16 = bench_dry_core(grid_compute="bfloat16")
    emit({"dry_core_bf16": round(dry_bf16, 1), "_dry_ens_bf16": e16})
    emit({"dry_core_ens": e32 if dry_f32 >= dry_bf16 else e16})


STAGES = {
    "hybrid": stage_hybrid,
    "hybrid_random": stage_hybrid_random,
    "fastloop": stage_fastloop,
    "ens_f32": lambda: stage_ensemble("float32"),
    "ens_bf16": lambda: stage_ensemble("bfloat16"),
    "drycore": stage_drycore,
}


# ========================================================================
# orchestrator
# ========================================================================

def run_stage(name, out, extra_args=(), timeout=2400):
    """One stage subprocess; merge its STAGE_JSON lines into `out` (and the
    partial file) AS THEY ARRIVE, so even a hung-then-killed stage keeps
    everything it measured."""
    import threading
    cmd = [sys.executable, os.path.abspath(__file__), "--stage", name,
           *extra_args]
    t0 = time.time()
    got = 0
    try:
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL, text=True,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        # hard watchdog: a hung stage prints nothing, so the timeout must
        # not depend on lines arriving
        timed_out = threading.Event()

        def _kill():
            timed_out.set()
            p.kill()
        watchdog = threading.Timer(timeout, _kill)
        watchdog.start()
        try:
            for line in p.stdout:
                if line.startswith("STAGE_JSON "):
                    out.update(json.loads(line[len("STAGE_JSON "):]))
                    got += 1
                    with open(PARTIAL_PATH, "w") as f:
                        json.dump(out, f)
            rc = p.wait(timeout=60)
            if timed_out.is_set():
                out[f"{name}_error"] = f"timeout {timeout}s"
            elif rc != 0:
                out[f"{name}_error"] = f"rc={rc}"
        finally:
            watchdog.cancel()
            if p.poll() is None:
                p.kill()
    except Exception as e:
        out[f"{name}_error"] = repr(e)[:120]
    print(f"# stage {name}: {got} results, {time.time()-t0:.0f}s"
          + (f" [{out.get(f'{name}_error')}]" if f"{name}_error" in out
             else ""), file=sys.stderr)
    with open(PARTIAL_PATH, "w") as f:
        json.dump(out, f)


def main():
    out = {}
    run_stage("hybrid", out)
    run_stage("hybrid_random", out)
    run_stage("fastloop", out)
    run_stage("ens_f32", out)
    run_stage("ens_bf16", out)
    # attribution at the best measured width (its own process: it follows
    # a sweep whose end state may be a poisoned allocator)
    best_E = max(out.get("ensemble_f32_best_E", 0),
                 out.get("ensemble_bf16_wout_best_E", 0))
    if best_E:
        run_stage("ens_attr", out, extra_args=("--e", str(best_E)))
    run_stage("drycore", out)
    tb_s, tb_T = bench_train_block()
    if tb_s is not None:
        out["train_block_s"] = round(tb_s, 2)
        out["train_block_samples"] = tb_T
    with open(PARTIAL_PATH, "w") as f:
        json.dump(out, f)

    # primary metric: best hybrid-step mode
    gp = 96 * 48 * 8
    modes = {"float32": out.get("hybrid_ms_per_step"),
             "bfloat16-grid": out.get("hybrid_ms_per_step_bf16"),
             "bfloat16-wout": out.get("hybrid_ms_per_step_bf16_wout"),
             "bfloat16-grid+wout": out.get("hybrid_ms_per_step_bf16_both")}
    modes = {k: v for k, v in modes.items() if v}
    if not modes:
        print(json.dumps({"metric":
                          "t30l8_hybrid_step_gridpoints_per_s_per_chip",
                          "value": None, "unit": "gridpoint-steps/s/chip",
                          "error": "no hybrid metric",
                          **out}))
        return 1
    best_mode = min(modes, key=modes.get)
    hybrid_gps = gp / (modes[best_mode] * 1e-3)
    out["hybrid_mode"] = best_mode

    # ensemble best across sweeps
    eb = {"f32": out.get("ensemble_f32_best_gps", 0) or 0,
          "bfloat16-wout": out.get("ensemble_bf16_wout_best_gps", 0) or 0}
    if max(eb.values()) > 0:
        m = max(eb, key=eb.get)
        out["hybrid_ensemble_gps"] = eb[m]
        out["hybrid_ensemble_E"] = out.get(
            "ensemble_f32_best_E" if m == "f32" else
            "ensemble_bf16_wout_best_E")
        out["hybrid_ensemble_mode"] = m

    print(json.dumps({
        "metric": "t30l8_hybrid_step_gridpoints_per_s_per_chip",
        "value": round(hybrid_gps, 1),
        "unit": "gridpoint-steps/s/chip",
        **out,
    }))
    return 0


if __name__ == "__main__":
    from speedyml.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", default=None)
    ap.add_argument("--e", type=int, default=64)
    a = ap.parse_args()
    if a.stage is None:
        sys.exit(main())
    if a.stage == "ens_attr":
        stage_ens_attr(a.e)
    else:
        STAGES[a.stage]()
