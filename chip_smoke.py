"""Smoke test of the hybrid SPEEDY + reservoir main path on NVIDIA GPUs.

    python chip_smoke.py               # one card, the phases below (~15 min)
    python chip_smoke.py --multichip   # four cards, the sharded paths only

One card, through the entry points a user calls, at reference width, on the
aquaplanet boundary (io.boundary) with seeded random reservoir weights:

  device      the card's name and power limit (nvidia-smi); refuses to run
              unless JAX's first device is a GPU (no CPU fallback)
  speedy      Speedy: initialize() + run_days(1) in f32; one 6-h window on
              the GPU (default and "highest" matmul precision) against the
              same window in float64 on JAX's CPU backend
  training    12 weeks of 6-hourly truth with a synthetic ENSO anomaly
              (TrajectoryRunner + collect_truth), dry-core forecasts
              (collect_forecasts), train_hybrid(also_ml=True,
              solver="device") for 1152 regions at m=6000 (na=5896),
              train_ocean at 4000 nodes; device-vs-host ridge solve for 2
              regions; the XLA normal-equation accumulation timed
  prediction  one coupled week through ScanHybridRunner (ocean on), 4
              ML-only steps through HybridRunner, and one hybrid step on the
              GPU in f32 against the same step in float64 on the CPU

Each phase prints its wall time and the device's peak memory so far
(memory_stats()["peak_bytes_in_use"]). The last line is one JSON object,
printed only when every phase and check passed; otherwise the exit code is
1 and no result is printed.

One process holds the card for the whole run. The float64 work (ridge
solves and CPU references) is scoped with jax.enable_x64 inside this
process, and the references run on JAX's CPU backend, which needs no
card. So no second JAX process ever competes for the card's memory, and
the reference computations see exactly the arrays the GPU produced.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

from speedyml.core.calendar import ModelDate
from speedyml.core.config import ModelConfig, ReservoirConfig
from speedyml.hybrid.state_io import SAFE_BOUNDS
from speedyml.utils.compile_cache import enable_compile_cache

# Agreement tolerances, each a relative RMS difference
# ||a - ref|| / ||ref - mean(ref)||. Over a 6-h window from a developed
# aquaplanet state, f32 differs from f64 on the CPU by at most 1.2e-3 in
# t/u/v/q/logp, and by 3e-2 in precipitation, where f32 rounding flips
# convection and condensation triggers at single points. The tolerances
# leave a factor >= 5 for the GPU's summation order and math library.
TOL_WINDOW = dict(t=1e-2, u=1e-2, v=1e-2, q=1e-2, logp=1e-2, precip=0.2)
TOL_HYBRID = 1e-2
# device f64 Cholesky vs host f64 LU of the same normal equations; the
# device result is returned in f32
TOL_RIDGE = 1e-5


def require_gpu(devices) -> None:
    """Exit unless JAX's first device is a GPU."""
    if not devices or devices[0].platform != "gpu":
        kinds = sorted({d.platform for d in devices})
        raise SystemExit(f"chip_smoke needs an NVIDIA GPU; JAX found {kinds}")


def rel_rms(a, ref) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref - ref.mean()))


class Run:
    """Phase bookkeeping: timing, peak memory, checks and failures."""

    def __init__(self):
        self.failed = []

    def check(self, name: str, ok: bool, detail: str = "") -> bool:
        print(f"  check {name}: {'ok' if ok else 'FAILED'} {detail}",
              flush=True)
        if not ok:
            self.failed.append(name)
        return ok

    def compare(self, name: str, got: dict, ref: dict, tol) -> bool:
        """Per-field rel_rms of `got` against `ref`, each within its
        tolerance (`tol`: one value, or a dict by field)."""
        tols = tol if isinstance(tol, dict) else dict.fromkeys(ref, tol)
        errs = {k: rel_rms(got[k], ref[k]) for k in ref}
        line = " ".join(f"{k}={v:.3e} (tol {tols[k]:g})"
                        for k, v in errs.items())
        return self.check(name, all(errs[k] <= tols[k] for k in errs),
                          f"rel RMS vs reference: {line}")

    def phase(self, name: str, fn, *args):
        """Run one phase; an exception fails it (and the run) and the
        traceback is printed, so later independent phases still report."""
        print(f"[{name}] start", flush=True)
        t0 = time.perf_counter()
        try:
            return fn(self, *args)
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            return None
        finally:
            stats = jax.devices()[0].memory_stats() or {}
            peak = stats.get("peak_bytes_in_use", 0) / 2**30
            print(f"[{name}] wall {time.perf_counter() - t0:.1f} s, device "
                  f"peak memory {peak:.2f} GiB", flush=True)


@contextlib.contextmanager
def cpu_f64():
    """float64 reference work on JAX's CPU backend."""
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        yield


def grid_fields(gs, precip=None) -> dict:
    out = {k: np.asarray(getattr(gs, k)) for k in ("t", "u", "v", "q",
                                                    "logp")}
    if precip is not None:
        out["precip"] = np.asarray(precip)
    return out


def check_bounds(run: Run, name: str, atmo, logp) -> bool:
    """Finite and inside the reference's safety gate (state_io)."""
    atmo = np.asarray(atmo)
    ok = bool(np.isfinite(atmo).all() and np.isfinite(logp).all())
    desc = []
    for v, key in enumerate(("t", "u", "v", "q")):
        lo, hi = SAFE_BOUNDS[key]
        f = atmo[..., v, :, :, :]
        ok &= bool(f.min() >= lo and f.max() <= hi)
        desc.append(f"{key} [{f.min():.2f}, {f.max():.2f}]")
    return run.check(f"{name} finite and in bounds", ok, " ".join(desc))


def nvidia_smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except OSError as e:
        return f"nvidia-smi unavailable: {e}"
    return r.stdout.strip() or r.stderr.strip()


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------
def phase_speedy(run: Run, develop_days=29):
    """Workload 1: full-physics SPEEDY, and the window's f64 agreement."""
    from speedyml.hybrid.forecast import SpeedyForecaster
    from speedyml.hybrid.state_io import extract
    from speedyml.model import Speedy

    sp = Speedy(ModelConfig(dtype="float32"))
    sp.initialize(year=1982, month=1)
    t0 = time.perf_counter()
    sp.run_days(1)                     # 96 leapfrog steps, one program
    g = sp.grid_view()
    print(f"  run_days(1): {time.perf_counter() - t0:.2f} s incl. compile")
    atmo = np.stack([g["t"], g["u"], g["v"], g["q"]])
    check_bounds(run, "run_days(1)", atmo, g["ps"])

    # compare the window on a developed flow (day 30): one day from rest
    # the winds are ~1 m/s, and two weeks in the zonally symmetric
    # aquaplanet flow is still breaking up from rounding noise, so f32 and
    # f64 differ by more than their arithmetic (v 1.3e-2, precip 0.16 on
    # the CPU at day 15)
    sp.run_days(develop_days)
    gs = jax.tree.map(np.asarray, extract(sp.dy, sp.state, level=0))
    date = sp.date
    res = SpeedyForecaster(sp, 6, physics=True).forecast(gs, date)
    gpu_default = grid_fields(res.gs, res.precip_mm)
    with jax.default_matmul_precision("highest"):
        res = SpeedyForecaster(sp, 6, physics=True).forecast(gs, date)
        gpu_highest = grid_fields(res.gs, res.precip_mm)
    with cpu_f64():
        sp64 = Speedy(ModelConfig(dtype="float64"))
        res = SpeedyForecaster(sp64, 6, physics=True).forecast(gs, date)
        ref = grid_fields(res.gs, res.precip_mm)
    run.compare("6-h window, default matmul precision", gpu_default, ref,
                TOL_WINDOW)
    run.compare("6-h window, highest matmul precision", gpu_highest, ref,
                TOL_WINDOW)


def phase_training(run: Run, n_samples=336, spinup_days=10, m=6000,
                   slab_nodes=4000, region_block=8):
    """Workload 5 (with 2 and 3 solved inline): data, atmosphere and ocean
    training at reference width. Returns what the prediction phase needs."""
    from speedyml.coupler.anomaly import SyntheticEnso
    from speedyml.domain.decomposition import build_layout
    from speedyml.hybrid.experiment import (collect_forecasts, collect_truth,
                                            train_hybrid, transform_and_pack)
    from speedyml.hybrid.forecast import SpeedyForecaster, TrajectoryRunner
    from speedyml.model import Speedy
    from speedyml.reservoir.slab import train_ocean

    cfg = ModelConfig(dtype="float32")
    sp = Speedy(cfg)
    lat = np.degrees(np.asarray(sp.dy.tables.radang))
    # one 12-week period of a +-1.5 K ENSO-like anomaly starting with the
    # samples: the slab-ocean targets then vary by ~1 K^2 where the pattern
    # is strong, above sst_variance_threshold (0.2 K^2)
    t_start = ModelDate(1982, 1, 1, 0)
    t_start.advance_hours(24 * spinup_days)
    enso = SyntheticEnso(lat, np.arange(cfg.ix) * 360.0 / cfg.ix,
                         sp.clim.fmask_s, seed=7, amp=1.5,
                         period_days=n_samples / 4.0, ramp_days=7.0,
                         t0=(t_start.iyear, t_start.imonth, t_start.iday))
    runner = TrajectoryRunner(sp, sst_anom_fn=enso.sst_anom_fn)
    t0 = time.perf_counter()
    runner.initialize(year=1982, month=1, spinup_days=spinup_days)
    truth = collect_truth(runner, n_samples)
    t1 = time.perf_counter()
    m_atmo, m_logp, m_precip = collect_forecasts(
        SpeedyForecaster(sp, 6, physics=False), truth)
    t2 = time.perf_counter()
    print(f"  truth: {n_samples} samples + {spinup_days} spin-up days in "
          f"{t1 - t0:.1f} s; dry-core forecasts in {t2 - t1:.1f} s")
    check_bounds(run, "truth", truth.atmo, truth.logp)

    rcfg = ReservoirConfig(nodes_per_input=m)
    L = build_layout(radang_deg=lat)
    eps = rcfg.precip_epsilon
    gv_truth = transform_and_pack(L, truth.atmo, truth.logp, truth.precip,
                                  truth.sst, truth.tisr, eps)
    gv_model = transform_and_pack(L, m_atmo, m_logp, m_precip, truth.sst,
                                  truth.tisr, eps)
    t0 = time.perf_counter()
    hm = train_hybrid(L, rcfg, gv_truth, gv_model, seed=0,
                      region_block=region_block, solver="device",
                      also_ml=True, verbose=True)
    t_train = time.perf_counter() - t0
    n_blocks = -(-L.R // region_block)
    na = hm.params.wout.shape[-1]
    print(f"  train_hybrid: {L.R} regions, n={hm.params.n}, na={na}, "
          f"{n_blocks} blocks in {t_train:.1f} s "
          f"({t_train / n_blocks:.2f} s/block)")
    run.check("atmosphere readouts finite",
              bool(np.isfinite(hm.host_np["wout"]).all()
                   and np.isfinite(hm.host_np["wout_ml"]).all()))

    t0 = time.perf_counter()
    ocean = train_ocean(L, ReservoirConfig(slab_nodes=slab_nodes), gv_truth,
                        seed=100, region_block=64, solver="device")
    n_active = int(ocean.active.sum())
    print(f"  train_ocean: n={ocean.params.n}, {n_active}/{ocean.ol.R} "
          f"active regions in {time.perf_counter() - t0:.1f} s")
    run.check("active ocean regions > 0", n_active > 0, f"({n_active})")

    ridge_agreement(run, hm, gv_truth, gv_model)
    accumulation_timing(na, t_train / n_blocks, gv_truth.shape[0]
                        - rcfg.discardlength // rcfg.timestep - 1)
    return sp, hm, ocean, gv_truth, runner.date


def ridge_agreement(run: Run, hm, gv_truth, gv_model, regions=2):
    """Device f64 Cholesky vs host f64 solve on the same accumulators."""
    from speedyml.reservoir.generate import generate_esn
    from speedyml.reservoir.training import (drive_and_accumulate,
                                             drive_discard, init_normal_eq,
                                             ridge_solve, ridge_solve_device)

    L, rcfg, stz = hm.layout, hm.rcfg, hm.stz
    blk = np.arange(regions)
    mean = lambda a: np.asarray(a)[blk]
    u = (gv_truth[:, L.input_index[blk]] - mean(stz.in_mean)) / mean(
        stz.in_std)
    y = (gv_truth[:, L.target_index[blk]] - mean(stz.out_mean)) / mean(
        stz.out_std)
    mv = (gv_model[:, L.target_index[blk]] - mean(stz.out_mean)) / mean(
        stz.out_std)
    params = generate_esn(0, regions, L.n_in, L.n_out, L.n_out,
                          m_target=rcfg.nodes_per_input)
    discard = rcfg.discardlength // rcfg.timestep
    x = drive_discard(params, jnp.zeros((regions, params.n)), u[:discard])
    acc = init_normal_eq(params, L.n_out)._replace(x=x)
    acc = drive_and_accumulate(params, acc, u[discard:-1], y[discard + 1:],
                               mv[discard + 1:], chunk=64)
    args = (L.n_out, rcfg.beta_res, rcfg.beta_model)
    w_dev = np.asarray(ridge_solve_device(acc, *args), np.float64)
    w_host = ridge_solve(acc, *args)
    err = float(np.linalg.norm(w_dev - w_host) / np.linalg.norm(w_host))
    run.check(f"ridge solve device f64 vs host f64 ({regions} regions)",
              err <= TOL_RIDGE, f"rel err {err:.3e} (tol {TOL_RIDGE:g})")


def accumulation_timing(na, block_s, samples, regions=8, chunk=128,
                        reps=10):
    """The XLA normal-equation accumulation (einsum + two-sum) at training
    width: time per chunk, its share of a training block, and its error
    at default and "highest" matmul precision against float64."""
    from speedyml.reservoir.training import accumulate_chunk

    rng = np.random.default_rng(0)
    aug = jnp.asarray(rng.uniform(-1, 1, (chunk, regions, na)), jnp.float32)
    hi = jnp.zeros((regions, na, na), jnp.float32)
    fn = jax.jit(accumulate_chunk)
    jax.block_until_ready(fn(hi, hi, aug))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(hi, hi, aug)
    jax.block_until_ready(out)
    per_chunk = (time.perf_counter() - t0) / reps
    per_block = per_chunk * samples / chunk
    print(f"  accumulation (R={regions}, chunk={chunk}, na={na}): "
          f"{per_chunk * 1e3:.2f} ms/chunk; {samples} samples -> "
          f"{per_block * 1e3:.1f} ms = {100 * per_block / block_s:.1f}% of "
          f"a {block_s:.2f} s training block")
    with jax.enable_x64(True):
        a64 = aug[:, :2].astype(jnp.float64)
        ref = np.asarray(jnp.einsum("tra,trb->rab", a64, a64))
    for prec in ("default", "highest"):
        with jax.default_matmul_precision(prec):
            h, lo = jax.jit(accumulate_chunk)(hi[:2], hi[:2], aug[:, :2])
        tot = np.asarray(h, np.float64) + np.asarray(lo, np.float64)
        print(f"  accumulation precision {prec}: rel err vs f64 "
              f"{np.linalg.norm(tot - ref) / np.linalg.norm(ref):.3e}")


def phase_prediction(run: Run, trained):
    """Workloads 2, 3 and 4: the coupled week, ML-only steps, and the
    hybrid step's f64 agreement."""
    from speedyml.hybrid.experiment import HybridRunner, ml_variant
    from speedyml.hybrid.fastloop import ScanHybridRunner
    from speedyml.hybrid.forecast import SpeedyForecaster
    from speedyml.reservoir.slab import weekly_ocean_inputs

    sp, hm, ocean, gv_truth, date0 = trained
    L = hm.layout
    n_sync = hm.rcfg.synclength // hm.rcfg.timestep
    s = L.gv_sizes
    last = gv_truth[-1]
    atmo0 = last[s["atmo3d"][0]:s["atmo3d"][1]].reshape(4, L.kx, L.il, L.ix)
    logp0 = last[s["logp"][0]:s["logp"][1]].reshape(L.il, L.ix)
    pr0 = last[s["precip"][0]:s["precip"][1]].reshape(L.il, L.ix)
    x = hm.synchronize(gv_truth[-n_sync:])

    t0 = time.perf_counter()
    x_ocean = ocean.synchronize(weekly_ocean_inputs(
        gv_truth, ocean.steps_per_week, L))
    out = ScanHybridRunner(hm, sp, physics=True).run(
        x, atmo0, logp0, pr0, date0, ocean.steps_per_week, ocean=ocean,
        x_ocean=x_ocean)
    print(f"  coupled week: {out['steps_done']} steps in "
          f"{time.perf_counter() - t0:.1f} s incl. compile, "
          f"aborted: {str(out['aborted']).lower()}")
    run.check("coupled week not aborted", not out["aborted"])
    check_bounds(run, "coupled week", out["atmo"], out["logp"])
    run.check("coupled SST finite", bool(np.isfinite(out["sst"]).all()),
              f"[{out['sst'].min():.2f}, {out['sst'].max():.2f}] K")

    hm_ml = ml_variant(hm)
    fc = SpeedyForecaster(sp, 6, physics=True)
    t0 = time.perf_counter()
    out = HybridRunner(hm_ml, fc).run(
        hm_ml.synchronize(gv_truth[-n_sync:]), atmo0, logp0, pr0, date0, 4)
    print(f"  ML-only: 4 steps in {time.perf_counter() - t0:.1f} s incl. "
          f"compile, aborted: {str(out['aborted']).lower()}")
    run.check("ML-only steps not aborted", not out["aborted"])
    check_bounds(run, "ML-only steps", out["atmo"], out["logp"])

    hybrid_agreement(run, hm, HybridRunner(hm, fc), x, atmo0, logp0, pr0,
                     date0)


def hybrid_agreement(run: Run, hm, runner, x, atmo0, logp0, pr0, date0):
    """One hybrid step (window + reservoirs) on the GPU in f32 against the
    same step in float64 on the CPU, at full width."""
    from speedyml.domain.standardize import Standardizer
    from speedyml.hybrid.experiment import HybridModel, HybridRunner
    from speedyml.hybrid.forecast import SpeedyForecaster
    from speedyml.model import Speedy

    def fields(out):
        a = out["atmo"][0]
        return dict(t=a[0], u=a[1], v=a[2], q=a[3], logp=out["logp"][0],
                    precip=out["precip_mm"][0], x=np.asarray(out["x"]))

    got = fields(runner.run(x, atmo0, logp0, pr0, date0, 1))
    with cpu_f64():
        f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        host = hm.host_np
        params = hm.params._replace(
            a_idx=jnp.asarray(host["a_idx"]), a_val=f64(host["a_val"]),
            win=f64(host["win"]), wout=f64(host["wout"]),
            node_map=jnp.asarray(np.asarray(hm.params.node_map)),
            a_shift=jnp.asarray(np.asarray(hm.params.a_shift)))
        hm64 = HybridModel(layout=hm.layout, params=params,
                           stz=Standardizer(*(f64(a) for a in hm.stz)),
                           rcfg=hm.rcfg)
        sp64 = Speedy(ModelConfig(dtype="float64"))
        ref = fields(HybridRunner(hm64, SpeedyForecaster(sp64, 6)).run(
            f64(x), atmo0, logp0, pr0, date0, 1))
    run.compare("hybrid step GPU f32 vs CPU f64", got, ref, TOL_HYBRID)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------
def timed(fn, *args):
    """(result, seconds) of the second call; the first compiles."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def phase_multichip(run: Run, n_dev=4, m=6000):
    """The region-sharded training block and predict step (dp=4) and the
    latitude-sharded composed step, each against one card."""
    from speedyml.parallel.mesh import make_mesh

    devs = jax.devices()
    run.check(f"{n_dev} devices visible", len(devs) >= n_dev,
              f"({len(devs)})")
    mesh = make_mesh(n_dev, tp=1, devices=devs)
    sharded_training(run, mesh, m)
    sharded_predict(run, mesh, m)
    composed_vs_replicated(run, n_dev, m)


def _regions(mesh, m, T=256, seed=0):
    """Reservoirs for two regions per card at width m, and a random
    standardized series (u, y, mv) of T steps."""
    from speedyml.reservoir.generate import generate_esn

    R, n_in, n_out = 2 * mesh.size, 576, 136
    params = generate_esn(seed, R, n_in, n_out, n_model=n_out, m_target=m)
    rng = np.random.default_rng(seed)
    series = tuple(rng.normal(size=(T, R, k)).astype(np.float32)
                   for k in (n_in, n_out, n_out))
    return params, series


def sharded_training(run: Run, mesh, m):
    """Accumulation with regions over dp vs one card, and the device ridge
    solve of the sharded accumulators vs the host f64 solve."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from speedyml.parallel.mesh import series_sharding, shard_params
    from speedyml.reservoir.training import (drive_and_accumulate,
                                             init_normal_eq, ridge_solve,
                                             ridge_solve_device)

    rcfg = ReservoirConfig(nodes_per_input=m)
    params, (u, y, mv) = _regions(mesh, m)
    n_out = y.shape[-1]
    block = jax.jit(lambda p, acc, u, y, mv: drive_and_accumulate(
        p, acc, u, y, mv, chunk=64))
    one = mesh.devices.flat[0]
    acc0 = init_normal_eq(params, n_out)
    ref, t_one = timed(block, jax.device_put(params, one),
                       jax.device_put(acc0, one), u, y, mv)
    put = lambda a: jax.device_put(a, series_sharding(mesh))
    got, t_sh = timed(block, shard_params(params, mesh),
                      jax.device_put(acc0, NamedSharding(mesh, P("dp"))),
                      put(u), put(y), put(mv))
    f64 = lambda hi, lo: (np.asarray(hi, np.float64)
                          + np.asarray(lo, np.float64))
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    errs = {k: rel(f64(getattr(got, k + "_hi"), getattr(got, k + "_lo")),
                   f64(getattr(ref, k + "_hi"), getattr(ref, k + "_lo")))
            for k in ("ss", "sy")}
    print(f"  training block (R={params.win.shape[0]}, "
          f"na={n_out + params.n}, T={u.shape[0]}): one card {t_one:.3f} s, "
          f"dp={mesh.size} {t_sh:.3f} s")
    # the per-card GEMMs may sum in another order than the one-card GEMM
    run.check("region-sharded accumulation vs one card",
              max(errs.values()) <= 1e-4,
              f"rel err ss {errs['ss']:.3e}, sy {errs['sy']:.3e} (tol 1e-4)")
    args = (n_out, rcfg.beta_res, rcfg.beta_model)
    w_sh = np.asarray(ridge_solve_device(got, *args), np.float64)
    err = rel(w_sh, ridge_solve(got, *args))
    run.check("region-sharded device ridge solve vs host f64",
              err <= TOL_RIDGE, f"rel err {err:.3e} (tol {TOL_RIDGE:g})")
    # with T=256 random samples for na=5896 unknowns the system is ridge
    # dominated and ill-conditioned: a 1e-5 change in sy moves w by O(1)
    w_ref = np.asarray(ridge_solve_device(ref, *args), np.float64)
    print(f"  readouts of the sharded vs the one-card accumulators: rel "
          f"diff {rel(w_sh, w_ref):.3e} (conditioning, not a check)")


def sharded_predict(run: Run, mesh, m):
    """One reservoir predict step with regions over dp vs one card."""
    from speedyml.parallel.mesh import shard_params, state_sharding
    from speedyml.reservoir.esn import predict_step

    params, (u, _, mv) = _regions(mesh, m, T=1)
    rng = np.random.default_rng(1)
    params = params._replace(wout=jnp.asarray(
        rng.normal(size=params.wout.shape) * 1e-3, jnp.float32))
    x0 = rng.normal(size=(params.win.shape[0], params.n)).astype(
        np.float32) * 0.1
    step = jax.jit(predict_step)
    one = mesh.devices.flat[0]
    (x_ref, o_ref), _ = timed(step, jax.device_put(params, one), x0, u[0],
                              mv[0])
    (x_sh, o_sh), _ = timed(step, shard_params(params, mesh),
                            jax.device_put(x0, state_sharding(mesh)), u[0],
                            mv[0])
    err = max(rel_rms(x_sh, x_ref), rel_rms(o_sh, o_ref))
    run.check("region-sharded predict step vs one card", err <= 1e-5,
              f"rel RMS {err:.3e} (tol 1e-5)")


def composed_vs_replicated(run: Run, n_dev, m):
    """The latitude-sharded composed hybrid step (shard_map + psum) against
    the replicated window + reservoir step on one card, full physics and
    full width (random readout)."""
    from jax.sharding import Mesh

    from speedyml.domain.decomposition import build_layout, pack_global
    from speedyml.domain.standardize import Standardizer
    from speedyml.hybrid.experiment import QMIN, HybridModel
    from speedyml.hybrid.forecast import SpeedyForecaster
    from speedyml.hybrid.state_io import GridState, extract
    from speedyml.model import Speedy
    from speedyml.parallel.composed import ComposedHybridStep
    from speedyml.reservoir.generate import generate_esn

    sp = Speedy(ModelConfig(dtype="float32"))
    sp.initialize(year=1982, month=1)
    L = build_layout(radang_deg=np.degrees(np.asarray(sp.dy.tables.radang)))
    rng = np.random.default_rng(1)
    params = generate_esn(1, L.R, L.n_in, L.n_out, n_model=L.n_out,
                          m_target=m)
    params = params._replace(wout=jnp.asarray(
        rng.normal(size=params.wout.shape) * 1e-3, jnp.float32))
    ones = lambda k: jnp.ones((L.R, k), jnp.float32)
    zeros = lambda k: jnp.zeros((L.R, k), jnp.float32)
    hm = HybridModel(layout=L, params=params,
                     stz=Standardizer(zeros(L.n_in), ones(L.n_in),
                                      zeros(L.n_out), ones(L.n_out)),
                     rcfg=ReservoirConfig())
    gs = jax.tree.map(np.asarray, extract(sp.dy, sp.state, level=0))
    atmo = np.stack([gs.t, gs.u, gs.v, np.maximum(gs.q, QMIN)]).astype(
        np.float32)
    logp = gs.logp.astype(np.float32)
    pr = np.zeros_like(logp)
    sst = np.asarray(sp.coupler.sst_am, np.float32)
    tisr = np.zeros_like(logp)
    x0 = jnp.zeros((L.R, params.n), jnp.float32)
    eps = hm.rcfg.precip_epsilon
    win = jax.jit(SpeedyForecaster(sp, 6)._window_fn())

    def replicated(x0):
        ss = jnp.maximum(jnp.asarray(sst), 272.0)
        gv = pack_global(L, jnp.asarray(atmo), jnp.asarray(logp),
                         jnp.asarray(pr), ss, jnp.asarray(tisr))
        res = win(GridState(t=atmo[0], u=atmo[1], v=atmo[2], q=atmo[3],
                            logp=logp), sp.surf, sp.forcing)
        f_atmo = jnp.stack([res.gs.t, res.gs.u, res.gs.v,
                            jnp.maximum(res.gs.q, QMIN)])
        f_pr = jnp.log1p(jnp.maximum(res.precip_mm, 0.0) / eps)
        model_gv = pack_global(L, f_atmo, res.gs.logp, f_pr, ss,
                               jnp.asarray(tisr))
        return hm.step(x0, gv, model_gv)

    ref, t_rep = timed(replicated, x0)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("mp",))
    comp = ComposedHybridStep(hm, sp, mesh, axis="mp", physics=True)
    surf = comp.shard_surface(sp.surf)
    got, t_comp = timed(lambda: comp.step(x0, atmo, logp, pr, sst, tisr,
                                          surf, sp.forcing))
    print(f"  hybrid step: replicated on one card {t_rep * 1e3:.2f} ms, "
          f"latitude-sharded over {n_dev} cards {t_comp * 1e3:.2f} ms")
    names = ("x", "atmo", "logp")
    run.compare("latitude-sharded composed step vs one card",
                {k: got[i] for i, k in enumerate(names)},
                {k: ref[i] for i, k in enumerate(names)}, TOL_HYBRID)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    print(nvidia_smi(), flush=True)
    devices = jax.devices()
    require_gpu(devices)
    print(f"device: {devices[0].device_kind}, count {len(devices)}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, compile cache "
          f"{enable_compile_cache()}", flush=True)

    run = Run()
    if args.multichip:
        run.phase("multichip", phase_multichip)
    else:
        run.phase("speedy", phase_speedy)
        trained = run.phase("training", phase_training)
        if trained is not None:
            run.phase("prediction", phase_prediction, trained)
    if run.failed:
        print(f"FAILED: {run.failed}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
