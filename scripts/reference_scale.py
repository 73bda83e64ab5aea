"""Reference-scale hybrid run: m=6000 (n=5760) reservoirs, 1152 regions,
n_aug=5896 ridge per region — the production workload the reference actually
runs (src/mod_reservoir.f90:91-93, src/parallelmain.f90:32), executed on one
GPU.

Phases (run as separate, resumable processes that share the npz cache):

  data   — generate the truth trajectory (full-physics SPEEDY) + imperfect
           one-window forecasts (dry core) and cache them to npz. The last
           --holdout samples are verification-only (never trained on).
  train  — load the cache, train all 1152 regions at reference
           hyperparameters (beta_res=0.001, beta_model=1.0, prior=0.0,
           noise 0.20, discard 240 h — mod_reservoir.f90:85-101), persist
           weights, synchronize, run a >=30-day hybrid prediction, score
           vs persistence on the held-out truth.

The ridge solve runs ON DEVICE in f64 (x64 scoped to the solve), so the
(Rb, 5896, 5896) normal equations (4.5 GB/block) never cross to the host.

Usage:
  python scripts/reference_scale.py data  --cache data/refscale.npz
  python scripts/reference_scale.py train --cache data/refscale.npz
"""

import argparse
import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, ".")

T0 = time.time()


def log(msg):
    print(f"[{time.time()-T0:7.1f}s] {msg}", flush=True)


def peak_rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def phase_data(args):
    """Fused day-batched generation: truth windows + dry-core forecasts in
    ONE jitted day program (FusedDataGenerator) — ~4x fewer RPC round trips
    than the r2 per-window loop, with sample downloads overlapping the next
    day's compute."""
    from speedyml.core.config import ModelConfig
    from speedyml.hybrid.forecast import FusedDataGenerator
    from speedyml.model import Speedy

    cfg = ModelConfig(dtype="float32")
    sp = Speedy(cfg)
    log("model built")
    anom_fn = None
    if args.enso_amp > 0.0:
        # impose a deterministic ENSO-like SST anomaly on the truth boundary
        # (coupler.anomaly — the in-repository stand-in for the observed
        # SST the reference trains its ocean on)
        from speedyml.coupler.anomaly import SyntheticEnso
        enso = SyntheticEnso(
            np.degrees(np.asarray(sp.dy.tables.radang)),
            np.arange(cfg.ix) * 360.0 / cfg.ix, sp.clim.fmask_s,
            seed=args.enso_seed, amp=args.enso_amp,
            period_days=args.enso_period_days)
        anom_fn = enso.sst_anom_fn
        log(f"ENSO forcing on: amp {args.enso_amp} K, period "
            f"{args.enso_period_days} d, seed {args.enso_seed}")
    gen = FusedDataGenerator(sp, sst_anom_fn=anom_fn)
    gen.initialize(year=args.year, month=1, spinup_days=args.spinup_days)
    log(f"spin-up done ({args.spinup_days} days)")

    res = gen.generate(args.samples, verbose=25, log=log)
    log(f"truth+forecasts collected: {res['atmo'].shape}")

    os.makedirs(os.path.dirname(args.cache) or ".", exist_ok=True)
    np.savez(args.cache, **res)
    log(f"cached -> {args.cache} "
        f"({os.path.getsize(args.cache)/1e9:.2f} GB); "
        f"peak rss {peak_rss_gb():.1f} GB")
    print("DATA PHASE OK")


def phase_train(args):
    import jax.numpy as jnp

    from speedyml.core.calendar import ModelDate, datetime_from_hours
    from speedyml.core.config import ModelConfig, ReservoirConfig
    from speedyml.domain.decomposition import build_layout
    from speedyml.hybrid.experiment import (HybridRunner, TruthSeries,
                                            train_hybrid, transform_and_pack)
    from speedyml.hybrid.forecast import SpeedyForecaster
    from speedyml.model import Speedy

    timings = {}
    z = np.load(args.cache)
    truth = TruthSeries(atmo=z["atmo"], logp=z["logp"], precip=z["precip"],
                        sst=z["sst"], tisr=z["tisr"], hours=z["hours"])
    m_atmo, m_logp, m_precip = z["m_atmo"], z["m_logp"], z["m_precip"]
    n_total = truth.atmo.shape[0]
    n_train = n_total - args.holdout
    log(f"cache loaded: {n_total} samples, {n_train} train / "
        f"{args.holdout} held out")

    cfg = ModelConfig(dtype="float32")
    sp = Speedy(cfg)
    # reference production hyperparameters (mod_reservoir.f90:85-101):
    # m=6000 -> n=5760, deg 6, sigma 0.5, leakage 1, beta_res 1e-3,
    # beta_model 1.0, prior 0, noise 0.20, discard 240 h
    rcfg = ReservoirConfig(nodes_per_input=args.m, prior_val=args.prior,
                           discardlength=args.discard)
    L = build_layout(radang_deg=np.degrees(np.asarray(sp.dy.tables.radang)))
    log(f"layout: R={L.R}, n_in={L.n_in}, n_out={L.n_out}, "
        f"n_aug={L.n_out + (args.m // L.n_in) * L.n_in}")

    gv_truth = transform_and_pack(L, truth.atmo, truth.logp, truth.precip,
                                  truth.sst, truth.tisr, rcfg.precip_epsilon)
    gv_model = transform_and_pack(L, m_atmo, m_logp, m_precip,
                                  truth.sst, truth.tisr, rcfg.precip_epsilon)
    hours = truth.hours
    if not args.predict_inline:               # inline scoring needs truth
        del z, truth, m_atmo, m_logp, m_precip    # ~30 GB of host arrays
    log(f"packed: gv {gv_truth.shape}")

    t = time.time()
    ckdir = (args.cache + (".ml_ckpt" if args.ml_only else ".train_ckpt")
             if args.train_ckpt else None)
    also_ml = args.also_ml and not args.ml_only
    hm = train_hybrid(L, rcfg, gv_truth[:n_train],
                      None if args.ml_only else gv_model[:n_train],
                      seed=0, region_block=args.region_block,
                      chunk=args.chunk, solver="device",
                      verbose=(2 if os.environ.get("TRAIN_DEBUG") else True),
                      checkpoint_dir=ckdir, also_ml=also_ml,
                      upload_dtype=(np.float16 if args.upload_f16 else None))
    timings["train_s"] = time.time() - t
    log(f"TRAIN done in {timings['train_s']:.0f}s: wout {hm.params.wout.shape}"
        f" ({hm.params.wout.nbytes/1e9:.2f} GB), peak rss {peak_rss_gb():.1f} GB")

    if args.weights:
        t = time.time()
        try:
            from speedyml.io.weights import save_model
            os.makedirs(os.path.dirname(args.weights) or ".", exist_ok=True)
            save_model(args.weights, hm)
            timings["persist_s"] = time.time() - t
            log(f"weights persisted -> {args.weights} "
                f"({os.path.getsize(args.weights)/1e9:.2f} GB, "
                f"{timings['persist_s']:.0f}s)")
        except Exception as e:       # never lose the run to a write failure
            log(f"WEIGHT PERSISTENCE FAILED ({e!r}); continuing")
        if also_ml:
            try:
                from speedyml.hybrid.experiment import ml_variant
                t = time.time()
                save_model(args.ml_weights, ml_variant(hm))
                timings["persist_ml_s"] = time.time() - t
                log(f"ml-only weights persisted -> {args.ml_weights} "
                    f"({os.path.getsize(args.ml_weights)/1e9:.2f} GB, "
                    f"{timings['persist_ml_s']:.0f}s)")
            except Exception as e:
                log(f"ML WEIGHT PERSISTENCE FAILED ({e!r}); continuing")

    if not args.predict_inline:
        # prediction runs in a FRESH process (phase `predict`): after 144
        # training blocks the device allocator is fragmented enough that the
        # window-forecast compile OOMs alongside the 4 GB of parameters
        log("training phase complete (run phase `predict` next)")
        print("TRAIN PHASE OK")
        return
    _sync_predict_score(args, hm, sp, truth, gv_truth, n_train, timings,
                        rcfg)
    print("TRAIN PHASE OK")


def phase_predict(args):
    """Sync + held-out prediction + skill from PERSISTED weights, in a
    process that never ran training (fresh device allocator)."""
    from speedyml.core.config import ModelConfig
    from speedyml.hybrid.experiment import TruthSeries, transform_and_pack
    from speedyml.io.weights import load_model
    from speedyml.model import Speedy

    z = np.load(args.cache)
    truth = TruthSeries(atmo=z["atmo"], logp=z["logp"], precip=z["precip"],
                        sst=z["sst"], tisr=z["tisr"], hours=z["hours"])
    n_train = truth.atmo.shape[0] - args.holdout
    cfg = ModelConfig(dtype="float32")
    sp = Speedy(cfg)
    t = time.time()
    hm = load_model(args.weights,
                    radang_deg=np.degrees(np.asarray(sp.dy.tables.radang)))
    timings = {"load_s": time.time() - t}
    log(f"weights loaded: wout {hm.params.wout.shape} "
        f"({timings['load_s']:.0f}s)")
    gv_truth = transform_and_pack(hm.layout, truth.atmo, truth.logp,
                                  truth.precip, truth.sst, truth.tisr,
                                  hm.rcfg.precip_epsilon)
    _sync_predict_score(args, hm, sp, truth, gv_truth, n_train, timings,
                        hm.rcfg)
    print("PREDICT PHASE OK")


def _sync_predict_score(args, hm, sp, truth, gv_truth, n_train, timings,
                        rcfg):
    import jax.numpy as jnp
    from speedyml.core.calendar import ModelDate, datetime_from_hours
    from speedyml.hybrid.experiment import HybridRunner
    from speedyml.hybrid.forecast import SpeedyForecaster

    L = hm.layout
    # synchronize on the last synclength hours of the training window
    # (mod_reservoir.f90:940-961), then predict the held-out window
    n_sync = rcfg.synclength // rcfg.timestep
    t = time.time()
    x = hm.synchronize(gv_truth[n_train - n_sync:n_train])
    timings["sync_s"] = time.time() - t
    log(f"synchronized ({n_sync} steps, {timings['sync_s']:.0f}s)")

    s = L.gv_sizes
    last = gv_truth[n_train - 1]
    atmo0 = last[s["atmo3d"][0]:s["atmo3d"][1]].reshape(4, L.kx, L.il, L.ix)
    logp0 = last[s["logp"][0]:s["logp"][1]].reshape(L.il, L.ix)
    pr0 = last[s["precip"][0]:s["precip"][1]].reshape(L.il, L.ix)
    y, m, d, h = datetime_from_hours(int(truth.hours[n_train - 1]))
    date0 = ModelDate(y, m, d, h)

    n_fc = min(args.fc_steps, args.holdout)
    t = time.time()
    if getattr(args, "fast_loop", False):
        from speedyml.hybrid.fastloop import ScanHybridRunner
        chunk = n_fc if n_fc <= 32 else 31
        # sp is needed even for ml_only (climatology/solar boundary fields)
        hrun = ScanHybridRunner(hm, sp, chunk=chunk)
        n_fc = (n_fc // chunk) * chunk
        out = hrun.run(x, atmo0, logp0, pr0, date0, n_fc, verbose=chunk)
    else:
        fc_speedy = SpeedyForecaster(sp, hours=6, physics=True)
        hrun = HybridRunner(hm, fc_speedy)
        out = hrun.run(x, atmo0, logp0, pr0, date0, n_fc, verbose=10)
    timings["predict_s"] = time.time() - t
    log(f"prediction: {n_fc} steps in {timings['predict_s']:.0f}s, "
        f"aborted={out['aborted']}")
    a = out["atmo"]
    assert a is not None and np.all(np.isfinite(a)), "non-finite forecast"

    # skill vs persistence on the held-out truth
    ver = truth.atmo[n_train:n_train + n_fc]
    per = truth.atmo[n_train - 1]
    lat = np.asarray(sp.dy.tables.radang)
    w = np.cos(lat)[None, :, None]
    w = w / w.mean()

    def wrms(x2):   # area-weighted RMS over (kx, il, ix)
        return float(np.sqrt(np.mean(x2 * w)))

    results = {"n_train": int(n_train), "n_fc": int(n_fc),
               "m": args.m, "n": (args.m // L.n_in) * L.n_in,
               "n_aug": L.n_out + (args.m // L.n_in) * L.n_in,
               "regions": int(L.R), "prior": args.prior,
               "ml_only": bool(args.ml_only),
               "timings_s": {k: round(v, 1) for k, v in timings.items()},
               "peak_rss_gb": round(peak_rss_gb(), 1), "leads": {}}
    steps_chk = sorted({1, 4, 20, 40, 80, n_fc} & set(range(1, n_fc + 1)))
    names = ["T", "u", "v", "q"]
    for step in steps_chk:
        i = step - 1
        lead_h = step * rcfg.timestep
        row = {}
        for v, nm in enumerate(names):
            rh = wrms((a[i, v] - ver[i, v]) ** 2)
            rp = wrms((per[v] - ver[i, v]) ** 2)
            row[nm] = {"hybrid": round(rh, 4), "persistence": round(rp, 4)}
        results["leads"][f"{lead_h}h"] = row
        log(f"lead {lead_h:5d}h: " + "  ".join(
            f"{nm} {row[nm]['hybrid']:.3f}/{row[nm]['persistence']:.3f}"
            for nm in names) + "  (hybrid/persistence RMS)")
    final = results["leads"][f"{n_fc * rcfg.timestep}h"]
    wins = sum(final[nm]["hybrid"] < final[nm]["persistence"] for nm in names)
    results["beats_persistence_at_final_lead"] = int(wins)
    with open(args.results, "w") as f:
        json.dump(results, f, indent=1)
    log(f"results -> {args.results}; hybrid beats persistence on "
        f"{wins}/4 variables at {n_fc * rcfg.timestep}h")


def phase_coupled(args):
    """Config 5: multi-year coupled run — trained atmosphere reservoirs +
    slab-ocean reservoir + SPEEDY, SST fed back to both the reservoirs and
    SPEEDY's boundary (cpl_sea.f90:38-44), with incremental NetCDF output
    and periodic exact-resume checkpoints.

    `--ocean-train-only` trains the ocean and block-checkpoints it to disk
    without loading the atmosphere weights; the coupled run then loads the
    ocean blocks from the checkpoint."""
    import jax.numpy as jnp

    from speedyml.core.calendar import ModelDate, datetime_from_hours
    from speedyml.core.config import ModelConfig, ReservoirConfig
    from speedyml.hybrid.experiment import (HybridRunner, TruthSeries,
                                            transform_and_pack)
    from speedyml.hybrid.forecast import SpeedyForecaster
    from speedyml.io.output import ForecastWriter
    from speedyml.io.weights import load_model
    from speedyml.model import Speedy
    from speedyml.reservoir.slab import train_ocean, weekly_ocean_inputs

    z = np.load(args.cache)
    truth = TruthSeries(atmo=z["atmo"], logp=z["logp"], precip=z["precip"],
                        sst=z["sst"], tisr=z["tisr"], hours=z["hours"])
    n_train = truth.atmo.shape[0] - args.holdout
    cfg = ModelConfig(dtype="float32")
    sp = Speedy(cfg)
    radang_deg = np.degrees(np.asarray(sp.dy.tables.radang))
    if args.ocean_train_only:
        # the 4 GB atmosphere weights have no role in ocean training and
        # would crowd the ocean normal equations out of HBM
        from speedyml.core.config import ReservoirConfig as _RC
        from speedyml.domain.decomposition import build_layout
        hm = None
        L = build_layout(radang_deg=radang_deg)
        rcfg = _RC()
    else:
        hm = load_model(args.weights, radang_deg=radang_deg)
        L = hm.layout
        rcfg = hm.rcfg
        log(f"weights loaded: wout {hm.params.wout.shape}")
    gv_truth = transform_and_pack(L, truth.atmo, truth.logp, truth.precip,
                                  truth.sst, truth.tisr, rcfg.precip_epsilon)

    if args.hybrid_only:
        # config-3 climate mode: the trained hybrid atmosphere free-runs on
        # climatological SST — the >=90-day climate-validation workload;
        # scored by scripts/score_run.py
        ocean = None
    else:
        # slab-ocean reservoir trained on the same cached series; modest
        # size — weekly cadence gives only n_train/28 samples (the
        # reference trains on decades; this is the machinery at the
        # coupled operating point)
        orcfg = ReservoirConfig(slab_nodes=args.ocean_m,
                                slab_beta_res=args.ocean_beta,
                                discardlength=rcfg.discardlength,
                                timestep_slab=args.slab_hours)
        ocean = train_ocean(L, orcfg, gv_truth[:n_train], seed=100,
                            region_block=args.ocean_block,
                            solver="device" if not args.cpu else "host",
                            checkpoint_dir=(args.cache + ".ocean_ckpt"
                                            if args.train_ckpt else None))
        # calibrate the pointwise anomaly gate: 3x max(open-loop residual,
        # training-distribution anomaly scale) — in the observed/synthetic-
        # anomaly regime the gate must admit what training contained, not
        # just the (small) residuals of a skilful model
        from speedyml.reservoir.slab import training_anomaly_std
        tstd = training_anomaly_std(sp.clim, truth.hours[:n_train],
                                    truth.sst[:n_train])
        _, ol_rms, p_rms = ocean.calibrate_gate(gv_truth[:n_train], L,
                                                train_anom_std=tstd)
        log(f"slab-ocean trained: {int(ocean.active.sum())}/{ocean.ol.R} "
            f"active; open-loop weekly SST RMS {ol_rms:.3f} K "
            f"(persistence {p_rms:.3f} K); gate = 3x max(residual, "
            f"train-anom) std (train-anom max "
            f"{float(np.nanmax(tstd)):.2f} K, gate max "
            f"{float(np.nanmax(ocean.anom_std)):.2f} K)")
        if args.ocean_train_only:
            log("ocean training blocks persisted; rerun without "
                "--ocean-train-only for the coupled run")
            print("OCEAN TRAIN OK")
            return
    ckpt = args.out + ".ckpt.npz"
    resume = args.fast_loop and args.resume and os.path.exists(ckpt)
    if resume:
        x = x_ocean = None       # checkpoint supplies the reservoir states
    else:
        if ocean is None:        # --hybrid-only: no interactive ocean
            x_ocean = None
        else:
            spw = ocean.steps_per_week
            gv_w = weekly_ocean_inputs(gv_truth[:n_train], spw, L)
            x_ocean = ocean.synchronize(gv_w)
        n_sync = rcfg.synclength // rcfg.timestep
        x = hm.synchronize(gv_truth[n_train - n_sync:n_train])
    s = L.gv_sizes
    last = gv_truth[n_train - 1]
    atmo0 = last[s["atmo3d"][0]:s["atmo3d"][1]].reshape(4, L.kx, L.il, L.ix)
    logp0 = last[s["logp"][0]:s["logp"][1]].reshape(L.il, L.ix)
    pr0 = last[s["precip"][0]:s["precip"][1]].reshape(L.il, L.ix)
    y, m, d, h = datetime_from_hours(int(truth.hours[n_train - 1]))
    date0 = ModelDate(y, m, d, h)

    t = time.time()
    deadline = time.time() + args.max_wall if args.max_wall else None
    nc_path = args.out if not resume else args.out + ".resume.nc"
    writer = ForecastWriter(nc_path, cfg.kx, cfg.il, cfg.ix,
                            sigma=np.asarray(sp.dy.vg.fsg), lat=radang_deg,
                            lon=np.arange(cfg.ix) * 360.0 / cfg.ix,
                            with_sst=True)
    # stream mode (bounded host memory): climate-length runs write every
    # step to the NetCDF and keep only running summary stats in RAM —
    # peak RSS is then independent of run length
    stream = (args.stream if args.stream is not None
              else args.fc_steps >= 1456)
    def _apply_debias(runner):
        if args.precip_debias:
            zb = np.load(args.precip_debias)
            if "debias" in zb:       # calibrated MOS field (signed)
                runner.precip_debias = np.asarray(zb["debias"], np.float64)
            else:                    # fallback: lognormal sigma^2/2
                runner.precip_debias = (
                    0.5 * np.asarray(zb["log_resid_std"], np.float64) ** 2)
            log(f"precip output debias on: range "
                f"[{float(runner.precip_debias.min()):.2f}, "
                f"{float(runner.precip_debias.max()):.2f}] "
                f"({args.precip_debias})")

    if args.fast_loop:
        from speedyml.hybrid.fastloop import ScanHybridRunner
        hrun = ScanHybridRunner(hm, sp, physics=True)
        _apply_debias(hrun)
        if resume:
            from speedyml.io.checkpoint import load_prediction
            st = load_prediction(ckpt)
            ex = st["extra"] or {}
            log(f"resuming from step {st['step']} (absolute)")
            out = hrun.run(jnp.asarray(st["x"]), st["atmo"], st["logp"],
                           st["precip_t"], st["date"],
                           args.fc_steps - st["step"], ocean=ocean,
                           x_ocean=ex.get("x_ocean"),
                           sst_anom0=ex.get("sst_anom"), writer=writer,
                           checkpoint_path=ckpt, checkpoint_every=112,
                           verbose=112, deadline=deadline, stream=stream,
                           step0=st["step"])
        else:
            out = hrun.run(x, atmo0, logp0, pr0, date0, args.fc_steps,
                           ocean=ocean, x_ocean=x_ocean, writer=writer,
                           checkpoint_path=ckpt, checkpoint_every=112,
                           verbose=112, deadline=deadline, stream=stream)
    else:
        fc_speedy = SpeedyForecaster(sp, hours=6, physics=True)
        hrun = HybridRunner(hm, fc_speedy)
        _apply_debias(hrun)
        out = hrun.run(x, atmo0, logp0, pr0, date0, args.fc_steps,
                       ocean=ocean, x_ocean=x_ocean, writer=writer,
                       checkpoint_path=ckpt,
                       checkpoint_every=112, verbose=28, deadline=deadline)
    writer.close()
    dt = time.time() - t
    a = out["atmo"]
    nsteps = out.get("steps_done", 0 if a is None else len(a))
    log(f"coupled run: {nsteps}/{args.fc_steps} steps in {dt:.0f}s "
        f"({dt/max(nsteps,1):.2f}s/step), aborted={out['aborted']}")
    res = {"steps": int(nsteps), "sim_days": nsteps / 4,
           "wall_s": round(dt, 1), "aborted": bool(out["aborted"]),
           "loop": "fast" if args.fast_loop else "perstep",
           "resumed": bool(resume), "streamed": bool(stream),
           "precip_debias": bool(args.precip_debias),
           "s_per_step": round(dt / max(nsteps, 1), 3),
           "peak_rss_gb": round(peak_rss_gb(), 1)}
    if a is not None:
        assert np.all(np.isfinite(a)), "non-finite state"
        sstt = out["sst"]
        res.update(
            T_range=[float(a[:, 0].min()), float(a[:, 0].max())],
            u_range=[float(a[:, 1].min()), float(a[:, 1].max())],
            q_range=[float(a[:, 3].min()), float(a[:, 3].max())],
            sst_range=[float(sstt.min()), float(sstt.max())],
            sst_drift_K=float(np.abs(sstt[-1] - sstt[0]).max()))
    else:
        s = out.get("summary", {})
        assert s and all(np.isfinite(v) for v in s.values()
                         if isinstance(v, float)), "non-finite state"
        res.update(
            T_range=[s.get("t_min"), s.get("t_max")],
            u_range=[s.get("u_min"), s.get("u_max")],
            q_range=[s.get("q_min"), s.get("q_max")],
            sst_range=[s.get("sst_min"), s.get("sst_max")],
            sst_drift_K=s.get("sst_drift_K"),
            sst_drift_mean_K=s.get("sst_drift_mean_K"))
    with open(args.results, "w") as f:
        json.dump(res, f, indent=1)
    log(f"results -> {args.results}: {res}")
    print("COUPLED PHASE OK")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("phase", choices=["data", "train", "predict", "coupled"])
    ap.add_argument("--cache", default="data/refscale.npz")
    ap.add_argument("--samples", type=int, default=2364,
                    help="total truth samples (train + holdout)")
    ap.add_argument("--holdout", type=int, default=124,
                    help="verification-only samples at the end (31 days)")
    ap.add_argument("--spinup-days", type=int, default=30)
    ap.add_argument("--year", type=int, default=1982)
    ap.add_argument("--m", type=int, default=6000,
                    help="target reservoir size (n rounded to mult of n_in)")
    ap.add_argument("--prior", type=float, default=0.0)
    ap.add_argument("--discard", type=int, default=240,
                    help="discard length in hours (reference: 240)")
    ap.add_argument("--ml-only", action="store_true",
                    help="train/predict the ML-only configuration "
                         "(ml_only=.True., mod_reservoir.f90:295-296)")
    ap.add_argument("--also-ml", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="train phase: additionally solve the ML-only "
                         "readout from the hybrid's normal equations (one "
                         "extra ridge factorization per block) and persist "
                         "it to --ml-weights")
    ap.add_argument("--ml-weights", default="data/refscale_weights_ml.nc")
    ap.add_argument("--predict-inline", action="store_true",
                    help="run the prediction inside the training process "
                         "(small scales only; at reference scale the "
                         "fragmented allocator OOMs)")
    ap.add_argument("--train-ckpt", action="store_true", default=True,
                    help="persist each trained region block; rerun resumes")
    ap.add_argument("--no-train-ckpt", dest="train_ckpt",
                    action="store_false")
    ap.add_argument("--region-block", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=256,
                    help="timesteps per accumulation GEMM (256 amortizes "
                         "the hi/lo accumulator HBM traffic, r3 probe)")
    ap.add_argument("--upload-f16", action="store_true", default=True,
                    help="upload standardized series as float16 (halves "
                         "the dominant per-block transfer; compute f32)")
    ap.add_argument("--no-upload-f16", dest="upload_f16",
                    action="store_false")
    ap.add_argument("--fc-steps", type=int, default=124)
    ap.add_argument("--weights", default="data/refscale_weights.nc")
    ap.add_argument("--results", default="data/refscale_results.json")
    ap.add_argument("--ocean-m", type=int, default=2000,
                    help="slab-ocean reservoir target size (coupled phase); "
                         "size to the WEEKLY sample count — a 4.4-year "
                         "cache gives 573 weekly samples, so ~500 nodes "
                         "(the reference's 4000 assumes decades of data)")
    ap.add_argument("--ocean-beta", type=float, default=1e-4,
                    help="ocean ridge beta_res (reference 1e-4 at decades "
                         "of data; raise for short training records)")
    ap.add_argument("--slab-hours", type=int, default=168,
                    help="ocean reservoir cadence in hours (reference: 168)")
    ap.add_argument("--ocean-block", type=int, default=64,
                    help="regions per ocean training block")
    ap.add_argument("--hybrid-only", action="store_true",
                    help="coupled phase: free-run the trained hybrid on "
                         "climatological SST with NO interactive ocean "
                         "(config-3 climate mode; score with score_run.py)")
    ap.add_argument("--ocean-train-only", action="store_true",
                    help="coupled phase: train+checkpoint the ocean "
                         "reservoir, then exit")
    ap.add_argument("--fast-loop", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="coupled phase: chunked device-resident loop "
                         "(hybrid.fastloop) instead of the per-step runner")
    ap.add_argument("--resume", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="coupled phase: resume from the run checkpoint "
                         "when present")
    ap.add_argument("--precip-debias", default="",
                    help="coupled phase: npz with log_resid_std (from "
                         "diag_precip_bias.py); applies the output-side "
                         "lognormal debias sigma^2/2 to the written "
                         "precip (feedback dynamics untouched)")
    ap.add_argument("--stream", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="coupled phase: stream trajectory chunks to the "
                         "NetCDF and drop them (bounded host memory; "
                         "default: auto-on for runs >= 1 year)")
    ap.add_argument("--max-wall", type=int, default=0,
                    help="coupled phase: stop the step loop cleanly after "
                         "this many seconds (0 = no limit)")
    ap.add_argument("--out", default="data/coupled_run.nc",
                    help="coupled-phase forecast NetCDF output")
    ap.add_argument("--enso-amp", type=float, default=0.0,
                    help="data phase: imposed ENSO-like SST anomaly "
                         "amplitude [K] (0 = off; 1.2 reproduces the "
                         "coupled-variability regime)")
    ap.add_argument("--enso-seed", type=int, default=7)
    ap.add_argument("--enso-period-days", type=float, default=480.0)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (smoke tests)")
    args = ap.parse_args()
    if args.phase == "coupled" and args.results == "data/refscale_results.json":
        args.results = "data/coupled_results.json"   # don't clobber predict
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from speedyml.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if args.phase == "data":
        phase_data(args)
    elif args.phase == "train":
        phase_train(args)
    elif args.phase == "predict":
        phase_predict(args)
    else:
        phase_coupled(args)


if __name__ == "__main__":
    main()
