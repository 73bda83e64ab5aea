"""End-to-end hybrid demo at T30L8: self-generated truth -> train -> predict.

Small-scale settings (short training, minimal reservoirs) so it runs in
minutes on CPU; the same code path scales to production settings on the
GPU (python chip_smoke.py runs it at reference width).

Usage: python scripts/demo_hybrid.py [--samples N] [--fc-steps N]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=48,
                    help="training samples (6-hourly)")
    ap.add_argument("--fc-steps", type=int, default=4)
    ap.add_argument("--spinup-days", type=int, default=5)
    ap.add_argument("--region-block", type=int, default=192)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--discard", type=int, default=24,
                    help="discard length in hours (reference: 240)")
    ap.add_argument("--prior", type=float, default=0.0)
    ap.add_argument("--beta-res", type=float, default=1e-3)
    ap.add_argument("--skip-ml-only", action="store_true")
    ap.add_argument("--ocean", action="store_true",
                    help="also train + couple the slab-ocean reservoir "
                         "(config 5)")
    ap.add_argument("--cache", default="",
                    help="npz path: reuse/generate truth + model forecasts")
    ap.add_argument("--components", default="",
                    help="path prefix: write v_ml/v_p contribution NetCDF "
                         "(PREFIX_ml.nc + PREFIX_p.nc)")
    ap.add_argument("--out", default="",
                    help="forecast NetCDF output path")
    ap.add_argument("--grads", default="",
                    help="base path: also write GrADS .grd/.ctl output")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from speedyml.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from speedyml.core.config import ModelConfig, ReservoirConfig
    from speedyml.domain.decomposition import build_layout
    from speedyml.hybrid.experiment import (HybridRunner, collect_forecasts,
                                            collect_truth, train_hybrid,
                                            transform_and_pack)
    from speedyml.hybrid.forecast import SpeedyForecaster, TrajectoryRunner
    from speedyml.model import Speedy

    t0 = time.time()
    cfg = ModelConfig(dtype=args.dtype)
    sp = Speedy(cfg)
    print(f"[{time.time()-t0:6.1f}s] model built", flush=True)

    runner = TrajectoryRunner(sp)
    import os
    from speedyml.hybrid.experiment import TruthSeries
    if args.cache and os.path.exists(args.cache):
        z = np.load(args.cache)
        truth = TruthSeries(atmo=z["atmo"], logp=z["logp"],
                            precip=z["precip"], sst=z["sst"], tisr=z["tisr"],
                            hours=z["hours"])
        m_atmo, m_logp, m_precip = z["m_atmo"], z["m_logp"], z["m_precip"]
        from speedyml.core.calendar import ModelDate, datetime_from_hours
        from speedyml.coupler.daily import init_coupler_state
        from speedyml.hybrid.experiment import _atmo_to_grid
        y, m, d, h = datetime_from_hours(int(truth.hours[-1]))
        runner.initialize(year=1982, month=1, spinup_days=0)
        runner.date = ModelDate(y, m, d, h)
        runner.cs = init_coupler_state(sp.clim, runner.date)
        runner.gs = _atmo_to_grid(truth.atmo[-1], truth.logp[-1])
        print(f"[{time.time()-t0:6.1f}s] cache loaded: {truth.atmo.shape}",
              flush=True)
    else:
        runner.initialize(year=1982, month=1, spinup_days=args.spinup_days)
        print(f"[{time.time()-t0:6.1f}s] spin-up done", flush=True)

        truth = collect_truth(runner, args.samples)
        print(f"[{time.time()-t0:6.1f}s] truth collected: "
              f"{truth.atmo.shape}", flush=True)

        # imperfect model: the DRY core (all physics off) — large, honest
        # model error for the reservoirs to correct
        fc_imperfect = SpeedyForecaster(sp, hours=6, physics=False)
        m_atmo, m_logp, m_precip = collect_forecasts(fc_imperfect, truth)
        print(f"[{time.time()-t0:6.1f}s] imperfect-model forecasts done",
              flush=True)
        if args.cache:
            np.savez(args.cache, atmo=truth.atmo, logp=truth.logp,
                     precip=truth.precip, sst=truth.sst, tisr=truth.tisr,
                     hours=truth.hours, m_atmo=m_atmo, m_logp=m_logp,
                     m_precip=m_precip)

    rcfg = ReservoirConfig(nodes_per_input=576, degree=6, noise_std=0.05,
                           discardlength=args.discard, synclength=48,
                           prior_val=args.prior, beta_res=args.beta_res)
    L = build_layout(radang_deg=np.degrees(np.asarray(sp.dy.tables.radang)))
    gv_truth = transform_and_pack(L, truth.atmo, truth.logp, truth.precip,
                                  truth.sst, truth.tisr, rcfg.precip_epsilon)
    gv_model = transform_and_pack(L, m_atmo, m_logp, m_precip,
                                  truth.sst, truth.tisr, rcfg.precip_epsilon)

    hm = train_hybrid(L, rcfg, gv_truth, gv_model, seed=0,
                      region_block=args.region_block)
    print(f"[{time.time()-t0:6.1f}s] hybrid training done "
          f"(wout {hm.params.wout.shape})", flush=True)

    # sync on the last samples, forecast beyond the training set
    n_sync = rcfg.synclength // rcfg.timestep
    x = hm.synchronize(gv_truth[-n_sync:])
    s = L.gv_sizes
    last = gv_truth[-1]
    atmo0 = last[s["atmo3d"][0]:s["atmo3d"][1]].reshape(4, L.kx, L.il, L.ix)
    logp0 = last[s["logp"][0]:s["logp"][1]].reshape(L.il, L.ix)
    pr0 = last[s["precip"][0]:s["precip"][1]].reshape(L.il, L.ix)

    ocean = None
    x_ocean = None
    if args.ocean:
        from speedyml.reservoir.slab import train_ocean, weekly_ocean_inputs
        # small slab reservoir: weekly cadence gives samples/7/24*6 points,
        # so n must stay modest for the demo training lengths
        om_rcfg = ReservoirConfig(slab_nodes=500,
                                  discardlength=args.discard,
                                  timestep_slab=168)
        ocean = train_ocean(L, om_rcfg, gv_truth, seed=100, region_block=576)
        spw = ocean.steps_per_week
        gv_w = weekly_ocean_inputs(gv_truth, spw, L)
        x_ocean = ocean.synchronize(gv_w)
        print(f"[{time.time()-t0:6.1f}s] slab-ocean trained: "
              f"{int(ocean.active.sum())}/{ocean.ol.R} active regions",
              flush=True)

    fc_speedy = SpeedyForecaster(sp, hours=6, physics=True)
    hrun = HybridRunner(hm, fc_speedy)
    comp_writers = None
    writer = None
    coords = dict(sigma=np.asarray(sp.dy.vg.fsg),
                  lat=np.degrees(np.asarray(sp.dy.tables.radang)),
                  lon=np.arange(cfg.ix) * 360.0 / cfg.ix)
    if args.components:
        from speedyml.io.output import ForecastWriter
        comp_writers = (
            ForecastWriter(args.components + "_ml.nc", cfg.kx, cfg.il,
                           cfg.ix, with_precip=False, **coords),
            ForecastWriter(args.components + "_p.nc", cfg.kx, cfg.il,
                           cfg.ix, with_precip=False, **coords))
    if args.out:
        from speedyml.io.output import ForecastWriter
        writer = ForecastWriter(args.out, cfg.kx, cfg.il, cfg.ix,
                                with_sst=True, **coords)
    out = hrun.run(x, atmo0, logp0, pr0, runner.date, args.fc_steps,
                   ocean=ocean, x_ocean=x_ocean, writer=writer,
                   component_writers=comp_writers)
    if comp_writers is not None:
        for w in comp_writers:
            w.close()
        print(f"  components -> {args.components}_ml.nc/_p.nc")
    if writer is not None:
        writer.close()
    if args.grads and out["atmo"] is not None:
        from speedyml.io.grads import GradsWriter
        gw = GradsWriter(args.grads,
                         np.degrees(np.asarray(sp.dy.tables.radang)),
                         np.asarray(sp.dy.vg.fsg), cfg.ix)
        for i in range(len(out["atmo"])):
            gw.append([out["atmo"][i][v] for v in range(4)],
                      [out["logp"][i]])
        gw.close()
        print(f"  GrADS -> {args.grads}.grd/.ctl")
    print(f"[{time.time()-t0:6.1f}s] hybrid forecast: aborted={out['aborted']}"
          f" steps={0 if out['atmo'] is None else len(out['atmo'])}",
          flush=True)
    a = out["atmo"]
    assert a is not None and np.all(np.isfinite(a)), "non-finite forecast"
    print("  T range:", a[:, 0].min(), a[:, 0].max())
    print("  u range:", a[:, 1].min(), a[:, 1].max())
    print("  q range:", a[:, 3].min(), a[:, 3].max())
    # persistence comparison over the forecast window: continue truth
    truth2 = collect_truth(runner, args.fc_steps)
    rms_hyb = [float(np.sqrt(np.mean((a[i, 0] - truth2.atmo[i, 0]) ** 2)))
               for i in range(args.fc_steps)]
    rms_per = [float(np.sqrt(np.mean((truth.atmo[-1, 0] -
                                      truth2.atmo[i, 0]) ** 2)))
               for i in range(args.fc_steps)]
    print("  T RMS hybrid     :", [f"{r:.3f}" for r in rms_hyb[:10]])
    print("  T RMS persistence:", [f"{r:.3f}" for r in rms_per[:10]])
    if len(rms_hyb) > 10:
        print(f"  T RMS at step {len(rms_hyb)}: hybrid {rms_hyb[-1]:.3f} "
              f"persistence {rms_per[-1]:.3f}")
    if ocean is not None and out["sst"] is not None:
        sst_traj = out["sst"]
        print("  SST forecast range:", float(sst_traj.min()),
              float(sst_traj.max()),
              " drift vs start:", float(np.abs(sst_traj[-1] -
                                               sst_traj[0]).max()))

    # ml-only from the same start
    if args.skip_ml_only:
        print("DEMO OK")
        return
    hm_ml = train_hybrid(L, rcfg, gv_truth, None, seed=0,
                         region_block=args.region_block)
    x_ml = hm_ml.synchronize(gv_truth[-n_sync:])
    hrun_ml = HybridRunner(hm_ml, fc_speedy)
    out_ml = hrun_ml.run(x_ml, atmo0, logp0, pr0, out["date"], args.fc_steps)
    a_ml = out_ml["atmo"]
    assert a_ml is not None and np.all(np.isfinite(a_ml))
    print(f"[{time.time()-t0:6.1f}s] ml-only forecast ok; "
          f"T range {a_ml[:, 0].min():.1f}..{a_ml[:, 0].max():.1f}",
          flush=True)
    print("DEMO OK")


if __name__ == "__main__":
    main()
