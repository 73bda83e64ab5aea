"""Diagnose the coupled run's tropical wet bias + jet weakening to a
mechanism.

Round-4 facts: the 1-year coupled run (config 5) reports global precip
8.16 mm/day vs the [0.5, 8.0] band and NH jet 30.6 m/s, while the SAME
atmosphere uncoupled (hybrid-only, config 3) passes at 6.70 mm/day with a
41.5 m/s jet. The only difference between the two runs is the weekly
slab-ocean SST feedback. This script quantifies, from the recorded runs
(no accelerator needed):

  1. the fed-back SST anomaly (coupled SST minus the date-matched
     climatological sea boundary): mean/std maps, tropical mean;
  2. where the precip difference (coupled minus hybrid-only, matched
     98-day windows) lives, and its spatial regression on the local SST
     anomaly — the precip-per-K sensitivity of the coupled response;
  3. stability: 28-day global precip means across the coupled year
     (bias constant => a shifted operating point, not a growing feedback);
  4. zonal-mean u (jet) for coupled vs hybrid-only vs truth over the
     matched window, upper-troposphere levels (utils.climate.JET_LEVELS).

Usage:
  python scripts/diag_wetbias.py --out data/wetbias_diag.json
"""

import argparse
import json
import sys

import numpy as np

sys.path.insert(0, ".")


def stream_mean(var, i0, i1):
    s = None
    for i in range(i0, i1):
        x = np.asarray(var[i], np.float64)
        s = x if s is None else s + x
    return s / max(i1 - i0, 1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coupled", default="data/coupled_run.nc")
    ap.add_argument("--hybrid", default="data/hybrid98_run.nc")
    ap.add_argument("--cache", default="data/refscale.npz")
    ap.add_argument("--holdout", type=int, default=124)
    ap.add_argument("--skip-days", type=int, default=10)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from scipy.io import netcdf_file

    from speedyml.core.calendar import ModelDate, datetime_from_hours
    from speedyml.core.config import ModelConfig
    from speedyml.coupler.daily import interp_sea
    from speedyml.model import Speedy
    from speedyml.utils.climate import JET_LEVELS

    fc = netcdf_file(args.coupled, "r", mmap=True)
    fh = netcdf_file(args.hybrid, "r", mmap=True)
    lat = np.asarray(fc.variables["Lat"][:], np.float64)
    w = np.cos(np.radians(lat))
    w = w / w.mean()
    nc, nh = fc.variables["p6hr"].shape[0], fh.variables["p6hr"].shape[0]
    i0 = args.skip_days * 4
    n98 = min(nc, nh)                       # matched windows

    # --- matched-window means -------------------------------------------
    spd = 4
    p_c = stream_mean(fc.variables["p6hr"], i0, n98) * spd   # mm/day
    p_h = stream_mean(fh.variables["p6hr"], i0, n98) * spd
    u_c = stream_mean(fc.variables["U-wind"], i0, n98)
    u_h = stream_mean(fh.variables["U-wind"], i0, n98)

    # truth climatology over its full record (cache precip is mm/window)
    z = np.load(args.cache, mmap_mode="r")
    p_t = np.asarray(z["precip"], np.float64).mean(axis=0) * spd
    hours = np.asarray(z["hours"])
    h0 = int(hours[len(hours) - args.holdout - 1])

    # --- fed-back SST anomaly vs date-matched clim boundary -------------
    sp = Speedy(ModelConfig(dtype="float32"))
    S = fc.variables["SST"]
    an_sum = np.zeros_like(p_c)
    an_sq = np.zeros_like(p_c)
    m = 0
    for i in range(i0, nc, 4):              # daily subsample
        y, mo, d, hh = datetime_from_hours(h0 + (i + 1) * 6)
        date = ModelDate(y, mo, d, hh)
        sstcl, sicecl, ticecl = interp_sea(sp.clim, date.imonth, date.tmonth)
        blend = sstcl + sicecl * (ticecl - sstcl)
        an = np.asarray(S[i], np.float64) - blend
        an_sum += an
        an_sq += an * an
        m += 1
    an_mean = an_sum / m
    an_std = np.sqrt(np.maximum(an_sq / m - an_mean ** 2, 0.0))

    trop = np.abs(lat) < 15.0
    sea = np.asarray(sp.clim.fmask_s) > 0.5
    trop2d = trop[:, None] & sea

    dp = p_c - p_h
    # precip-per-K sensitivity: regression of the local precip difference
    # on the local mean SST anomaly over tropical sea points
    x = an_mean[trop2d]
    y = dp[trop2d]
    slope = float(np.cov(x, y)[0, 1] / max(np.var(x), 1e-12))
    corr = float(np.corrcoef(x, y)[0, 1])

    def wmean(f, mask=None):
        ww = np.broadcast_to(w[:, None], f.shape)
        if mask is not None:
            return float((f * ww)[mask].sum() / ww[mask].sum())
        return float((f * ww).mean())

    # --- stability: 28-day precip means over the coupled year ------------
    P = fc.variables["p6hr"]
    monthly = []
    for j in range(i0, nc - 111, 112):
        pm = stream_mean(P, j, j + 112) * spd
        monthly.append(round(wmean(pm), 3))

    # --- jets ------------------------------------------------------------
    def jets(u_mean):
        uz = u_mean[JET_LEVELS].mean(axis=(0, 2))
        out = {}
        for hemi, mask in (("nh", lat > 15.0), ("sh", lat < -15.0)):
            um = np.where(mask, uz, -np.inf)
            i = int(np.argmax(um))
            out[hemi] = {"speed": round(float(uz[i]), 1),
                         "lat": round(float(lat[i]), 1)}
        return out, uz

    jc, uz_c = jets(u_c)
    jh, uz_h = jets(u_h)

    out = {
        "windows": {"coupled_steps": int(nc), "matched_steps": int(n98)},
        "precip_mm_day": {
            "coupled_98d": round(wmean(p_c), 3),
            "hybrid_98d": round(wmean(p_h), 3),
            "truth_clim": round(wmean(p_t), 3),
            "diff_tropics": round(wmean(dp, trop[:, None] &
                                        np.ones_like(sea)), 3),
            "diff_extratropics": round(
                wmean(dp, (~trop)[:, None] & np.ones_like(sea)), 3),
        },
        "sst_anomaly_K": {
            "tropical_sea_mean": round(wmean(an_mean, trop2d), 3),
            "tropical_sea_std_timemean": round(wmean(an_std, trop2d), 3),
            "global_sea_mean": round(wmean(an_mean, sea), 3),
            "max_abs": round(float(np.abs(an_mean[sea]).max()), 3),
        },
        "precip_sst_regression": {
            "slope_mm_day_per_K": round(slope, 3),
            "spatial_corr": round(corr, 3),
            "note": "coupled-minus-hybrid 98-day precip vs time-mean SST "
                    "anomaly, tropical sea points",
        },
        "coupled_precip_28day_means": monthly,
        "jets": {"coupled": jc, "hybrid_only": jh,
                 "uz_diff_max": round(float(np.abs(uz_c - uz_h).max()), 2)},
    }
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
