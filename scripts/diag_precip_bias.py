"""Open-loop vs closed-loop precip bias attribution.

diag_wetbias.py established that the free-running hybrid carries an
intrinsic ~2x precip overestimate vs its own training truth (6.7-7.2 vs
3.3 mm/day) in BOTH the coupled and hybrid-only configs, and that the r4
"coupled wet bias" was mostly annual-vs-98-day windowing. This script
separates the remaining mechanism candidates for the intrinsic bias:

  * OPEN-loop (teacher-forced) readout bias: run the trained readout over
    held-out truth inputs and compare predicted precip against truth in
    both the log1p channel and physical mm/day. If unbiased here, the
    closed-loop inflation comes from feedback distribution shift.
  * Jensen/lognormal inflation: the readout is (near-)unbiased in the
    LOG channel; inverting P = eps*expm1(c) turns symmetric log-residual
    noise of std sigma into a positive physical bias ~exp(sigma^2/2).
    The per-gridpoint log-residual std measured here quantifies exactly
    that factor.

Outputs data/precip_bias.npz (per-gridpoint log-residual mean/std) and a
JSON summary. Reference: precip is output var 5 of the reservoir
(mod_reservoir.f90, log(1+P/eps) transform at mod_reservoir.f90:123-127).

Usage (chip must be free):
  python scripts/diag_precip_bias.py --out data/precip_bias.json
"""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

T0 = time.time()


def log(msg):
    print(f"[{time.time()-T0:7.1f}s] {msg}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", default="data/refscale.npz")
    ap.add_argument("--weights", default="data/refscale_weights.nc")
    ap.add_argument("--n", type=int, default=2124,
                    help="trailing samples to evaluate (incl. holdout)")
    ap.add_argument("--holdout", type=int, default=124)
    ap.add_argument("--sync", type=int, default=56)
    ap.add_argument("--out", default="data/precip_bias.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from speedyml.core.config import ModelConfig
    from speedyml.domain.decomposition import scatter_outputs
    from speedyml.domain.standardize import (standardize_in,
                                             standardize_out,
                                             unstandardize_out)
    from speedyml.hybrid.experiment import (clamp_precip_t,
                                            transform_and_pack)
    from speedyml.io.weights import load_model
    from speedyml.model import Speedy
    from speedyml.reservoir.esn import predict_step

    sp = Speedy(ModelConfig(dtype="float32"))
    hm = load_model(args.weights,
                    radang_deg=np.degrees(np.asarray(sp.dy.tables.radang)))
    L = hm.layout
    eps = hm.rcfg.precip_epsilon
    cap = getattr(hm.rcfg, "precip_cap_mm", 40.0)
    log(f"weights loaded: wout {hm.params.wout.shape}")

    z = np.load(args.cache, mmap_mode="r")
    Tt = z["atmo"].shape[0]
    sl = slice(Tt - args.n, Tt)
    gv_t = transform_and_pack(L, z["atmo"][sl], z["logp"][sl],
                              z["precip"][sl], z["sst"][sl], z["tisr"][sl],
                              eps)
    gv_m = transform_and_pack(L, z["m_atmo"][sl], z["m_logp"][sl],
                              z["m_precip"][sl], z["sst"][sl],
                              z["tisr"][sl], eps)
    log(f"packed {gv_t.shape}")

    idx, tidx = hm._maps()
    s = L.gv_sizes
    p0, p1 = s["precip"]

    x = hm.synchronize(gv_t[:args.sync])

    # weights/stats enter as jit ARGUMENTS (HybridModel._build_step
    # contract): closing over the 3.9 GB wout would embed it in the
    # compiled program
    @jax.jit
    def run(params, stz, x, gvs, mgvs):
        def body(x, inp):
            gv, mgv = inp
            u = standardize_in(stz, gv[idx])
            mv = standardize_out(stz, mgv[tidx])
            x, out_std = predict_step(params, x, u, mv)
            out = unstandardize_out(stz, out_std)
            _, _, pr_t = scatter_outputs(L, out)
            return x, clamp_precip_t(pr_t, eps, cap)

        return jax.lax.scan(body, x, (gvs, mgvs))

    gvs = jnp.asarray(gv_t[args.sync:-1], jnp.float32)
    mgvs = jnp.asarray(gv_m[args.sync + 1:], jnp.float32)
    # teacher-forced prediction at index t is valid at truth index t+1,
    # driven by the model forecast VALID at t+1 (m_* index convention)
    _, pr_pred = run(hm.params, hm.stz, x, gvs, mgvs)
    pr_pred = np.asarray(pr_pred)                       # (T', il, ix) log1p
    log(f"open-loop readout done: {pr_pred.shape}")

    truth_log = gv_t[args.sync + 1:, p0:p1].reshape(pr_pred.shape)
    resid = pr_pred - truth_log                         # log1p channel
    sig = resid.std(axis=0)
    mu = resid.mean(axis=0)

    lat = np.degrees(np.asarray(sp.dy.tables.radang))
    w = np.cos(np.radians(lat))
    w = w / w.mean()

    def wmean(f):
        return float((f * w[:, None]).mean())

    p_pred_mm = eps * np.expm1(pr_pred) * 4.0           # mm/day
    p_true_mm = eps * np.expm1(truth_log) * 4.0
    ho = args.holdout
    out = {
        "n_eval": int(pr_pred.shape[0]), "holdout": ho,
        "open_loop": {
            "pred_mm_day": round(wmean(p_pred_mm.mean(axis=0)), 3),
            "truth_mm_day": round(wmean(p_true_mm.mean(axis=0)), 3),
            "pred_mm_day_holdout": round(
                wmean(p_pred_mm[-ho:].mean(axis=0)), 3),
            "truth_mm_day_holdout": round(
                wmean(p_true_mm[-ho:].mean(axis=0)), 3),
        },
        "log_channel": {
            "resid_mean_globalavg": round(wmean(mu), 4),
            "resid_std_globalavg": round(wmean(sig), 4),
            "resid_std_max": round(float(sig.max()), 3),
            "jensen_factor_globalavg": round(
                wmean(np.exp(0.5 * sig ** 2)), 3),
            "jensen_factor_tropics": round(float(np.exp(
                0.5 * sig[np.abs(lat) < 15.0] ** 2).mean()), 3),
        },
        "closed_loop_reference": {
            "hybrid98_mm_day": 6.701, "coupled_98d_mm_day": 7.199,
            "truth_clim_mm_day": 3.327,
            "note": "from diag_wetbias.json (matched windows)",
        },
    }
    np.savez("data/precip_bias.npz", log_resid_mean=mu, log_resid_std=sig,
             lat=lat)
    print(json.dumps(out, indent=1))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    log("PRECIP BIAS DIAG OK")


if __name__ == "__main__":
    sys.exit(main())
