"""Device-resident K-step hybrid prediction loop.

The per-step HybridRunner pays a full host round trip every hybrid step
(state fetch + window jit dispatch + safety sync + writer append). This
module scans K steps (one ocean "week" by default) inside ONE jitted
program — the loop-level analog of the
reference's per-step file/MPI cycle (src/mpires.f90:218-804), where
parallel/composed.py is the step-level analog:

  for each chunk of K steps:                       [host]
    scan_k:                                        [one XLA program]
      SST = clim(k) + anomaly -> pack gv
      SPEEDY window (full physics, lax.scan)       <- surf/qcorh on device
      pack model_gv -> reservoir advance+readout -> scatter
      accumulate week-mean supervector + safety flags
    weekly slab-ocean step (device) -> new SST anomaly   [tiny fetch]
    dispatch next chunk, THEN fetch this chunk's trajectory stacks
    (transfer overlaps the next chunk's compute - FusedDataGenerator
    pattern)

Everything date-dependent but SST-independent (climatology interpolation,
solar/ozone tables, albedos, diurnal TISR, tcorh) is precomputed host-side
per chunk and scanned over; the two SST-dependent pieces of the boundary
condition — the hybrid-SST gate + ice blending (cpl_sea.f90:38-44) and the
humidity forcing correction qcorh (ini_fordate.f90) — are computed inside
the scan from the fed-back SST.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.calendar import ModelDate
from ..core.constants import DYN, PHYS
from ..coupler.daily import fordate, init_coupler_state
from ..domain.decomposition import pack_global, scatter_outputs
from ..domain.standardize import (standardize_in, standardize_out,
                                  unstandardize_out)
from ..dynamics.core import Forcing
from ..physics.constants import PP
from ..physics.driver import SurfaceDailyState
from ..reservoir.esn import predict_step
from .experiment import QMIN, SST_MIN, clamp_precip_t
from .forecast import SpeedyForecaster
from .state_io import GridState


class StepFields(NamedTuple):
    """Per-step host-precomputed boundary fields, stacked (K, ...)."""

    sst_clim: np.ndarray     # ice-blended climatological SST (reservoir input)
    sstcl: np.ndarray        # adjusted open-water SST clim (gate reference)
    sicecl: np.ndarray
    ticecl: np.ndarray
    stl_am: np.ndarray
    snowd_am: np.ndarray
    soilw_am: np.ndarray
    tisr: np.ndarray
    alb_l: np.ndarray
    alb_s: np.ndarray
    albsfc: np.ndarray
    snowc: np.ndarray
    fsol: np.ndarray         # (K, il) zonal
    ozupp: np.ndarray
    ozone: np.ndarray
    zenit: np.ndarray
    stratz: np.ndarray


def _ml_sane(atmo2, logp2):
    """Default ml_only safety: finite state inside physical bounds — the
    closed-loop reservoir has no window model to flag divergence, so the
    gate checks the readout's own output (invars-gate analog)."""
    ok = jnp.isfinite(atmo2).all() & jnp.isfinite(logp2).all()
    return (ok & (atmo2[0].min() > 150.0) & (atmo2[0].max() < 400.0)
            & (jnp.abs(atmo2[1:3]).max() < 500.0))


def _qsat_dev(ta, pres_norm):
    """Device twin of coupler.daily._qsat_np (identical constants)."""
    e0, c1, c2 = 6.108e-3, 17.269, 21.875
    t0, t1, t2 = 273.16, 35.86, 7.66
    es = jnp.where(ta >= t0,
                   e0 * jnp.exp(c1 * (ta - t0) / (ta - t1)),
                   e0 * jnp.exp(c2 * (ta - t0) / (ta - t2)))
    return 622.0 * es / (pres_norm - 0.378 * es)


class ScanHybridRunner:
    """Chunked device-resident prediction loop; drop-in alternative to
    HybridRunner.run for production-length integrations.

    hm: trained HybridModel; speedy: full model (provides dycore tables,
    climatology and the window program); physics: window physics flag;
    chunk: steps per XLA program (forced to ocean.steps_per_week when an
    ocean is coupled).
    """

    def __init__(self, hm, speedy=None, physics: bool = True,
                 chunk: int = 28):
        assert speedy is not None or hm.ml_only, \
            "the hybrid configuration needs the SPEEDY window model"
        self.hm = hm
        self.speedy = speedy
        self.physics = physics
        self.chunk = chunk
        self._fn = None
        # ml_only safety predicate (atmo2, logp2, xs) -> bool, evaluated
        # inside the scan on the POST-step state. None selects the default
        # sanity gate (finite + physical T/wind bounds) — the ml_only
        # analog of the window path's safety flag (the reference's invars
        # gate, mpires.f90:744); tests override for determinism.
        self._ml_safe_fn = None
        # optional (il, ix) output-side precip debias (sigma^2/2 of the
        # readout's log1p residual — see HybridRunner.precip_debias)
        self.precip_debias = None
        if speedy is None:
            self.fc = None
            self._np_dtype = np.float32
            return
        self.fc = SpeedyForecaster(speedy, hours=hm.rcfg.timestep,
                                   physics=physics)
        # boundary fields ride the model dtype (f64 under x64 test runs)
        # so the chunked program reproduces the per-step runner exactly
        self._np_dtype = (np.float64 if speedy.config.dtype == "float64"
                          else np.float32)
        # constant forcing pieces (ini_fordate.f90): tcorh is a pure
        # function of the truncated orography
        dy = speedy.dy
        gamlat = DYN.gamma / (1000.0 * PHYS.grav)
        phis0 = np.asarray(dy.phis0_grid, np.float64)
        corh_t = gamlat * phis0
        self._corh_t = np.asarray(corh_t, self._np_dtype)
        self._tcorh = np.asarray(dy.T.host_grid_to_spec(corh_t),
                                 self._np_dtype)
        self._pexp = 1.0 / (PP.rd * gamlat)
        self._fmask_l = np.asarray(speedy.clim.fmask_l, self._np_dtype)
        self._fmask_s = np.asarray(speedy.clim.fmask_s, self._np_dtype)

    # ------------------------------------------------------------------
    def _host_step_fields(self, date: ModelDate) -> dict:
        """All SST-independent boundary fields for one step (host numpy).
        Overridable (tests stub this the way they stub
        HybridRunner._sst_tisr)."""
        from ..physics.radiation import diurnal_tisr

        sp = self.speedy
        cs = init_coupler_state(sp.clim, date)
        rad, _, _ = fordate(sp.dy, sp.clim, cs, date)
        tisr = diurnal_tisr(date.tyear, date.ihour, sp.dy.tables.gsin,
                            sp.dy.tables.gcos, sp.config.ix)
        return dict(sst_clim=cs.sst_am, sstcl=cs.sstcl_ob, sicecl=cs.sice_am,
                    ticecl=cs.tice_am, stl_am=cs.stl_am,
                    snowd_am=cs.snowd_am, soilw_am=cs.soilw_am, tisr=tisr,
                    alb_l=rad["alb_l"], alb_s=rad["alb_s"],
                    albsfc=rad["albsfc"], snowc=rad["snowc"],
                    fsol=rad["fsol"], ozupp=rad["ozupp"],
                    ozone=rad["ozone"], zenit=rad["zenit"],
                    stratz=rad["stratz"])

    def _precompute(self, date0: ModelDate, K: int) -> StepFields:
        d = ModelDate(date0.iyear, date0.imonth, date0.iday, date0.ihour)
        L = self.hm.layout
        rows = []
        for _ in range(K):
            r = self._host_step_fields(d)
            # stubs (tests) may provide only the reservoir-facing fields;
            # the ml_only path never reads the window boundary fields
            for k in StepFields._fields:
                if k not in r:
                    r[k] = np.zeros((L.il, L.ix))
            rows.append(r)
            d.advance_hours(self.hm.rcfg.timestep)
        dt = self._np_dtype
        stacked = {k: np.stack([np.asarray(r[k], dt) for r in rows])
                   for k in rows[0]}
        return StepFields(**stacked)

    # ------------------------------------------------------------------
    def _build(self):
        hm = self.hm
        L = hm.layout
        ml_only = hm.ml_only
        ml_safe_fn = self._ml_safe_fn
        eps = hm.rcfg.precip_epsilon
        cap = getattr(hm.rcfg, "precip_cap_mm", 40.0)
        window = None if ml_only else self.fc._window_fn()
        if not ml_only:
            T = self.speedy.dy.T
            pexp = self._np_dtype(self._pexp)
            fm_l = jnp.asarray(self._fmask_l)
            fm_s = jnp.asarray(self._fmask_s)
            corh_t = jnp.asarray(self._corh_t)
            refrh1 = self._np_dtype(DYN.refrh1)
            one = self._np_dtype(1.0)

        def qcorh_dev(tsfc):
            """fordate's humidity forcing correction from the (SST-dependent)
            surface temperature, on device (ini_fordate.f90:fordate)."""
            tref = tsfc + corh_t
            psfc = (tsfc / tref) ** pexp
            corh_q = refrh1 * (_qsat_dev(tref, one) - _qsat_dev(tsfc, psfc))
            return T.grid_to_spec(corh_q)

        def body_fn(params, stz, idx, tidx, anom, tcorh, carry, xs):
            x, atmo, logp, pr, gv_sum, gv_last = carry
            # sst rides the model dtype (f64 under x64) down the WINDOW
            # path — the packed supervector is always f32 (HybridRunner
            # _pack contract)
            sst = jnp.clip(xs.sst_clim + anom, 200.0, 306.0)
            ss = jnp.maximum(sst.astype(jnp.float32), SST_MIN)
            ti = jnp.maximum(xs.tisr.astype(jnp.float32), 0.0)
            gv = pack_global(L, atmo, logp, pr, ss, ti)
            gv_sum = gv_sum + gv

            if ml_only:
                model_gv, safe = None, jnp.asarray(True)
            else:
                # the hybrid-SST gate + ice blending of ini_sea
                # (cpl_sea.f90:38-48, coupler.daily.init_coupler_state)
                sst_am = jnp.where(xs.sstcl - sst < 6.0, sst, xs.sstcl)
                sst_am = sst_am + xs.sicecl * (xs.ticecl - sst_am)
                surf = SurfaceDailyState(
                    stl_am=xs.stl_am, snowd_am=xs.snowd_am,
                    soilw_am=xs.soilw_am, sst_am=sst_am, sice_am=xs.sicecl,
                    tice_am=xs.ticecl, alb_l=xs.alb_l, alb_s=xs.alb_s,
                    albsfc=xs.albsfc, snowc=xs.snowc, fsol=xs.fsol,
                    ozupp=xs.ozupp, ozone=xs.ozone, zenit=xs.zenit,
                    stratz=xs.stratz)
                tsfc = fm_l * xs.stl_am + fm_s * sst_am
                forcing = Forcing(tcorh=tcorh, qcorh=qcorh_dev(tsfc))
                gs = GridState(t=atmo[0], u=atmo[1], v=atmo[2],
                               q=jnp.maximum(atmo[3], 0.0), logp=logp)
                res = window(gs, surf, forcing)
                safe = res.safe
                f_atmo = jnp.stack([res.gs.t, res.gs.u, res.gs.v,
                                    jnp.maximum(res.gs.q, QMIN)]).astype(
                                        jnp.float32)
                f_pr = jnp.log1p(jnp.maximum(res.precip_mm, 0.0)
                                 / eps).astype(jnp.float32)
                model_gv = pack_global(L, f_atmo,
                                       res.gs.logp.astype(jnp.float32),
                                       f_pr, ss, ti)

            u = standardize_in(stz, gv[idx])
            mv = (None if ml_only
                  else standardize_out(stz, model_gv[tidx]))
            x, out_std = predict_step(params, x, u, mv)
            out = unstandardize_out(stz, out_std)
            atmo2, logp2, pr2 = scatter_outputs(L, out)
            atmo2 = atmo2.at[3].set(jnp.maximum(atmo2[3], QMIN))
            if pr2 is not None:
                pr2 = clamp_precip_t(pr2, eps, cap)
            if ml_only:
                safe = (_ml_sane(atmo2, logp2) if ml_safe_fn is None
                        else ml_safe_fn(atmo2, logp2, xs))
            carry = (x, atmo2, logp2, pr2, gv_sum, gv)
            return carry, (atmo2, logp2, pr2, sst, safe)

        def chunk(params, stz, idx, tidx, x, atmo, logp, pr, anom, tcorh,
                  xs):
            gv0 = jnp.zeros((L.gv_len,), jnp.float32)

            def body(carry, xs_k):
                return body_fn(params, stz, idx, tidx, anom, tcorh, carry,
                               xs_k)

            carry0 = (x, jnp.asarray(atmo, jnp.float32),
                      jnp.asarray(logp, jnp.float32),
                      jnp.asarray(pr, jnp.float32), gv0, gv0)
            (x, atmo, logp, pr, gv_sum, gv_last), outs = jax.lax.scan(
                body, carry0, xs)
            return (x, atmo, logp, pr, gv_sum, gv_last) + outs

        return jax.jit(chunk)

    # ------------------------------------------------------------------
    def _upload_fields(self, xs: StepFields):
        """One batched host->device transfer for the per-chunk boundary
        fields: stacking same-shape fields into one buffer and slicing on
        device replaces 17 small (K, il, ix) transfers with 1-2."""
        dt = self._np_dtype
        host = {k: np.asarray(getattr(xs, k), dt)
                for k in StepFields._fields}
        by_shape = {}
        for k, v in host.items():
            by_shape.setdefault(v.shape, []).append(k)
        out = {}
        for shape, keys in by_shape.items():
            if len(keys) == 1:
                out[keys[0]] = jnp.asarray(host[keys[0]])
                continue
            dev = jnp.asarray(np.stack([host[k] for k in keys]))
            for i, k in enumerate(keys):
                out[k] = dev[i]
        return StepFields(**out)

    def run(self, x, atmo0, logp0, precip_t0, date: ModelDate, n_steps: int,
            ocean=None, x_ocean=None, sst_anom0=None, writer=None,
            checkpoint_path=None, checkpoint_every=0, verbose=0,
            deadline=None, fetch_traj=True, stream=False, step0=0):
        """HybridRunner.run-compatible chunked loop.

        checkpoint_every is in STEPS but rounds to chunk boundaries.
        fetch_traj=False skips the per-chunk trajectory download entirely
        (no writer output either); stream=True downloads each chunk, feeds
        the writer, accumulates running summary stats (out["summary"]) and
        DROPS the host copy — peak RSS is then independent of run length
        (multi-decade runs require streaming).
        step0: absolute step offset added to saved checkpoint steps, so a
        resumed run's checkpoints stay absolute and a second resume
        integrates the right remaining length.
        Returns the HybridRunner.run result dict; n_steps is floored to a
        multiple of the chunk size. out["steps_done"] is authoritative; on
        a mid-chunk safety abort the trajectory, steps_done and date are
        truncated AT the abort step, the returned atmo/logp/precip_t are
        the last SAFE state (from the trajectory stacks), and the reservoir
        state x is None (it only exists at chunk boundaries) — post-abort
        state never leaks out (mpires.f90:744 aborts atomically).
        """
        hm = self.hm
        L = hm.layout
        K = self.chunk if ocean is None else ocean.steps_per_week
        n_chunks = n_steps // K
        assert n_chunks > 0, f"n_steps {n_steps} < chunk {K}"
        if self._fn is None or getattr(self, "_K", None) != K:
            self._fn = self._build()
            self._K = K
        idx, tidx = hm._maps()
        date = ModelDate(date.iyear, date.imonth, date.iday, date.ihour)
        date_start = ModelDate(date.iyear, date.imonth, date.iday,
                               date.ihour)
        atmo = jnp.asarray(atmo0, jnp.float32)
        logp = jnp.asarray(logp0, jnp.float32)
        pr = (jnp.zeros((L.il, L.ix), jnp.float32) if precip_t0 is None
              else jnp.asarray(precip_t0, jnp.float32))
        dt = self._np_dtype
        anom = (jnp.zeros((L.il, L.ix), dt) if sst_anom0 is None
                else jnp.asarray(np.asarray(sst_anom0, dt)))
        tcorh = (jnp.zeros(()) if hm.ml_only
                 else jnp.asarray(self._tcorh))
        if ocean is not None and x_ocean is None:
            x_ocean = jnp.zeros((ocean.ol.R, ocean.params.n), jnp.float32)

        traj = {k: [] for k in ("atmo", "logp", "precip_mm", "sst")}
        aborted = False
        pending = None          # previous chunk's device stacks to fetch
        import time as _time
        from concurrent.futures import ThreadPoolExecutor

        keep_traj = fetch_traj and not stream
        fetch = fetch_traj or stream
        summary = {"steps": 0, "sst_first": None, "sst_last": None}
        last_state = {}         # streamed: last flushed step's fields

        def _acc_summary(a, lp, pr, ss):
            for name, arr in (("t", a[:, 0]), ("u", a[:, 1]),
                              ("q", a[:, 3]), ("sst", ss),
                              ("precip_mm", pr)):
                lo = float(arr.min()) if len(arr) else np.inf
                hi = float(arr.max()) if len(arr) else -np.inf
                summary[f"{name}_min"] = min(
                    summary.get(f"{name}_min", np.inf), lo)
                summary[f"{name}_max"] = max(
                    summary.get(f"{name}_max", -np.inf), hi)
            if len(ss):
                if summary["sst_first"] is None:
                    summary["sst_first"] = ss[0].copy()
                summary["sst_last"] = ss[-1].copy()
            summary["steps"] += len(a)

        def flush(p):
            a_st, l_st, p_st, s_st, upto = p
            a = np.asarray(a_st)[:upto]
            lp = np.asarray(l_st)[:upto]
            p_log = np.asarray(p_st)[:upto]
            if self.precip_debias is not None:
                p_log = np.maximum(p_log - self.precip_debias, 0.0)
            pr = hm.rcfg.precip_epsilon * np.expm1(np.maximum(p_log, 0.0))
            ss = np.asarray(s_st)[:upto]
            if writer is not None:
                for j in range(upto):
                    writer.append(a[j], lp[j], precip_mm=pr[j], sst=ss[j])
            _acc_summary(a, lp, pr, ss)
            if keep_traj:
                traj["atmo"].append(a)
                traj["logp"].append(lp)
                traj["precip_mm"].append(pr)
                traj["sst"].append(ss)
            elif upto:              # streamed: drop all but the tail step
                last_state.update(atmo=a[-1], logp=lp[-1],
                                  precip_mm=pr[-1], sst=ss[-1])

        steps_done = 0
        t_run0 = _time.time()
        t_prev = t_run0
        # single-worker pool: trajectory downloads + writer appends run in
        # order, overlapping the NEXT chunk's device compute
        pool = ThreadPoolExecutor(max_workers=1)
        flush_fut = None
        xs_host = self._precompute(date, K)
        xs_dev = self._upload_fields(xs_host)
        clim_last_host = np.asarray(xs_host.sst_clim[K - 1], np.float64)
        try:
            for ci in range(n_chunks):
                res = self._fn(hm.params, hm.stz, idx, tidx, x, atmo, logp,
                               pr, anom, tcorh, xs_dev)
                (x2, atmo2, logp2, pr2, gv_sum, gv_last,
                 a_st, l_st, p_st, s_st, safe_st) = res
                # while the chunk computes: drain the previous chunk's
                # trajectory in the worker and stage the next chunk's
                # boundary fields (all overlap the device work)
                if pending is not None:
                    if fetch:
                        if flush_fut is not None:
                            flush_fut.result()
                        flush_fut = pool.submit(flush, pending)
                    pending = None
                sst_clim_last = clim_last_host
                date_next = ModelDate(date.iyear, date.imonth, date.iday,
                                      date.ihour)
                for _ in range(K):
                    date_next.advance_hours(hm.rcfg.timestep)
                if ci + 1 < n_chunks:
                    xs_host = self._precompute(date_next, K)
                    xs_dev = self._upload_fields(xs_host)
                    clim_last_host = np.asarray(xs_host.sst_clim[K - 1],
                                                np.float64)
                # safety (tiny fetch; forces chunk completion)
                safe = np.asarray(safe_st)
                upto = int(np.argmax(~safe)) if (~safe).any() else K
                if upto < K:
                    aborted = True
                if ocean is not None and not aborted:
                    from ..reservoir.slab import compose_week_inputs
                    gv_week = compose_week_inputs(gv_last, gv_sum, K, L)
                    x_ocean, sst_core = ocean.step(x_ocean, gv_week)
                    grid = ocean.compose_sst(np.asarray(sst_core),
                                             sst_clim_last, L)
                    anom = jnp.asarray(np.asarray(grid - sst_clim_last, dt))
                x, atmo, logp, pr = x2, atmo2, logp2, pr2
                date = date_next
                steps_done += upto
                pending = (a_st, l_st, p_st, s_st, upto)
                if aborted:
                    break
                if checkpoint_path and checkpoint_every and \
                        ((ci + 1) * K) % max(checkpoint_every // K * K,
                                             K) == 0:
                    from ..io.checkpoint import save_prediction
                    extra = {"sst_anom": np.asarray(anom, np.float64)}
                    if ocean is not None:
                        extra["n_accum"] = 0
                        extra["x_ocean"] = np.asarray(x_ocean)
                    # step is ABSOLUTE (step0 + progress): a checkpoint
                    # written by a resumed run must not restart the count
                    save_prediction(checkpoint_path, np.asarray(x),
                                    np.asarray(atmo), np.asarray(logp),
                                    np.asarray(pr), date,
                                    step=step0 + (ci + 1) * K, extra=extra)
                if verbose and ((ci + 1) * K) % verbose < K:
                    now = _time.time()
                    print(f"  fast-loop chunk {ci+1}/{n_chunks} "
                          f"({steps_done} steps, "
                          f"{(now - t_prev):.1f}s since last print, "
                          f"{(now - t_run0)/steps_done:.2f}s/step avg) "
                          f"[{_time.strftime('%H:%M:%S')}]", flush=True)
                    t_prev = now
                if deadline is not None and _time.time() > deadline:
                    break
            if flush_fut is not None:
                flush_fut.result()
            if pending is not None and fetch:
                flush(pending)
        finally:
            pool.shutdown(wait=True)
        out = {k: (np.concatenate(v) if v else None)
               for k, v in traj.items()}
        out["x"] = x
        out["x_ocean"] = x_ocean
        out["date"] = date
        out["aborted"] = aborted
        out["sst_anom"] = np.asarray(anom)
        out["steps_done"] = steps_done
        if aborted:
            # abort atomicity: the carry above is
            # END-of-chunk state that ran through the unsafe window. Return
            # the last SAFE state from the trajectory stacks instead,
            # truncate the date to the abort step, and drop x/x_ocean
            # (reservoir state only exists at chunk boundaries).
            out["x"] = None
            out["x_ocean"] = None
            date_ab = ModelDate(date_start.iyear, date_start.imonth,
                                date_start.iday, date_start.ihour)
            for _ in range(steps_done):
                date_ab.advance_hours(hm.rcfg.timestep)
            out["date"] = date_ab
            if keep_traj and steps_done:
                out["atmo_last"] = out["atmo"][-1]
                out["logp_last"] = out["logp"][-1]
            elif last_state:
                out["atmo_last"] = last_state["atmo"]
                out["logp_last"] = last_state["logp"]
        if stream:
            s = dict(summary)
            if s["sst_first"] is not None:
                s["sst_drift_K"] = float(
                    np.abs(s["sst_last"] - s["sst_first"]).max())
                s["sst_drift_mean_K"] = float(
                    (s["sst_last"] - s["sst_first"]).mean())
            s.pop("sst_first", None)
            s.pop("sst_last", None)
            out["summary"] = s
        return out
