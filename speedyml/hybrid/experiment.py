"""End-to-end hybrid experiment orchestration: data -> train -> predict.

Redesign of the reference driver + MPI exchange
(parallelmain.f90:30-282, mpires.f90:218-804): there is no hub-and-spoke —
the global state lives in ONE packed supervector on device; reservoir
input packing is a batched gather, output scattering a reshape, and the
SPEEDY window forecast is another jitted program on the same arrays.

Data contract (the reference's unit fixes, mod_reservoir.f90:322-603):
  * atmo3d variables (T, u, v, q[g/kg]) with q clamped >= QMIN,
  * precip -> log(1 + P/eps), eps = precip_epsilon (mod_reservoir.f90:44),
  * sst clamped >= 272 K, tisr clamped >= 0.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.calendar import ModelDate
from ..core.config import ReservoirConfig
from ..coupler.daily import init_coupler_state
from ..domain.decomposition import (RegionLayout, build_layout, gather_inputs,
                                    pack_global, scatter_outputs)
from ..domain.standardize import (Standardizer, compute_stats,
                                  standardize_in, standardize_out,
                                  unstandardize_out)
from ..reservoir.esn import (EsnParams, advance, predict_step, readout_split,
                             synchronize)
from ..reservoir.generate import generate_esn, radius_by_lat
from ..reservoir.training import (drive_and_accumulate, drive_discard,
                                  init_normal_eq, ridge_solve)
from .forecast import SpeedyForecaster, TrajectoryRunner
from .state_io import GridState

QMIN = 1e-6     # q floor [g/kg] (reference training-data clamp)
SST_MIN = 272.0
# fallback precipitation ceiling [mm per window] for the PREDICTED
# log-precip channel — the self-generated 4.4-year truth's instantaneous
# max is 39.6 mm/6h. The linear readout extrapolates the exp-stretched
# log1p(P/eps) channel past its training range (a +2x excursion in log
# space is 1e8 mm of "rain"; observed in the r4 coupled year run), so
# predictions are clamped to the TRAINING SUPPORT: train_hybrid records
# the actual series max in rcfg.precip_cap_mm — the same class of sanity
# clamp as the q floor (mpires.f90:456-462).
PRECIP_MM_CAP = 40.0


def clamp_precip_t(pr_t, eps, cap_mm: float = PRECIP_MM_CAP):
    """Clamp the transformed log-precip channel to [0, log1p(cap/eps)]."""
    return jnp.clip(pr_t, 0.0, jnp.log1p(cap_mm / eps))


class TruthSeries(NamedTuple):
    """Host-side 6-hourly series (the ERA5-training-set analog)."""

    atmo: np.ndarray     # (T, nvars=4, kx, il, ix) order (T, u, v, q)
    logp: np.ndarray     # (T, il, ix)
    precip: np.ndarray   # (T, il, ix) raw mm per window
    sst: np.ndarray      # (T, il, ix)
    tisr: np.ndarray     # (T, il, ix)
    hours: np.ndarray    # (T,) hours since epoch per sample


def _grid_to_atmo(gs: GridState) -> np.ndarray:
    """GridState -> (4, kx, il, ix) in the reference variable order."""
    return np.stack([np.asarray(gs.t), np.asarray(gs.u),
                     np.asarray(gs.v), np.asarray(gs.q)], axis=0)


def _atmo_to_grid(atmo, logp) -> GridState:
    return GridState(t=atmo[0], u=atmo[1], v=atmo[2],
                     q=jnp.maximum(atmo[3], 0.0), logp=logp)


def collect_truth(runner: TrajectoryRunner, n_samples: int) -> TruthSeries:
    """Advance the truth trajectory n_samples windows, recording each."""
    from ..core.calendar import hours_since_epoch

    atmo, logp, precip, sst, tisr, hours = [], [], [], [], [], []
    for _ in range(n_samples):
        s = runner.advance()
        atmo.append(_grid_to_atmo(s.gs))
        logp.append(np.asarray(s.gs.logp))
        precip.append(s.precip_mm)
        sst.append(s.sst)
        tisr.append(s.tisr)
        d = runner.date
        hours.append(hours_since_epoch(d.iyear, d.imonth, d.iday, d.ihour))
    return TruthSeries(atmo=np.stack(atmo), logp=np.stack(logp),
                       precip=np.stack(precip), sst=np.stack(sst),
                       tisr=np.stack(tisr), hours=np.asarray(hours))


def collect_forecasts(fc: SpeedyForecaster, truth: TruthSeries):
    """Imperfect-model one-window forecasts from each truth state.

    Returns (atmo, logp, precip) arrays aligned so index t is the forecast
    VALID at truth sample t (launched from t-1); index 0 is a copy of truth
    (never used: training pairs start at t=1). This is the analog of the
    reference's precomputed "restart_6hour" SPEEDY states
    (speedy_res_interface.f90:637-723).
    """
    from ..core.calendar import datetime_from_hours

    T = truth.atmo.shape[0]
    atmo = np.empty_like(truth.atmo)
    logp = np.empty_like(truth.logp)
    precip = np.zeros_like(truth.precip)
    atmo[0] = truth.atmo[0]
    logp[0] = truth.logp[0]
    for t in range(T - 1):
        y, m, d, h = datetime_from_hours(int(truth.hours[t]))
        date = ModelDate(iyear=y, imonth=m, iday=d, ihour=h)
        gs = _atmo_to_grid(truth.atmo[t], truth.logp[t])
        res = fc.forecast(gs, date, sst_hybrid=truth.sst[t])
        atmo[t + 1] = _grid_to_atmo(res.gs)
        logp[t + 1] = np.asarray(res.gs.logp)
        precip[t + 1] = np.asarray(res.precip_mm)
    return atmo, logp, precip


# ----------------------------------------------------------------------
# packing + transforms
# ----------------------------------------------------------------------
def transform_and_pack(layout: RegionLayout, atmo, logp, precip, sst, tisr,
                       eps: float, ohtc=None) -> np.ndarray:
    """Apply the reference's unit fixes and pack to (T, gv_len) float32."""
    T = atmo.shape[0]
    a = np.array(atmo, np.float32, copy=True)
    a[:, 3] = np.maximum(a[:, 3], QMIN)
    pr = np.log1p(np.maximum(precip, 0.0) / eps).astype(np.float32)
    ss = np.maximum(sst, SST_MIN).astype(np.float32)
    ti = np.maximum(tisr, 0.0).astype(np.float32)
    gv = np.empty((T, layout.gv_len), np.float32)
    s = layout.gv_sizes
    gv[:, s["atmo3d"][0]:s["atmo3d"][1]] = a.reshape(T, -1)
    gv[:, s["logp"][0]:s["logp"][1]] = logp.reshape(T, -1)
    for name, arr in (("precip", pr), ("sst", ss), ("tisr", ti),
                      ("ohtc", ohtc)):
        t0, t1 = s.get(name, (0, 0))
        if t1 > t0:
            assert arr is not None, f"{name} required by layout"
            gv[:, t0:t1] = np.asarray(arr, np.float32).reshape(T, -1)
    return gv


def invert_precip(precip_t, eps: float):
    """log(1 + P/eps) -> P [mm]."""
    return eps * jnp.expm1(jnp.maximum(precip_t, 0.0))


# ----------------------------------------------------------------------
# the trained hybrid model
# ----------------------------------------------------------------------
@dataclasses.dataclass
class HybridModel:
    """Trained per-region reservoirs + standardization + layout."""

    layout: RegionLayout
    params: EsnParams
    stz: Standardizer
    rcfg: ReservoirConfig
    ml_only: bool = False
    # host copies of the big parameter arrays (set by train_hybrid) so
    # persistence never pulls them back over a slow device link
    host_np: Optional[dict] = None

    # jit caches
    _step_fn: Optional[callable] = None
    _split_fn: Optional[callable] = None
    _sync_fn: Optional[callable] = None

    def _maps(self):
        if not hasattr(self, "_idx") or self._idx is None:
            self._idx = jnp.asarray(self.layout.input_index)
            self._tidx = jnp.asarray(self.layout.target_index)
        return self._idx, self._tidx

    def _build_step(self):
        """One hybrid step entirely on device.

        All weights/stats/maps enter as jit ARGUMENTS (never closure
        constants — wout alone is ~0.5 GB at full scale and would otherwise
        be embedded in the compiled program)."""
        L = self.layout
        ml_only = self.ml_only

        eps = self.rcfg.precip_epsilon
        cap = getattr(self.rcfg, "precip_cap_mm", PRECIP_MM_CAP)

        def step(params, stz, idx, tidx, x, gv, model_gv):
            u = standardize_in(stz, gv[idx])
            if ml_only:
                model_vec = None
            else:
                model_vec = standardize_out(stz, model_gv[tidx])
            x, out_std = predict_step(params, x, u, model_vec)
            out = unstandardize_out(stz, out_std)
            atmo, logp, precip_t = scatter_outputs(L, out)
            # physical sanity clamps (mpires.f90:456-462)
            atmo = atmo.at[3].set(jnp.maximum(atmo[3], QMIN))
            if precip_t is not None:
                precip_t = clamp_precip_t(precip_t, eps, cap)
            return x, atmo, logp, precip_t

        return jax.jit(step)

    def _build_split(self):
        """Hybrid step with the v_ml/v_p component decomposition
        (mod_reservoir.f90:1458-1469; shipped to disk by the reference via
        mpires.f90:1146-1547). Physical-unit components satisfy
        atmo = atmo_ml + atmo_p: the ML increment is std * v_ml, the SPEEDY
        part std * v_p + mean."""
        L = self.layout
        assert not self.ml_only, "component split needs the model block"

        eps = self.rcfg.precip_epsilon
        cap = getattr(self.rcfg, "precip_cap_mm", PRECIP_MM_CAP)

        def step(params, stz, idx, tidx, x, gv, model_gv):
            u = standardize_in(stz, gv[idx])
            model_vec = standardize_out(stz, model_gv[tidx])
            x = advance(params, x, u)
            out_std, v_ml, v_p = readout_split(params, x, model_vec)
            out = unstandardize_out(stz, out_std)
            atmo, logp, precip_t = scatter_outputs(L, out)
            atmo = atmo.at[3].set(jnp.maximum(atmo[3], QMIN))
            if precip_t is not None:
                precip_t = clamp_precip_t(precip_t, eps, cap)
            ml_phys = v_ml * stz.out_std
            p_phys = v_p * stz.out_std + stz.out_mean
            atmo_ml, logp_ml, _ = scatter_outputs(L, ml_phys)
            atmo_p, logp_p, _ = scatter_outputs(L, p_phys)
            comp = dict(atmo_ml=atmo_ml, logp_ml=logp_ml,
                        atmo_p=atmo_p, logp_p=logp_p)
            return x, atmo, logp, precip_t, comp

        return jax.jit(step)

    def step_split(self, x, gv, model_gv):
        """step() + v_ml/v_p component grids (see _build_split)."""
        if self._split_fn is None:
            self._split_fn = self._build_split()
        idx, tidx = self._maps()
        return self._split_fn(self.params, self.stz, idx, tidx, x, gv,
                              model_gv)

    def _build_sync(self):
        def sync(params, stz, idx, x, gv_series):
            u = standardize_in(stz, gv_series[:, idx])
            return synchronize(params, x, u)

        return jax.jit(sync)

    def synchronize(self, gv_series: np.ndarray, x=None):
        """Drive reservoirs with true data (mod_reservoir.f90:1354-1416)."""
        if self._sync_fn is None:
            self._sync_fn = self._build_sync()
        if x is None:
            x = jnp.zeros((self.layout.R, self.params.n), jnp.float32)
        idx, _ = self._maps()
        return self._sync_fn(self.params, self.stz, idx, x,
                             jnp.asarray(gv_series, jnp.float32))

    def step(self, x, gv, model_gv=None):
        if self._step_fn is None:
            self._step_fn = self._build_step()
        if model_gv is None:
            model_gv = jnp.zeros_like(gv)
        idx, tidx = self._maps()
        return self._step_fn(self.params, self.stz, idx, tidx, x, gv,
                             model_gv)


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def train_hybrid(layout: RegionLayout, rcfg: ReservoirConfig,
                 gv_truth: np.ndarray, gv_model: Optional[np.ndarray],
                 seed: int = 0, region_block: int = 0,
                 chunk: int = 64, solver: str = "host",
                 verbose: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 upload_dtype=None, also_ml: bool = False) -> HybridModel:
    """Train all regions' readouts by blocked normal-equation accumulation.

    gv_truth: (T, gv_len) transformed truth series.
    gv_model: (T, gv_len) imperfect-model forecasts valid at each index
              (hybrid) or None (ml_only).
    region_block: regions trained per device pass (0 = all at once; at full
    scale the (Rb, na, na) normal equations bound the block size — the
    reference instead serializes one region per MPI rank).
    solver: "host" (numpy f64 LU; pulls the normal equations to the host) or
    "device" (f64 Cholesky on the device, x64 scoped to the solve; the
    (Rb, na, na) normal equations never leave the device).
    checkpoint_dir: if set, each completed region block is persisted there
    and already-persisted blocks are skipped on re-entry — a multi-hour
    reference-scale run survives interruptions and OOM kills. Generation is
    deterministic in (seed, block), so a resumed run is bitwise-identical.
    upload_dtype: host dtype for the per-block standardized series (e.g.
    np.float16 halves the host->device transfer; compute stays f32 on
    device). f16
    quantization is ~5e-4 relative on O(1) standardized values — far below
    the 20% training input noise (mod_utilities.f90:1387-1410) and the fit
    residual; equivalence bound pinned by test_reservoir.
    also_ml: additionally solve the ML-ONLY readout from the SAME
    accumulated normal equations: the augmented vector is [model; nodes],
    so the ml-only system (mod_reservoir.f90:1491-1535 fit_chunk_ml) is
    exactly the trailing (n, n) sub-block of the hybrid's — the reservoir
    drive (states, noise keys, win/A generation) is identical, so config 2
    costs one extra ridge factorization per block instead of a second full
    training pass. Retrieve with `ml_variant(hm)`.
    """
    R = layout.R
    ml_only = gv_model is None
    assert not (also_ml and ml_only), "also_ml needs a hybrid training run"
    Tn = gv_truth.shape[0]
    discard = max(1, rcfg.discardlength // rcfg.timestep)
    assert Tn > discard + 2, "training series shorter than discard"

    # record the training support of the precip channel: predictions are
    # clamped to it (clamp_precip_t — the readout must not extrapolate the
    # exp-stretched log-precip channel past anything it saw in training)
    p0, p1 = layout.gv_sizes.get("precip", (0, 0))
    if p1 > p0:
        pmax = float(rcfg.precip_epsilon
                     * np.expm1(float(gv_truth[:, p0:p1].max())))
        rcfg = dataclasses.replace(rcfg, precip_cap_mm=max(pmax, 1.0))

    # stats from the packed truth inputs (per region/var/level), streamed —
    # the gathered (T, R, n_in) series is 43 GB at reference scale x 16k
    # samples and is never materialized; per-block inputs are gathered
    # from the packed series on demand below
    from ..domain.standardize import compute_stats_gv
    stz = compute_stats_gv(layout, gv_truth)
    out_mean = np.asarray(stz.out_mean)
    out_std = np.asarray(stz.out_std)
    in_mean = np.asarray(stz.in_mean)
    in_std = np.asarray(stz.in_std)

    radii = radius_by_lat(layout.lat_region_deg[:, 0],
                          layout.lat_region_deg[:, 1],
                          max_radius=rcfg.radius_high,
                          min_radius=rcfg.radius_low)

    blocks = [np.arange(R)] if region_block in (0, R) else [
        np.arange(i, min(i + region_block, R))
        for i in range(0, R, region_block)]

    wout_parts, idx_parts, val_parts, win_parts = [], [], [], []
    wout_ml_parts = []
    q_nodes = None
    shift_parts = []    # per-block circulant shifts (None entry = generic)
    key0 = jax.random.PRNGKey(seed)
    import time as _time
    t_start = _time.time()
    if checkpoint_dir:
        import os
        os.makedirs(checkpoint_dir, exist_ok=True)
    for bi, blk in enumerate(blocks):
        Rb = len(blk)
        if checkpoint_dir:
            ck = f"{checkpoint_dir}/block_{bi:04d}.npz"
            import os
            if os.path.exists(ck):
                z = np.load(ck)
                # a block persisted without the ml readout cannot satisfy
                # an also_ml resume (the accumulator is gone) — recompute it
                if not (also_ml and "wout_ml" not in z.files):
                    wout_parts.append(z["wout"])
                    if also_ml:
                        wout_ml_parts.append(z["wout_ml"])
                    idx_parts.append(z["a_idx"])
                    val_parts.append(z["a_val"])
                    win_parts.append(z["win"])
                    q_nodes = int(z["q"])
                    shift_parts.append(z["a_shift"] if "a_shift" in z.files
                                       else None)
                    continue
        tphase = _time.time()

        def _tp(label, on=verbose == 2):
            nonlocal tphase
            if on:
                print(f"    [{label}: {_time.time()-tphase:.1f}s]",
                      flush=True)
            tphase = _time.time()

        n_model = 0 if ml_only else layout.n_out
        params = generate_esn(seed + 17 * bi, Rb, layout.n_in, layout.n_out,
                              n_model, m_target=rcfg.nodes_per_input,
                              deg=rcfg.degree, sigma=rcfg.sigma,
                              leakage=rcfg.leakage, radii=radii[blk])
        q_nodes = params.q
        _tp("generate")

        u_blk = (gv_truth[:, layout.input_index[blk]]
                 - in_mean[blk]) / in_std[blk]
        y_all = gv_truth[:, layout.target_index[blk]]
        y_blk = (y_all - out_mean[blk]) / out_std[blk]
        if not ml_only:
            m_all = gv_model[:, layout.target_index[blk]]
            m_blk = (m_all - out_mean[blk]) / out_std[blk]
        if upload_dtype is not None:
            u_blk = u_blk.astype(upload_dtype)
            y_blk = y_blk.astype(upload_dtype)
            if not ml_only:
                m_blk = m_blk.astype(upload_dtype)
        _tp("slice+standardize")

        # noise keys are a pure function of (seed, block) so a checkpoint
        # resume that skips completed blocks stays bitwise-identical
        kd, kt = jax.random.split(jax.random.fold_in(key0, bi))
        x = jnp.zeros((Rb, params.n), jnp.float32)
        x = drive_discard(params, x, u_blk[:discard],
                          noise_mag=rcfg.noise_std, rng_key=kd)
        acc = init_normal_eq(params, layout.n_out)
        acc = acc._replace(x=x)
        # pairs: state after u(t) vs target(t+1), t = discard..T-2
        acc = drive_and_accumulate(
            params, acc, u_blk[discard:-1], y_blk[discard + 1:],
            None if ml_only else m_blk[discard + 1:],
            noise_mag=rcfg.noise_std, rng_key=kt, chunk=chunk)
        if verbose == 2:
            np.asarray(jnp.ravel(acc.ss_hi)[0])
        _tp("discard+accumulate")
        if solver == "device":
            from ..reservoir.training import ridge_solve_device
            wout = ridge_solve_device(acc, n_model, rcfg.beta_res,
                                      rcfg.beta_model,
                                      prior_val=rcfg.prior_val,
                                      use_prior=rcfg.prior_val != 0.0)
        else:
            wout = ridge_solve(acc, n_model, rcfg.beta_res, rcfg.beta_model,
                               prior_val=rcfg.prior_val,
                               use_prior=rcfg.prior_val != 0.0)
        _tp("ridge solve")
        wout_parts.append(np.asarray(wout, np.float32))
        _tp("wout fetch")
        if also_ml:
            # ml-only system = trailing (n, n) sub-block of the hybrid
            # normal equations (aug = [model; nodes]); one extra Cholesky
            acc_ml = acc._replace(
                ss_hi=acc.ss_hi[:, n_model:, n_model:],
                ss_lo=acc.ss_lo[:, n_model:, n_model:],
                sy_hi=acc.sy_hi[:, :, n_model:],
                sy_lo=acc.sy_lo[:, :, n_model:])
            del acc          # free the full (Rb, na, na) pairs before the
            #                  f64 promotion (memory headroom at na=5896; the
            #                  runtime holds buffers live until the slice
            #                  ops that read them complete)
            if solver == "device":
                wout_ml = ridge_solve_device(
                    acc_ml, 0, rcfg.beta_res, rcfg.beta_model,
                    prior_val=rcfg.prior_val,
                    use_prior=rcfg.prior_val != 0.0)
            else:
                wout_ml = ridge_solve(acc_ml, 0, rcfg.beta_res,
                                      rcfg.beta_model,
                                      prior_val=rcfg.prior_val,
                                      use_prior=rcfg.prior_val != 0.0)
            wout_ml_parts.append(np.asarray(wout_ml, np.float32))
            _tp("ml ridge solve")
        idx_parts.append(np.asarray(params.a_idx))
        val_parts.append(np.asarray(params.a_val))
        win_parts.append(np.asarray(params.win))
        shift_parts.append(None if params.a_shift is None
                           else np.asarray(params.a_shift))
        if checkpoint_dir:
            import os
            tmp = ck + ".tmp"
            extra = ({} if shift_parts[-1] is None
                     else dict(a_shift=shift_parts[-1]))
            if also_ml:
                extra["wout_ml"] = wout_ml_parts[-1]
            with open(tmp, "wb") as fh:     # atomic: write-then-rename
                np.savez(fh, wout=wout_parts[-1], a_idx=idx_parts[-1],
                         a_val=val_parts[-1], win=win_parts[-1], q=q_nodes,
                         **extra)
            os.replace(tmp, ck)
        if verbose and (bi % 8 == 0 or bi == len(blocks) - 1):
            el = _time.time() - t_start
            print(f"  train block {bi+1}/{len(blocks)} "
                  f"({el:.0f}s, {el/(bi+1):.1f}s/block)", flush=True)

    n_nodes = win_parts[0].shape[1]
    host = dict(a_idx=np.concatenate(idx_parts),
                a_val=np.concatenate(val_parts),
                win=np.concatenate(win_parts),
                wout=np.concatenate(wout_parts))
    if also_ml:
        host["wout_ml"] = np.concatenate(wout_ml_parts)
    # all blocks share the deterministic (n, deg) shifts by construction;
    # a resume mixing legacy (shift-less) checkpoint blocks re-detects the
    # circulant structure from the indices instead of dropping the fast
    # path for the whole model (matches slab.train_ocean)
    shifts = shift_parts[0] if all(
        s is not None and np.array_equal(s, shift_parts[0])
        for s in shift_parts) else None
    if shifts is None:
        from ..reservoir.generate import shifts_from_ell
        shifts = shifts_from_ell(host["a_idx"])
    params_all = EsnParams(
        a_idx=jnp.asarray(host["a_idx"]),
        a_val=jnp.asarray(host["a_val"]),
        win=jnp.asarray(host["win"]),
        wout=jnp.asarray(host["wout"]),
        node_map=jnp.asarray(np.arange(n_nodes) // q_nodes, np.int32),
        leakage=rcfg.leakage,
        a_shift=None if shifts is None else jnp.asarray(shifts))
    return HybridModel(layout=layout, params=params_all, stz=stz, rcfg=rcfg,
                       ml_only=ml_only, host_np=host)


def ml_variant(hm: HybridModel) -> HybridModel:
    """The ML-ONLY model (config 2, mod_reservoir.f90:295-296,1491-1535)
    extracted from a `train_hybrid(..., also_ml=True)` run: identical
    reservoirs/standardization, readout restricted to the reservoir block
    (n_model == 0)."""
    assert hm.host_np is not None and "wout_ml" in hm.host_np, \
        "train with also_ml=True first"
    host = {k: v for k, v in hm.host_np.items() if k != "wout_ml"}
    host["wout"] = hm.host_np["wout_ml"]
    # keep the host copy (3.6 GB at reference scale) — persistence reads
    # host_np and prediction runs in a fresh process; no eager upload
    p = hm.params._replace(wout=host["wout"])
    return HybridModel(layout=hm.layout, params=p, stz=hm.stz, rcfg=hm.rcfg,
                       ml_only=True, host_np=host)


# ----------------------------------------------------------------------
# prediction
# ----------------------------------------------------------------------
class HybridRunner:
    """The prediction loop (parallelmain.f90:206-273 redesigned):
    reservoir step + SPEEDY window per hybrid timestep, global state
    device-resident throughout."""

    def __init__(self, hm: HybridModel, fc: Optional[SpeedyForecaster],
                 clim=None, dy=None):
        self.hm = hm
        self.fc = fc
        self.clim = clim if clim is not None else (fc.speedy.clim if fc else None)
        self.dy = dy if dy is not None else (fc.speedy.dy if fc else None)
        self.eps = hm.rcfg.precip_epsilon
        # optional (il, ix) output-side lognormal debias for the precip
        # channel: sigma^2/2 of the readout's log1p residual, subtracted
        # before inversion so the WRITTEN mm is the debiased estimate of
        # E[P] rather than exp-inflated (diag_precip_bias.py measures the
        # field; feedback dynamics are untouched)
        self.precip_debias = None

    def _sst_tisr(self, date: ModelDate):
        """Boundary SST (climatology; slab-ocean reservoir overrides later)
        and hourly-resolved TISR for the date (the reference's
        get_tisr_by_date, mpires.f90:1676-1710 — diurnal, matching the
        train-time TISR statistics)."""
        from ..physics.radiation import diurnal_tisr

        cs = init_coupler_state(self.clim, date)
        ix = self.hm.layout.ix
        tisr = diurnal_tisr(date.tyear, date.ihour,
                            self.dy.tables.gsin, self.dy.tables.gcos, ix)
        return np.asarray(cs.sst_am), tisr

    def _pack(self, atmo, logp, precip_t, sst, tisr):
        L = self.hm.layout
        ss = jnp.maximum(jnp.asarray(sst, jnp.float32), SST_MIN)
        ti = jnp.maximum(jnp.asarray(tisr, jnp.float32), 0.0)
        return pack_global(L, jnp.asarray(atmo, jnp.float32),
                           jnp.asarray(logp, jnp.float32),
                           precip_t if precip_t is not None else None,
                           ss, ti)

    def run(self, x, atmo0, logp0, precip_t0, date: ModelDate, n_steps: int,
            sst_fn=None, tisr_fn=None, ocean=None, x_ocean=None,
            sst_anom0=None, writer=None, component_writers=None,
            checkpoint_path=None, checkpoint_every=0, verbose=0,
            deadline=None, gv_sum0=None, n_accum0=0):
        """Run n_steps hybrid steps from transformed global fields.

        sst_fn(date) -> (il, ix) SST override; default climatology.
        Mutually exclusive with `ocean` (an interactive ocean's anomaly is
        defined against the climatology; adding it on top of an observed
        field would double-count observed anomalies).
        sst_anom0: (il, ix) initial SST ANOMALY vs climatology (NOT an
        absolute field) applied until the first weekly ocean update.
        tisr_fn(date) -> (il, ix) TISR override; default diurnal analytic.
        File-backed observed sources for both (the reference's
        get_sst_by_date/get_tisr_by_date, mpires.f90:1676-1710) are provided
        by io.era.ObservedBoundary.
        ocean: trained OceanModel — steps every timestep_slab hours on the
        rolling week-mean supervector and feeds predicted SST back to both
        the atmosphere reservoirs and SPEEDY's boundary condition
        (mod_slab_ocean_reservoir.f90:1268-1316, cpl_sea.f90:38-44).
        writer: io.output.ForecastWriter — incremental NetCDF output every
        step (the reference root's per-step write, mpires.f90:518-563).
        component_writers: (writer_ml, writer_p) pair of ForecastWriters —
        per-step v_ml/v_p contribution output in physical units
        (atmo = atmo_ml + atmo_p; the reference's
        send_outvec_ml_contrib/speedy_contrib path, mpires.f90:1146-1547).
        checkpoint_path/every: atomic full-state checkpoints every K steps
        (io.checkpoint), enabling exact resume via resume_from().
        Returns a dict of trajectory arrays + final reservoir state; stops
        early if SPEEDY's safety gate trips (ppo_iogrid.f90:563-577 ->
        mpires.f90:744).
        """
        hm = self.hm
        L = hm.layout
        assert not (sst_fn is not None and ocean is not None), \
            "sst_fn (observed SST) and an interactive ocean are mutually " \
            "exclusive: the ocean anomaly is defined against climatology"
        atmo, logp, precip_t = (jnp.asarray(atmo0, jnp.float32),
                                jnp.asarray(logp0, jnp.float32),
                                None if precip_t0 is None
                                else jnp.asarray(precip_t0, jnp.float32))
        date = ModelDate(date.iyear, date.imonth, date.iday, date.ihour)
        traj = {k: [] for k in ("atmo", "logp", "precip_mm", "sst")}
        aborted = False
        gv_sum = None if gv_sum0 is None else jnp.asarray(gv_sum0,
                                                          jnp.float32)
        n_accum = int(n_accum0)
        # ocean feedback persists as an ANOMALY vs climatology between
        # weekly updates (re-applied on the advancing climatology), not as
        # a week-frozen absolute field — the seasonal cycle the reservoirs
        # were trained on keeps moving underneath
        sst_anom = (None if sst_anom0 is None
                    else np.asarray(sst_anom0, np.float64))
        spw = 0 if ocean is None else ocean.steps_per_week
        for step_i in range(n_steps):
            sst, tisr = self._sst_tisr(date)
            if sst_fn is not None:
                sst = sst_fn(date)
            if tisr_fn is not None:
                tisr = tisr_fn(date)
            if sst_anom is not None:
                sst = np.clip(sst + sst_anom, 200.0, 306.0)
            gv = self._pack(atmo, logp, precip_t, sst, tisr)

            if ocean is not None:
                gv_sum = gv if gv_sum is None else gv_sum + gv
                n_accum += 1
                if n_accum == spw:
                    if x_ocean is None:
                        x_ocean = jnp.zeros(
                            (ocean.ol.R, ocean.params.n), jnp.float32)
                    # week-mean ATMO blocks + instantaneous SST/TISR/OHTC
                    # (mpires.f90:776-791; see slab.weekly_ocean_inputs)
                    from ..reservoir.slab import compose_week_inputs
                    gv_week = compose_week_inputs(gv, gv_sum, spw, L)
                    x_ocean, sst_core = ocean.step(x_ocean, gv_week)
                    clim_sst, _ = self._sst_tisr(date)
                    sst_anom = ocean.compose_sst(
                        np.asarray(sst_core), clim_sst, L) - clim_sst
                    gv_sum, n_accum = None, 0

            model_gv = None
            if not hm.ml_only:
                gs = _atmo_to_grid(atmo, logp)
                res = self.fc.forecast(gs, date, sst_hybrid=sst)
                if not bool(res.safe):
                    aborted = True
                    break
                f_atmo = jnp.stack([res.gs.t, res.gs.u, res.gs.v,
                                    jnp.maximum(res.gs.q, QMIN)])
                f_pr = jnp.log1p(jnp.maximum(res.precip_mm, 0.0) / self.eps)
                model_gv = self._pack(f_atmo, res.gs.logp, f_pr, sst, tisr)

            if component_writers is not None and not hm.ml_only:
                x, atmo, logp, precip_t, comp = hm.step_split(x, gv,
                                                              model_gv)
                w_ml, w_p = component_writers
                w_ml.append(np.asarray(comp["atmo_ml"]),
                            np.asarray(comp["logp_ml"]))
                w_p.append(np.asarray(comp["atmo_p"]),
                           np.asarray(comp["logp_p"]))
            else:
                x, atmo, logp, precip_t = hm.step(x, gv, model_gv)
            date.advance_hours(hm.rcfg.timestep)
            traj["atmo"].append(np.asarray(atmo))
            traj["logp"].append(np.asarray(logp))
            if precip_t is None:
                pr_mm = None
            else:
                p_log = np.asarray(precip_t)
                if self.precip_debias is not None:
                    p_log = np.maximum(p_log - self.precip_debias, 0.0)
                pr_mm = self.eps * np.expm1(np.maximum(p_log, 0.0))
            traj["precip_mm"].append(pr_mm)
            traj["sst"].append(np.asarray(sst))
            if writer is not None:
                writer.append(traj["atmo"][-1], traj["logp"][-1],
                              precip_mm=traj["precip_mm"][-1], sst=sst)
            if checkpoint_path and checkpoint_every and \
                    (step_i + 1) % checkpoint_every == 0:
                from ..io.checkpoint import save_prediction
                extra = {}
                if sst_anom is not None:
                    extra["sst_anom"] = sst_anom
                if ocean is not None:
                    # weekly accumulator + ocean reservoir state: without
                    # these, a mid-week resume would restart the week-mean
                    # window with shifted phase and a cold ocean state
                    extra["n_accum"] = n_accum
                    if gv_sum is not None:
                        extra["gv_sum"] = np.asarray(gv_sum)
                    if x_ocean is not None:
                        extra["x_ocean"] = np.asarray(x_ocean)
                save_prediction(checkpoint_path, x, atmo, logp, precip_t,
                                date, step=step_i + 1, extra=extra or None)
            if verbose and (step_i + 1) % verbose == 0:
                import time as _t
                print(f"  predict step {step_i + 1}/{n_steps} "
                      f"[{_t.strftime('%H:%M:%S')}]", flush=True)
            if deadline is not None:
                import time as _t
                if _t.time() > deadline:   # budgeted run: stop cleanly
                    break
        out = {k: (np.stack(v) if v and v[0] is not None else None)
               for k, v in traj.items()}
        out["x"] = x
        out["x_ocean"] = x_ocean
        out["date"] = date
        out["aborted"] = aborted
        return out

    def resume_from(self, checkpoint_path: str, n_steps: int, **kw):
        """Resume a prediction exactly from a run() checkpoint."""
        from ..io.checkpoint import load_prediction
        st = load_prediction(checkpoint_path)
        ex = st["extra"] or {}
        if "sst_cur" in ex:
            # legacy (pre-r4) checkpoints stored the ABSOLUTE fed-back SST;
            # convert to the anomaly semantics against the climatology at
            # the checkpoint date rather than silently dropping the feedback
            clim_sst, _ = self._sst_tisr(st["date"])
            ex["sst_anom"] = np.asarray(ex.pop("sst_cur"),
                                        np.float64) - clim_sst
        sst_anom0 = ex.get("sst_anom")
        if "x_ocean" in ex and kw.get("ocean") is not None \
                and kw.get("x_ocean") is None:
            kw["x_ocean"] = jnp.asarray(ex["x_ocean"])
        return self.run(jnp.asarray(st["x"]), st["atmo"], st["logp"],
                        st["precip_t"], st["date"], n_steps,
                        sst_anom0=kw.pop("sst_anom0", sst_anom0),
                        gv_sum0=kw.pop("gv_sum0", ex.get("gv_sum")),
                        n_accum0=kw.pop("n_accum0",
                                        int(ex.get("n_accum", 0))), **kw)
