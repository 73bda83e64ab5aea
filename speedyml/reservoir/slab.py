"""Slab-ocean reservoir: weekly SST prediction coupled to the atmosphere.

Re-design of the reference's per-region "special" ocean reservoir
(src/mod_slab_ocean_reservoir.f90): one batched ESN over all ocean-active
regions, driven on the slow (weekly, timestep_slab=168 h) cadence.

Inputs per region (get_training_data_from_atmo,
mod_slab_ocean_reservoir.f90:271-405): week-averaged bottom-level atmosphere
(T, u, v, q) over the halo patch + logp patch + SST patch + TISR patch
(+ optional OHTC patch); target = SST at the region core one week ahead.
Regions are active only where the training SST variance exceeds a threshold
(sst_bool_prediction); elsewhere climatology is used.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import ReservoirConfig
from ..domain.decomposition import RegionLayout
from ..domain.standardize import Standardizer
from .esn import EsnParams, predict_step, synchronize
from .generate import generate_esn
from .training import (drive_and_accumulate, drive_discard, init_normal_eq,
                       ridge_solve)


class OceanLayout(NamedTuple):
    """Gather maps for the ocean reservoir, indexing the SAME packed global
    supervector as the atmosphere layout."""

    input_index: np.ndarray   # (R, n_in) int32 into gv
    target_index: np.ndarray  # (R, n_out) int32 into gv (sst core points)
    sections: dict            # name -> (start, stop) within the input vector
    n_in: int
    n_out: int
    R: int


def build_ocean_layout(L: RegionLayout, bottom_level: Optional[int] = None
                       ) -> OceanLayout:
    """Derive the ocean gather maps from the atmosphere layout.

    Ocean reservoirs are per HORIZONTAL region (R_ocean = nregy*nregx, one
    per column regardless of the atmosphere's vertical slabs); inputs index
    the global supervector directly.

    bottom_level: sigma level index used for the near-surface atmosphere
    inputs (default kx-1 = lowest model level)."""
    from ..domain.decomposition import _patch_indices

    kz = L.kx - 1 if bottom_level is None else bottom_level
    npatch = L.inpy * L.inpx
    ncore = L.resy * L.resx
    nv = L.nvars
    ngp = L.il * L.ix
    has_ohtc = L.gv_sizes.get("ohtc", (0, 0))[1] > L.gv_sizes.get(
        "ohtc", (0, 0))[0]

    sections = {}
    pos = 0
    in2d = ["logp", "sst", "tisr"] + (["ohtc"] if has_ohtc else [])
    for name, ln in [("atmo_bot", nv * npatch)] + [(n, npatch)
                                                   for n in in2d]:
        sections[name] = (pos, pos + ln)
        pos += ln
    n_in = pos
    n_out = ncore * (2 if has_ohtc else 1)    # [sst core | ohtc core]

    Ro = L.nregy * L.nregx
    input_index = np.empty((Ro, n_in), np.int32)
    target_index = np.empty((Ro, n_out), np.int32)

    a0 = L.gv_sizes["atmo3d"][0]
    for r in range(Ro):
        ry, rx = divmod(r, L.nregx)
        patch = _patch_indices(L.il, L.ix, ry * L.resy - L.overlap,
                               rx * L.resx - L.overlap, L.inpy, L.inpx)
        sec = np.empty(nv * npatch, np.int32)
        for p in range(npatch):
            for v in range(nv):
                sec[v + nv * p] = a0 + (v * L.kx + kz) * ngp + patch[p]
        s0, s1 = sections["atmo_bot"]
        input_index[r, s0:s1] = sec
        for name in in2d:
            g0, g1 = L.gv_sizes[name]
            assert g1 > g0, f"ocean reservoir needs {name} in the layout"
            u0, u1 = sections[name]
            input_index[r, u0:u1] = g0 + patch
        core = _patch_indices(L.il, L.ix, ry * L.resy, rx * L.resx,
                              L.resy, L.resx)
        target_index[r, :ncore] = L.gv_sizes["sst"][0] + core
        if has_ohtc:
            target_index[r, ncore:] = L.gv_sizes["ohtc"][0] + core

    return OceanLayout(input_index=input_index, target_index=target_index,
                       sections=sections, n_in=n_in, n_out=n_out, R=Ro)


def weekly_average(gv_series: np.ndarray, steps_per_week: int) -> np.ndarray:
    """Average the 6-hourly transformed supervector over each week window.
    Plain block-mean of EVERY field — see weekly_ocean_inputs for the
    reference's actual input mixing. Returns (T_w, gv_len)."""
    T = gv_series.shape[0]
    Tw = T // steps_per_week
    return gv_series[:Tw * steps_per_week].reshape(
        Tw, steps_per_week, -1).mean(axis=1)


def weekly_ocean_inputs(gv_series: np.ndarray, steps_per_week: int,
                        L: RegionLayout) -> np.ndarray:
    """Ocean-reservoir input series at slab cadence, with the reference's
    mixing: ONLY the atmosphere blocks (atmo3d + logp) are week-averaged
    (rolling_average_over_a_period_2d applied to atmo3d_start:logp_end,
    mod_slab_ocean_reservoir.f90:398; prediction-time averaging
    mpires.f90:776-791); the SST/TISR/OHTC blocks stay INSTANTANEOUS values
    at the week boundary (the reference strides the un-averaged trainingdata
    at ::timestep_slab). Returns (T_w, gv_len)."""
    T = gv_series.shape[0]
    Tw = T // steps_per_week
    g = gv_series[:Tw * steps_per_week].reshape(Tw, steps_per_week, -1)
    out = np.array(g[:, -1], copy=True)            # week-boundary endpoint
    for name in ("atmo3d", "logp"):
        s0, s1 = L.gv_sizes[name]
        out[:, s0:s1] = g[:, :, s0:s1].mean(axis=1)
    return out


def compose_week_inputs(gv_end, gv_sum, steps_per_week: int,
                        L: RegionLayout):
    """Prediction-time analog of weekly_ocean_inputs for ONE week window:
    gv_end is the current (week-boundary) supervector, gv_sum the running sum
    over the window. Atmosphere blocks become the window mean, everything
    else keeps the instantaneous endpoint (mpires.f90:776-791)."""
    out = jnp.asarray(gv_end)
    for name in ("atmo3d", "logp"):
        s0, s1 = L.gv_sizes[name]
        out = out.at[s0:s1].set(gv_sum[s0:s1] / steps_per_week)
    return out


def _section_stats(series: np.ndarray, sections: dict, groups: dict,
                   eps: float = 1e-8, std_floors: Optional[dict] = None):
    """Per-region scalar stats per (section, group) expanded to per-element
    (the reference's per-variable scalars, mod_utilities.f90:934-1040).

    groups[name] = number of interleaved variables in the section (stats are
    computed per variable, shared across patch positions).
    std_floors[name] = absolute std floor for clamped/bounded INPUT sections
    (see standardize.SST_STD_FLOOR)."""
    T, R, n = series.shape
    mean = np.empty((R, n), np.float32)
    std = np.empty((R, n), np.float32)
    for name, (s0, s1) in sections.items():
        if s1 <= s0:
            continue
        g = groups.get(name, 1)
        sec = series[:, :, s0:s1].reshape(T, R, (s1 - s0) // g, g)
        m = sec.mean(axis=(0, 2))            # (R, g)
        sd = sec.std(axis=(0, 2)) + eps
        if std_floors and name in std_floors:
            sd = np.maximum(sd, std_floors[name])
        mean[:, s0:s1] = np.tile(m[:, None, :], (1, (s1 - s0) // g, 1)
                                 ).reshape(R, -1)
        std[:, s0:s1] = np.tile(sd[:, None, :], (1, (s1 - s0) // g, 1)
                                ).reshape(R, -1)
    return mean, std


@dataclasses.dataclass
class OceanModel:
    """Trained slab-ocean reservoirs + masks."""

    ol: OceanLayout
    params: EsnParams
    stz: Standardizer
    active: np.ndarray        # (R,) bool: sst variance above threshold
    rcfg: ReservoirConfig
    # optional (il, ix) per-gridpoint anomaly-gate scale: compose_sst
    # tightens the clip to 3x this value pointwise. Set it to the model's
    # OPEN-LOOP one-week residual std (calibrate_gate) — "trust the ocean
    # prediction only up to its demonstrated skill". The r4 coupled smoke
    # showed why total training-SST std is the WRONG scale: it is dominated
    # by the seasonal cycle, so the 3-sigma gate admitted ~2.6 K warm-pool
    # anomalies that the atmosphere reservoirs (trained on icsea=0
    # climatological SST with ~zero deseasonalized variance) had never
    # seen, and tropical convection blew up within a week of the first
    # feedback application.
    anom_std: Optional[np.ndarray] = None
    _step_fn: Optional[callable] = None
    _sync_fn: Optional[callable] = None

    @property
    def steps_per_week(self) -> int:
        return self.rcfg.timestep_slab // self.rcfg.timestep

    def _build(self):
        # weights/stats/maps are jit ARGUMENTS, not closure constants
        # (see HybridModel._build_step)
        def step(params, stz, idx, x, gv_weekmean):
            u = (gv_weekmean[idx] - stz.in_mean) / stz.in_std
            x, out_std = predict_step(params, x, u)
            return x, out_std * stz.out_std + stz.out_mean

        def sync(params, stz, idx, x, gv_series):
            u = (gv_series[:, idx] - stz.in_mean) / stz.in_std
            return synchronize(params, x, u)

        return jax.jit(step), jax.jit(sync)

    def _maps(self):
        if not hasattr(self, "_idx") or self._idx is None:
            self._idx = jnp.asarray(self.ol.input_index)
        return self._idx

    def step(self, x, gv_weekmean):
        """One weekly step: returns (x', sst core values (R, n_out) [K])."""
        if self._step_fn is None:
            self._step_fn, self._sync_fn = self._build()
        return self._step_fn(self.params, self.stz, self._maps(), x,
                             jnp.asarray(gv_weekmean, jnp.float32))

    def synchronize(self, gv_weekly: np.ndarray, x=None):
        if self._step_fn is None:
            self._step_fn, self._sync_fn = self._build()
        if x is None:
            x = jnp.zeros((self.ol.R, self.params.n), jnp.float32)
        return self._sync_fn(self.params, self.stz, self._maps(), x,
                             jnp.asarray(gv_weekly, jnp.float32))

    def open_loop(self, gv_weekly: np.ndarray, x=None):
        """Teacher-forced one-week-ahead predictions over a weekly input
        series: ONE scanned program returning (T_w, R, n_out) physical
        outputs (prediction at index t is valid at week t+1's end)."""
        from .esn import advance, readout

        if x is None:
            x = jnp.zeros((self.ol.R, self.params.n), jnp.float32)
        idx = self._maps()

        def run(params, stz, x, gv_series):
            u = (gv_series[:, idx] - stz.in_mean) / stz.in_std

            def body(x, u_t):
                x = advance(params, x, u_t)
                return x, readout(params, x)

            x, outs = jax.lax.scan(body, x, u)
            return x, outs * stz.out_std + stz.out_mean

        if not hasattr(self, "_ol_fn") or self._ol_fn is None:
            self._ol_fn = jax.jit(run)
        return self._ol_fn(self.params, self.stz, x,
                           jnp.asarray(gv_weekly, jnp.float32))

    def calibrate_gate(self, gv_truth: np.ndarray, L: RegionLayout,
                      discard: int = 8, train_anom_std=None):
        """Set the compose_sst anomaly gate from OPEN-LOOP residuals.

        Runs teacher-forced one-week-ahead predictions over the training
        series and stores the per-gridpoint residual std (floored at the
        weekly persistence error scale) as anom_std. The fed-back anomaly
        is then clipped to 3x the model's demonstrated skill — the analog
        of the reference's 6 K acceptance gate (cpl_sea.f90:38-44)
        recalibrated to the training regime's actual variance.

        train_anom_std: optional (il, ix) per-gridpoint std of the TRAINING
        SST's deviation from the date-matched climatological boundary (see
        training_anomaly_std). When the truth carries real anomalies (the
        observed-SST / synthetic-ENSO regime), a skilful model's residuals
        are SMALL — gating on them alone would clip the very anomalies the
        ocean was trained to produce. The gate scale is therefore
        max(residual std, training anomaly std): admit what the coupled
        system has seen in training, never less than the model's noise
        floor. In the climatological regime (icsea=0) train_anom_std ~ 0
        over open water, reproducing the r4 behaviour exactly.
        Returns (gate_std_grid, open_loop_rms, persistence_rms)."""
        spw = self.steps_per_week
        gv_w = weekly_ocean_inputs(gv_truth, spw, L)
        Tw = gv_w.shape[0]
        ends = np.arange(1, Tw + 1) * spw - 1
        truth = gv_truth[ends][:, self.ol.target_index]     # (Tw, R, n_out)
        _, pred = self.open_loop(gv_w[:-1])
        pred = np.asarray(pred)                             # valid at t+1
        resid = pred[discard:] - truth[discard + 1:]
        ncore = L.resy * L.resx
        resid_sst = resid[:, :, :ncore]                     # (T', R, ncore)
        per_pt = resid_sst.std(axis=0)                      # (R, ncore)
        pers = truth[discard + 1:, :, :ncore] - truth[discard:-1, :, :ncore]

        grid = np.zeros((L.il, L.ix))
        g_ss0 = L.gv_sizes["sst"][0]
        tgt = self.ol.target_index[:, :ncore] - g_ss0
        grid.reshape(-1)[tgt.reshape(-1)] = per_pt.reshape(-1)
        if train_anom_std is not None:
            grid = np.maximum(grid, np.asarray(train_anom_std, np.float64))
        self.anom_std = grid
        ol_rms = float(np.sqrt((resid_sst[:, self.active] ** 2).mean()))
        p_rms = float(np.sqrt((pers[:, self.active] ** 2).mean()))
        return grid, ol_rms, p_rms

    def compose_sst(self, sst_pred_core, sst_clim: np.ndarray,
                    layout: RegionLayout):
        """Blend predicted SST (active regions) with climatology: the
        reference's sst_bool_prediction + sea-mask freeze
        (mod_slab_ocean_reservoir.f90:833-867, mpires.f90:456-563).

        Predicted SST is gated to within slab_anom_clip [K] of the
        climatology — the anomaly analog of the reference's 6 K
        hybrid-SST acceptance gate at the SPEEDY boundary
        (cpl_sea.f90:38-44): a reservoir extrapolating far outside its
        training distribution (short ocean training records) must not be
        allowed to destabilize the coupled system. ENSO-scale anomalies
        (+-3 K) pass untouched; absolute bounds [271, 306] K apply last."""
        L = layout
        ncore = L.resy * L.resx
        clim = np.asarray(sst_clim, np.float64)
        grid = clim.copy()
        flat = grid.reshape(-1)
        g_ss0 = L.gv_sizes["sst"][0]
        tgt = self.ol.target_index[:, :ncore] - g_ss0   # flat grid indices
        pred = np.asarray(sst_pred_core, np.float64)[:, :ncore]
        act = self.active
        flat[tgt[act].reshape(-1)] = pred[act].reshape(-1)
        grid = flat.reshape(grid.shape)
        clip = getattr(self.rcfg, "slab_anom_clip", 0.0)
        if clip:
            cf = np.asarray(clip, np.float64)
            if self.anom_std is not None:
                cf = np.minimum(cf, np.maximum(3.0 * self.anom_std, 0.05))
            grid = np.clip(grid, clim - cf, clim + cf)
        # sanity bounds ONLY — the boundary field is the ICE-BLENDED
        # sst_am (sst + sice*(tice - sst), cpl_sea.f90), which
        # legitimately reaches ~237 K over sea ice. Flooring it at the
        # open-water freezing point (an earlier-round mistake, first
        # executed in the r3 coupled run) jumped polar surface
        # temperatures by +34 K at the first ocean step and destabilized
        # the whole coupled system.
        return np.clip(grid, 200.0, 306.0)


def training_anomaly_std(clim, hours: np.ndarray, sst_series: np.ndarray,
                         subsample: int = 4) -> np.ndarray:
    """(il, ix) per-gridpoint std [K] of the truth SST's deviation from the
    date-matched climatological sea boundary — the training-distribution
    anomaly scale for the compose_sst gate (see calibrate_gate).

    Open water only: where the climatological ice fraction ever exceeds 5%
    the result is zeroed, because there the ice-blended sst_am deviates
    from the climatological blend through the PROGNOSTIC ice temperature,
    which is not an SST anomaly the ocean reservoir should be licensed to
    feed back."""
    from ..coupler.daily import interp_sea
    from ..core.calendar import ModelDate, datetime_from_hours

    h = np.asarray(hours)[::subsample]
    ss = np.asarray(sst_series, np.float64)[::subsample]
    dev_sq = np.zeros(ss.shape[1:], np.float64)
    dev_mean = np.zeros_like(dev_sq)
    ice_any = np.zeros_like(dev_sq, dtype=bool)
    for i in range(len(h)):
        y, m, d, hh = datetime_from_hours(int(h[i]))
        date = ModelDate(y, m, d, hh)
        sstcl, sicecl, ticecl = interp_sea(clim, date.imonth, date.tmonth)
        blend = sstcl + sicecl * (ticecl - sstcl)
        dev = ss[i] - blend
        dev_mean += dev
        dev_sq += dev * dev
        ice_any |= sicecl > 0.05
    n = max(len(h), 1)
    var = dev_sq / n - (dev_mean / n) ** 2
    std = np.sqrt(np.maximum(var, 0.0))
    std[ice_any] = 0.0
    return std


def train_ocean(L: RegionLayout, rcfg: ReservoirConfig,
                gv_truth: np.ndarray, seed: int = 100,
                bottom_level: Optional[int] = None,
                region_block: int = 0, solver: str = "host",
                checkpoint_dir: Optional[str] = None) -> OceanModel:
    """Train the slab-ocean reservoirs from the 6-hourly truth supervector
    (train_slab_ocean_model, mod_slab_ocean_reservoir.f90:172-269).

    solver/checkpoint_dir: as in hybrid.experiment.train_hybrid — "device"
    keeps the (Rb, n, n) normal equations on the device, and per-block
    persistence makes long runs resumable."""
    ol = build_ocean_layout(L, bottom_level)
    spw = rcfg.timestep_slab // rcfg.timestep
    gv_w = weekly_ocean_inputs(gv_truth, spw, L)
    Tw = gv_w.shape[0]
    assert Tw > 4, "need more than 4 weekly samples to train the slab ocean"

    inputs = gv_w[:, ol.input_index]                       # (Tw, R, n_in)
    # targets: INSTANTANEOUS SST (+OHTC) at week boundaries — the reference
    # never averages the SST block (rolling_average_over_a_period_2d covers
    # only atmo3d_start:logp_end, mod_slab_ocean_reservoir.f90:398) and
    # strides the raw series at ::timestep_slab for training
    ends = np.arange(1, Tw + 1) * spw - 1
    targets_raw = gv_truth[ends][:, ol.target_index]       # (Tw, R, n_out)

    from ..domain.standardize import SST_STD_FLOOR
    in_mean, in_std = _section_stats(
        inputs, ol.sections, groups={"atmo_bot": L.nvars},
        std_floors={"sst": SST_STD_FLOOR})
    ncore = L.resy * L.resx
    out_sec = {"sst": (0, ncore)}
    if ol.n_out > ncore:
        out_sec["ohtc"] = (ncore, ol.n_out)
    out_mean, out_std = _section_stats(targets_raw, out_sec, groups={})
    stz = Standardizer(in_mean=jnp.asarray(in_mean),
                       in_std=jnp.asarray(in_std),
                       out_mean=jnp.asarray(out_mean),
                       out_std=jnp.asarray(out_std))

    # active where SST varies (sst_bool_prediction threshold)
    sst_var = targets_raw[:, :, :ncore].var(axis=(0, 2))   # (R,)
    active = sst_var > rcfg.sst_variance_threshold

    u_all = (inputs - in_mean) / in_std
    y_all = (targets_raw - out_mean) / out_std

    R = ol.R
    blocks = [np.arange(R)] if region_block in (0, R) else [
        np.arange(i, min(i + region_block, R))
        for i in range(0, R, region_block)]
    key0 = jax.random.PRNGKey(seed)
    idx_p, val_p, win_p, wout_p = [], [], [], []
    q_nodes = None
    discard = max(1, min(Tw // 4, 8))
    if checkpoint_dir:
        import os
        os.makedirs(checkpoint_dir, exist_ok=True)
    for bi, blk in enumerate(blocks):
        if checkpoint_dir:
            import os
            ck = f"{checkpoint_dir}/ocean_block_{bi:04d}.npz"
            if os.path.exists(ck):
                z = np.load(ck)
                idx_p.append(z["a_idx"])
                val_p.append(z["a_val"])
                win_p.append(z["win"])
                wout_p.append(z["wout"])
                q_nodes = int(z["q"])
                continue
        params = generate_esn(seed + 31 * bi, len(blk), ol.n_in, ol.n_out,
                              n_model=0, m_target=rcfg.slab_nodes,
                              deg=rcfg.degree, sigma=rcfg.slab_sigma,
                              leakage=rcfg.slab_leakage,
                              radii=np.full(len(blk), 0.9))
        q_nodes = params.q
        kd, kt = jax.random.split(jax.random.fold_in(key0, bi))
        x = jnp.zeros((len(blk), params.n), jnp.float32)
        x = drive_discard(params, x, u_all[:discard, blk],
                          noise_mag=rcfg.slab_noise_std, rng_key=kd)
        acc = init_normal_eq(params, ol.n_out)._replace(x=x)
        acc = drive_and_accumulate(
            params, acc, u_all[discard:-1, blk], y_all[discard + 1:, blk],
            noise_mag=rcfg.slab_noise_std, rng_key=kt,
            chunk=min(16, max(1, (Tw - discard - 1))))
        if solver == "device":
            from .training import ridge_solve_device
            wout = ridge_solve_device(acc, 0, rcfg.slab_beta_res, 1.0)
        else:
            wout = ridge_solve(acc, 0, rcfg.slab_beta_res, 1.0)
        idx_p.append(np.asarray(params.a_idx))
        val_p.append(np.asarray(params.a_val))
        win_p.append(np.asarray(params.win))
        wout_p.append(np.asarray(wout, np.float32))
        if checkpoint_dir:
            import os
            tmp = ck + ".tmp"
            with open(tmp, "wb") as fh:
                np.savez(fh, a_idx=idx_p[-1], a_val=val_p[-1],
                         win=win_p[-1], wout=wout_p[-1], q=q_nodes)
            os.replace(tmp, ck)

    n_nodes = win_p[0].shape[1]
    from .generate import shifts_from_ell
    a_idx_h = np.concatenate(idx_p)
    shifts = shifts_from_ell(a_idx_h)   # circulant fast path when detected
    params_all = EsnParams(
        a_idx=jnp.asarray(a_idx_h),
        a_val=jnp.asarray(np.concatenate(val_p)),
        win=jnp.asarray(np.concatenate(win_p)),
        wout=jnp.asarray(np.concatenate(wout_p)),
        node_map=jnp.asarray(np.arange(n_nodes) // q_nodes, np.int32),
        leakage=rcfg.slab_leakage,
        a_shift=None if shifts is None else jnp.asarray(shifts))
    return OceanModel(ol=ol, params=params_all, stz=stz, active=active,
                      rcfg=rcfg)
