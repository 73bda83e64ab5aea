"""SPEEDY window forecasts + truth-trajectory generation for the hybrid model.

Replacement of the reference's run_model path (mpires.f90:1548-
1660), which re-launches the full Fortran model from files every hybrid step
(agcm_main -> agcm_init -> stepone -> stloop, at_gcm.f90:5-62). Here a window
forecast is ONE jitted XLA program: inject grid state -> stepone bootstrap ->
lax.scan of leapfrog steps with physics -> extract grid state, with the
6-hourly precipitation accumulated in the scan carry.

The same window function drives truth-trajectory generation (the analog of
the reference's ERA5 truth + precomputed 6-h SPEEDY forecasts,
speedy_res_interface.f90:439-723): a TrajectoryRunner carries the spectral
state across windows and applies the daily land/sea/ice coupler update.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.calendar import ModelDate
from ..coupler.daily import (SSTFR, daily_coupler_update, fordate,
                             init_coupler_state)
from ..dynamics.core import Forcing
from ..model import Speedy
from ..physics.constants import PP
from ..physics.driver import init_rad_carry
from .state_io import GridState, extract, inject


class WindowResult(NamedTuple):
    gs: GridState          # forecast grid state at window end
    precip_mm: jax.Array   # (il, ix) accumulated precipitation [mm] over window
    safe: jax.Array        # () bool: injection passed the safety gate
    flux_sums: tuple       # (hflux_l, hflux_s, hflux_i) per-step sums for coupler


class SpeedyForecaster:
    """Runs SPEEDY for a fixed window (default 6 h) from an injected grid
    state — the hybrid's "imperfect model" step.

    physics=False gives the dry core (a deliberately more imperfect model for
    self-generated training data; the reference's model error comes from
    SPEEDY-vs-ERA5 instead).
    """

    def __init__(self, speedy: Speedy, hours: int = 6, physics: bool = True):
        self.speedy = speedy
        self.hours = hours
        self.physics = physics
        cfg = speedy.config
        assert (hours * cfg.nsteps) % 24 == 0
        self.nsteps_window = hours * cfg.nsteps // 24
        self._fn = None

    # ------------------------------------------------------------------
    def _build(self):
        return jax.jit(self._window_fn())

    def _window_fn(self, dy=None, phys=None, il=None):
        """The raw (un-jitted) window program — reused by FusedDataGenerator
        to fuse several windows + imperfect-model forecasts into one day
        program, and by parallel.composed with LATITUDE-LOCALIZED dycore/
        physics proxies (dy/phys/il overrides; il is then the local shard's
        latitude block size, and the function runs inside a shard_map)."""
        sp = self.speedy
        dy = dy if dy is not None else sp.dy
        phys = phys if phys is not None else sp.phys
        cfg = sp.config
        il = il if il is not None else cfg.il
        nst = self.nsteps_window
        use_phys = self.physics
        # precip unit: physics precnv/precls are g/(m^2 s); x delt/1000 -> mm
        mm_per_step = cfg.delt / 1000.0
        rday = 1.0 / cfg.nsteps

        def phys_fn(surf, rad, lradsw):
            def fn(dyf, fphy):
                tends, rad_new, fluxes = phys.step_physics(
                    dyf, fphy, surf, rad, lradsw)
                return tends, (rad_new, fluxes)
            return fn

        def ice_flux(fx, surf):
            # difice term for the sea-ice heat budget (model.py day loop,
            # reference ppo_dmflux.f90)
            esbc = PP.emisfc * PP.sbc
            difice = ((PP.albsea - PP.albice) * fx.ssrd
                      + esbc * (SSTFR**4 - surf.tice_am**4)
                      + fx.shf_s + fx.evap_s * PP.alhc)
            return fx.hfluxn_s + difice * (1.0 - surf.sice_am)

        def _cast(tree):
            # surf/forcing leaves arrive as host numpy (f64 when the process
            # runs with x64 for the ridge solve); pin them to the core dtype
            # so no f64 creeps into the physics under jit
            def leaf(a):
                a = jnp.asarray(a)
                return a.astype(dy.dtype) if jnp.issubdtype(
                    a.dtype, jnp.floating) else a
            return jax.tree.map(leaf, tree)

        def window(gs: GridState, surf, forcing: Forcing):
            surf = _cast(surf)
            forcing = _cast(forcing)
            gs = _cast(gs)
            state, safe = inject(dy, gs)
            z = jnp.zeros((il, cfg.ix), dtype=dy.dtype)

            if use_phys:
                rad = init_rad_carry(cfg.kx, il, cfg.ix, dy.dtype)
                t = jnp.asarray(True)
                # stepone bootstrap (ini_stepone.f90) = window step 1
                state, (rad, fx) = dy.step(state, forcing, 0, 0, "half",
                                           phys_fn(surf, rad, t))
                state, (rad, fx) = dy.step(state, forcing, 0, 1, "delt",
                                           phys_fn(surf, rad, t))
                precip0 = (fx.precnv + fx.precls) * mm_per_step
                acc0 = (fx.hfluxn_l * rday, fx.hfluxn_s * rday,
                        ice_flux(fx, surf) * rday)

                def body(carry, j):
                    state, rad, pr, acc = carry
                    lradsw = (j % cfg.nstrad) == 0
                    state, (rad, fx) = dy.step(state, forcing, 1, 1, "delt2",
                                               phys_fn(surf, rad, lradsw))
                    pr = pr + (fx.precnv + fx.precls) * mm_per_step
                    acc = (acc[0] + fx.hfluxn_l * rday,
                           acc[1] + fx.hfluxn_s * rday,
                           acc[2] + ice_flux(fx, surf) * rday)
                    return (state, rad, pr, acc), None

                (state, rad, precip, acc), _ = jax.lax.scan(
                    body, (state, rad, precip0, acc0),
                    jnp.arange(1, nst))
            else:
                state = dy.step(state, forcing, 0, 0, "half")
                state = dy.step(state, forcing, 0, 1, "delt")

                def body(s, _):
                    return dy.step(s, forcing, 1, 1, "delt2"), None

                state, _ = jax.lax.scan(body, state, None, length=nst - 1)
                precip, acc = z, (z, z, z)

            return WindowResult(gs=extract(dy, state, level=0),
                                precip_mm=precip, safe=safe,
                                flux_sums=acc)

        return window

    # ------------------------------------------------------------------
    def _surf_forcing(self, date: ModelDate, sst_hybrid=None):
        sp = self.speedy
        cs = init_coupler_state(sp.clim, date, sst_hybrid=sst_hybrid)
        rad_fields, tcorh, qcorh = fordate(sp.dy, sp.clim, cs, date)
        sp.coupler = cs
        sp.date = date
        surf = sp._make_surf(rad_fields)
        np_dtype = (np.float64 if sp.config.dtype == "float64"
                    else np.float32)
        forcing = Forcing(tcorh=np.asarray(tcorh, np_dtype),
                          qcorh=np.asarray(qcorh, np_dtype))
        return surf, forcing, cs, rad_fields

    def forecast(self, gs: GridState, date: ModelDate,
                 sst_hybrid: Optional[np.ndarray] = None) -> WindowResult:
        """One window forecast from grid state `gs` valid at `date`.

        sst_hybrid overrides the climatological SST boundary condition (the
        reference's ini_sea hybrid hook, cpl_sea.f90:38-44).
        """
        if self._fn is None:
            self._fn = self._build()
        surf, forcing, _, _ = self._surf_forcing(date, sst_hybrid)
        return self._fn(gs, surf, forcing)


@dataclasses.dataclass
class TruthSample:
    """One 6-hourly truth record (the ERA5-slice analog)."""

    gs: GridState
    precip_mm: np.ndarray   # accumulated over the PREVIOUS window
    sst: np.ndarray         # coupler sst_am at sample time
    tisr: np.ndarray        # (il, ix) top incoming solar (zonal fsol broadcast)


class TrajectoryRunner:
    """Generates a 6-hourly "truth" trajectory by integrating SPEEDY
    continuously: spectral->grid state and ONE persistent coupler state are
    carried across windows (unlike SpeedyForecaster, which re-initializes the
    coupler per window exactly as the reference re-launches SPEEDY)."""

    def __init__(self, speedy: Speedy, hours: int = 6,
                 truth_physics: bool = True, sst_anom_fn=None):
        self.speedy = speedy
        self.fc = SpeedyForecaster(speedy, hours=hours, physics=truth_physics)
        self.hours = hours
        self.sst_anom_fn = sst_anom_fn   # see FusedDataGenerator
        self.date: Optional[ModelDate] = None
        self.gs: Optional[GridState] = None
        self.cs = None
        self._day_flux = None
        self._hour = 0

    def initialize(self, year: int = 1982, month: int = 1,
                   spinup_days: int = 10):
        """Rest start + spin-up (the reference trains on ERA5; self-generated
        truth needs the model to leave the rest state first)."""
        sp = self.speedy
        sp.initialize(year=year, month=month)
        if spinup_days:
            sp.run_days(spinup_days)
        self.date = sp.date
        self.cs = sp.coupler
        self.gs = jax.tree.map(np.asarray, extract(sp.dy, sp.state, level=0))
        self._hour = 0
        self._day_flux = None

    def current_sample(self, precip_mm=None) -> TruthSample:
        from ..physics.radiation import diurnal_tisr

        sp = self.speedy
        il, ix = sp.config.il, sp.config.ix
        # hourly-resolved TISR (the reference trains on hourly ERA5 TISR,
        # speedy_res_interface.f90:368-370; daily zonal fsol has no diurnal
        # signal for the reservoirs to learn)
        tisr = diurnal_tisr(self.date.tyear, self.date.ihour,
                            sp.dy.tables.gsin, sp.dy.tables.gcos, ix)
        if precip_mm is None:
            precip_mm = np.zeros((il, ix))
        return TruthSample(gs=self.gs, precip_mm=np.asarray(precip_mm),
                           sst=np.asarray(self.cs.sst_am), tisr=tisr)

    def advance(self) -> TruthSample:
        """Advance one window; returns the truth sample at the NEW time."""
        sp = self.speedy
        if self.fc._fn is None:
            self.fc._fn = self.fc._build()
        rad_fields, tcorh, qcorh = fordate(sp.dy, sp.clim, self.cs, self.date)
        sp.coupler = self.cs
        surf = sp._make_surf(rad_fields)
        np_dtype = (np.float64 if sp.config.dtype == "float64"
                    else np.float32)
        forcing = Forcing(tcorh=np.asarray(tcorh, np_dtype),
                          qcorh=np.asarray(qcorh, np_dtype))
        res = self.fc._fn(self.gs, surf, forcing)
        self.gs = jax.tree.map(np.asarray, res.gs)
        # daily coupler update once a full day has elapsed
        hl, hs, hi = (np.asarray(f, np.float64) for f in res.flux_sums)
        if self._day_flux is None:
            self._day_flux = [hl, hs, hi]
        else:
            for i, f in enumerate((hl, hs, hi)):
                self._day_flux[i] = self._day_flux[i] + f
        self._hour += self.hours
        self.date.advance_hours(self.hours)
        if self._hour >= 24:
            daily_coupler_update(sp.clim, self.cs, self.date,
                                 *self._day_flux)
            if self.sst_anom_fn is not None:
                from ..coupler.anomaly import apply_sst_anomaly
                apply_sst_anomaly(self.cs, self.sst_anom_fn(self.date))
            self._hour = 0
            self._day_flux = None
        return self.current_sample(precip_mm=res.precip_mm)


class FusedDataGenerator:
    """Day-batched truth + imperfect-model training-data generation.

    ONE jitted day program integrates windows_per_day (default 4) truth
    windows AND launches a dry-core imperfect-model window forecast from
    each window-start state, returning stacked samples. Replaces the
    TrajectoryRunner.advance + collect_forecasts pair for bulk generation:

      * per-sample dispatch overhead drops ~4x (one dispatch and one fetch
        per DAY instead of per window);
      * bulk sample downloads overlap the NEXT day's device compute (the
        daily coupler update only needs the tiny flux sums, which are
        fetched first);
      * fordate runs at the reference's daily cadence (fordate(1) once per
        day, at_gcm.f90:64-70) instead of TrajectoryRunner's per-window
        refresh — the more reference-faithful choice.

    The imperfect-model forecasts match collect_forecasts' contract: the
    dry window launched from the truth state at sample t-1 is the forecast
    VALID at sample t (speedy_res_interface.f90:637-723 analog), with the
    per-window forcing derived from a FRESH climatological coupler with the
    trajectory SST override (the reference re-launches SPEEDY per window,
    mpires.f90:1548-1660).
    """

    def __init__(self, speedy: Speedy, hours: int = 6,
                 truth_physics: bool = True, sst_anom_fn=None):
        assert 24 % hours == 0
        self.speedy = speedy
        self.hours = hours
        self.wpd = 24 // hours           # windows per day
        # optional imposed SST-anomaly forcing (coupler.anomaly): applied to
        # the coupler's atmosphere-facing SST after every daily update — the
        # truth trajectory then FEELS the anomaly through the surface fluxes
        # and qcorh, and the recorded sst samples carry it into training
        self.sst_anom_fn = sst_anom_fn
        # truth_physics=False (dry truth) exists for cross-implementation
        # equivalence tests: full-physics windows are numerically sensitive
        # to compilation context (discrete convection/condensation triggers
        # amplify f32 reassociation noise to ~0.4 K/day), so only the dry
        # core compares tightly across differently-fused programs
        self.fc_phys = SpeedyForecaster(speedy, hours=hours,
                                        physics=truth_physics)
        self.fc_dry = SpeedyForecaster(speedy, hours=hours, physics=False)
        self.date: Optional[ModelDate] = None
        self.gs = None                   # device GridState
        self.cs = None
        self._day_fn = None

    def initialize(self, year: int = 1982, month: int = 1,
                   spinup_days: int = 10):
        sp = self.speedy
        sp.initialize(year=year, month=month)
        if spinup_days:
            sp.run_days(spinup_days)
        self.date = sp.date
        self.cs = sp.coupler
        if self.sst_anom_fn is not None:
            from ..coupler.anomaly import apply_sst_anomaly
            apply_sst_anomaly(self.cs, self.sst_anom_fn(self.date))
        self.gs = extract(sp.dy, sp.state, level=0)

    def _build_day(self):
        window_phys = self.fc_phys._window_fn()
        window_dry = self.fc_dry._window_fn()
        wpd = self.wpd

        def day(gs: GridState, surf, forcing: Forcing, dry_forcings):
            """dry_forcings: Forcing pytree stacked (wpd, ...) — one per
            window (fresh-coupler forcing at the window-start date)."""

            def body(gs, dryf):
                res = window_phys(gs, surf, forcing)
                # collect_forecasts launches from the saved truth state,
                # which has q clamped >= 0 (_atmo_to_grid)
                gs0 = gs._replace(q=jnp.maximum(gs.q, 0.0))
                dres = window_dry(gs0, surf, dryf)
                out = (res.gs, res.precip_mm, dres.gs, res.flux_sums,
                       jnp.logical_and(res.safe, dres.safe))
                return res.gs, out

            gs, (gs_st, pr_st, dry_st, fx_st, safe_st) = jax.lax.scan(
                body, gs, dry_forcings, length=wpd)
            fx_day = tuple(jnp.sum(f, axis=0) for f in fx_st)
            return gs, gs_st, pr_st, dry_st, fx_day, jnp.all(safe_st)

        return jax.jit(day)

    def _day_inputs(self):
        """Host-side per-day prep: daily fordate for the truth windows +
        per-window fresh-coupler forcing for the dry forecasts."""
        sp = self.speedy
        np_dtype = (np.float64 if sp.config.dtype == "float64"
                    else np.float32)
        rad_fields, tcorh, qcorh = fordate(sp.dy, sp.clim, self.cs, self.date)
        sp.coupler = self.cs
        surf = sp._make_surf(rad_fields)
        forcing = Forcing(tcorh=np.asarray(tcorh, np_dtype),
                          qcorh=np.asarray(qcorh, np_dtype))
        sst_day = np.asarray(self.cs.sst_am)
        dryfs = []
        d = ModelDate(self.date.iyear, self.date.imonth, self.date.iday,
                      self.date.ihour)
        for _ in range(self.wpd):
            cs_w = init_coupler_state(sp.clim, d, sst_hybrid=sst_day)
            _, tc, qc = fordate(sp.dy, sp.clim, cs_w, d)
            dryfs.append(Forcing(tcorh=np.asarray(tc, np_dtype),
                                 qcorh=np.asarray(qc, np_dtype)))
            d.advance_hours(self.hours)
        dry_forcings = jax.tree.map(lambda *xs: np.stack(xs), *dryfs)
        return surf, forcing, dry_forcings, sst_day

    def generate(self, n_samples: int, verbose: int = 0, log=print):
        """Generate n_samples 6-hourly truth samples + aligned dry-core
        forecasts. Returns a dict with TruthSeries fields (atmo, logp,
        precip, sst, tisr, hours) plus m_atmo, m_logp, m_precip.

        m_* index t is the forecast valid at truth sample t (launched from
        t-1; index 0 is launched from the pre-series initial state — a
        usable pair, unlike collect_forecasts' copied placeholder)."""
        from ..core.calendar import hours_since_epoch
        from ..physics.radiation import diurnal_tisr

        sp = self.speedy
        il, ix = sp.config.il, sp.config.ix
        if self._day_fn is None:
            self._day_fn = self._build_day()
        n_days = (n_samples + self.wpd - 1) // self.wpd

        out = dict(atmo=[], logp=[], precip=[], sst=[], tisr=[], hours=[],
                   m_atmo=[], m_logp=[])
        pending = None      # (device stacks of previous day) for overlap

        def flush(p):
            """Fetch one day's bulk stacks to host and append samples."""
            gs_st, pr_st, dry_st, sst_list, tisr_list, hour_list = p
            a = np.stack([np.asarray(gs_st.t), np.asarray(gs_st.u),
                          np.asarray(gs_st.v), np.asarray(gs_st.q)], axis=1)
            out["atmo"].append(a)                       # (wpd, 4, kx, il, ix)
            out["logp"].append(np.asarray(gs_st.logp))
            out["precip"].append(np.asarray(pr_st))
            ma = np.stack([np.asarray(dry_st.t), np.asarray(dry_st.u),
                           np.asarray(dry_st.v), np.asarray(dry_st.q)],
                          axis=1)
            out["m_atmo"].append(ma)
            out["m_logp"].append(np.asarray(dry_st.logp))
            out["sst"].append(np.stack(sst_list))
            out["tisr"].append(np.stack(tisr_list))
            out["hours"].append(np.asarray(hour_list))

        import time as _time
        t0 = _time.time()
        for di in range(n_days):
            surf, forcing, dry_forcings, sst_day = self._day_inputs()
            gs_new, gs_st, pr_st, dry_st, fx_day, safe = self._day_fn(
                self.gs, surf, forcing, dry_forcings)
            self.gs = gs_new
            # pull the PREVIOUS day's bulk stacks now — the transfer
            # overlaps this day's device compute (dispatch is async)
            if pending is not None:
                flush(pending)
                pending = None
            # per-sample host metadata: date/tisr at each window end; the
            # hour-24 sample's sst is the NEW day's (post-update) sst_am,
            # matching TrajectoryRunner.advance ordering
            sst_list, tisr_list, hour_list = [], [], []
            d = self.date
            for w in range(self.wpd):
                d.advance_hours(self.hours)
                tisr_list.append(diurnal_tisr(d.tyear, d.ihour,
                                              sp.dy.tables.gsin,
                                              sp.dy.tables.gcos, ix))
                hour_list.append(hours_since_epoch(d.iyear, d.imonth,
                                                   d.iday, d.ihour))
                sst_list.append(sst_day)
            # daily coupler update needs only the flux sums: fetch them
            # (tiny, completes this day), update, then DISPATCH the next
            # day before pulling this day's bulk sample stacks
            fx_host = [np.asarray(f, np.float64) for f in fx_day]
            assert bool(np.asarray(safe)), \
                f"truth trajectory tripped the safety gate on day {di}"
            daily_coupler_update(sp.clim, self.cs, self.date, *fx_host)
            if self.sst_anom_fn is not None:
                from ..coupler.anomaly import apply_sst_anomaly
                apply_sst_anomaly(self.cs, self.sst_anom_fn(self.date))
            sst_list[-1] = np.asarray(self.cs.sst_am)   # post-update sample
            pending = (gs_st, pr_st, dry_st, sst_list, tisr_list, hour_list)
            if verbose and (di + 1) % verbose == 0:
                el = _time.time() - t0
                log(f"  day {di+1}/{n_days} ({el:.0f}s, "
                    f"{el/((di+1)*self.wpd):.2f}s/sample)")
        flush(pending)

        res = {k: np.concatenate(v)[:n_samples] for k, v in out.items()}
        res["m_precip"] = np.zeros_like(res["precip"])   # dry core: no precip
        return res
