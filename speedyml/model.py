"""Full-physics SPEEDY T30L8 atmosphere model.

Orchestrates the dycore + physics + coupler at the reference's cadences
(src/at_gcm.f90): per-day fordate + flux zeroing, 96 leapfrog steps (one
lax.scan, one XLA program), end-of-day slab land/sea/ice update. Unlike the
reference's hybrid path (which re-initializes SPEEDY from files every hour,
mpires.f90:1548-1660), the model state stays device-resident; the hybrid
coupler injects/extracts grid states as pure array ops.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .core.config import ModelConfig
from .core.calendar import ModelDate
from .physics.constants import PP, make_sigma_tables
from .physics.driver import (Physics, RadCarry, SurfaceDailyState,
                             init_rad_carry)
from .coupler.climatology import Climatology, build_climatology
from .coupler.daily import (CouplerState, daily_coupler_update, fordate,
                            init_coupler_state, SSTFR)
from .dynamics.core import Dycore, Forcing
from .dynamics.initial import rest_state
from .dynamics.state import SpectralState


class DailyFluxes(NamedTuple):
    """Daily-mean fluxes for the coupler (ppo_dmflux.f90)."""

    hflux_l: jnp.ndarray
    hflux_s: jnp.ndarray
    hflux_i: jnp.ndarray
    precip: jnp.ndarray     # total precipitation [g/(m^2 s)] daily mean
    evap: jnp.ndarray       # weighted evaporation [g/(m^2 s)] daily mean
    tsr: jnp.ndarray
    olr: jnp.ndarray


class Speedy:
    def __init__(self, config: ModelConfig = ModelConfig(), boundary=None):
        """boundary: a BoundaryData, a directory holding the reference's
        fort.20-26 files, or None for the aquaplanet
        (io.boundary.load_boundary)."""
        from .io.boundary import load_boundary

        self.config = config
        bd = load_boundary(boundary, config.ix, config.il)
        # dycore first (owns the spectral transform + truncated orography)
        self.dy = Dycore(config, orog=bd.orog)
        self.clim = build_climatology(bd, self.dy.tables.gcos,
                                      self.dy.tables.radang)

        self.st = make_sigma_tables(self.dy.vg.hsg)
        dtype = self.dy.dtype

        # orographic drag factor from the truncated surface geopotential
        # (sflset(phis0), ini_agcm_init path)
        from .physics.surface import sflset
        forog = sflset(np.asarray(self.dy.phis0_grid))

        np_dtype = np.float64 if config.dtype == "float64" else np.float32
        self.phys = Physics(
            self.st,
            clat=np.asarray(self.dy.tables.gcos, np_dtype),
            forog=np.asarray(forog, np_dtype),
            fmask1=np.asarray(self.clim.fmask_l, np_dtype),
            phis0_grid=np.asarray(self.dy.phis0_grid, np_dtype),
            dtype=np_dtype,
        )

        self.date: Optional[ModelDate] = None
        self.coupler: Optional[CouplerState] = None
        self.state: Optional[SpectralState] = None
        self.rad: Optional[RadCarry] = None
        self.surf: Optional[SurfaceDailyState] = None
        self.forcing: Optional[Forcing] = None
        self._day_fn = None
        self._bootstrapped = False

        # random diabatic forcing pattern (off by default; ini_inirdf)
        self._randfh = None
        if config.rdf_on:
            from .physics.randfor import make_randfh
            np_dt = np.float64 if config.dtype == "float64" else np.float32
            self._randfh = np.asarray(
                make_randfh(self.dy.T, np.asarray(self.dy.tables.gsin),
                            config.ix, seed=config.rdf_index), np_dt)

        # time-mean diagnostics (off by default; mod_tmean/ppo_tminc/tmout)
        self.time_means = None
        if config.time_means_on:
            from .utils.timemean import init_timemean
            self.time_means = init_timemean(config.kx, config.il, config.ix,
                                            self.dy.dtype)

        # SPPT stochastic physics (off by default, mod_tsteps.f90:68)
        self._sppt = None
        self._sppt_state = None
        self._sppt_key = None
        if config.sppt_on:
            from .physics.sppt import Sppt
            self._sppt = Sppt(self.dy)
            self._sppt_key = jax.random.PRNGKey(0)
            self._sppt_state = self._sppt.init(self._sppt_key)

    # ------------------------------------------------------------------
    def _make_surf(self, rad_fields: dict) -> SurfaceDailyState:
        # numpy leaves: passed as jit ARGUMENTS (device_put at dispatch)
        dtype = np.float64 if self.config.dtype == "float64" else np.float32
        cs = self.coupler
        as_r = lambda x: np.asarray(x, dtype)
        return SurfaceDailyState(
            stl_am=as_r(cs.stl_am), snowd_am=as_r(cs.snowd_am),
            soilw_am=as_r(cs.soilw_am), sst_am=as_r(cs.sst_am),
            sice_am=as_r(cs.sice_am), tice_am=as_r(cs.tice_am),
            alb_l=as_r(rad_fields["alb_l"]), alb_s=as_r(rad_fields["alb_s"]),
            albsfc=as_r(rad_fields["albsfc"]), snowc=as_r(rad_fields["snowc"]),
            fsol=as_r(rad_fields["fsol"]), ozupp=as_r(rad_fields["ozupp"]),
            ozone=as_r(rad_fields["ozone"]), zenit=as_r(rad_fields["zenit"]),
            stratz=as_r(rad_fields["stratz"]))

    def initialize(self, year: int = 1981, month: int = 1,
                   state: Optional[SpectralState] = None):
        """agcm_init equivalent: coupler init, fordate(0), rest start +
        stepone bootstrap (with physics)."""
        cfg = self.config
        self.date = ModelDate(iyear=year, imonth=month, iday=1, ihour=0)
        self.coupler = init_coupler_state(self.clim, self.date)
        rad_fields, tcorh, qcorh = fordate(self.dy, self.clim, self.coupler,
                                           self.date)
        np_dtype = np.float64 if cfg.dtype == "float64" else np.float32
        self.surf = self._make_surf(rad_fields)
        self.forcing = Forcing(tcorh=np.asarray(tcorh, np_dtype),
                               qcorh=np.asarray(qcorh, np_dtype))
        self.state = state if state is not None else rest_state(self.dy)
        self.rad = init_rad_carry(cfg.kx, cfg.il, cfg.ix, self.dy.dtype)
        self._bootstrap()

    def _phys_fn(self, surf, rad, lradsw, sppt_pattern=None):
        def fn(dy, fphy):
            tends, rad_new, fluxes = self.phys.step_physics(
                dy, fphy, surf, rad, lradsw, randfh=self._randfh)
            if sppt_pattern is not None:
                # multiplicative tendency perturbation (phy_phypar.f90 SPPT
                # hook; mod_sppt.f90 mu tapering)
                mu = jnp.asarray(self._sppt.mu, tends[0].dtype)
                s = 1.0 + sppt_pattern * mu[:, None, None]
                tends = tuple(t * s for t in tends)
            return tends, (rad_new, fluxes)
        return fn

    def _bootstrap(self):
        """stepone with physics: forward half-step then leapfrog half-step
        (ini_stepone.f90; lradsw=.true. initially, mod_lflags.f90:22),
        compiled as ONE XLA program."""
        dy = self.dy

        @jax.jit
        def boot(state, rad, surf, forcing):
            t = jnp.asarray(True)
            state, (rad, _) = dy.step(state, forcing, 0, 0, "half",
                                      self._phys_fn(surf, rad, t))
            state, (rad, _) = dy.step(state, forcing, 0, 1, "delt",
                                      self._phys_fn(surf, rad, t))
            return state, rad

        self.state, self.rad = boot(self.state, self.rad, self.surf,
                                    self.forcing)
        self._bootstrapped = True

    # ------------------------------------------------------------------
    def _build_day_fn(self):
        dy = self.dy
        cfg = self.config
        nsteps = cfg.nsteps
        rsteps = 1.0 / nsteps

        use_sppt = self._sppt is not None
        sppt = self._sppt
        use_tm = self.time_means is not None
        st = self.st

        def day_fn(state: SpectralState, rad: RadCarry,
                   surf: SurfaceDailyState, forcing: Forcing,
                   sppt_state=None, sppt_key=None, tm=None):
            def body(carry, j):
                state, rad, acc, sst, tm = carry
                lradsw = (j % cfg.nstrad) == 0
                pattern = None
                if use_sppt:
                    sst, pattern = sppt.step(
                        sst, jax.random.fold_in(sppt_key, j))
                (state, (rad, fx)) = dy.step(
                    state, forcing, 1, 1, "delt2",
                    self._phys_fn(surf, rad, lradsw, pattern))
                if use_tm:
                    from .utils.timemean import tm_update, tm_update_fluxes
                    tm = tm_update_fluxes(fx, tm)
                    # sample prognostics every nstppr steps (ppo_tminc)
                    tm = jax.lax.cond(
                        (j + 1) % cfg.nstppr == 0,
                        lambda t: tm_update(dy, st, state.at_level(0), t),
                        lambda t: t, tm)

                esbc = PP.emisfc * PP.sbc
                difice = ((PP.albsea - PP.albice) * fx.ssrd
                          + esbc * (SSTFR**4 - surf.tice_am**4)
                          + fx.shf_s + fx.evap_s * PP.alhc)
                acc = DailyFluxes(
                    hflux_l=acc.hflux_l + fx.hfluxn_l * rsteps,
                    hflux_s=acc.hflux_s + fx.hfluxn_s * rsteps,
                    hflux_i=acc.hflux_i + (fx.hfluxn_s + difice *
                                           (1.0 - surf.sice_am)) * rsteps,
                    precip=acc.precip + (fx.precnv + fx.precls) * rsteps,
                    evap=acc.evap + fx.evap * rsteps,
                    tsr=acc.tsr + fx.tsr * rsteps,
                    olr=acc.olr + fx.olr * rsteps,
                )
                return (state, rad, acc, sst, tm), None

            z = jnp.zeros((cfg.il, cfg.ix), dtype=dy.dtype)
            acc0 = DailyFluxes(z, z, z, z, z, z, z)
            (state, rad, acc, sppt_state, tm), _ = jax.lax.scan(
                body, (state, rad, acc0, sppt_state, tm), jnp.arange(nsteps))
            return state, rad, acc, sppt_state, tm

        return jax.jit(day_fn)

    def run_day(self):
        """agcm_1day + coupler exchange (at_gcm.f90:38-44, 64-106)."""
        assert self._bootstrapped, "call initialize() first"
        if self._day_fn is None:
            self._day_fn = self._build_day_fn()

        # 1. forcing for the current date (fordate(1))
        rad_fields, tcorh, qcorh = fordate(self.dy, self.clim, self.coupler,
                                           self.date)
        np_dtype = np.float64 if self.config.dtype == "float64" else np.float32
        self.surf = self._make_surf(rad_fields)
        self.forcing = Forcing(tcorh=np.asarray(tcorh, np_dtype),
                               qcorh=np.asarray(qcorh, np_dtype))

        # 2.-3. one day of leapfrog steps with flux accumulation
        if self._sppt is not None:
            self._sppt_key = jax.random.fold_in(self._sppt_key, 1)
        self.state, self.rad, acc, self._sppt_state, self.time_means = (
            self._day_fn(self.state, self.rad, self.surf, self.forcing,
                         self._sppt_state, self._sppt_key, self.time_means))

        # 4. date advance + coupler slab models (daily)
        self.date.advance_day()
        daily_coupler_update(self.clim, self.coupler, self.date,
                             np.asarray(acc.hflux_l, np.float64),
                             np.asarray(acc.hflux_s, np.float64),
                             np.asarray(acc.hflux_i, np.float64))
        return acc

    def run_days(self, ndays: int):
        acc = None
        for _ in range(ndays):
            acc = self.run_day()
        return acc

    def write_time_means(self, basepath: str) -> dict:
        """tmout(imode>0) equivalent: normalize the accumulated means, write
        one GrADS record (.grd + .ctl), reset the accumulators
        (ppo_tmout.f90:34-42, ppo_setctl.f90). Returns the field dict."""
        from .utils.timemean import init_timemean, write_grads
        assert self.time_means is not None, "set ModelConfig.time_means_on"
        fields = write_grads(
            self.time_means, basepath,
            np.degrees(np.asarray(self.dy.tables.radang)),
            np.asarray(self.st.sig),
            year=self.date.iyear, month=self.date.imonth)
        self.time_means = init_timemean(self.config.kx, self.config.il,
                                        self.config.ix, self.dy.dtype)
        return fields

    # ------------------------------------------------------------------
    def grid_view(self, level: int = 0):
        """Diagnostic grid-space view of the current state (one jitted
        program; only real grid arrays cross the device->host boundary)."""
        if not hasattr(self, "_grid_view_fn") or self._grid_view_fn is None:
            T = self.dy.T

            @functools.partial(jax.jit, static_argnums=1)
            def gv(state, level):
                f = state.at_level(level)
                ug, vg = T.uv_grid(f.vor, f.div)
                return dict(
                    u=ug, v=vg,
                    t=T.spec_to_grid(f.t),
                    q=T.spec_to_grid(f.tr[0]),
                    ps=jnp.exp(T.spec_to_grid(f.ps)) * 1013.0,
                )

            self._grid_view_fn = gv
        out = self._grid_view_fn(self.state, level)
        return {k: np.asarray(v) for k, v in out.items()}
