"""Ensemble-batched hybrid stepping: vmap the FULL hybrid step over members.

The reference's operating mode is one trajectory (parallelmain.f90:206-273),
which leaves the chip idle: the single-trajectory 6-h SPEEDY window is 24
sequential tiny T30 leapfrog steps, latency-bound. For climate-ensemble
workloads the whole step — pack, SPEEDY window, forecast pack, ESN
advance + readout, scatter — vmaps over E members in ONE jitted program:

  * the window's grid work gains an ensemble batch axis;
  * the 3.7 GB wout memory stream of the readout is read ONCE per step for
    all members (einsum batches members into the matmul), amortizing the
    dominant single-trajectory cost E-fold.

Members share the boundary forcing (SST/TISR/surf per date); the reservoir
state and atmospheric fields are per-member. Ensemble spread comes from the
initial conditions (and, with trained weights, from the chaotic window).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.calendar import ModelDate
from ..domain.decomposition import pack_global, scatter_outputs
from ..domain.standardize import (standardize_in, standardize_out,
                                  unstandardize_out)
from ..reservoir.esn import predict_step
from .forecast import SpeedyForecaster
from .state_io import GridState

QMIN = 1e-6
SST_MIN = 272.0


class EnsembleHybrid:
    """vmapped hybrid step over an ensemble axis E (hybrid configs only)."""

    def __init__(self, hm, fc: SpeedyForecaster):
        assert not hm.ml_only, "ensemble step batches the hybrid exchange"
        self.hm = hm
        self.fc = fc
        self.eps = hm.rcfg.precip_epsilon
        self._fn = None

    def _build(self):
        hm = self.hm
        L = hm.layout
        eps = self.eps
        win = self.fc._window_fn()

        def member(params, stz, idx, tidx, x, atmo, logp, precip_t, ss, ti,
                   surf, forcing):
            gv = pack_global(L, atmo, logp, precip_t, ss, ti)
            gs = GridState(t=atmo[0], u=atmo[1], v=atmo[2],
                           q=jnp.maximum(atmo[3], 0.0), logp=logp)
            res = win(gs, surf, forcing)
            f_atmo = jnp.stack([res.gs.t, res.gs.u, res.gs.v,
                                jnp.maximum(res.gs.q, QMIN)])
            f_pr = jnp.log1p(jnp.maximum(res.precip_mm, 0.0) / eps)
            model_gv = pack_global(L, f_atmo.astype(jnp.float32),
                                   res.gs.logp.astype(jnp.float32),
                                   f_pr.astype(jnp.float32), ss, ti)
            u = standardize_in(stz, gv[idx])
            mv = standardize_out(stz, model_gv[tidx])
            x, out_std = predict_step(params, x, u, mv)
            out = unstandardize_out(stz, out_std)
            from .experiment import clamp_precip_t
            atmo2, logp2, pr2 = scatter_outputs(L, out)
            atmo2 = atmo2.at[3].set(jnp.maximum(atmo2[3], QMIN))
            if pr2 is not None:
                pr2 = clamp_precip_t(pr2, eps, getattr(hm.rcfg, 'precip_cap_mm', 40.0))
            return x, atmo2, logp2, pr2, res.safe

        # members vary in (x, atmo, logp, precip_t); weights/boundary shared
        vm = jax.vmap(member, in_axes=(None, None, None, None, 0, 0, 0, 0,
                                       None, None, None, None))
        return jax.jit(vm)

    def step(self, x_e, atmo_e, logp_e, precip_t_e, sst, tisr, surf,
             forcing):
        """One ensemble hybrid step.

        x_e (E, R, n); atmo_e (E, 4, kx, il, ix); logp_e/precip_t_e
        (E, il, ix); sst/tisr (il, ix) shared. Returns per-member outputs +
        (E,) safety flags."""
        if self._fn is None:
            self._fn = self._build()
        hm = self.hm
        idx, tidx = hm._maps()
        ss = jnp.maximum(jnp.asarray(sst, jnp.float32), SST_MIN)
        ti = jnp.maximum(jnp.asarray(tisr, jnp.float32), 0.0)
        return self._fn(hm.params, hm.stz, idx, tidx, x_e,
                        jnp.asarray(atmo_e, jnp.float32),
                        jnp.asarray(logp_e, jnp.float32),
                        jnp.asarray(precip_t_e, jnp.float32),
                        ss, ti, surf, forcing)

    # ------------------------------------------------------------------
    def run(self, x_e, atmo_e, logp_e, precip_t_e, date: ModelDate,
            n_steps: int, sst_fn=None, verbose: int = 0,
            collect: bool = True):
        """Ensemble prediction loop (the batched parallelmain.f90:206-273).

        Boundary SST/TISR per date as in HybridRunner._sst_tisr; members
        evolve independently. An unsafe member makes the run abort (the
        reference's global gate, mpires.f90:744). Returns dict with
        per-member trajectories (if collect) + final state."""
        from ..coupler.daily import init_coupler_state
        from ..physics.radiation import diurnal_tisr

        fc = self.fc
        sp = fc.speedy
        date = ModelDate(date.iyear, date.imonth, date.iday, date.ihour)
        traj = {k: [] for k in ("atmo", "logp", "precip_t")}
        x_e = jnp.asarray(x_e, jnp.float32)
        aborted = False
        for step_i in range(n_steps):
            cs = init_coupler_state(sp.clim, date)
            sst = np.asarray(cs.sst_am)
            if sst_fn is not None:
                sst = sst_fn(date)
            tisr = diurnal_tisr(date.tyear, date.ihour, sp.dy.tables.gsin,
                                sp.dy.tables.gcos, sp.config.ix)
            surf, forcing, _, _ = fc._surf_forcing(date, sst_hybrid=sst)
            x_e, atmo_e, logp_e, precip_t_e, safe = self.step(
                x_e, atmo_e, logp_e, precip_t_e, sst, tisr, surf, forcing)
            date.advance_hours(self.hm.rcfg.timestep)
            if not bool(jnp.all(safe)):
                aborted = True
                break
            if collect:
                traj["atmo"].append(np.asarray(atmo_e))
                traj["logp"].append(np.asarray(logp_e))
                traj["precip_t"].append(np.asarray(precip_t_e))
            if verbose and (step_i + 1) % verbose == 0:
                print(f"  ensemble step {step_i + 1}/{n_steps}", flush=True)
        out = {k: (np.stack(v) if v else None) for k, v in traj.items()}
        out.update(x=x_e, atmo=out["atmo"], aborted=aborted, date=date,
                   final=(atmo_e, logp_e, precip_t_e))
        return out
