"""Composed end-to-end sharded hybrid step: ONE multi-device XLA program.

The true replacement for the reference's per-step MPI cycle
(src/mpires.f90:218-804: gather outvecs to rank 0, rebuild global grids,
run SPEEDY serially on rank 0, re-scatter halo'd inputs + forecasts):

  pack -> lat-sharded SPEEDY window (shard_map) -> pack forecast ->
  region-sharded ESN advance + readout -> scatter

all inside one jit over one device mesh — no hub, no host round trip,
no per-step re-launch.

Mesh: ONE axis serves both roles. The region batch R (1152) and the
latitude count il (48) are each divisible by any practical device count,
and the window and reservoir phases of the step use the devices
SEQUENTIALLY (the reservoir consumes the window's output), so distinct
axes would only idle hardware. Grid-space work inside the window is
sharded over latitude (parallel.spatial: inverse transforms local, one
psum per forward transform); the reservoir phase shards regions.

Equivalence vs the single-device step is pinned by tests/test_composed.py
on the virtual 8-device CPU mesh; dryrun_multichip runs it as phase 6.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..domain.decomposition import pack_global, scatter_outputs
from ..domain.standardize import (standardize_in, standardize_out,
                                  unstandardize_out)
from ..hybrid.forecast import SpeedyForecaster
from ..hybrid.state_io import GridState
from ..reservoir.esn import predict_step
from .spatial import _lat_spec, _localize_dycore, _localize_physics

QMIN = 1e-6
SST_MIN = 272.0


class ComposedHybridStep:
    """One-jit hybrid step over a device mesh.

    hm: trained HybridModel (not ml_only); speedy: the full-physics model
    providing the window; mesh: single-axis device mesh (axis shards both
    latitude inside the window and regions in the reservoir phase);
    physics: window physics on (False = dry window, used by the tight
    equivalence test — full-physics windows are numerically sensitive to
    compilation context, see FusedDataGenerator).
    """

    def __init__(self, hm, speedy, mesh: Mesh, axis: Optional[str] = None,
                 physics: bool = True):
        assert not hm.ml_only, "the composed step is the hybrid exchange"
        self.hm = hm
        self.speedy = speedy
        self.mesh = mesh
        self.axis = axis if axis is not None else mesh.axis_names[0]
        self.n_shards = mesh.shape[self.axis]
        cfg = speedy.config
        assert cfg.il % self.n_shards == 0, (cfg.il, self.n_shards)
        assert hm.layout.R % self.n_shards == 0, (hm.layout.R, self.n_shards)
        self.fc = SpeedyForecaster(speedy, hours=hm.rcfg.timestep,
                                   physics=physics)
        self._fn = None
        self._surf_specs = None

    # ------------------------------------------------------------------
    def _grid_specs(self):
        # _lat_spec keys on the il-sized axis; build with real shapes
        cfg = self.speedy.config
        z3 = np.zeros((cfg.kx, cfg.il, cfg.ix))
        z2 = np.zeros((cfg.il, cfg.ix))
        gs_ex = GridState(t=z3, u=z3, v=z3, q=z3, logp=z2)
        return _lat_spec(gs_ex, self.axis, cfg.il)

    def _build(self, surf_example):
        hm = self.hm
        L = hm.layout
        sp = self.speedy
        cfg = sp.config
        axis, n = self.axis, self.n_shards
        jl = cfg.il // n
        fc = self.fc
        eps = hm.rcfg.precip_epsilon

        def window_body(gs, surf, forcing):
            loc = _localize_dycore(sp.dy, axis, n)
            ploc = _localize_physics(sp.phys, axis, n)
            win = fc._window_fn(dy=loc, phys=ploc, il=jl)
            res = win(gs, surf, forcing)
            # global safety gate: every shard's bounds check must pass
            # (ppo_iogrid.f90:563-577 -> the broadcast abort mpires.f90:744)
            safe = jax.lax.psum(res.safe.astype(jnp.float32), axis) >= n
            return res.gs, res.precip_mm, safe

        gs_specs = self._grid_specs()
        surf_specs = _lat_spec(surf_example, axis, cfg.il)
        window = jax.shard_map(
            window_body, mesh=self.mesh,
            in_specs=(gs_specs, surf_specs, P()),
            out_specs=(gs_specs, P(axis, None), P()), check_vma=False)

        rep = NamedSharding(self.mesh, P())

        def step(params, stz, idx, tidx, x, atmo, logp, precip_t, sst,
                 tisr, surf, forcing):
            # pin the full-grid tensors REPLICATED: their two consumers want
            # different shardings (the shard_map window lat-shards them — a
            # local slice from replicated; the pack_global flatten feeds the
            # replicated supervector). Leaving them unannotated lets GSPMD
            # back-propagate the window's lat sharding onto the parameter
            # while the flatten derives a contiguous (4,2)-split, and the
            # partitioner bridges the two with an "involuntary full
            # rematerialization" (replicate-then-repartition) round trip.
            wsc = jax.lax.with_sharding_constraint
            atmo = wsc(atmo, rep)
            logp = wsc(logp, rep)
            ss = jnp.maximum(jnp.asarray(sst, jnp.float32), SST_MIN)
            ti = jnp.maximum(jnp.asarray(tisr, jnp.float32), 0.0)
            gv = wsc(pack_global(L, atmo, logp, precip_t, ss, ti), rep)

            gs = GridState(t=atmo[0], u=atmo[1], v=atmo[2],
                           q=jnp.maximum(atmo[3], 0.0), logp=logp)
            fgs, fpr, safe = window(gs, surf, forcing)
            f_atmo = wsc(jnp.stack([fgs.t, fgs.u, fgs.v,
                                    jnp.maximum(fgs.q, QMIN)]), rep)
            f_pr = jnp.log1p(jnp.maximum(fpr, 0.0) / eps)
            # one explicit all-gather point: the 0.65 MB supervector goes
            # replicated before the region-sharded input gather (the halo
            # "exchange" of the reference becomes this single collective)
            model_gv = jax.lax.with_sharding_constraint(
                pack_global(L, f_atmo, fgs.logp, f_pr, ss, ti), rep)

            u = standardize_in(stz, gv[idx])
            mv = standardize_out(stz, model_gv[tidx])
            x, out_std = predict_step(params, x, u, mv)
            out = unstandardize_out(stz, out_std)
            atmo2, logp2, pr2 = scatter_outputs(L, out)
            atmo2 = atmo2.at[3].set(jnp.maximum(atmo2[3], QMIN))
            if pr2 is not None:
                from ..hybrid.experiment import clamp_precip_t
                pr2 = clamp_precip_t(
                    pr2, eps, getattr(hm.rcfg, "precip_cap_mm", 40.0))
            return x, atmo2, logp2, pr2, safe

        return jax.jit(step)

    # ------------------------------------------------------------------
    def place(self):
        """device_put the trained parameters/state maps with region-sharded
        layouts over the mesh axis; returns (params, stz, idx, tidx)."""
        hm = self.hm
        ns = lambda *spec: NamedSharding(self.mesh, P(*spec))
        a = self.axis
        p = hm.params
        params = p._replace(
            a_idx=jax.device_put(p.a_idx, ns(a)),
            a_val=jax.device_put(p.a_val, ns(a)),
            win=jax.device_put(p.win, ns(a)),
            wout=jax.device_put(p.wout, ns(a)),
            node_map=jax.device_put(p.node_map, ns()),
            a_shift=(None if p.a_shift is None
                     else jax.device_put(p.a_shift, ns())))
        stz = jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), ns(a)),
                           hm.stz)
        idx = jax.device_put(jnp.asarray(hm.layout.input_index), ns(a))
        tidx = jax.device_put(jnp.asarray(hm.layout.target_index), ns(a))
        return params, stz, idx, tidx

    def shard_surface(self, tree):
        specs = _lat_spec(tree, self.axis, self.speedy.config.il)
        return jax.tree.map(
            lambda x, s: jax.device_put(jnp.asarray(x),
                                        NamedSharding(self.mesh, s)),
            tree, specs)

    def step(self, x, atmo, logp, precip_t, sst, tisr, surf, forcing):
        """One composed hybrid step. surf should be lat-sharded
        (shard_surface); the rest may be host arrays (replicated on entry).
        Returns (x', atmo', logp', precip_t', safe)."""
        if self._fn is None:
            self._fn = self._build(surf)
            self._placed = self.place()
        params, stz, idx, tidx = self._placed
        return self._fn(params, stz, idx, tidx, x,
                        jnp.asarray(atmo, jnp.float32),
                        jnp.asarray(logp, jnp.float32),
                        jnp.asarray(precip_t, jnp.float32),
                        sst, tisr, surf, forcing)
