"""Grid-state injection/extraction for the hybrid coupler.

Equivalent of the reference's file/COMMON-block state plumbing
(ppo_iogrid.f90:497-577 mode 30 = inject, 579-602 mode 31 = extract): here
the "internal state vector" is just a pytree of grid arrays and
inject/extract are pure jittable functions, so the hybrid exchange never
leaves the device.

Conventions (matching the reference's internal_state_vector):
  * 3-D variables ordered (T, u, v, q) with q in g/kg
    (speedy_res_interface.f90:760-774, ppo_iogrid.f90:500-507).
  * logp = ln(p_s / p0) on the grid.
  * Injection clamps q >= 0 (ppo_iogrid.f90:513-515), transforms grid ->
    spectral (vdspec for winds, spec for scalars) with triangular truncation
    (ppo_iogrid.f90:525-539), sets BOTH leapfrog time levels, and evaluates
    the physical-bounds safety gate on the truncation round-trip
    (ppo_iogrid.f90:563-577).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..dynamics.state import SpectralState


class GridState(NamedTuple):
    """Grid-space prognostic state (the internal_state_vector analog)."""

    t: jax.Array      # (kx, il, ix) absolute temperature [K]
    u: jax.Array      # (kx, il, ix) zonal wind [m/s]
    v: jax.Array      # (kx, il, ix) meridional wind [m/s]
    q: jax.Array      # (kx, il, ix) specific humidity [g/kg]
    logp: jax.Array   # (il, ix)     ln(p_s / p0)


# physical-bounds safety gate (ppo_iogrid.f90:563-577)
SAFE_BOUNDS = dict(u=(-150.0, 150.0), v=(-120.0, 120.0),
                   t=(160.0, 330.0), q=(-6.0, 30.0))


def safety_check(gs: GridState) -> jax.Array:
    """is_safe_to_run_speedy: True iff all fields are within physical bounds.

    Evaluated on (possibly truncation-rung-tripped) grid fields, matching the
    reference's check after the spectral round-trip (ppo_iogrid.f90:540-577).
    """
    ok = jnp.asarray(True)
    for name in ("u", "v", "t", "q"):
        lo, hi = SAFE_BOUNDS[name]
        f = getattr(gs, name)
        ok = ok & (jnp.min(f) >= lo) & (jnp.max(f) <= hi)
    return ok


def inject(dy, gs: GridState):
    """Grid state -> spectral SpectralState + safety flag (iogrid mode 30).

    Returns (state, safe): state has both leapfrog levels set to the injected
    fields; safe is a traced boolean from the post-truncation bounds check.
    """
    T = dy.T
    dtype = dy.dtype
    q = jnp.maximum(jnp.asarray(gs.q, dtype), 0.0)
    u = jnp.asarray(gs.u, dtype)
    v = jnp.asarray(gs.v, dtype)
    tg = jnp.asarray(gs.t, dtype)
    lp = jnp.asarray(gs.logp, dtype)

    vor, div = T.vdspec(u, v, kcos=2)
    vor = T.trunct(vor)
    div = T.trunct(div)
    t_sp = T.trunct(T.grid_to_spec(tg))
    q_sp = T.trunct(T.grid_to_spec(q))
    ps_sp = T.trunct(T.grid_to_spec(lp))

    two = lambda x: jnp.stack([x, x], axis=0)
    state = SpectralState(vor=two(vor), div=two(div), t=two(t_sp),
                          ps=two(ps_sp), tr=two(q_sp[None]))

    # safety gate on the truncated round-trip (the reference re-grids the
    # spectral fields before checking, ppo_iogrid.f90:540-560)
    safe = safety_check(extract(dy, state, level=0))
    return state, safe


def extract(dy, state: SpectralState, level: int = 0) -> GridState:
    """Spectral state -> grid state (iogrid mode 31; the reference reads
    Fortran time index 1 = our level 0)."""
    f = state.at_level(level)
    T = dy.T
    ug, vg = T.uv_grid(f.vor, f.div)
    return GridState(
        t=T.spec_to_grid(f.t),
        u=ug, v=vg,
        q=T.spec_to_grid(f.tr[0]),
        logp=T.spec_to_grid(f.ps),
    )
