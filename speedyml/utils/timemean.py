"""Time-mean / variance diagnostics with GrADS output.

Equivalent of the reference's post-processing accumulators
(src/mod_tmean.f90, src/ppo_tminc.f90, src/ppo_tmout.f90): grid-space means
of the prognostic fields, second moments (variances + covariances), 2-D
surface diagnostics (including the lapse-rate mean-sea-level pressure
reduction, ppo_tminc.f90:47-66) and every-step flux means, all held as one
jitted-updatable pytree instead of mutable module arrays. `tmout`'s
normalize-write-reset cycle becomes `finalize` + `write_grads`.

Diabatic-heating means (the reference's ns3d3 block, ppo_tminc.f90:264-268)
are not accumulated: the physics driver fuses the per-scheme heating terms
inside one XLA program and only the summed tendency leaves it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..dynamics.tendencies import to_grid
from ..physics.humidity import rel_hum

#: order of the 3-D mean fields (reference save3d(:,:,1:9) less psi/chi/omega,
#: which tmout derives from the saved winds at output time)
MEAN3D_NAMES = ("u", "v", "t", "q", "phi", "rh")
#: second moments (reference ns3d2 block, ppo_tminc.f90:241-255)
VAR3D_NAMES = ("u2", "v2", "t2", "q2", "uv", "vt")
#: 2-D fields saved at post-processing steps (subset of save2d_1)
MEAN2D_NAMES = ("ps", "mslp", "u0", "v0", "t0", "rh0")
#: 2-D flux fields saved every step (subset of save2d_2, StepFluxes units)
FLUX2D_NAMES = ("precnv", "precls", "evap_s", "ustr_s", "vstr_s",
                "olr", "tsr", "ssr")


class TimeMeanState(NamedTuple):
    """Accumulated sums; divide by the counters to get means."""

    mean3d: jnp.ndarray   # (6, kx, il, ix)
    var3d: jnp.ndarray    # (6, kx, il, ix)
    mean2d: jnp.ndarray   # (6, il, ix)
    flux2d: jnp.ndarray   # (8, il, ix)
    rnsave: jnp.ndarray   # () post-proc sample counter (mod_tmean rnsave)
    nstep: jnp.ndarray    # () every-step flux counter


def init_timemean(kx: int, il: int, ix: int, dtype=jnp.float32) -> TimeMeanState:
    """tmout(imode=0) equivalent (ppo_tmout.f90:700 block)."""
    z = lambda *s: jnp.zeros(s, dtype=dtype)
    return TimeMeanState(mean3d=z(len(MEAN3D_NAMES), kx, il, ix),
                         var3d=z(len(VAR3D_NAMES), kx, il, ix),
                         mean2d=z(len(MEAN2D_NAMES), il, ix),
                         flux2d=z(len(FLUX2D_NAMES), il, ix),
                         rnsave=jnp.zeros((), dtype),
                         nstep=jnp.zeros((), dtype))


def tm_update(dy, st, f, tm: TimeMeanState) -> TimeMeanState:
    """Accumulate one post-processing sample from prognostic fields `f`
    (one leapfrog time level). Pure function; jit/scan-safe.

    Mirrors ppo_tminc.f90:47-100 (2-D) and 180-255 (3-D means + second
    moments) on sigma surfaces (the reference interpolates to pressure
    surfaces at accumulation time; here raw sigma-level fields are
    accumulated and any regridding is left to post-processing).
    """
    g = to_grid(dy, f, with_phi=True)
    qg = g.trg[0]
    # relative humidity at full levels: pressure p/p0 = exp(psg) * sigma
    psn = jnp.exp(g.psg)                                 # p_s / p0
    pres = psn[None] * jnp.asarray(st.sig, g.tg.dtype)[:, None, None]
    rh, _ = rel_hum(qg, g.tg, pres)

    from ..physics.constants import PP
    kxm = g.tg.shape[0] - 1
    rd, gg = PP.rd, PP.gg
    gam0 = 0.006 / gg
    rgam = rd * gam0
    # surface air temperature: lapse extrapolation from the lowest full
    # level (suflux-style), then the tminc MSL reduction with clipped tsg
    t0 = g.tg[kxm] * (1.0 / jnp.asarray(st.sig[kxm], g.tg.dtype)) ** rgam
    tsg = 0.5 * (t0 + jnp.clip(t0, 255.0, 295.0))
    phis = dy.phis0_grid.astype(g.tg.dtype)
    mslp = psn * (1.0 + gam0 * phis / tsg) ** (1.0 / rgam)  # p_msl / p0
    rh0 = rh[kxm]

    m3 = jnp.stack([g.ug, g.vg, g.tg, qg, g.phig, rh])
    v3 = jnp.stack([g.ug * g.ug, g.vg * g.vg, g.tg * g.tg, qg * qg,
                    g.ug * g.vg, g.vg * g.tg])
    m2 = jnp.stack([psn, mslp, g.ug[kxm], g.vg[kxm], t0, rh0])
    return tm._replace(mean3d=tm.mean3d + m3, var3d=tm.var3d + v3,
                       mean2d=tm.mean2d + m2, rnsave=tm.rnsave + 1.0)


def tm_update_fluxes(fx, tm: TimeMeanState) -> TimeMeanState:
    """Accumulate the every-step flux block (ppo_tminc save2d_2 analog)."""
    f2 = jnp.stack([fx.precnv, fx.precls, fx.evap_s, fx.ustr_s, fx.vstr_s,
                    fx.olr, fx.tsr, fx.ssr])
    return tm._replace(flux2d=tm.flux2d + f2, nstep=tm.nstep + 1.0)


def finalize(tm: TimeMeanState) -> dict:
    """tmout(imode>0) normalization (ppo_tmout.f90:34-42): divide sums by
    the counters; variances become central moments. Returns numpy arrays."""
    n = float(np.asarray(tm.rnsave))
    out = {}
    if n > 0:
        m3 = np.asarray(tm.mean3d, np.float64) / n
        v3 = np.asarray(tm.var3d, np.float64) / n
        for i, name in enumerate(MEAN3D_NAMES):
            out[name] = m3[i]
        # central moments: var(x) = E[x^2]-E[x]^2, cov similarly
        mu = dict(zip(MEAN3D_NAMES, m3))
        out["u2"] = v3[0] - mu["u"] ** 2
        out["v2"] = v3[1] - mu["v"] ** 2
        out["t2"] = v3[2] - mu["t"] ** 2
        out["q2"] = v3[3] - mu["q"] ** 2
        out["uv"] = v3[4] - mu["u"] * mu["v"]
        out["vt"] = v3[5] - mu["v"] * mu["t"]
        m2 = np.asarray(tm.mean2d, np.float64) / n
        for i, name in enumerate(MEAN2D_NAMES):
            out[name] = m2[i]
    ns = float(np.asarray(tm.nstep))
    if ns > 0:
        f2 = np.asarray(tm.flux2d, np.float64) / ns
        for i, name in enumerate(FLUX2D_NAMES):
            out[name] = f2[i]
    return out


def write_grads(tm: TimeMeanState, basepath: str, lat: np.ndarray,
                sigma: np.ndarray, year: int = 1981, month: int = 1,
                dt_hours: int = 24) -> dict:
    """Write the normalized means as one GrADS time record (.grd + .ctl),
    the reference's output format for tmout (ppo_setctl.f90). Returns the
    finalized field dict."""
    from ..io.grads import GradsWriter

    fields = finalize(tm)
    f3d = [(name, fields[name]) for name in MEAN3D_NAMES + VAR3D_NAMES
           if name in fields]
    f2d = [(name, fields[name]) for name in MEAN2D_NAMES + FLUX2D_NAMES
           if name in fields]
    ix = f2d[0][1].shape[-1] if f2d else f3d[0][1].shape[-1]
    with GradsWriter(basepath, lat, sigma, ix,
                     var3d=[n for n, _ in f3d], var2d=[n for n, _ in f2d],
                     year0=year, month0=month, dt_hours=dt_hours) as w:
        w.append([a for _, a in f3d], [a for _, a in f2d])
    return fields
