"""Grid-space nonlinear dynamics tendencies and spectral linear tendencies.

Re-design of the reference's `grtend` (src/dyn_grtend.f90) and `sptend`
(src/dyn_sptend.f90) as pure, fully-batched functions: all per-level loops
become leading-axis batches over kx so every transform runs as one fused
einsum/FFT, and all vertical loops become cumulative sums / stacked slices.

Grid arrays are (kx, il, ix); spectral arrays (kx, mx, nx) complex.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax.numpy as jnp

from .state import PrognosticFields, Tendencies
from .implicit import ImplicitCoefs, geopotential, implicit_correction


class GridFields(NamedTuple):
    """Grid-point view of one time level (inputs to physics)."""

    ug: jnp.ndarray     # (kx, il, ix) zonal wind
    vg: jnp.ndarray     # meridional wind
    tg: jnp.ndarray     # temperature
    trg: jnp.ndarray    # (ntr, kx, il, ix) tracers
    vorg: jnp.ndarray   # relative vorticity
    divg: jnp.ndarray   # divergence
    psg: jnp.ndarray    # (il, ix) log surface pressure
    phig: jnp.ndarray   # (kx, il, ix) geopotential


def to_grid(dy, f: PrognosticFields, with_phi: bool = True) -> GridFields:
    """Transform one time level to grid space (as dyn_grtend.f90:61-79 and
    phy_phypar's own converts)."""
    T = dy.T
    vorg = T.spec_to_grid(f.vor)
    divg = T.spec_to_grid(f.div)
    tg = T.spec_to_grid(f.t)
    trg = T.spec_to_grid(f.tr)
    ucosm, vcosm = T.uvspec(f.vor, f.div)
    ug = T.spec_to_grid(ucosm, kcos=2)
    vg = T.spec_to_grid(vcosm, kcos=2)
    psg = T.spec_to_grid(f.ps)
    if with_phi:
        phi = geopotential(f.t, dy.phis, dy.vg_jnp)
        phig = T.spec_to_grid(phi)
    else:
        phig = jnp.zeros_like(tg)
    return GridFields(ug=ug, vg=vg, tg=tg, trg=trg, vorg=vorg, divg=divg,
                      psg=psg, phig=phig)


def grtend(dy, fdyn: PrognosticFields, fphy: PrognosticFields,
           phys_fn: Optional[Callable] = None) -> Tendencies:
    """Nonlinear grid-space tendencies -> spectral (dyn_grtend.f90:1-279).

    fdyn: fields at the dynamics time level (j2); fphy: at the physics time
    level (j1). phys_fn(dy, fphy) must return ((utend, vtend, ttend, trtend),
    extras): grid-space tendency increments added before the spectral
    conversion (phy_phypar.f90 contract) plus an arbitrary extras pytree
    (radiation carry, fluxes) threaded back to the caller.

    Returns (Tendencies, extras).
    """
    T = dy.T
    dhs = dy.vg_jnp["dhs"]          # (kx,)
    dhsr = dy.vg_jnp["dhsr"]
    fsgr = dy.vg_jnp["fsgr"]
    tref = dy.imp_main.tref          # (kx,) reference temperature (impint)
    tref3 = dy.imp_main.tref3
    akap = dy.akap
    rgas = dy.rgas
    coriol = dy.coriol

    # opt-in bf16 grid-space compute: the elementwise tendency work below is
    # memory-bandwidth-bound; casting the grid fields + vertical constants
    # halves that traffic. Spectral state
    # and the transforms stay full precision (tables are f32, so the forward
    # einsums below promote the results back).
    gd = getattr(dy, "grid_dtype", None)
    tref_full = tref
    if gd is not None:
        cast = lambda x: jnp.asarray(x, gd)
        dhs, dhsr, fsgr, tref3, coriol = map(
            cast, (dhs, dhsr, fsgr, tref3, coriol))

    # --- grid converts: ONE batched transform per cos-scaling group
    # (stacking all fields makes one large matmul batch) ---
    kx = fdyn.vor.shape[0]
    ntr = fdyn.tr.shape[0]
    trf = fdyn.tr.reshape(ntr * kx, *fdyn.tr.shape[2:])
    g1 = T.spec_to_grid(jnp.concatenate([fdyn.vor, fdyn.div, fdyn.t, trf]))
    tg_full = g1[2 * kx:3 * kx]
    if gd is not None:
        g1 = g1.astype(gd)
    vorg, divg, tg = g1[:kx], g1[kx:2 * kx], g1[2 * kx:3 * kx]
    trg = g1[3 * kx:].reshape(ntr, kx, *g1.shape[1:])

    ucosm, vcosm = T.uvspec(fdyn.vor, fdyn.div)
    pdx_s, pdy_s = T.grad(fdyn.ps)
    g2 = T.spec_to_grid(jnp.concatenate(
        [ucosm, vcosm, pdx_s[None], pdy_s[None]]), kcos=2)
    if gd is not None:
        g2 = g2.astype(gd)
    ug, vg, px, py = g2[:kx], g2[kx:2 * kx], g2[2 * kx], g2[2 * kx + 1]

    vorg_abs = vorg + coriol[:, None]                  # add planetary vorticity

    w = dhs[:, None, None]
    umean = jnp.sum(ug * w, axis=0)                    # (il, ix)
    vmean = jnp.sum(vg * w, axis=0)
    dmean = jnp.sum(divg * w, axis=0)

    # --- log-ps tendency (dyn_grtend.f90:94-103) ---
    psdt = T.grid_to_spec(-umean * px - vmean * py)
    psdt = psdt.at[0, :, 0].set(0.0)

    # --- vertical sigma velocity (dyn_grtend.f90:105-123) ---
    puv = (ug - umean[None]) * px[None] + (vg - vmean[None]) * py[None]
    # sigdt/sigm at interfaces: (kx+1, il, ix), index 0 = top
    zero_iface = jnp.zeros_like(umean)[None]
    sigdt = jnp.concatenate(
        [zero_iface,
         -jnp.cumsum(w * (puv + divg - dmean[None]), axis=0)], axis=0)
    sigm = jnp.concatenate([zero_iface, -jnp.cumsum(w * puv, axis=0)], axis=0)

    # temperature anomaly: subtract BEFORE any downcast — T and tref are
    # ~270 K, so rounding first would wipe out the anomaly's low bits
    tgg = tg_full - tref_full[:, None, None]
    if gd is not None:
        tgg = tgg.astype(gd)
    rpx = rgas * px
    rpy = rgas * py

    def vadv(field):
        """Interface vertical-advection terms -> per-level contribution
        (temp(k)+temp(k+1))*dhsr(k) with temp(iface) = sigdt*(df across iface)."""
        df = field[1:] - field[:-1]                            # (kx-1, il, ix)
        iface = sigdt[1:-1] * df                               # interior ifaces
        iface_full = jnp.concatenate([zero_iface, iface, zero_iface], axis=0)
        return (iface_full[1:] + iface_full[:-1]) * dhsr[:, None, None]

    # --- wind tendencies (dyn_grtend.f90:140-162) ---
    utend = vg * vorg_abs - tgg * rpx - vadv(ug)
    vtend = -ug * vorg_abs - tgg * rpy - vadv(vg)

    # --- temperature tendency (dyn_grtend.f90:165-182) ---
    dtgg = tgg[1:] - tgg[:-1]
    dtref = tref_full[1:] - tref_full[:-1]
    if gd is not None:
        dtref = dtref.astype(gd)
    iface_t = sigdt[1:-1] * dtgg + sigm[1:-1] * dtref[:, None, None]
    iface_t = jnp.concatenate([zero_iface, iface_t, zero_iface], axis=0)
    ttend = (tgg * divg
             - (iface_t[1:] + iface_t[:-1]) * dhsr[:, None, None]
             + fsgr[:, None, None] * tgg * (sigdt[1:] + sigdt[:-1])
             + tref3[:, None, None] * (sigm[1:] + sigm[:-1])
             + akap * (tg * puv - tgg * dmean[None]))

    # --- tracer tendencies (dyn_grtend.f90:187-217) ---
    dtr = trg[:, 1:] - trg[:, :-1]                     # (ntr, kx-1, il, ix)
    iface_tr = sigdt[None, 1:-1] * dtr
    # no vertical advection between the top three layers (moisture; the
    # reference zeroes interfaces k=2,3 i.e. interior ifaces 0,1 here)
    iface_tr = iface_tr.at[:, 0:2].set(0.0)
    zi = jnp.zeros_like(iface_tr[:, :1])
    iface_tr = jnp.concatenate([zi, iface_tr, zi], axis=1)
    trtend = (trg * divg[None]
              - (iface_tr[:, 1:] + iface_tr[:, :-1]) * dhsr[None, :, None, None])

    # --- physics (phy_phypar contract: adds to grid tendencies) ---
    extras = None
    if phys_fn is not None:
        (du, dv, dtt, dtrt), extras = phys_fn(dy, fphy)
        utend = utend + du                 # promotes back to full precision
        vtend = vtend + dv
        ttend = ttend + dtt
        trtend = trtend + dtrt

    # --- back to spectral (dyn_grtend.f90:233-277): again one batched
    # vdspec over [wind | T-flux | tracer-flux] and one grid_to_spec over
    # [ke | ttend | trtend] ---
    u_side = jnp.concatenate([utend, -ug * tgg,
                              (-ug[None] * trg).reshape(ntr * kx,
                                                        *ug.shape[1:])])
    v_side = jnp.concatenate([vtend, -vg * tgg,
                              (-vg[None] * trg).reshape(ntr * kx,
                                                        *vg.shape[1:])])
    vors, divs = T.vdspec(u_side, v_side, kcos=2)
    vordt = vors[:kx]
    divdt = divs[:kx]
    tdt_flux = divs[kx:2 * kx]
    trdt_flux = divs[2 * kx:].reshape(ntr, kx, *divs.shape[1:])

    ke = 0.5 * (ug * ug + vg * vg)
    s1 = T.grid_to_spec(jnp.concatenate(
        [ke, ttend, trtend.reshape(ntr * kx, *ttend.shape[1:])]))
    divdt = divdt - T.lap(s1[:kx])
    tdt = tdt_flux + s1[kx:2 * kx]
    trdt = trdt_flux + s1[2 * kx:].reshape(ntr, kx, *s1.shape[1:])

    return Tendencies(vordt=vordt, divdt=divdt, tdt=tdt, psdt=psdt,
                      trdt=trdt), extras


def sptend(dy, f: PrognosticFields, tend: Tendencies,
           imp: ImplicitCoefs) -> Tendencies:
    """Spectral linear tendencies (dyn_sptend.f90:27-66)."""
    T = dy.T
    dhs = dy.vg_jnp["dhs"]
    dhsr = dy.vg_jnp["dhsr"]
    kx = f.vor.shape[0]

    dmeanc = jnp.sum(f.div * dhs[:, None, None, None], axis=0)  # (mx, 2, nx)
    psdt = tend.psdt - dmeanc
    psdt = psdt.at[0, :, 0].set(0.0)

    # sigma-dot at interfaces (only interior kx-1 accumulate; last stays 0)
    incr = -(dhs[: kx - 1, None, None, None]
             * (f.div[: kx - 1] - dmeanc[None]))
    zero_iface = jnp.zeros_like(dmeanc)[None]
    sigdtc = jnp.concatenate(
        [zero_iface, jnp.cumsum(incr, axis=0), zero_iface], axis=0)

    tref = imp.tref
    dtref = tref[1:] - tref[:-1]
    dumk = sigdtc[1:-1] * dtref[:, None, None, None]
    dumk = jnp.concatenate([zero_iface, dumk, zero_iface], axis=0)

    tdt = (tend.tdt
           - (dumk[1:] + dumk[:-1]) * dhsr[:, None, None, None]
           + imp.tref3[:, None, None, None] * (sigdtc[1:] + sigdtc[:-1])
           - imp.tref2[:, None, None, None] * dmeanc[None])

    # geopotential + RT*lap(ps) into divergence tendency
    phi = geopotential(f.t, dy.phis, dy.vg_jnp)
    dump = phi + dy.rgas * imp.tref[:, None, None, None] * f.ps[None]
    divdt = tend.divdt - T.lap(dump)

    return Tendencies(vordt=tend.vordt, divdt=divdt, tdt=tdt, psdt=psdt,
                      trdt=tend.trdt)
