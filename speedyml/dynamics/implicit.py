"""Semi-implicit gravity-wave scheme tables and correction step.

Re-design of the reference's `impint` (src/ini_impint.f90) and `implic`
(src/dyn_implic.f90). The per-total-wavenumber inverse matrices xj are
precomputed in numpy float64 at setup (once per dt value — three values are
needed for the stepone bootstrap) and applied on device as one batched einsum
instead of the reference's per-(m,n) scalar loops.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from ..core.constants import PHYS, DYN
from ..core.vertical import VerticalGrid
from ..transforms.spectral import HIGHEST


@dataclasses.dataclass(frozen=True)
class ImplicitTables:
    """Numpy float64 tables from impint for a given (dt, alph)."""

    dt: float
    tref: np.ndarray    # (kx,) reference temperature profile
    tref1: np.ndarray   # rgas * tref
    tref2: np.ndarray   # akap * tref
    tref3: np.ndarray   # fsgr * tref
    xc: np.ndarray      # (kx, kx)  (already scaled by xi)
    xd: np.ndarray      # (kx, kx)
    dhsx: np.ndarray    # (kx,)
    elz: np.ndarray     # (mx, nx)
    xj_mn: np.ndarray   # (mx, nx, kx, kx) per-(m,n) inverse (0 where l == 0)


def build_implicit(vg: VerticalGrid, dt: float, alph: float,
                   mx: int, nx: int) -> ImplicitTables:
    """Replicates ini_impint.f90:43-152 in vectorized numpy."""
    kx = vg.kx
    rgas, akap, a = PHYS.rgas, PHYS.akap, PHYS.rearth
    hsg, dhs, fsg, fsgr = vg.hsg, vg.dhs, vg.fsg, vg.fsgr

    rgam = rgas * DYN.gamma / (1000.0 * PHYS.grav)
    tref = 288.0 * np.maximum(0.2, fsg) ** rgam
    tref1 = rgas * tref
    tref2 = akap * tref
    tref3 = fsgr * tref

    xi = dt * alph
    xxi = xi / (a * a)
    dhsx = xi * dhs

    m_idx = np.arange(mx)
    n_idx = np.arange(nx)
    ll = m_idx[:, None] + n_idx[None, :]
    elz = ll * (ll + 1.0) * xxi

    # T(K) = TEX + YA(K,K')*D(K') + XA(K,K')*SIG(K')
    ya = -akap * tref[:, None] * dhs[None, :]
    xa = np.zeros((kx, kx))
    for k in range(1, kx):
        xa[k, k - 1] = 0.5 * (akap * tref[k] / fsg[k]
                              - (tref[k] - tref[k - 1]) / dhs[k])
    for k in range(kx - 1):
        xa[k, k] = 0.5 * (akap * tref[k] / fsg[k]
                          - (tref[k + 1] - tref[k]) / dhs[k])

    # sig(k) = xb(k,k')*d(k')
    dsum = np.cumsum(dhs)
    xb = np.zeros((kx, kx))
    for k in range(kx - 1):
        for k1 in range(kx):
            xb[k, k1] = dhs[k1] * dsum[k]
            if k1 <= k:
                xb[k, k1] -= dhs[k1]

    # t(k) = tex + xc(k,k')*d(k')   (xa contributes only k2 < kx rows)
    xc = ya + xa[:, : kx - 1] @ xb[: kx - 1, :]

    # P(K) = XD(K,K')*T(K')
    xd = np.zeros((kx, kx))
    for k in range(kx):
        for k1 in range(k + 1, kx):
            xd[k, k1] = rgas * np.log(hsg[k1 + 1] / hsg[k1])
        xd[k, k] = rgas * np.log(hsg[k + 1] / fsg[k])

    xe = xd @ xc

    lmax = mx + nx - 2
    xj = np.zeros((lmax + 1, kx, kx))  # index by l, l=0 row left zero
    eye = np.eye(kx)
    for l in range(1, lmax + 1):
        xxx = l * (l + 1) / (a * a)
        xf = xi * xi * xxx * (rgas * np.outer(tref, dhs) - xe) + eye
        xj[l] = np.linalg.inv(xf)

    # gather xj per (m, n); l = m + n
    xj_mn = xj[np.minimum(ll, lmax)]
    xj_mn[ll == 0] = 0.0

    xc_scaled = xc * xi
    return ImplicitTables(dt=dt, tref=tref, tref1=tref1, tref2=tref2,
                          tref3=tref3, xc=xc_scaled, xd=xd, dhsx=dhsx,
                          elz=elz, xj_mn=xj_mn)


class ImplicitCoefs:
    """Implicit tables as host (numpy) constants (embedded at jit time)."""

    def __init__(self, tables: ImplicitTables, dtype=jnp.float32):
        self.dt = tables.dt
        np_dtype = np.float64 if dtype == jnp.float64 else np.float32
        as_r = lambda x: np.asarray(x, dtype=np_dtype)
        self.tref = as_r(tables.tref)
        self.tref1 = as_r(tables.tref1)
        self.tref2 = as_r(tables.tref2)
        self.tref3 = as_r(tables.tref3)
        self.xc = as_r(tables.xc)
        self.xd = as_r(tables.xd)
        self.dhsx = as_r(tables.dhsx)
        self.elz = as_r(tables.elz)
        self.xj_mn = as_r(tables.xj_mn)


def implicit_correction(imp: ImplicitCoefs, divdt, tdt, psdt):
    """Implicit gravity-wave correction (dyn_implic.f90:27-67).

    divdt, tdt: (kx, mx, 2, nx) real-pair spectral; psdt: (mx, 2, nx).
    """
    # ye(k) = sum_k1 xd(k,k1) tdt(k1) + tref1(k) * psdt
    ye = jnp.einsum("kl,lmcn->kmcn", imp.xd, tdt, precision=HIGHEST)
    ye = ye + imp.tref1[:, None, None, None] * psdt[None]
    yf = divdt + imp.elz[None, :, None, :] * ye
    # divdt(m,n,:) = xj(m,n) @ yf(m,n,:)
    new_divdt = jnp.einsum("mnkl,lmcn->kmcn", imp.xj_mn, yf,
                           precision=HIGHEST)
    new_psdt = psdt - jnp.einsum("kmcn,k->mcn", new_divdt, imp.dhsx,
                                 precision=HIGHEST)
    new_tdt = tdt + jnp.einsum("kl,lmcn->kmcn", imp.xc, new_divdt,
                               precision=HIGHEST)
    return new_divdt, new_tdt, new_psdt


def geopotential(t_spec, phis, vg_jnp):
    """Hydrostatic integration (dyn_geop.f90:19-32).

    t_spec: (kx, mx, 2, nx) real-pair temperature; phis: (mx, 2, nx) surface
    geopotential; vg_jnp: dict of numpy vertical arrays with keys
    xgeop1, xgeop2, hsg, fsg.
    Returns phi: (kx, mx, 2, nx).
    """
    kx = t_spec.shape[0]
    xg1 = vg_jnp["xgeop1"]
    xg2 = vg_jnp["xgeop2"]
    hsg = vg_jnp["hsg"]
    fsg = vg_jnp["fsg"]

    levels = [phis + xg1[kx - 1] * t_spec[kx - 1]]
    for k in range(kx - 2, -1, -1):
        levels.append(levels[-1] + xg2[k + 1] * t_spec[k + 1] + xg1[k] * t_spec[k])
    phi = jnp.stack(levels[::-1], axis=0)

    # lapse-rate correction in the free troposphere, zonal (m=0) part only
    corr_rows = []
    for k in range(1, kx - 1):
        corf = float(xg1[k] * 0.5 * np.log(hsg[k + 1] / fsg[k])
                     / np.log(fsg[k + 1] / fsg[k - 1]))
        corr_rows.append((k, corf * (t_spec[k + 1, 0, :] - t_spec[k - 1, 0, :])))
    for k, row in corr_rows:
        phi = phi.at[k, 0, :].add(row)
    return phi
