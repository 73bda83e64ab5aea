"""Climatological boundary-condition preprocessing and coupler constants.

Re-implements the load-time processing of the reference's inbcon
(src/ini_inbcon.f90): mask definitions, land-temperature fill, soil-water
availability, field checks — plus the land/sea slab-model constants
(src/mod_cpl_land_model.f90:land_model_init, src/cpl_sea_model.f90:
sea_model_init). All host-side numpy, computed once.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..io.boundary import BoundaryData
from ..physics.constants import PP


def forchk(mask: np.ndarray, field: np.ndarray, fmin: float, fmax: float,
           fset: float) -> np.ndarray:
    """Set field to fset where mask == 0 (ini_inbcon.f90:284-313)."""
    out = field.copy()
    out[..., mask <= 0.0] = fset
    return out


def fillsf(sf: np.ndarray, fmis: float = 0.0) -> np.ndarray:
    """Replace values < fmis by zonal means (ini_inbcon.f90:fillsf)."""
    out = sf.copy()
    bad = out < fmis
    if not bad.any():
        return out
    for j in range(out.shape[0]):
        row = out[j]
        miss = bad[j]
        if miss.all():
            continue
        fmean = row[~miss].mean()
        row2 = np.where(miss, fmean, row)
        out[j] = np.where(miss, 0.5 * (np.roll(row2, 1) + np.roll(row2, -1)),
                          row)
    return out


@dataclasses.dataclass
class Climatology:
    """Processed boundary conditions + slab-model constants."""

    # masks
    fmask: np.ndarray     # fractional land mask (original)
    fmask_l: np.ndarray   # model land fraction (thresholded)
    bmask_l: np.ndarray   # binary land mask
    fmask_s: np.ndarray   # sea fraction
    bmask_s: np.ndarray
    fmask1: np.ndarray    # = fmask_l (model land fraction used by physics)

    # static fields
    orog: np.ndarray
    alb0: np.ndarray
    forog: np.ndarray     # orographic drag factor (sflset)

    # monthly climatologies (12, il, ix)
    stl12: np.ndarray
    snowd12: np.ndarray
    soilw12: np.ndarray
    sst12: np.ndarray
    sice12: np.ndarray

    # land slab-model constants
    rhcapl: np.ndarray
    cdland: np.ndarray

    # sea slab-model constants
    rhcaps: np.ndarray
    rhcapi: np.ndarray
    cdsea: np.ndarray
    cdice: np.ndarray
    beta: float
    hfseacl: np.ndarray   # annual-mean sea heat flux climatology (0 here)


def build_climatology(bd: BoundaryData, gcos: np.ndarray,
                      radang: np.ndarray) -> Climatology:
    il, ix = bd.orog.shape
    thrsh = 0.1

    fmask = bd.fmask
    fmask_l = fmask.copy()
    bmask_l = np.where(fmask_l >= thrsh, 1.0, 0.0)
    fmask_l = np.where(fmask_l >= thrsh,
                       np.where(fmask > 1.0 - thrsh, 1.0, fmask_l), 0.0)

    fmask_s = 1.0 - fmask
    bmask_s = np.where(fmask_s >= thrsh, 1.0, 0.0)
    fmask_s = np.where(fmask_s >= thrsh,
                       np.where(fmask_s > 1.0 - thrsh, 1.0, fmask_s), 0.0)

    # land surface temperature: fill + check (ini_inbcon.f90:77-89)
    stl12 = np.stack([fillsf(m) for m in bd.stl12])
    stl12 = forchk(bmask_l, stl12, 0.0, 400.0, 273.0)

    snowd12 = forchk(bmask_l, bd.snowd12, 0.0, 20000.0, 0.0)

    # soil water availability (ini_inbcon.f90:104-141)
    veg = np.maximum(0.0, bd.veg_low + 0.8 * bd.veg_high)
    idep2 = 3
    swwil2 = idep2 * PP.swwil
    rsw = 1.0 / (PP.swcap + idep2 * (PP.swcap - PP.swwil))
    soilw12 = np.empty_like(bd.swl1_12)
    for it in range(12):
        swroot = idep2 * bd.swl2_12[it]
        soilw12[it] = np.minimum(
            1.0, rsw * (bd.swl1_12[it]
                        + veg * np.maximum(0.0, swroot - swwil2)))
    soilw12 = forchk(bmask_l, soilw12, 0.0, 10.0, 0.0)

    sst12 = np.stack([fillsf(m) for m in bd.sst12])
    sst12 = forchk(bmask_s, sst12, 100.0, 400.0, 273.0)
    sice12 = forchk(bmask_s, np.maximum(bd.sice12, 0.0), 0.0, 1.0, 0.0)

    # --- land slab model constants (mod_cpl_land_model.f90:23-100) ---
    flandmin = 1.0 / 3.0
    tdland = 40.0
    hcapl = 1.0 * 2.50e6
    hcapli = 5.0 * 1.93e6
    dmask_l = np.where(fmask_l < flandmin, 0.0, 1.0)
    rhcapl = np.where(bd.alb0 < 0.4, 86400.0 / hcapl, 86400.0 / hcapli)
    cdland = dmask_l * tdland / (1.0 + dmask_l * tdland)

    # --- sea slab model constants (cpl_sea_model.f90:1-115) ---
    depth_ml, dept0_ml = 60.0, 40.0
    depth_ice, dept0_ice = 2.5, 1.5
    tdsst, tdice = 90.0, 30.0
    fseamin = 1.0 / 3.0
    beta = 1.0

    coslat = np.cos(radang)
    hcaps = 4.18e6 * (depth_ml + (dept0_ml - depth_ml) * coslat**3)
    hcapi = 1.93e6 * (depth_ice + (dept0_ice - depth_ice) * coslat**2)

    dmask = np.ones((il, ix))
    sm = dmask.copy()
    sm[1:-1] = 0.25 * (dmask[:-2] + 2 * dmask[1:-1] + dmask[2:])
    dmask = sm
    dmask[fmask_s < fseamin] = 0.0

    rhcaps = np.broadcast_to((86400.0 / hcaps)[:, None], (il, ix)).copy()
    rhcapi = np.broadcast_to((86400.0 / hcapi)[:, None], (il, ix)).copy()
    cdsea = dmask * tdsst / (1.0 + dmask * tdsst)
    cdice = dmask * tdice / (1.0 + dmask * tdice)

    # orographic drag factor (phy_suflux.f90:358-382)
    from ..physics.surface import sflset
    forog = sflset(9.81 * bd.orog)

    return Climatology(
        fmask=fmask, fmask_l=fmask_l, bmask_l=bmask_l, fmask_s=fmask_s,
        bmask_s=bmask_s, fmask1=fmask_l, orog=bd.orog, alb0=bd.alb0,
        forog=forog, stl12=stl12, snowd12=snowd12, soilw12=soilw12,
        sst12=sst12, sice12=sice12, rhcapl=rhcapl, cdland=cdland,
        rhcaps=rhcaps, rhcapi=rhcapi, cdsea=cdsea, cdice=cdice, beta=beta,
        hfseacl=np.zeros((il, ix)))
