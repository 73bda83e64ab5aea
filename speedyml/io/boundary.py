"""SPEEDY climatological boundary conditions: the fort.2x reader and the
aquaplanet provider.

The reference reads its boundary files as direct-access little-endian real*4
records of one latitude row each, stored north->south and flipped to
south->north on read (reference: src/ini_inbcon.f90:463-495). Field/unit
assignments follow ini_inbcon.f90:38-201.

`BoundaryData.aquaplanet` builds the same fields from the grid alone, per the
Aqua-Planet Experiment "Control" protocol (Neale & Hoskins 2000), so the
model runs from the repository without the reference's data files.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


def read_boundary_records(path: str, ix: int = 96, il: int = 48) -> np.ndarray:
    """Read all (nfields, il, ix) records from a fort.2x file.

    Rows are flipped so row 0 = southernmost latitude (the model's internal
    convention), mirroring load_boundary_file's `inp(:,nlat+1-i)`.
    Values <= -999 (missing) are zeroed. Uses the native mmap decoder
    (native/speedy_io.cpp) when built, numpy otherwise.
    """
    from .native_loader import read_records_native
    try:
        native = read_records_native(path, ix, il)
    except Exception:
        native = None
    if native is not None:
        return native
    raw = np.fromfile(path, dtype="<f4")
    nrec = raw.size // (ix * il)
    assert nrec * ix * il == raw.size, f"file {path} not a whole number of fields"
    data = raw.reshape(nrec, il, ix)[:, ::-1, :].astype(np.float64)
    data[data <= -999] = 0.0
    return data


def gaussian_latitudes(il: int) -> np.ndarray:
    """(il,) Gaussian latitudes [rad], south -> north (the model's rows)."""
    from ..transforms.tables import gauss_legendre
    sia, _ = gauss_legendre(il // 2)
    half = np.arcsin(sia)                    # pole -> equator, positive
    return np.concatenate([-half, half[::-1]])


def ape_control_sst(lat: np.ndarray) -> np.ndarray:
    """APE "Control" SST [K] at latitudes `lat` [rad]:
    27 (1 - sin^2(3 phi / 2)) degC for |phi| < 60 deg, 0 degC poleward."""
    lat = np.asarray(lat, np.float64)
    sst_c = np.where(np.abs(lat) < np.pi / 3.0,
                     27.0 * (1.0 - np.sin(1.5 * lat) ** 2), 0.0)
    return sst_c + 273.15


# Annual-mean surface albedo of the aquaplanet: the open-sea value of the
# physics (PP.albsea). With land fraction 0 it enters no flux; it only sets
# the land heat-capacity branch of the coupler constants (alb0 < 0.4).
APE_ALB0 = 0.07


@dataclasses.dataclass
class BoundaryData:
    """Static + monthly-climatology boundary fields (ini_inbcon.f90).

    Unit map of the reference files (records within each file;
    ini_inbcon.f90:38-201):
      fort.20: [orography(m), land-sea mask, annual albedo, vegetation (low),
                vegetation (high)]
      fort.21: 12 monthly SST climatology
      fort.22: 12 monthly sea-ice concentration climatology
      fort.23: 12 monthly land-surface temperature climatology
      fort.24: 12 monthly snow depth climatology
      fort.26: 12 months x [soil wetness layer 1, layer 2 (root), layer 3]
    Static fields are (il, ix), monthly ones (12, il, ix); row 0 is the
    southernmost latitude.
    """

    orog: np.ndarray       # surface height [m]
    fmask: np.ndarray      # fractional land-sea mask
    alb0: np.ndarray       # annual-mean albedo
    veg_low: np.ndarray
    veg_high: np.ndarray
    sst12: np.ndarray      # sea surface temperature [K]
    sice12: np.ndarray     # sea-ice concentration [0..1]
    stl12: np.ndarray      # land surface temperature [K]
    snowd12: np.ndarray    # snow depth [mm w.e.]
    swl1_12: np.ndarray    # soil wetness, top layer
    swl2_12: np.ndarray    # soil wetness, root layer

    @classmethod
    def from_dir(cls, bindir: str, ix: int = 96, il: int = 48
                 ) -> "BoundaryData":
        """Read the reference's fort.20-26 files from `bindir`. A missing
        directory or file raises FileNotFoundError."""
        def path(unit):
            p = os.path.join(bindir, f"fort.{unit}")
            if not os.path.isfile(p):
                raise FileNotFoundError(f"boundary file {p} not found")
            return p

        f20 = read_boundary_records(path(20), ix, il)
        monthly = {u: read_boundary_records(path(u), ix, il)
                   for u in (21, 22, 23, 24)}
        f26 = read_boundary_records(path(26), ix, il).reshape(12, 3, il, ix)
        return cls(
            orog=f20[0], fmask=f20[1], alb0=f20[2], veg_low=f20[3],
            veg_high=f20[4] if f20.shape[0] > 4 else np.zeros_like(f20[0]),
            sst12=monthly[21], sice12=np.maximum(monthly[22], 0.0),
            stl12=monthly[23], snowd12=monthly[24],
            swl1_12=f26[:, 0], swl2_12=f26[:, 1])

    @classmethod
    def aquaplanet(cls, ix: int = 96, il: int = 48, **fields
                   ) -> "BoundaryData":
        """APE "Control" aquaplanet (Neale & Hoskins 2000): no orography,
        land fraction 0, no sea ice or snow, zero soil water and vegetation,
        albedo APE_ALB0, and the zonally symmetric ape_control_sst in all 12
        months (land temperature carries the same profile).

        `fields` replaces named fields with given arrays (for example an
        orography or a land mask for tests of those code paths)."""
        sst = np.broadcast_to(ape_control_sst(gaussian_latitudes(il))[:, None],
                              (il, ix))
        zero = np.zeros((il, ix))
        zero12 = np.zeros((12, il, ix))
        sst12 = np.broadcast_to(sst, (12, il, ix)).copy()
        base = dict(orog=zero, fmask=zero, alb0=np.full((il, ix), APE_ALB0),
                    veg_low=zero, veg_high=zero, sst12=sst12, sice12=zero12,
                    stl12=sst12.copy(), snowd12=zero12, swl1_12=zero12,
                    swl2_12=zero12)
        unknown = set(fields) - set(base)
        if unknown:
            raise TypeError(f"unknown boundary fields {sorted(unknown)}")
        base.update(fields)
        return cls(**{k: np.array(v, np.float64) for k, v in base.items()})


def load_boundary(boundary, ix: int = 96, il: int = 48) -> BoundaryData:
    """Resolve a `boundary=` argument: None -> the aquaplanet, a
    BoundaryData as is, a path -> the fort.2x files in that directory (an
    error if it is missing, never a fallback to the aquaplanet)."""
    if boundary is None:
        return BoundaryData.aquaplanet(ix, il)
    if isinstance(boundary, BoundaryData):
        return boundary
    if not os.path.isdir(boundary):
        raise FileNotFoundError(f"boundary directory {boundary} not found")
    return BoundaryData.from_dir(os.fspath(boundary), ix, il)
