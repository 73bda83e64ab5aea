"""Synthetic ENSO-like SST anomaly forcing for the truth trajectory.

The reference's coupled headline (JAMES 2023) is an ocean reservoir that
learns ENSO-scale SST variability from OBSERVED SST (read per date from the
era companion files, mpires.f90:1676-1710, mod_io.f90:2731-2812) and then
propagates it through the coupled hybrid loop. This environment has zero
egress — no observed SST — and the self-generated truth runs with icsea=0,
so its SST is exactly climatology and a correctly trained ocean reservoir
predicts ~zero anomaly.

This module supplies the missing ingredient in-image: a deterministic,
seeded, ENSO-like SST anomaly field imposed on the truth trajectory's sea
boundary (the analog of SPEEDY's observed-anomaly mode, isstan>0 in
cpl_sea.f90: sst_am = sstcl + sstan). The anomaly is

    anom(t, lat, lon) = ramp(t) * [ A sin(2 pi (t - t0)/P) + ar1(t) ] *
                        pattern(lat, lon)

with `pattern` a Nino-3.4-centred equatorial-Pacific dipole (warm core at
215E with a weaker opposite-sign west-Pacific pole, sea points only) and
`ar1` a daily AR(1) process adding ENSO-like irregularity. Everything is a
pure function of (seed, date): the data phase, the ocean training phase and
the evaluation script reconstruct bit-identical forcing independently.
"""

from __future__ import annotations

import numpy as np

from ..core.calendar import hours_since_epoch


def enso_pattern(lat_deg: np.ndarray, lon_deg: np.ndarray,
                 fmask_s: np.ndarray) -> np.ndarray:
    """(il, ix) dimensionless anomaly pattern, max ~1 in the Nino-3.4 box.

    Warm pole: Gaussian centred (0N, 215E), sigma (10 deg, 32 deg) — covers
    Nino-3.4 (5S-5N, 190-240E). Cold pole: -0.35 x Gaussian centred
    (0N, 130E), sigma (12 deg, 22 deg) — the west-Pacific see-saw. Scaled by
    the fractional sea mask so land points stay untouched.
    """
    la = np.asarray(lat_deg, np.float64)[:, None]
    lo = np.asarray(lon_deg, np.float64)[None, :]
    warm = np.exp(-0.5 * ((la / 10.0) ** 2 + ((lo - 215.0) / 32.0) ** 2))
    cold = np.exp(-0.5 * ((la / 12.0) ** 2 + ((lo - 130.0) / 22.0) ** 2))
    return (warm - 0.35 * cold) * np.asarray(fmask_s, np.float64)


class SyntheticEnso:
    """Deterministic date->anomaly(il, ix) forcing.

    seed/amp/period_days/ar_std/ar_tau_days define the process; t0 (a
    (year, month, day) tuple) anchors both the sinusoid phase (sin=0,
    rising) and a 30-day ramp so the imposed boundary change never shocks
    the trajectory. The daily AR(1) series is precomputed for n_years from
    t0 and interpolated to the requested date's day.
    """

    def __init__(self, lat_deg, lon_deg, fmask_s, seed: int = 7,
                 amp: float = 1.2, period_days: float = 480.0,
                 ar_std: float = 0.25, ar_tau_days: float = 45.0,
                 t0=(1982, 2, 1), n_years: int = 30,
                 ramp_days: float = 30.0):
        self.pattern = enso_pattern(lat_deg, lon_deg, fmask_s)
        self.amp = float(amp)
        self.period_days = float(period_days)
        self.ramp_days = float(ramp_days)
        self.h0 = hours_since_epoch(t0[0], t0[1], t0[2], 0)
        n_days = int(n_years * 366)
        phi = np.exp(-1.0 / float(ar_tau_days))
        innov = np.random.default_rng(seed).normal(
            size=n_days) * ar_std * np.sqrt(1.0 - phi * phi)
        ar = np.empty(n_days)
        a = 0.0
        for i in range(n_days):          # one-time host setup; tiny
            a = phi * a + innov[i]
            ar[i] = a
        self.ar = ar

    def index_at(self, hours: float) -> float:
        """Scalar anomaly index [K] at `hours` since epoch (the imposed
        analog of the Nino-3.4 index, before the spatial pattern)."""
        d = (float(hours) - self.h0) / 24.0
        if d < 0.0:
            return 0.0
        ramp = min(1.0, d / self.ramp_days) if self.ramp_days > 0 else 1.0
        osc = self.amp * np.sin(2.0 * np.pi * d / self.period_days)
        i = min(int(d), len(self.ar) - 2)
        w = min(d - i, 1.0)
        ar = (1.0 - w) * self.ar[i] + w * self.ar[i + 1]
        return float(ramp * (osc + ar))

    def index(self, date) -> float:
        return self.index_at(hours_since_epoch(date.iyear, date.imonth,
                                               date.iday, date.ihour))

    def anomaly(self, date) -> np.ndarray:
        """(il, ix) SST anomaly [K] at `date`."""
        return self.index(date) * self.pattern

    def sst_anom_fn(self, date) -> np.ndarray:
        return self.anomaly(date)


def apply_sst_anomaly(cs, anom: np.ndarray) -> None:
    """Impose `anom` on a CouplerState's atmosphere-facing SST.

    Mirrors sea2atm's ice blending (cpl_sea.f90:155-200, daily.py:186-189)
    with sstcl -> sstcl + anom: the anomalous open-water SST is blended
    toward tice over ice exactly like the climatological field, so polar
    behaviour is unchanged wherever the pattern is zero. Mutates cs.
    """
    sst = cs.sstcl_ob + anom
    cs.sst_am = sst + cs.sice_am * (cs.tice_am - sst)
