"""Offline forecast/climate analysis library.

Counterpart of the reference's post-processing scripts
(scripts/hybrid_climo.py, scripts/enso_hybrid.py, scripts/total_precip.py,
scripts/extreme_values.py): the numerical cores — RMS skill, sigma→pressure
interpolation, monthly climatology, anomaly correlation, Niño-3.4 ENSO index,
power spectra — as vectorized numpy functions over the (time, level, lat,
lon) arrays produced by `speedyml.io.output.read_forecast`, with no plotting
/ cartopy / numba dependencies.
"""

from __future__ import annotations

import numpy as np

#: SPEEDY full-level sigma values (scripts/hybrid_climo.py:34 speedy_sigma;
#: mod_dyncon1 fsg at kx=8).
SPEEDY_SIGMA = np.array([0.025, 0.095, 0.20, 0.34, 0.51, 0.685, 0.835, 0.95])


def rms(true: np.ndarray, prediction: np.ndarray, axis=None) -> np.ndarray:
    """Root-mean-square error, NaN-tolerant (scripts/hybrid_climo.py:29-30)."""
    return np.sqrt(np.nanmean((np.asarray(prediction) - np.asarray(true)) ** 2,
                              axis=axis))


def latitude_weights(lat_deg: np.ndarray) -> np.ndarray:
    """cos(lat) area weights normalized to mean 1."""
    w = np.cos(np.deg2rad(np.asarray(lat_deg, np.float64)))
    return w / w.mean()


def weighted_rms(true, prediction, lat_deg, lat_axis=-2, axis=None):
    """Area-weighted RMS over (..., lat, lon) fields."""
    err2 = (np.asarray(prediction) - np.asarray(true)) ** 2
    w = latitude_weights(lat_deg)
    shape = [1] * err2.ndim
    shape[lat_axis] = w.size
    wb = np.broadcast_to(w.reshape(shape), err2.shape)
    valid = ~np.isnan(err2)
    num = np.nansum(err2 * wb, axis=axis)
    den = np.sum(wb * valid, axis=axis)
    return np.sqrt(num / np.where(den > 0, den, np.nan))


def sigma_to_pressure(var: np.ndarray, logp: np.ndarray,
                      target_pressures_hpa: np.ndarray,
                      sigma: np.ndarray = SPEEDY_SIGMA,
                      p0_hpa: float = 1000.0) -> np.ndarray:
    """Linear interpolation from sigma levels to constant-pressure levels
    (vectorized re-design of scripts/hybrid_climo.py:32-60 lin_interp).

    var: (..., kx, il, ix) on full sigma levels (top→bottom);
    logp: (..., il, ix) log(ps/p0); target_pressures_hpa: (np_out,).
    Returns (..., np_out, il, ix); NaN where the target pressure lies below
    the lowest sigma level or above the highest (no extrapolation).
    """
    var = np.asarray(var, np.float64)
    ps = np.exp(np.asarray(logp, np.float64)) * p0_hpa      # (..., il, ix)
    pres = sigma[:, None, None] * ps[..., None, :, :]       # (..., kx, il, ix)
    tgt = np.asarray(target_pressures_hpa, np.float64)

    kx = sigma.size
    out_shape = var.shape[:-3] + (tgt.size,) + var.shape[-2:]
    out = np.full(out_shape, np.nan)
    for i, p in enumerate(tgt):
        # index of first level with pres >= p (searchsorted along k)
        below = pres >= p                                   # (..., kx, il, ix)
        k_hi = below.argmax(axis=-3)                        # first True
        valid = below.any(axis=-3) & (k_hi > 0)
        k_hi_c = np.clip(k_hi, 1, kx - 1)
        k_lo_c = k_hi_c - 1
        p_hi = np.take_along_axis(pres, k_hi_c[..., None, :, :], -3)[..., 0, :, :]
        p_lo = np.take_along_axis(pres, k_lo_c[..., None, :, :], -3)[..., 0, :, :]
        v_hi = np.take_along_axis(var, k_hi_c[..., None, :, :], -3)[..., 0, :, :]
        v_lo = np.take_along_axis(var, k_lo_c[..., None, :, :], -3)[..., 0, :, :]
        frac = (p - p_lo) / (p_hi - p_lo)
        out[..., i, :, :] = np.where(valid, v_lo + frac * (v_hi - v_lo), np.nan)
    return out


def monthly_climatology(fields: np.ndarray, months: np.ndarray):
    """Per-calendar-month mean over the time axis (axis 0).

    fields: (T, ...); months: (T,) 1..12. Returns (12, ...) with NaN for
    months absent from the record (hybrid_climo's seasonal means).
    """
    fields = np.asarray(fields)
    months = np.asarray(months)
    out = np.full((12,) + fields.shape[1:], np.nan)
    for m in range(1, 13):
        sel = months == m
        if sel.any():
            out[m - 1] = np.nanmean(fields[sel], axis=0)
    return out


def anomalies(fields: np.ndarray, months: np.ndarray,
              clim: np.ndarray | None = None) -> np.ndarray:
    """Subtract the (given or self-computed) monthly climatology."""
    if clim is None:
        clim = monthly_climatology(fields, months)
    return np.asarray(fields) - clim[np.asarray(months) - 1]


def anomaly_correlation(pred, truth, clim, lat_deg, lat_axis=-2, axis=None):
    """Centered anomaly correlation coefficient with cos-lat weighting."""
    pa = np.asarray(pred, np.float64) - clim
    ta = np.asarray(truth, np.float64) - clim
    w = latitude_weights(lat_deg)
    shape = [1] * pa.ndim
    shape[lat_axis] = w.size
    w = w.reshape(shape)
    num = np.nansum(w * pa * ta, axis=axis)
    den = np.sqrt(np.nansum(w * pa * pa, axis=axis)
                  * np.nansum(w * ta * ta, axis=axis))
    return num / np.where(den == 0.0, np.nan, den)


def box_mean(field: np.ndarray, lat_deg: np.ndarray, lon_deg: np.ndarray,
             lat_range: tuple, lon_range: tuple, lat_axis=-2) -> np.ndarray:
    """cos-lat-weighted mean over a lat/lon box; lon_range in [0, 360),
    wrapping allowed (lo > hi selects across the dateline)."""
    lat_deg = np.asarray(lat_deg)
    lon = np.mod(np.asarray(lon_deg), 360.0)
    la = (lat_deg >= lat_range[0]) & (lat_deg <= lat_range[1])
    lo, hi = np.mod(lon_range[0], 360.0), np.mod(lon_range[1], 360.0)
    lb = (lon >= lo) & (lon <= hi) if lo <= hi else (lon >= lo) | (lon <= hi)
    sub = np.compress(la, np.asarray(field, np.float64), axis=lat_axis)
    sub = np.compress(lb, sub, axis=lat_axis + 1 if lat_axis >= 0 else -1)
    w = latitude_weights(lat_deg[la])
    shape = [1] * sub.ndim
    shape[lat_axis] = w.size
    return (np.nanmean(sub * w.reshape(shape), axis=(lat_axis,
            lat_axis + 1 if lat_axis >= 0 else -1)))


def nino34_index(sst: np.ndarray, lat_deg: np.ndarray, lon_deg: np.ndarray,
                 months: np.ndarray, smooth: int = 5) -> np.ndarray:
    """Niño-3.4 SST anomaly index (scripts/enso_hybrid.py capability):
    box mean over 5S–5N, 170W–120W, monthly climatology removed, centered
    running mean of `smooth` samples."""
    series = box_mean(sst, lat_deg, lon_deg, (-5.0, 5.0), (190.0, 240.0))
    anom = anomalies(series, months)
    if smooth > 1:
        kernel = np.ones(smooth) / smooth
        pad = smooth // 2
        padded = np.pad(anom, pad, mode="edge")
        anom = np.convolve(padded, kernel, mode="valid")[: series.shape[0]]
    return anom


def power_spectrum(series: np.ndarray, dt: float = 1.0, nperseg=None):
    """Welch power spectral density of a 1-D index (scripts/enso_hybrid.py
    spectral analysis). Returns (freq, psd)."""
    from scipy.signal import welch
    series = np.asarray(series, np.float64)
    if nperseg is None:
        nperseg = min(series.size, 256)
    return welch(series, fs=1.0 / dt, nperseg=nperseg)


def return_period_maxima(field: np.ndarray, block: int) -> np.ndarray:
    """Block maxima over the time axis (scripts/extreme_values.py core):
    (T, ...) -> (T // block, ...)."""
    field = np.asarray(field)
    nb = field.shape[0] // block
    return field[: nb * block].reshape((nb, block) + field.shape[1:]).max(axis=1)


def global_total_precip(precip_log: np.ndarray, lat_deg: np.ndarray,
                        eps: float = 0.001) -> np.ndarray:
    """Undo the log(1 + P/eps) transform and area-average
    (scripts/total_precip.py; transform mod_reservoir.f90:446-449)."""
    p = (np.exp(np.asarray(precip_log, np.float64)) - 1.0) * eps
    w = latitude_weights(lat_deg)
    return np.nanmean(p * w[:, None], axis=(-2, -1))


def total_atmosphere_mass(logp: np.ndarray, lat_deg: np.ndarray,
                          g: float = 9.81) -> np.ndarray:
    """Total atmospheric mass per unit area (kg/m^2) from the model's
    log-surface-pressure field (scripts/total_atmosphere_weight.py core):
    area-weighted global-mean ps / g per time step. The ps convention is
    the training one, ps = exp(logp) * 1000 hPa. A drift in this series
    over a long free run is a mass-conservation violation of the learned
    component (SPEEDY itself conserves by construction)."""
    ps_pa = np.exp(np.asarray(logp, np.float64)) * 1000.0 * 100.0
    w = latitude_weights(lat_deg)
    return np.nanmean(ps_pa * w[:, None], axis=(-2, -1)) / g


def running_mean(series: np.ndarray, n: int) -> np.ndarray:
    """Centered moving average over the leading axis, edge-padded to keep
    length (the reference's moving_average / uniform_filter1d smoothing,
    scripts/total_atmosphere_weight.py, non_stationary_trends.py)."""
    series = np.asarray(series, np.float64)
    if n <= 1:
        return series
    pad = n // 2
    padded = np.pad(series, [(pad, n - 1 - pad)] + [(0, 0)] *
                    (series.ndim - 1), mode="edge")
    c = np.cumsum(padded, axis=0, dtype=np.float64)
    out = (c[n - 1:] - np.concatenate(
        [np.zeros((1,) + c.shape[1:]), c[:-n]], axis=0)) / n
    return out[: series.shape[0]]


def linear_trend(series: np.ndarray, dt: float = 1.0):
    """Least-squares linear trend of a (possibly smoothed) global-mean
    anomaly series (scripts/non_stationary_trends.py capability: detect
    non-stationary drift in multi-year hybrid runs). Returns
    (slope_per_time_unit, intercept); `dt` is the sample spacing."""
    y = np.asarray(series, np.float64)
    t = np.arange(y.shape[0], dtype=np.float64) * dt
    tm, ym = t.mean(), y.mean(axis=0)
    denom = np.sum((t - tm) ** 2)
    slope = np.tensordot(t - tm, y - ym, axes=(0, 0)) / denom
    return slope, ym - slope * tm
