"""Random diabatic forcing (reference: src/ini_inirdf.f90, src/mod_randfor.f90,
src/phy_phypar.f90:202-310 xs_rdf/setrdf).

A fixed random horizontal pattern pair (T18-truncated, built once at init)
times slowly-varying zonal-mean vertical profiles of the model's own
diabatic heating, added to the temperature tendency. Used by the reference
for perturbation/predictability experiments (off by default,
mod_tsteps.f90 nstrdf=0).

Shape conventions: fields are (kx, il, ix); the pattern is (2, il, ix);
the profiles are (2, kx, il). The pattern build is host-side numpy at init
(one-off); the per-step profile + application is pure jnp inside the
physics program.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

#: reduced-grid row lengths, pole to pole (ini_inirdf.f90:22-23)
NLONRG = np.array([1, 6, 12, 18, 24, 28, 32, 34, 36, 36,
                   36, 34, 32, 28, 24, 18, 12, 6, 1])


def make_randfh(transform, gsin: np.ndarray, ix: int, seed: int = 1,
                ampl: float = 0.5, ntrfor: int = 18) -> np.ndarray:
    """Build the fixed horizontal pattern pair randfh (2, il, ix).

    Normally-distributed values on a 19-row reduced grid, bilinearly
    interpolated to the Gaussian grid, then spectrally truncated at T{ntrfor}
    (ini_inirdf.f90:40-88 + truncg). `seed < 0` flips the sign (the
    reference's indrdf<0 convention); `gsin` is sin(lat) south->north.
    """
    il = gsin.size
    rng = np.random.default_rng(abs(seed))
    sign = -1.0 if seed < 0 else 1.0

    rdeg = 9.0 / np.arcsin(1.0)
    colat = rdeg * np.arcsin(gsin) + 9.0          # in [0, 18]

    out = np.zeros((2, il, ix))
    for nf in range(2):
        # reduced grid with periodic column 0 = last real column
        redgrd = np.zeros((37 + 1, 19))
        for jlat in range(19):
            vals = rng.normal(0.0, ampl, NLONRG[jlat])
            redgrd[1:NLONRG[jlat] + 1, jlat] = vals
            redgrd[0, jlat] = vals[-1]

        randf2 = np.zeros((il, ix))
        for j in range(il):
            jlat1 = min(int(colat[j]), 17)
            jlat2 = jlat1 + 1
            for i in range(ix):
                def row(jl):
                    rlon = i * NLONRG[jl] / ix
                    jlon = int(rlon)
                    return (redgrd[jlon, jl]
                            + (rlon - jlon) * (redgrd[jlon + 1, jl]
                                               - redgrd[jlon, jl]))
                f1, f2 = row(jlat1), row(jlat2)
                randf2[j, i] = f1 + (colat[j] - jlat1) * (f2 - f1)

        # spectral truncation at T{ntrfor} (truncg equivalent)
        spec = transform.grid_to_spec(jnp.asarray(randf2))
        mx, _, nx = spec.shape
        ll = np.add.outer(np.arange(mx), np.arange(nx))
        filt = jnp.asarray((ll <= ntrfor).astype(np.float64))[:, None, :]
        out[nf] = np.asarray(transform.spec_to_grid(spec * filt))
    return sign * out


def xs_rdf(tt1, tt2, sig, ivm: int):
    """Zonal-mean cross-section of diabatic heating with two passes of
    1-2-1 latitude smoothing (phy_phypar.f90 xs_rdf). tt1/tt2: (kx, il, ix);
    returns (kx, il). Mode 2 weights levels by sin(2*pi*sigma)."""
    prof = (tt1 + tt2).mean(axis=-1)              # (kx, il)
    if ivm == 2:
        pigr2 = 4.0 * np.arcsin(1.0)
        prof = prof * jnp.sin(pigr2 * jnp.asarray(sig, prof.dtype))[:, None]
    for _ in range(2):
        # boundary mirror: rand1(0)=rand1(2), rand1(il+1)=rand1(il-1)
        lo = prof[:, 1:2]
        hi = prof[:, -2:-1]
        padded = jnp.concatenate([lo, prof, hi], axis=1)
        prof = 0.5 * padded[:, 1:-1] + 0.25 * (padded[:, :-2]
                                               + padded[:, 2:])
    return prof


def tt_rdf(randfh, randfv1, randfv2):
    """3-D forcing pattern (setrdf): randfh (2, il, ix), randfv* (kx, il)
    -> (kx, il, ix) temperature tendency increment [K/s]."""
    return (randfh[0][None] * randfv1[:, :, None]
            + randfh[1][None] * randfv2[:, :, None])
