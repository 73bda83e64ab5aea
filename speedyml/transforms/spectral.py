"""Batched spherical-harmonic transforms — real arithmetic only.

Design decisions (vs the reference's spe_spectral.f90 + FFTPACK):
  * Spectral coefficients are REAL arrays of shape (..., mx, 2, nx): zonal
    wavenumber m, (re, im) pair, total-wavenumber offset n. This mirrors the
    reference's mx2 real packing (spe_subfft_fftpack.f90:30-38) and keeps
    every transform a real matrix product, with no complex dtypes.
  * The longitude DFT is a dense cos/sin MATMUL (96x62 operator), not an
    FFT: at T30 the operator is small and the DFT chains with the Legendre
    contraction as two matrix products. Whether an FFT is faster on the GPU
    has not been measured.
  * The Legendre transform is a batched einsum over the full latitude grid
    with hemispheric parity and truncation masks baked into the operator
    (replacing the reference's per-latitude loops, spe_spectral.f90:454-538).

Layouts:
  spectral: real (..., mx, 2, nx)
  fourier:  real (..., il, mx, 2)
  grid:     real (..., il, ix)     row 0 = southernmost latitude
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .tables import SpectralTables, build_tables

# Full-f32 contractions: at the default precision an f32 matmul on the GPU
# may run in TF32 (10-bit mantissa), which moved a 6-h window's winds and
# surface pressure by 5-9% of their spread against float64 on an H100
# (chip_smoke.py); "highest" keeps the f32 result.
HIGHEST = jax.lax.Precision.HIGHEST


def to_real(c: np.ndarray) -> np.ndarray:
    """complex (..., mx, nx) -> real (..., mx, 2, nx)."""
    return np.stack([np.real(c), np.imag(c)], axis=-2)


def to_complex(r) -> np.ndarray:
    """real (..., mx, 2, nx) -> complex numpy (..., mx, nx)."""
    r = np.asarray(r)
    return r[..., 0, :] + 1j * r[..., 1, :]


def _shift_down(x):
    """out[..., n] = x[..., n-1] (zero at n=0)."""
    return jnp.concatenate([jnp.zeros_like(x[..., :1]), x[..., :-1]], axis=-1)


def _shift_up(x):
    """out[..., n] = x[..., n+1] (zero at n=nx-1)."""
    return jnp.concatenate([x[..., 1:], jnp.zeros_like(x[..., :1])], axis=-1)


def _mul_i(x):
    """Multiply by the imaginary unit: (re, im) -> (-im, re).

    x: (..., mx, 2, nx).
    """
    return jnp.stack([-x[..., 1, :], x[..., 0, :]], axis=-2)


class SpectralTransform:
    """Holds host (numpy) operator constants; all methods are pure and
    jittable (constants embed into the XLA program directly)."""

    def __init__(self, tables: SpectralTables | None = None,
                 dtype=jnp.float32):
        t = tables if tables is not None else build_tables()
        self.tables = t
        self.dtype = dtype
        self.ix, self.il, self.iy = t.ix, t.il, t.iy
        self.mx, self.nx, self.ntrun = t.mx, t.nx, t.ntrun

        np_dtype = np.float64 if dtype == jnp.float64 else np.float32
        as_r = lambda x: np.asarray(x, dtype=np_dtype)

        self.leg_inv = as_r(t.leg_inv)      # (mx, nx, il)
        self.leg_fwd = as_r(t.leg_fwd)      # (mx, nx, il)
        # coefficient tables broadcast over the (re, im) axis: (mx, 1, nx)
        b = lambda x: as_r(x)[:, None, :]
        self.el2 = b(t.el2)
        self.elm2 = b(t.elm2)
        self.el4 = b(t.el4)
        self.trfilt = b(t.trfilt)
        self.gradx = as_r(t.gradx)          # (mx,)
        self.gradym = b(t.gradym)
        self.gradyp = b(t.gradyp)
        self.uvdx = b(t.uvdx)
        self.uvdym = b(t.uvdym)
        self.uvdyp = b(t.uvdyp)
        self.vddym = b(t.vddym)
        self.vddyp = b(t.vddyp)
        self.cosgr = as_r(t.cosgr)
        self.cosgr2 = as_r(t.cosgr2)
        self.coriol = as_r(t.coriol)

        # dense DFT operators (matmuls)
        m = np.arange(self.mx)
        i = np.arange(self.ix)
        ang = 2.0 * np.pi * np.outer(i, m) / self.ix          # (ix, mx)
        scale = np.where(m == 0, 1.0, 2.0)
        # inverse: grid[i] = sum_m scale*(re_m cos - im_m sin)
        dft_inv = np.empty((self.mx, 2, self.ix))
        dft_inv[:, 0, :] = (scale[:, None] * np.cos(ang).T)
        dft_inv[:, 1, :] = (-scale[:, None] * np.sin(ang).T)
        self.dft_inv = as_r(dft_inv.reshape(self.mx * 2, self.ix))
        # forward: re_m = (1/ix) sum_i g cos ; im_m = -(1/ix) sum_i g sin
        dft_fwd = np.empty((self.ix, self.mx, 2))
        dft_fwd[:, :, 0] = np.cos(ang) / self.ix
        dft_fwd[:, :, 1] = -np.sin(ang) / self.ix
        self.dft_fwd = as_r(dft_fwd.reshape(self.ix, self.mx * 2))

    # ------------------------------------------------------------------
    # core transforms
    # ------------------------------------------------------------------
    def spec_to_fourier(self, spec):
        """(..., mx, 2, nx) -> (..., il, mx, 2) (gridy equivalent)."""
        return jnp.einsum("...mcn,mnj->...jmc", spec, self.leg_inv,
                          precision=HIGHEST)

    def fourier_to_grid(self, fourier, kcos: int = 1):
        """(..., il, mx, 2) -> (..., il, ix) via dense DFT matmul."""
        flat = fourier.reshape(fourier.shape[:-2] + (self.mx * 2,))
        grid = jnp.einsum("...jf,fi->...ji", flat, self.dft_inv,
                          precision=HIGHEST)
        if kcos == 2:
            grid = grid * self.cosgr[:, None]
        return grid

    def grid_to_fourier(self, grid):
        """(..., il, ix) -> (..., il, mx, 2)."""
        flat = jnp.einsum("...ji,if->...jf", grid, self.dft_fwd,
                          precision=HIGHEST)
        return flat.reshape(flat.shape[:-1] + (self.mx, 2))

    def fourier_to_spec(self, fourier):
        """(..., il, mx, 2) -> (..., mx, 2, nx) (specy equivalent)."""
        return jnp.einsum("...jmc,mnj->...mcn", fourier, self.leg_fwd,
                          precision=HIGHEST)

    def spec_to_grid(self, spec, kcos: int = 1):
        """Spectral -> grid (reference `grid`, spe_spectral.f90:389-401)."""
        return self.fourier_to_grid(self.spec_to_fourier(spec), kcos)

    def grid_to_spec(self, grid):
        """Grid -> spectral (reference `spec`, spe_spectral.f90:403-414)."""
        return self.fourier_to_spec(self.grid_to_fourier(grid))

    # ------------------------------------------------------------------
    # spectral-space operators
    # ------------------------------------------------------------------
    def lap(self, spec):
        return -spec * self.el2

    def invlap(self, spec):
        return -spec * self.elm2

    def trunct(self, spec):
        return spec * self.trfilt

    def grad(self, psi):
        """Spectral gradient (spe_spectral.f90:271-305)."""
        psdx = _mul_i(psi) * self.gradx[:, None, None]
        psdy = (-self.gradym * _shift_down(psi)
                + self.gradyp * _shift_up(psi))
        return psdx, psdy

    def uvspec(self, vorm, divm):
        """(vor, div) -> (U*cos, V*cos) spectral (spe_spectral.f90:351-387)."""
        zp = _mul_i(vorm) * self.uvdx
        zc = _mul_i(divm) * self.uvdx
        ucosm = (self.uvdym * _shift_down(vorm)
                 - self.uvdyp * _shift_up(vorm) + zc)
        vcosm = (-self.uvdym * _shift_down(divm)
                 + self.uvdyp * _shift_up(divm) + zp)
        return ucosm, vcosm

    def vds(self, ucosm, vcosm):
        """(U*cos, V*cos) spectral -> (vor, div) (spe_spectral.f90:307-349)."""
        zp = _mul_i(ucosm) * self.gradx[:, None, None]
        zc = _mul_i(vcosm) * self.gradx[:, None, None]
        vorm = (self.vddym * _shift_down(ucosm)
                - self.vddyp * _shift_up(ucosm) + zc)
        divm = (-self.vddym * _shift_down(vcosm)
                + self.vddyp * _shift_up(vcosm) + zp)
        return vorm, divm

    def vdspec(self, ug, vg, kcos: int = 2):
        """Grid (u, v) -> spectral (vor, div) (spe_spectral.f90:416-452)."""
        scale = self.cosgr if kcos == 2 else self.cosgr2
        ug1 = ug * scale[:, None]
        vg1 = vg * scale[:, None]
        um = self.fourier_to_spec(self.grid_to_fourier(ug1))
        vm = self.fourier_to_spec(self.grid_to_fourier(vg1))
        return self.vds(um, vm)

    def uv_grid(self, vorm, divm):
        """Spectral (vor, div) -> grid (u, v) (dyn_grtend.f90:70-72)."""
        ucosm, vcosm = self.uvspec(vorm, divm)
        ug = self.spec_to_grid(ucosm, kcos=2)
        vg = self.spec_to_grid(vcosm, kcos=2)
        return ug, vg

    # ------------------------------------------------------------------
    # host (pure numpy) variants for setup / daily host-side code
    # ------------------------------------------------------------------
    def host_grid_to_spec(self, grid: np.ndarray) -> np.ndarray:
        """numpy grid -> real-layout spectral (..., mx, 2, nx), float64."""
        flat = np.einsum("...ji,if->...jf", np.asarray(grid, np.float64),
                         np.asarray(self.dft_fwd, np.float64))
        fourier = flat.reshape(flat.shape[:-1] + (self.mx, 2))
        return np.einsum("...jmc,mnj->...mcn", fourier,
                         np.asarray(self.tables.leg_fwd))

    def host_spec_to_grid(self, spec: np.ndarray, kcos: int = 1) -> np.ndarray:
        fourier = np.einsum("...mcn,mnj->...jmc", np.asarray(spec, np.float64),
                            np.asarray(self.tables.leg_inv))
        flat = fourier.reshape(fourier.shape[:-2] + (self.mx * 2,))
        grid = np.einsum("...jf,fi->...ji", flat,
                         np.asarray(self.dft_inv, np.float64))
        if kcos == 2:
            grid = grid * np.asarray(self.tables.cosgr)[:, None]
        return grid

    def host_trunct(self, spec: np.ndarray) -> np.ndarray:
        return np.asarray(spec) * np.asarray(self.tables.trfilt)[:, None, :]
