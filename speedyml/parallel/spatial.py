"""Latitude-sharded SPEEDY step: the sharded-grid scale-out path.

Replacement for the reference's rank-0-serialized SPEEDY
(mpires.f90:1548-1660 runs the whole model on one process) and the MPI
hub-and-spoke (SURVEY 5.8): the grid-space work — the elementwise
tendency/physics compute — runs inside a `shard_map` with every (il, ix)
array sharded over a mesh axis in LATITUDE, while the spectral state
(31 x 2 x 32 per field-level, ~8 kB) stays replicated.

Communication analysis (why this shape, not all-to-all transposes):
  * inverse transforms (spec -> grid) are LOCAL: each shard contracts the
    replicated spectral coefficients against its own latitude rows of the
    Legendre operator;
  * forward transforms (grid -> spec) contract the local latitude block and
    `psum` the partial coefficients over the lat axis — the ONLY collective
    in the step, moving ~n_fields x 8 kB per step between devices;
  * all grid-space tendency/physics work is pointwise in latitude (products,
    vertical cumsums, column physics), so NO halo exchange exists at all —
    spectral models take horizontal derivatives spectrally.
At T30 this is bandwidth-optimal: an all-to-all transpose scheme (needed
when the spectral state itself must shard, e.g. T1000+) would move the full
grid per step; the psum moves only truncated coefficients.

Everything here is equivalence-tested against the replicated step on a
virtual 8-device CPU mesh (tests/test_spatial.py).
"""

from __future__ import annotations

import copy
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..transforms.spectral import HIGHEST, SpectralTransform

# Every shard_map here passes check_vma=False: outputs are replicated via
# psum, but the dynamic table slices by axis_index defeat the static
# varying-axis tracker.


class LatLocalTransform:
    """SpectralTransform view for use INSIDE shard_map: grid/fourier arrays
    hold only this shard's latitude block; spectral arrays are replicated.

    Spectral-space operators delegate to the wrapped transform; the four
    core transform kernels are re-derived with the Legendre/cos tables
    sliced to the local block (a dynamic_slice by axis_index — the full
    table is an embedded constant, 31 x 32 x 48 floats).
    """

    def __init__(self, T: SpectralTransform, axis: str, n_shards: int):
        assert T.il % n_shards == 0, (T.il, n_shards)
        self._T = T
        self.axis = axis
        self.jl = T.il // n_shards
        self.ix, self.il, self.iy = T.ix, T.il, T.iy
        self.mx, self.nx, self.ntrun = T.mx, T.nx, T.ntrun
        self.dtype = T.dtype
        # spectral-space operators + DFT tables pass through unchanged
        for name in ("lap", "invlap", "trunct", "grad", "uvspec", "vds",
                     "dft_inv", "dft_fwd", "el2", "elm2", "el4", "trfilt",
                     "gradx", "gradym", "gradyp", "uvdx", "uvdym", "uvdyp",
                     "vddym", "vddyp", "tables"):
            setattr(self, name, getattr(T, name))

    # -- local table slices (traced: axis_index only exists inside shard_map)
    def _lat0(self):
        return jax.lax.axis_index(self.axis) * self.jl

    def _slice(self, arr, axis):
        return jax.lax.dynamic_slice_in_dim(jnp.asarray(arr), self._lat0(),
                                            self.jl, axis)

    @property
    def cosgr(self):
        return self._slice(self._T.cosgr, 0)

    @property
    def cosgr2(self):
        return self._slice(self._T.cosgr2, 0)

    @property
    def coriol(self):
        return self._slice(self._T.coriol, 0)

    # -- core transforms over the local latitude block ---------------------
    def spec_to_fourier(self, spec):
        leg = self._slice(self._T.leg_inv, 2)            # (mx, nx, jl)
        return jnp.einsum("...mcn,mnj->...jmc", spec, leg,
                          precision=HIGHEST)

    def fourier_to_grid(self, fourier, kcos: int = 1):
        flat = fourier.reshape(fourier.shape[:-2] + (self.mx * 2,))
        grid = jnp.einsum("...jf,fi->...ji", flat, self.dft_inv,
                          precision=HIGHEST)
        if kcos == 2:
            grid = grid * self.cosgr[:, None]
        return grid

    def grid_to_fourier(self, grid):
        flat = jnp.einsum("...ji,if->...jf", grid, self.dft_fwd,
                          precision=HIGHEST)
        return flat.reshape(flat.shape[:-1] + (self.mx, 2))

    def fourier_to_spec(self, fourier):
        """Partial Legendre contraction over local latitudes + psum over the
        lat mesh axis — the step's single collective."""
        leg = self._slice(self._T.leg_fwd, 2)
        partial = jnp.einsum("...jmc,mnj->...mcn", fourier, leg,
                             precision=HIGHEST)
        return jax.lax.psum(partial, self.axis)

    def spec_to_grid(self, spec, kcos: int = 1):
        return self.fourier_to_grid(self.spec_to_fourier(spec), kcos)

    def grid_to_spec(self, grid):
        return self.fourier_to_spec(self.grid_to_fourier(grid))

    def vdspec(self, ug, vg, kcos: int = 2):
        scale = self.cosgr if kcos == 2 else self.cosgr2
        um = self.fourier_to_spec(self.grid_to_fourier(ug * scale[:, None]))
        vm = self.fourier_to_spec(self.grid_to_fourier(vg * scale[:, None]))
        return self.vds(um, vm)

    def uv_grid(self, vorm, divm):
        ucosm, vcosm = self.uvspec(vorm, divm)
        return (self.spec_to_grid(ucosm, kcos=2),
                self.spec_to_grid(vcosm, kcos=2))


def _localize_dycore(dy, axis: str, n_shards: int):
    """Shallow Dycore proxy whose transform + (il,) constants are
    shard-local. Build INSIDE the shard_map body (slicing needs
    axis_index)."""
    loc = copy.copy(dy)
    Tl = LatLocalTransform(dy.T, axis, n_shards)
    loc.T = Tl
    loc.coriol = Tl.coriol
    return loc


def _localize_physics(phys, axis: str, n_shards: int):
    loc = copy.copy(phys)
    il = np.asarray(phys.clat).shape[0]
    jl = il // n_shards
    i0 = jax.lax.axis_index(axis) * jl

    def sl(a):
        return jax.lax.dynamic_slice_in_dim(jnp.asarray(a), i0, jl, 0)

    loc.clat = sl(phys.clat)
    loc.forog = sl(phys.forog)
    loc.fmask1 = sl(phys.fmask1)
    loc.phis0 = sl(phys.phis0)
    return loc


def _lat_spec(tree, axis: str, il: int):
    """PartitionSpec pytree sharding each leaf's LAST axis of size il:
    handles (il,), (il, ix) and (..., il, ix) leaves alike (ix != il on this
    grid, so the match is unambiguous)."""
    def spec(leaf):
        shape = jnp.shape(leaf)
        for ax in range(len(shape) - 1, -1, -1):
            if shape[ax] == il:
                parts = [None] * len(shape)
                parts[ax] = axis
                return P(*parts)
        return P()

    return jax.tree.map(spec, tree)


class SpatialDycore:
    """shard_map-wrapped step functions over a latitude-sharded mesh axis.

    Usage: sd = SpatialDycore(dy, mesh, axis="lat");
    jitted = jax.jit(sd.step_fn()); state' = jitted(state, forcing).
    State/forcing are replicated (tiny); all grid-space intermediates are
    sharded over `axis`.
    """

    def __init__(self, dy, mesh: Mesh, axis: str = "lat",
                 phys=None):
        self.dy = dy
        self.mesh = mesh
        self.axis = axis
        self.n = mesh.shape[axis]
        self.phys = phys
        assert dy.config.il % self.n == 0

    # ------------------------------------------------------------------
    def step_fn(self, j1: int = 1, j2: int = 1, dt_key: str = "delt2"):
        """Dry-core step: (SpectralState, Forcing) -> SpectralState, grid
        work sharded over latitude."""
        dy, axis, n = self.dy, self.axis, self.n

        def body(state, forcing):
            loc = _localize_dycore(dy, axis, n)
            return loc.step(state, forcing, j1, j2, dt_key)

        return jax.shard_map(body, mesh=self.mesh, in_specs=(P(), P()),
                             out_specs=P(), check_vma=False)

    def run_steps_fn(self, nsteps: int, dt_key: str = "delt2"):
        dy, axis, n = self.dy, self.axis, self.n

        def body(state, forcing):
            loc = _localize_dycore(dy, axis, n)

            def one(s, _):
                return loc.step(s, forcing, 1, 1, dt_key), None

            state, _ = jax.lax.scan(one, state, None, length=nsteps)
            return state

        return jax.shard_map(body, mesh=self.mesh, in_specs=(P(), P()),
                             out_specs=P(), check_vma=False)

    # ------------------------------------------------------------------
    def physics_step_fn(self, lradsw: bool = True, j1: int = 1, j2: int = 1,
                        dt_key: str = "delt2"):
        """Full-physics step. surf/rad enter latitude-SHARDED (their natural
        layout: columns live with their shard); returns (state, rad, fluxes)
        with rad/fluxes sharded.

        in_specs: (state P(), forcing P(), surf by-leaf lat specs,
                   rad by-leaf lat specs)."""
        assert self.phys is not None, "pass phys= to shard physics"
        dy, axis, n, phys = self.dy, self.axis, self.n, self.phys

        def body(state, forcing, surf, rad):
            loc = _localize_dycore(dy, axis, n)
            ploc = _localize_physics(phys, axis, n)
            lsw = jnp.asarray(lradsw)

            def phys_fn(dyf, fphy):
                tends, rad_new, fluxes = ploc.step_physics(
                    dyf, fphy, surf, rad, lsw)
                return tends, (rad_new, fluxes)

            new_state, (rad_new, fluxes) = loc.step(state, forcing, j1, j2,
                                                    dt_key, phys_fn)
            return new_state, rad_new, fluxes

        return body                 # wrapped by caller with example pytrees

    def wrap_physics(self, surf_example, rad_example, fluxes_example=None,
                     lradsw: bool = True, j1: int = 1, j2: int = 1,
                     dt_key: str = "delt2"):
        """shard_map the physics step using example pytrees to derive the
        per-leaf latitude specs."""
        body = self.physics_step_fn(lradsw, j1, j2, dt_key)
        surf_specs = _lat_spec(surf_example, self.axis, self.dy.config.il)
        rad_specs = _lat_spec(rad_example, self.axis, self.dy.config.il)
        if fluxes_example is None:
            from ..physics.driver import StepFluxes
            z = np.zeros((self.dy.config.il, self.dy.config.ix))
            fluxes_example = StepFluxes(*([z] * len(StepFluxes._fields)))
        flux_specs = _lat_spec(fluxes_example, self.axis, self.dy.config.il)
        return jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P(), P(), surf_specs, rad_specs),
            out_specs=(P(), rad_specs, flux_specs), check_vma=False)

    # ------------------------------------------------------------------
    def shard_surface(self, tree):
        """device_put a surf/rad/flux pytree with its latitude axis sharded
        over the mesh."""
        specs = _lat_spec(tree, self.axis, self.dy.config.il)
        return jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(self.mesh, s)),
            tree, specs)
