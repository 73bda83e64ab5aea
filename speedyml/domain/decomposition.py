"""Region decomposition and global<->region pack/unpack.

Re-design of the reference's domain layer (src/res_domain.f90):
instead of per-rank index bookkeeping + MPI send/recv of per-region vectors
(mpires.f90:218-804), the global grid stays one (sharded) device array and

  * input packing (core + halo, periodic in x, clamped at poles AND at the
    top/bottom sigma levels) is ONE batched gather through a precomputed
    index map,
  * output scattering is a pure reshape/transpose, because the region cores
    tile the grid exactly.

Default geometry mirrors the reference: 96x48 grid, 2x2 cores -> 48x24 =
1152 regions, overlap=1 halo -> 4x4 input patches, all kx levels in one
vertical slab (res_domain.f90:31-292). Vertical localization (nz_slabs > 1,
res_domain.f90:206-256) splits the column into contiguous slabs with
vert_overlap halo levels (clamped by duplication at the top/bottom, the same
convention as the pole clamp); region index r = rz * (nregy*nregx) + ry *
nregx + rx.

Uniform-shape deviation from the reference: every slab's input vector
carries the 2-D sections (logp/precip/sst/tisr) and every slab's output
carries logp/precip slots, so all R regions share ONE batched shape (the
reference gives surface fields to the bottom slab only). At scatter time
only the bottom slab's 2-D outputs are used.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class RegionLayout:
    """Static decomposition geometry + gather maps."""

    ix: int
    il: int
    kx: int
    nvars: int           # 3-D variables packed (T, u, v, q -> 4)
    resx: int            # core size in lon
    resy: int            # core size in lat
    overlap: int
    nregx: int
    nregy: int
    nz: int              # vertical slabs
    kz_core: int         # core levels per slab (kx // nz)
    inpz: int            # input levels per slab (kz_core + 2*vert_overlap)
    vert_overlap: int
    R: int               # number of regions (nregx*nregy*nz)
    inpx: int            # input patch lon size
    inpy: int

    # per-region input gather map into the packed global supervector
    input_index: np.ndarray    # (R, n_in) int32
    # per-region target/core gather map (output layout) into the supervector
    target_index: np.ndarray   # (R, n_out) int32
    n_in: int
    n_out: int                 # chunk size (atmo3d core + logp + precip)
    sizes: dict                # section name -> (start, stop) in input vec
    out_sizes: dict            # section name -> (start, stop) in output vec
    lat_region_deg: np.ndarray # (R, 2) min/max core latitude [deg]

    # global supervector layout
    gv_sizes: dict             # name -> (start, stop) in global flat vector
    gv_len: int


def _patch_indices(layout_il, layout_ix, y0, x0, ny, nx):
    """Flat indices of a (ny, nx) patch at (y0, x0): periodic in x, clamped
    in y (the reference's x-wrap + pole clamp, res_domain.f90:155-256)."""
    ys = np.clip(np.arange(y0, y0 + ny), 0, layout_il - 1)
    xs = np.arange(x0, x0 + nx) % layout_ix
    return (ys[:, None] * layout_ix + xs[None, :]).ravel()


def build_layout(ix: int = 96, il: int = 48, kx: int = 8, nvars: int = 4,
                 resx: int = 2, resy: int = 2, overlap: int = 1,
                 nz_slabs: int = 1, vert_overlap: int = 1,
                 use_logp: bool = True, use_precip: bool = True,
                 use_sst: bool = True, use_tisr: bool = True,
                 use_ohtc: bool = False,
                 radang_deg: np.ndarray | None = None) -> RegionLayout:
    nregx = ix // resx
    nregy = il // resy
    assert kx % nz_slabs == 0, "kx must divide into nz_slabs"
    kz_core = kx // nz_slabs
    vo = vert_overlap if nz_slabs > 1 else 0
    inpz = kz_core + 2 * vo
    nz = nz_slabs
    R = nregx * nregy * nz
    inpx = resx + 2 * overlap
    inpy = resy + 2 * overlap

    # global supervector: [atmo3d (nvars,kx,il,ix) | logp | precip | sst | tisr]
    ngp = il * ix
    gv_sizes = {}
    pos = 0
    gv_sizes["atmo3d"] = (pos, pos + nvars * kx * ngp)
    pos += nvars * kx * ngp
    for name, used in (("logp", use_logp), ("precip", use_precip),
                       ("sst", use_sst), ("tisr", use_tisr),
                       ("ohtc", use_ohtc)):
        ln = ngp if used else 0
        gv_sizes[name] = (pos, pos + ln)
        pos += ln
    gv_len = pos

    # per-region input index maps; input layout matches the reference
    # (mod_reservoir.f90:502-547): [atmo3d var-fastest | logp | precip | sst
    # | tisr], atmo3d flattened (var, x, y, z) Fortran-order var fastest.
    npatch = inpy * inpx
    n_atmo = nvars * inpz * npatch
    sizes = {}
    p = 0
    sizes["atmo3d"] = (p, p + n_atmo); p += n_atmo
    for name, used in (("logp", use_logp), ("precip", use_precip),
                       ("sst", use_sst), ("tisr", use_tisr),
                       ("ohtc", use_ohtc)):
        ln = npatch if used else 0
        sizes[name] = (p, p + ln); p += ln
    n_in = p

    n_out_atmo = nvars * kz_core * resx * resy
    out_sizes = {"atmo3d": (0, n_out_atmo)}
    p = n_out_atmo
    if use_logp:
        out_sizes["logp"] = (p, p + resx * resy); p += resx * resy
    if use_precip:
        out_sizes["precip"] = (p, p + resx * resy); p += resx * resy
    n_out = p

    input_index = np.empty((R, n_in), dtype=np.int32)
    target_index = np.empty((R, n_out), dtype=np.int32)
    lat_region = np.zeros((R, 2))
    if radang_deg is None:
        radang_deg = np.linspace(-87, 87, il)

    a0 = gv_sizes["atmo3d"][0]

    def atmo_section(patch_yx, py, px, zlevels):
        """Gather indices for an atmo3d patch in the var-fastest layout
        flat[v + nvars*(xx + px*(yy + py*zz))] (mod_reservoir.f90:506-517);
        zlevels[zz] = absolute sigma level."""
        nzp = len(zlevels)
        sec = np.empty(nvars * nzp * py * px, dtype=np.int32)
        for zz, iz in enumerate(zlevels):
            for yy in range(py):
                for xx in range(px):
                    base = patch_yx[yy, xx]
                    for v in range(nvars):
                        sec[v + nvars * (xx + px * (yy + py * zz))] = (
                            a0 + (v * kx + iz) * ngp + base)
        return sec

    nh = nregy * nregx
    for r in range(R):
        rz, rh = divmod(r, nh)
        ry, rx = divmod(rh, nregx)
        y0 = ry * resy - overlap
        x0 = rx * resx - overlap
        z_core = np.arange(rz * kz_core, (rz + 1) * kz_core)
        z_in = np.clip(np.arange(rz * kz_core - vo,
                                 (rz + 1) * kz_core + vo), 0, kx - 1)

        patch = _patch_indices(il, ix, y0, x0, inpy, inpx)  # (npatch,) y-major
        input_index[r, sizes["atmo3d"][0]:sizes["atmo3d"][1]] = atmo_section(
            patch.reshape(inpy, inpx), inpy, inpx, z_in)
        for name in ("logp", "precip", "sst", "tisr", "ohtc"):
            s0, s1 = sizes[name]
            if s1 > s0:
                g0, _ = gv_sizes[name]
                input_index[r, s0:s1] = g0 + patch

        # target/core map (no halo): tile_full_input_to_target_data analog
        # (res_domain.f90:602-689)
        core = _patch_indices(il, ix, ry * resy, rx * resx, resy, resx)
        target_index[r, out_sizes["atmo3d"][0]:out_sizes["atmo3d"][1]] = (
            atmo_section(core.reshape(resy, resx), resy, resx, z_core))
        for name in ("logp", "precip"):
            if name in out_sizes:
                t0, t1 = out_sizes[name]
                g0, _ = gv_sizes[name]
                target_index[r, t0:t1] = g0 + core

        lat0 = radang_deg[min(max(ry * resy, 0), il - 1)]
        lat1 = radang_deg[min(ry * resy + resy - 1, il - 1)]
        lat_region[r] = (lat0, lat1)

    return RegionLayout(ix=ix, il=il, kx=kx, nvars=nvars, resx=resx,
                        resy=resy, overlap=overlap, nregx=nregx, nregy=nregy,
                        nz=nz, kz_core=kz_core, inpz=inpz, vert_overlap=vo,
                        R=R, inpx=inpx, inpy=inpy, input_index=input_index,
                        target_index=target_index,
                        n_in=n_in, n_out=n_out, sizes=sizes,
                        out_sizes=out_sizes, lat_region_deg=lat_region,
                        gv_sizes=gv_sizes, gv_len=gv_len)


# ----------------------------------------------------------------------
# pack / unpack (jittable)
# ----------------------------------------------------------------------
def pack_global(layout: RegionLayout, atmo3d, logp=None, precip=None,
                sst=None, tisr=None, ohtc=None):
    """Assemble the global supervector from grid fields.

    atmo3d: (nvars, kx, il, ix); 2-D fields (il, ix) or None.
    """
    parts = [atmo3d.reshape(-1)]
    for name, arr in (("logp", logp), ("precip", precip), ("sst", sst),
                      ("tisr", tisr), ("ohtc", ohtc)):
        s0, s1 = layout.gv_sizes[name]
        if s1 > s0:
            assert arr is not None, f"{name} required by layout"
            parts.append(arr.reshape(-1))
    return jnp.concatenate(parts)


def gather_inputs(layout: RegionLayout, gv):
    """Global supervector -> per-region input vectors (R, n_in): ONE gather
    (replaces tileoverlapgrid* + MPI scatter, res_domain.f90:294-545)."""
    return gv[jnp.asarray(layout.input_index)]


def scatter_outputs(layout: RegionLayout, outvec):
    """Per-region output vectors (R, n_out) -> global grid fields.

    Returns (atmo3d (nvars, kx, il, ix), logp, precip) — pure reshapes since
    region cores tile the grid (replaces
    tile_full_grid_with_local_state_vec_res1d, res_domain.f90:791-850).
    For nz > 1 slabs, 2-D fields come from the BOTTOM slab (rz = nz-1).
    """
    L = layout
    s0, s1 = L.out_sizes["atmo3d"]
    # region output atmo3d ordering: v + nvars*(xx + resx*(yy + resy*z))
    a = outvec[:, s0:s1].reshape(L.nz, L.nregy, L.nregx, L.kz_core, L.resy,
                                 L.resx, L.nvars)
    # -> (nvars, nz, kz_core, nregy, resy, nregx, resx) -> (nvars, kx, il, ix)
    atmo = a.transpose(6, 0, 3, 1, 4, 2, 5).reshape(L.nvars, L.kx, L.il,
                                                    L.ix)

    def unpack2d(name):
        if name not in L.out_sizes:
            return None
        t0, t1 = L.out_sizes[name]
        nh = L.nregy * L.nregx
        g = outvec[(L.nz - 1) * nh:, t0:t1].reshape(L.nregy, L.nregx,
                                                    L.resy, L.resx)
        return g.transpose(0, 2, 1, 3).reshape(L.il, L.ix)

    return atmo, unpack2d("logp"), unpack2d("precip")
