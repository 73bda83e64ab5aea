"""Trained-weight persistence.

Two formats:

1. **Batched native format** (one NetCDF-3 file): the whole trained hybrid
   model — ELL adjacency, win, wout, standardization stats, hyperparameters —
   in R-leading batched arrays, written/read in one shot. This is the
   batched replacement for the reference's 1152 per-worker files.

2. **Reference worker layout** (one file per region/level,
   `worker_%04d_level_%d_<trial>.nc` with variables win/wout/rows/cols/vals/
   mean/std — mod_reservoir.f90:1703-1738, mod_io.f90:2938-2983), for
   interchange with the reference ecosystem (Zenodo 10.5281/zenodo.7548902
   artifacts use this schema). COO <-> fixed-degree ELL conversion happens on
   load/save.

NetCDF-3 classic via scipy.io (no netCDF4 in the image); the reference's
files are NetCDF too so the variable schema carries over directly.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from scipy.io import netcdf_file


def _native(a: np.ndarray) -> np.ndarray:
    """NetCDF-3 data is big-endian; JAX needs native byte order."""
    a = np.asarray(a)
    return a.astype(a.dtype.newbyteorder("="))


# ----------------------------------------------------------------------
# native batched format
# ----------------------------------------------------------------------
def save_model(path: str, hm) -> None:
    """Write a trained HybridModel to one NetCDF-3 file."""
    from ..hybrid.experiment import HybridModel  # noqa: F401 (type only)

    p = hm.params
    stz = hm.stz
    host = getattr(hm, "host_np", None) or {}
    a_idx = host.get("a_idx", None)
    a_idx = np.asarray(p.a_idx) if a_idx is None else a_idx
    a_val = np.asarray(host.get("a_val", p.a_val))
    win = np.asarray(host.get("win", p.win))
    wout = np.asarray(host.get("wout", p.wout))
    R, n, deg = a_idx.shape

    f = netcdf_file(path, "w", version=2)
    try:
        # region is the UNLIMITED record dimension: scipy's netcdf packs the
        # per-variable vsize field as int32 (spec: 32-bit in CDF-1 and
        # CDF-2), so a fixed-shape wout (1152, 136, 5896) f32 = 3.7 GB
        # overflows it; as a record variable only the per-region record size
        # (3.2 MB) is packed and the total may exceed 4 GB
        f.createDimension("region", None)
        f.createDimension("node", n)
        f.createDimension("deg", deg)
        f.createDimension("n_out", wout.shape[1])
        f.createDimension("n_aug", wout.shape[2])
        f.createDimension("n_in", np.asarray(stz.in_mean).shape[1])

        def wv(name, dtype, dims, data):
            v = f.createVariable(name, dtype, dims)
            v[:] = data

        wv("a_idx", "i4", ("region", "node", "deg"), a_idx)
        wv("a_val", "f4", ("region", "node", "deg"), a_val)
        wv("win", "f4", ("region", "node"), win)
        wv("wout", "f4", ("region", "n_out", "n_aug"), wout)
        wv("in_mean", "f4", ("region", "n_in"), np.asarray(stz.in_mean))
        wv("in_std", "f4", ("region", "n_in"), np.asarray(stz.in_std))
        wv("out_mean", "f4", ("region", "n_out"), np.asarray(stz.out_mean))
        wv("out_std", "f4", ("region", "n_out"), np.asarray(stz.out_std))

        import dataclasses
        meta = dict(leakage=p.leakage, q=p.q, ml_only=int(hm.ml_only),
                    rcfg=dataclasses.asdict(hm.rcfg),
                    layout=dict(ix=hm.layout.ix, il=hm.layout.il,
                                kx=hm.layout.kx, nvars=hm.layout.nvars,
                                resx=hm.layout.resx, resy=hm.layout.resy,
                                overlap=hm.layout.overlap,
                                nz_slabs=hm.layout.nz,
                                vert_overlap=hm.layout.vert_overlap))
        f.meta_json = json.dumps(meta).encode()
    finally:
        f.close()


def load_model(path: str, radang_deg: Optional[np.ndarray] = None):
    """Read a trained HybridModel back (inverse of save_model)."""
    import jax.numpy as jnp

    from ..core.config import ReservoirConfig
    from ..domain.decomposition import build_layout
    from ..domain.standardize import Standardizer
    from ..hybrid.experiment import HybridModel
    from ..reservoir.esn import EsnParams

    f = netcdf_file(path, "r", mmap=False)
    try:
        meta = json.loads(bytes(f.meta_json).decode())

        g = lambda name: _native(f.variables[name][:])
        win = g("win")
        q = int(meta["q"])
        from ..reservoir.generate import shifts_from_ell
        a_idx = g("a_idx")
        shifts = shifts_from_ell(a_idx)     # recover the circulant fast path
        params = EsnParams(
            a_idx=jnp.asarray(a_idx),
            a_val=jnp.asarray(g("a_val"), jnp.float32),
            win=jnp.asarray(win, jnp.float32),
            wout=jnp.asarray(g("wout"), jnp.float32),
            node_map=jnp.asarray(np.arange(win.shape[1]) // q, np.int32),
            leakage=float(meta["leakage"]),
            a_shift=None if shifts is None else jnp.asarray(shifts))
        stz = Standardizer(
            in_mean=jnp.asarray(g("in_mean")), in_std=jnp.asarray(g("in_std")),
            out_mean=jnp.asarray(g("out_mean")),
            out_std=jnp.asarray(g("out_std")))
    finally:
        f.close()

    lo = meta["layout"]
    rcfg = ReservoirConfig(**meta["rcfg"])
    layout = build_layout(ix=lo["ix"], il=lo["il"], kx=lo["kx"],
                          nvars=lo["nvars"], resx=lo["resx"], resy=lo["resy"],
                          overlap=lo["overlap"],
                          nz_slabs=lo.get("nz_slabs", 1),
                          vert_overlap=lo.get("vert_overlap", 1),
                          radang_deg=radang_deg)
    # weight files persisted before the clamped-SST std floor existed carry
    # the collapsed (eps-scale) stds; flooring is idempotent and training-
    # equivalent (see standardize.SST_STD_FLOOR)
    from ..domain.standardize import floor_sst_std
    stz = floor_sst_std(stz, layout)
    return HybridModel(layout=layout, params=params, stz=stz, rcfg=rcfg,
                       ml_only=bool(meta["ml_only"]))


# ----------------------------------------------------------------------
# reference worker layout (per region/level files)
# ----------------------------------------------------------------------
def ell_to_coo(a_idx: np.ndarray, a_val: np.ndarray):
    """One region's ELL -> 1-based COO (rows, cols, vals), dropping zero
    padding entries."""
    n, deg = a_idx.shape
    rows = np.repeat(np.arange(n, dtype=np.int32), deg)
    cols = a_idx.reshape(-1).astype(np.int32)
    vals = a_val.reshape(-1).astype(np.float64)
    keep = vals != 0.0
    return rows[keep] + 1, cols[keep] + 1, vals[keep]


def coo_to_ell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int,
               deg: Optional[int] = None):
    """1-based COO -> fixed-degree ELL (pad with zero-valued self entries).
    Vectorized: slot = rank within row after a stable row sort (a Python
    per-entry loop is ~40M iterations over a full 1152-region import)."""
    rows0 = np.asarray(rows, np.int64) - 1
    cols0 = np.asarray(cols, np.int64) - 1
    counts = np.bincount(rows0, minlength=n)
    d = int(counts.max()) if deg is None else max(deg, int(counts.max()))
    a_idx = np.zeros((n, d), np.int32)
    a_val = np.zeros((n, d), np.float32)
    order = np.argsort(rows0, kind="stable")
    r_sorted = rows0[order]
    starts = np.zeros(len(r_sorted), np.int64)
    if len(r_sorted):
        first = np.r_[0, np.flatnonzero(np.diff(r_sorted)) + 1]
        starts[first] = first
        starts = np.maximum.accumulate(starts)
    slot = np.arange(len(r_sorted)) - starts
    a_idx[r_sorted, slot] = cols0[order]
    a_val[r_sorted, slot] = np.asarray(vals)[order]
    return a_idx, a_val


def export_worker_files(dirpath: str, hm, trial_name: str = "trial",
                        level_index: int = 1) -> None:
    """Write per-region files in the reference's schema
    (write_trained_res, mod_reservoir.f90:1703-1738): win (n, n_in) dense,
    wout (n_out, n_aug), COO rows/cols/vals (1-based), mean/std per
    (var-level | 2-D field) in the reference stat order."""
    os.makedirs(dirpath, exist_ok=True)
    p = hm.params
    L = hm.layout
    a_idx = np.asarray(p.a_idx)
    a_val = np.asarray(p.a_val)
    win = np.asarray(p.win)
    wout = np.asarray(p.wout)
    means, stds = _stats_to_reference_order(hm)
    n = win.shape[1]
    q = p.q
    n_in = n // q

    for r in range(L.R):
        rows, cols, vals = ell_to_coo(a_idx[r], a_val[r])
        win_dense = np.zeros((n, n_in))
        win_dense[np.arange(n), np.arange(n) // q] = win[r]
        fn = os.path.join(
            dirpath, f"worker_{r:04d}_level_{level_index}_{trial_name}.nc")
        f = netcdf_file(fn, "w")
        try:
            f.createDimension("win_x", n)
            f.createDimension("win_y", n_in)
            f.createDimension("wout_x", wout.shape[1])
            f.createDimension("wout_y", wout.shape[2])
            f.createDimension("rows_x", len(rows))
            f.createDimension("cols_x", len(cols))
            f.createDimension("vals_x", len(vals))
            f.createDimension("mean_x", means.shape[1])
            f.createDimension("std_x", stds.shape[1])

            def wv(name, dtype, dims, data):
                v = f.createVariable(name, dtype, dims)
                v[:] = data

            wv("win", "f8", ("win_x", "win_y"), win_dense)
            wv("wout", "f8", ("wout_x", "wout_y"), wout[r])
            wv("rows", "i4", ("rows_x",), rows)
            wv("cols", "i4", ("cols_x",), cols)
            wv("vals", "f8", ("vals_x",), vals)
            wv("mean", "f8", ("mean_x",), means[r])
            wv("std", "f8", ("std_x",), stds[r])
        finally:
            f.close()

    with open(os.path.join(dirpath, f"{trial_name}_controller_file.txt"),
              "w") as fh:
        rc = hm.rcfg
        fh.write("-" * 59 + "\n")
        for k, v in (("num_hor_regions", L.R), ("ml_only", hm.ml_only),
                     ("atmo_timestep", rc.timestep),
                     ("ocean_timestep", rc.timestep_slab),
                     ("precip_epsilon", rc.precip_epsilon),
                     ("full_predictvars", L.nvars),
                     ("full_heightlevels", L.kx), ("overlap", L.overlap),
                     ("reservoir_nodes", p.n), ("deg", a_idx.shape[-1]),
                     ("beta_res", rc.beta_res), ("beta_model", rc.beta_model),
                     ("sigma", rc.sigma), ("leakage", rc.leakage),
                     ("prior_val", rc.prior_val)):
            fh.write(f" {k}:{v}\n")
        fh.write("-" * 59 + "\n")


def _stats_to_reference_order(hm):
    """Our per-element Standardizer -> the reference's compact per-region
    stat vector [per-(var,level) atmo means | logp | precip | sst | tisr]
    (standardize_data, mod_utilities.f90:934-1040)."""
    L = hm.layout
    in_mean = np.asarray(hm.stz.in_mean)
    in_std = np.asarray(hm.stz.in_std)
    npatch = L.inpy * L.inpx
    s0, s1 = L.sizes["atmo3d"]
    # element (v + nvars*(xx + inpx*(yy + inpy*z))): stats constant over the
    # patch -> take patch position 0 for each (z, v)
    m3 = in_mean[:, s0:s1].reshape(L.R, L.inpz, npatch, L.nvars)[:, :, 0, :]
    s3 = in_std[:, s0:s1].reshape(L.R, L.inpz, npatch, L.nvars)[:, :, 0, :]
    # reference order: (var, level) var-major
    parts_m = [m3.transpose(0, 2, 1).reshape(L.R, -1)]
    parts_s = [s3.transpose(0, 2, 1).reshape(L.R, -1)]
    for name in ("logp", "precip", "sst", "tisr", "ohtc"):
        t0, t1 = L.sizes[name]
        if t1 > t0:
            parts_m.append(in_mean[:, t0:t0 + 1])
            parts_s.append(in_std[:, t0:t0 + 1])
    return np.concatenate(parts_m, 1), np.concatenate(parts_s, 1)


def _stats_from_reference_order(layout, means, stds):
    """Inverse of _stats_to_reference_order -> Standardizer."""
    import jax.numpy as jnp

    from ..domain.standardize import Standardizer

    L = layout
    R = L.R
    npatch = L.inpy * L.inpx
    nvl = L.nvars * L.inpz
    m3 = means[:, :nvl].reshape(R, L.nvars, L.inpz).transpose(0, 2, 1)
    s3 = stds[:, :nvl].reshape(R, L.nvars, L.inpz).transpose(0, 2, 1)
    in_mean = np.empty((R, L.n_in), np.float32)
    in_std = np.empty((R, L.n_in), np.float32)
    a0, a1 = L.sizes["atmo3d"]
    in_mean[:, a0:a1] = np.repeat(m3[:, :, None, :], npatch, 2).reshape(R, -1)
    in_std[:, a0:a1] = np.repeat(s3[:, :, None, :], npatch, 2).reshape(R, -1)
    k = nvl
    for name in ("logp", "precip", "sst", "tisr", "ohtc"):
        t0, t1 = L.sizes[name]
        if t1 > t0:
            in_mean[:, t0:t1] = means[:, k:k + 1]
            in_std[:, t0:t1] = stds[:, k:k + 1]
            k += 1
    out_mean = np.empty((R, L.n_out), np.float32)
    out_std = np.empty((R, L.n_out), np.float32)
    ncore = L.resy * L.resx
    o0, o1 = L.out_sizes["atmo3d"]
    mc = m3[:, L.vert_overlap:L.vert_overlap + L.kz_core, :]
    sc = s3[:, L.vert_overlap:L.vert_overlap + L.kz_core, :]
    out_mean[:, o0:o1] = np.repeat(mc[:, :, None, :], ncore, 2).reshape(R, -1)
    out_std[:, o0:o1] = np.repeat(sc[:, :, None, :], ncore, 2).reshape(R, -1)
    k = nvl
    for name in ("logp", "precip"):
        if name in L.out_sizes:
            u0, u1 = L.out_sizes[name]
            out_mean[:, u0:u1] = means[:, k:k + 1]
            out_std[:, u0:u1] = stds[:, k:k + 1]
            k += 1
    return Standardizer(in_mean=jnp.asarray(in_mean),
                        in_std=jnp.asarray(in_std),
                        out_mean=jnp.asarray(out_mean),
                        out_std=jnp.asarray(out_std))


def import_worker_files(dirpath: str, layout, rcfg, trial_name: str = "trial",
                        level_index: int = 1, ml_only: bool = False,
                        regions=None):
    """Read reference-schema per-worker files into a batched HybridModel
    (read_trained_res, mod_io.f90:2938-2983). regions: optional region-id
    subset (the batched model then covers only those rows)."""
    import jax.numpy as jnp

    from ..hybrid.experiment import HybridModel
    from ..reservoir.esn import EsnParams

    L = layout
    idxs, vals_l, wins, wouts, means, stds = [], [], [], [], [], []
    deg = None
    for r in (range(L.R) if regions is None else regions):
        fn = os.path.join(
            dirpath, f"worker_{r:04d}_level_{level_index}_{trial_name}.nc")
        f = netcdf_file(fn, "r", mmap=False)
        try:
            win_dense = _native(f.variables["win"][:])
            wout = _native(f.variables["wout"][:])
            rows = _native(f.variables["rows"][:])
            cols = _native(f.variables["cols"][:])
            vv = _native(f.variables["vals"][:])
            means.append(_native(f.variables["mean"][:]))
            stds.append(_native(f.variables["std"][:]))
        finally:
            f.close()
        n = win_dense.shape[0]
        a_idx, a_val = coo_to_ell(rows, cols, vv, n, deg)
        deg = a_idx.shape[1]
        idxs.append(a_idx)
        vals_l.append(a_val)
        # block-diagonal win: node j reads input j // q
        q = n // win_dense.shape[1]
        wins.append(win_dense[np.arange(n), np.arange(n) // q])
        wouts.append(wout)

    # pad every region to the common max degree
    dmax = max(a.shape[1] for a in idxs)
    idxs = [np.pad(a, ((0, 0), (0, dmax - a.shape[1]))) for a in idxs]
    vals_l = [np.pad(a, ((0, 0), (0, dmax - a.shape[1]))) for a in vals_l]

    n = idxs[0].shape[0]
    from ..reservoir.generate import shifts_from_ell
    a_idx_h = np.stack(idxs)
    shifts = shifts_from_ell(a_idx_h)
    params = EsnParams(a_idx=jnp.asarray(a_idx_h),
                       a_val=jnp.asarray(np.stack(vals_l), jnp.float32),
                       win=jnp.asarray(np.stack(wins), jnp.float32),
                       wout=jnp.asarray(np.stack(wouts), jnp.float32),
                       node_map=jnp.asarray(
                           np.arange(n) // (n // L.n_in), np.int32),
                       leakage=rcfg.leakage,
                       a_shift=None if shifts is None else jnp.asarray(shifts))
    stz = _stats_from_reference_order(L, np.stack(means), np.stack(stds))
    return HybridModel(layout=L, params=params, stz=stz, rcfg=rcfg,
                       ml_only=ml_only)
