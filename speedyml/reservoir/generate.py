"""Host-side reservoir generation: adjacency, spectral radius, input weights.

Replaces the reference's makesparse + ARPACK largest-eigenvalue solve +
rescale (src/mod_linalg.f90:180-218, 220-514; src/mod_reservoir.f90:182-212)
with a fixed-degree random ELL graph and vectorized numpy power iteration —
only the largest |eigenvalue| is needed, so Arnoldi is unnecessary.
"""

from __future__ import annotations

import numpy as np


def make_ell_adjacency(rng: np.random.Generator, R: int, n: int, deg: int):
    """Random fixed-degree adjacency: each row has `deg` uniform(0,1) entries
    at uniform random columns. Same density deg/n and value distribution as
    the reference's shuffled COO (mod_linalg.f90:180-218)."""
    idx = rng.integers(0, n, size=(R, n, deg), dtype=np.int32)
    val = rng.uniform(0.0, 1.0, size=(R, n, deg))
    return idx, val


def ring_shifts(n: int, deg: int) -> np.ndarray:
    """Deterministic circulant shifts for the fast-path topology
    ("ring with random jumps"): deg distinct shifts in [1, n-1], a pure
    function of (n, deg) ONLY — every region, block, and resumed run with
    the same reservoir geometry shares them (required both to batch the
    shifted-slice matvec across regions and to combine separately-generated
    region blocks into one EsnParams)."""
    rs = np.random.default_rng(0x5EED + 1000003 * deg + n)
    shifts = set([1])                      # include the plain ring edge
    while len(shifts) < min(deg, n - 1):
        shifts.add(int(rs.integers(1, n)))
    out = np.sort(np.fromiter(shifts, np.int32, len(shifts)))
    if len(out) < deg:
        # tiny-n degenerate case (n <= deg, unit tests only): repeating
        # shifts creates duplicate parallel edges, so the effective degree
        # is < deg. Both spmv paths stay consistent; the full-degree
        # topology requires n > deg (reference scale: n ~ 5760 >> deg 6).
        out = np.resize(out, deg)
    return out.astype(np.int32)


def make_ring_adjacency(rng: np.random.Generator, R: int, n: int, deg: int):
    """Circulant-support adjacency: node i connects to (i + s_d) mod n for
    the deg shared shifts s_d, with per-(region, node, edge) uniform(0,1)
    values. Same degree/density and value distribution as make_ell_adjacency;
    the support is hardware-friendly (contiguous shifted slices instead of a
    random gather). Returns (idx, val, shifts)."""
    shifts = ring_shifts(n, deg)
    idx = ((np.arange(n, dtype=np.int64)[None, :, None]
            + shifts[None, None, :]) % n).astype(np.int32)
    idx = np.broadcast_to(idx, (R, n, deg)).copy()
    val = rng.uniform(0.0, 1.0, size=(R, n, deg))
    return idx, val, shifts


def shifts_from_ell(a_idx: np.ndarray):
    """Detect circulant structure in an ELL index array: returns the (deg,)
    shifts if a_idx[r, i, d] == (i + s_d) % n for all r, i (with s_d shared
    across regions), else None. Used on weight load so persisted/legacy ELL
    files recover the fast path without any schema change."""
    a_idx = np.asarray(a_idx)
    R, n, deg = a_idx.shape
    if n == 0:
        return None
    # out-of-range indices behave differently on the generic path (JAX
    # gather clamps) than mod-n wraparound would, so only well-formed
    # in-range indices qualify for the fast path
    if a_idx.min() < 0 or a_idx.max() >= n:
        return None
    s = a_idx[0, 0, :].astype(np.int64)
    want = (np.arange(n, dtype=np.int64)[None, :, None] + s[None, None, :]) % n
    if np.array_equal(a_idx, np.broadcast_to(want, a_idx.shape)):
        return s.astype(np.int32)
    return None


def spectral_radius_ell(idx: np.ndarray, val: np.ndarray,
                        iters: int = 200, seed: int = 0,
                        shifts=None) -> np.ndarray:
    """Largest |eigenvalue| per batched ELL matrix via power iteration.

    Returns (R,) radii. Vectorized over the batch in numpy. With `shifts`
    (circulant support, idx[r, i, d] == (i + shifts[d]) % n) the gather is
    deg contiguous rolls, which at reference scale is what keeps host-side
    generation small next to the device work of a training block.
    """
    R, n, deg = idx.shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, n))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    lam = np.ones(R)
    ridx = np.arange(R)[:, None, None]

    def matvec(x):
        if shifts is None:
            return (val * x[ridx, idx]).sum(axis=-1)
        y = val[:, :, 0] * np.roll(x, -int(shifts[0]), axis=1)
        for d in range(1, deg):
            y += val[:, :, d] * np.roll(x, -int(shifts[d]), axis=1)
        return y

    for _ in range(iters):
        y = matvec(x)
        lam = np.linalg.norm(y, axis=1)
        x = y / np.maximum(lam[:, None], 1e-30)
    return lam


def radius_by_lat(lat_min_deg: np.ndarray, lat_max_deg: np.ndarray,
                  highest_lat: float = 45.0, max_radius: float = 0.7,
                  min_radius: float = 0.3) -> np.ndarray:
    """Spectral radius as a function of region latitude
    (res_domain.f90:1623-1660): max_radius poleward of highest_lat, otherwise
    the reference's constant interior value (max-min)/highest_lat + min."""
    smallest = np.minimum(np.abs(lat_min_deg), np.abs(lat_max_deg))
    interior = (max_radius - min_radius) / highest_lat + min_radius
    return np.where(smallest >= highest_lat, max_radius, interior)


def make_win(rng: np.random.Generator, R: int, n: int, n_in: int,
             sigma: float) -> np.ndarray:
    """Block-diagonal input weights as a flat (R, n) vector: node j reads
    input j // q with weight sigma*U(-1,1) (mod_reservoir.f90:262-283)."""
    assert n % n_in == 0
    return sigma * rng.uniform(-1.0, 1.0, size=(R, n))


def generate_esn(seed: int, R: int, n_in: int, n_out: int, n_model: int,
                 m_target: int = 6000, deg: int = 6, sigma: float = 0.5,
                 leakage: float = 1.0, radii=None, dtype=np.float32,
                 topology: str = "ring"):
    """Full reservoir generation for R regions. Returns an EsnParams with a
    zero wout (trained later) plus the host copies.

    n is rounded to a multiple of n_in: n = round(m/n_in)*n_in
    (mod_reservoir.f90:169-172). topology: "ring" (circulant support, the
    fast path — the default) or "er" (the reference's Erdos-Renyi-style
    random support, generic gather path).
    """
    from .esn import EsnParams
    import jax.numpy as jnp

    q = max(1, int(round(m_target / n_in)))
    n = q * n_in
    rng = np.random.default_rng(seed)
    if topology == "ring":
        idx, val, shifts = make_ring_adjacency(rng, R, n, deg)
    else:
        idx, val = make_ell_adjacency(rng, R, n, deg)
        shifts = None
    lam = spectral_radius_ell(idx, val, shifts=shifts)
    if radii is None:
        radii = np.full(R, 0.9)
    val = val * (np.asarray(radii)[:, None, None] / lam[:, None, None])
    win = make_win(rng, R, n, n_in, sigma)
    wout = np.zeros((R, n_out, n_model + n), dtype=dtype)
    return EsnParams(
        a_idx=jnp.asarray(idx),
        a_val=jnp.asarray(val, dtype),
        win=jnp.asarray(win, dtype),
        wout=jnp.asarray(wout),
        node_map=jnp.asarray(np.arange(n) // q, np.int32),
        leakage=leakage,
        a_shift=None if shifts is None else jnp.asarray(shifts),
    )
