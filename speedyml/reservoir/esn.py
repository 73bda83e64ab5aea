"""Batched echo-state-network core.

Re-design of the reference's per-region reservoir
(src/mod_reservoir.f90, src/mod_linalg.f90): the 1152 independent
region/level reservoirs become ONE batched computation with a leading region
axis R, so every step is a handful of large fused array ops instead of 1152
MPI ranks each doing an MKL spmv.

Sparse adjacency: fixed-degree ELL format (idx/val (R, n, deg)) instead of
the reference's COO + MKL handle (mod_linalg.f90:10-25). Two execution paths:

- generic ELL: row-gather + small reduction (arbitrary COO, e.g. Zenodo
  trained weights, is padded row-wise into ELL on load);
- circulant-support fast path (`a_shift` set): when the graph is generated
  with node i -> (i + s_d) mod n for deg shared shifts s_d ("ring with
  random jumps", Rodan & Tino 2012-style), A @ x is deg shifted slices +
  multiplies — pure contiguous memory traffic instead of the generic path's
  40M-element gather at reference scale (1152 x 5760 x 6). This is the
  production default for self-generated reservoirs (the reference's ER
  topology is random only for convenience — the values, radius scaling, and
  degree are what set the dynamics; mod_linalg.f90:180-218).

Input weights: the reference's Win is block-diagonal with q = n/n_in
contiguous nodes per input column (mod_reservoir.f90:262-283), so Win @ u is
an elementwise multiply against the input broadcast q times — no matmul.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


_N_IN_CACHE: dict = {}   # id(node_map) -> (node_map, n_in); see EsnParams.n_in


class EsnParams(NamedTuple):
    """Batched reservoir parameters (leading axis R = regions[x levels]).

    Every field is a device array so the whole tuple can be passed as a jit
    ARGUMENT (embedding wout & co. as compile-time constants blows up the
    program: ~0.5 GB at full scale). node_map encodes the block-diagonal Win
    structure (node j reads input node_map[j] = j // q)."""

    a_idx: jax.Array     # (R, n, deg) int32 column indices
    a_val: jax.Array     # (R, n, deg) adjacency values (radius-scaled)
    win: jax.Array       # (R, n) block-diagonal input weights
    wout: jax.Array      # (R, n_out, n_model + n) readout
    node_map: jax.Array  # (n,) int32: node -> input index
    leakage: float
    # (deg,) int32 shared circulant shifts when a_idx[r,i,d] == (i+s_d)%n
    # for ALL regions (enables the roll fast path); None for arbitrary ELL
    a_shift: Optional[jax.Array] = None

    @property
    def n(self) -> int:
        return self.win.shape[-1]

    @property
    def n_in(self) -> int:
        # cached host-side: the node_map[-1] fetch is a device->host sync
        # (a stall if ever called in a loop).
        # Cache entries hold a reference to the array, so an id() can never
        # be reused while its entry is alive (identity-checked below).
        nm = self.node_map
        ent = _N_IN_CACHE.get(id(nm))
        if ent is not None and ent[0] is nm:
            return ent[1]
        import numpy as np
        v = int(np.asarray(nm[-1])) + 1
        _N_IN_CACHE[id(nm)] = (nm, v)
        return v

    @property
    def q(self) -> int:
        """Nodes per input (n = q * n_in). Host-side only."""
        return self.n // self.n_in

    @property
    def n_model(self) -> int:
        return self.wout.shape[-1] - self.win.shape[-1]


def spmv_ell(a_idx, a_val, x, a_shift=None):
    """Batched ELL sparse matvec: y[r, i] = sum_d val[r,i,d] * x[r, idx[r,i,d]].

    x: (R, n) -> (R, n). With a_shift (deg,) set (circulant support,
    idx[r,i,d] = (i + s_d) mod n), the gather becomes deg contiguous
    shifted slices — the fast path.
    """
    R, n, deg = a_idx.shape
    if a_shift is not None:
        xx = jnp.concatenate([x, x], axis=-1)          # (R, 2n) wraparound
        y = None
        for d in range(deg):
            col = jax.lax.dynamic_slice_in_dim(xx, a_shift[d], n, axis=1)
            t = a_val[:, :, d] * col
            y = t if y is None else y + t
        return y
    gathered = jnp.take_along_axis(x, a_idx.reshape(R, n * deg),
                                   axis=1).reshape(R, n, deg)
    return jnp.sum(a_val * gathered, axis=-1)


def win_apply(params: EsnParams, u):
    """Win @ u via the block structure: node j gets input node_map[j]."""
    u_rep = jnp.take(u, params.node_map, axis=-1)    # (R, n)
    return params.win * u_rep


def advance(params: EsnParams, x, u):
    """One reservoir update x <- (1-l)x + l*tanh(A x + Win u)
    (mod_reservoir.f90:1418-1435 core update)."""
    u = jnp.asarray(u, x.dtype)
    y = spmv_ell(params.a_idx, params.a_val, x, params.a_shift)
    x_new = jnp.tanh(y + win_apply(params, u))
    lk = params.leakage
    return (1.0 - lk) * x + lk * x_new


def nonlinear_state(x):
    """x~ with odd (0-based) nodes squared (reference squares 1-based even
    indices, mod_reservoir.f90:1029)."""
    sq = x * x
    mask = (jnp.arange(x.shape[-1]) % 2).astype(x.dtype)
    return x * (1.0 - mask) + sq * mask


def readout(params: EsnParams, x, model_vec=None):
    """outvec = Wout @ [model_vec; x~] (predict, mod_reservoir.f90:1446-1455).

    model_vec: (R, n_model) standardized imperfect-model forecast (hybrid) or
    None (ml_only; wout then has n_model == 0).
    """
    xt = nonlinear_state(x)
    if model_vec is not None and params.n_model > 0:
        aug = jnp.concatenate([model_vec, xt], axis=-1)
    else:
        aug = xt
    # wout may be kept in bfloat16 to halve the dominant memory stream of
    # the predict step (3.7 GB/step at reference scale) — see cast_wout. Only
    # in that case is aug rounded to the storage dtype; accumulation is at
    # least f32, and an f64 state (x64 processes) keeps an f64 readout.
    if params.wout.dtype == jnp.bfloat16:
        aug = aug.astype(jnp.bfloat16)
    pt = jnp.promote_types(jnp.float32, aug.dtype)
    return jnp.einsum("roa,ra->ro", params.wout, aug,
                      preferred_element_type=pt)


def cast_wout(params: EsnParams, dtype=jnp.bfloat16) -> EsnParams:
    """Readout weights in reduced-precision storage (f32 accumulation stays).

    At reference scale wout is 3.7 GB f32 and its memory stream dominates
    the predict step once the state update is on the circulant fast path;
    bfloat16 storage halves that traffic. Readout error is ~wout's rounding
    (|e| ~ 2^-8 relative per weight, averaging out over the 5896-term dot) —
    same acceptance rationale as the bf16 grid-compute fast path; keep f32
    for golden-value comparisons."""
    return params._replace(wout=params.wout.astype(dtype))


def readout_split(params: EsnParams, x, model_vec):
    """Readout decomposed into the SPEEDY (v_p) and reservoir (v_ml)
    contributions (mod_reservoir.f90:1458-1469), standardized space.

    Returns (outvec, v_ml, v_p) with outvec = v_p + v_ml.
    """
    n_model = params.wout.shape[-1] - params.win.shape[-1]
    xt = nonlinear_state(x)
    if params.wout.dtype == jnp.bfloat16:      # storage rounding only when
        xt = xt.astype(jnp.bfloat16)           # wout itself is bf16 (see
        model_vec = model_vec.astype(jnp.bfloat16)   # readout())
    pt = jnp.promote_types(jnp.float32, xt.dtype)
    v_ml = jnp.einsum("roa,ra->ro", params.wout[..., n_model:],
                      xt, preferred_element_type=pt)
    v_p = jnp.einsum("roa,ra->ro", params.wout[..., :n_model],
                     model_vec, preferred_element_type=pt)
    return v_p + v_ml, v_ml, v_p


def synchronize(params: EsnParams, x, inputs):
    """Drive the reservoir with a (T, R, n_in) series, no readout
    (mod_reservoir.f90:1354-1380)."""
    inputs = jnp.asarray(inputs, x.dtype)

    def body(x, u):
        return advance(params, x, u), None

    x, _ = jax.lax.scan(body, x, inputs)
    return x


def predict_step(params: EsnParams, x, feedback, model_vec=None):
    """One prediction step: advance with feedback, read out."""
    x = advance(params, x, feedback)
    return x, readout(params, x, model_vec)
