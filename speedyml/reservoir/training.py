"""Ridge-regression training of the batched reservoirs.

Re-design of the reference's chunked normal-equation accumulation + LAPACK
solve (src/mod_reservoir.f90:963-1334, src/mod_linalg.f90:109-151):

  * The time loop is a lax.scan over CHUNKS: each chunk collects its
    reservoir states and folds them into the normal equations with one
    batched GEMM (the reference's DGEMM, mod_reservoir.f90:1645-1701).
  * The normal equations are ill-conditioned and need better-than-f32
    accumulation (the reference compiles everything real*8). The
    accumulators are COMPENSATED double-float (two-sum) pairs: an (hi, lo)
    f32 pair per entry giving ~2^-48 effective precision from f32 ops.
  * Multiplicative Gaussian input noise (mod_utilities.f90:1387-1410) is
    generated on device with jax.random.
  * The ridge solve runs in float64, on the host (ridge_solve) or on the
    device (ridge_solve_device, which scopes x64 to the solve itself).
"""

from __future__ import annotations

import functools as _functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .esn import EsnParams, advance, nonlinear_state


def _two_sum(hi, lo, delta):
    """Compensated accumulation: (hi, lo) += delta exactly to ~2 ulps^2."""
    s = hi + delta
    v = s - hi
    e = (hi - (s - v)) + (delta - v)
    return s, lo + e


def accumulate_chunk(hi, lo, aug):
    """(hi, lo) += sum_t aug[t]^T aug[t] per region, compensated.
    aug: (chunk, R, na); hi/lo: (R, na, na)."""
    return _two_sum(hi, lo, jnp.einsum("tra,trb->rab", aug, aug))


class NormalEq(NamedTuple):
    ss_hi: jax.Array   # (R, na, na) sum of aug aug^T (leading part)
    ss_lo: jax.Array   # compensation part
    sy_hi: jax.Array   # (R, n_out, na) sum of target aug^T
    sy_lo: jax.Array
    x: jax.Array       # (R, n) carried reservoir state


def init_normal_eq(params: EsnParams, n_out: int,
                   dtype=jnp.float32) -> NormalEq:
    R = params.win.shape[0]
    na = params.n_model + params.n
    z = lambda *s: jnp.zeros(s, dtype)
    return NormalEq(ss_hi=z(R, na, na), ss_lo=z(R, na, na),
                    sy_hi=z(R, n_out, na), sy_lo=z(R, n_out, na),
                    x=z(R, params.n))


def _add_noise(inputs, noise_mag, rng_key):
    noise = jax.random.normal(rng_key, inputs.shape, inputs.dtype)
    return inputs + noise * noise_mag * inputs


def drive_and_accumulate(params: EsnParams, acc: NormalEq, inputs, targets,
                         model_states=None, noise_mag: float = 0.0,
                         rng_key=None, chunk: int = 128):
    """Run the reservoir over a training series, accumulating normal equations.

    inputs:  (T, R, n_in) standardized input series u(t), t = 0..T-1
    targets: (T, R, n_out) truth at t+1 (already shifted by the caller)
    model_states: (T, R, n_model) imperfect-model forecast valid at t+1
    noise_mag: multiplicative input noise magnitude (training only)
    chunk: timesteps per GEMM block; T is truncated to a multiple of chunk.

    The (state-after-u(t), target(t+1)) pairing matches the reference's
    chunked layer (mod_reservoir.f90:1004-1065).
    """
    dt = acc.x.dtype
    # two-step convert: device_put at the HOST dtype (callers may hand
    # float16 series to halve the host->device transfer — train_hybrid
    # upload_dtype), then cast to the compute dtype ON DEVICE
    inputs = jnp.asarray(inputs).astype(dt)
    targets = jnp.asarray(targets).astype(dt)
    if model_states is not None:
        model_states = jnp.asarray(model_states).astype(dt)
    if noise_mag > 0.0:
        assert rng_key is not None
        inputs = _add_noise(inputs, noise_mag, rng_key)

    T = inputs.shape[0]
    chunk = min(chunk, T)
    nchunks = T // chunk
    if nchunks == 0:
        raise ValueError(f"no training data: T={T} < chunk={chunk}")
    Tc = nchunks * chunk
    inputs = inputs[:Tc].reshape(nchunks, chunk, *inputs.shape[1:])
    targets = targets[:Tc].reshape(nchunks, chunk, *targets.shape[1:])
    if model_states is not None:
        model_states = model_states[:Tc].reshape(
            nchunks, chunk, *model_states.shape[1:])

    def make_aug(x, u_blk, m_blk):
        def step(x, u):
            x = advance(params, x, u)
            return x, nonlinear_state(x)

        x, xt_blk = jax.lax.scan(step, x, u_blk)      # xt_blk (chunk, R, n)
        if m_blk is not None:
            aug = jnp.concatenate([m_blk, xt_blk], axis=-1)
        else:
            aug = xt_blk
        return x, aug

    xs = (inputs, targets) if model_states is None else (
        inputs, targets, model_states)

    def chunk_body(carry, blk):
        x, ss_hi, ss_lo, sy_hi, sy_lo = carry
        m_blk = blk[2] if model_states is not None else None
        x, aug = make_aug(x, blk[0], m_blk)
        ss_hi, ss_lo = accumulate_chunk(ss_hi, ss_lo, aug)
        sy_d = jnp.einsum("tro,tra->roa", blk[1], aug)
        sy_hi, sy_lo = _two_sum(sy_hi, sy_lo, sy_d)
        return (x, ss_hi, ss_lo, sy_hi, sy_lo), None

    carry = (acc.x, acc.ss_hi, acc.ss_lo, acc.sy_hi, acc.sy_lo)
    (x, ss_hi, ss_lo, sy_hi, sy_lo), _ = jax.lax.scan(chunk_body, carry, xs)
    return NormalEq(ss_hi=ss_hi, ss_lo=ss_lo, sy_hi=sy_hi, sy_lo=sy_lo, x=x)


def drive_discard(params: EsnParams, x, inputs, noise_mag: float = 0.0,
                  rng_key=None):
    """Discard/spin-up phase: advance only (mod_reservoir.f90:983-996)."""
    inputs = jnp.asarray(inputs).astype(x.dtype)
    if noise_mag > 0.0:
        inputs = _add_noise(inputs, noise_mag, rng_key)

    def body(x, u):
        return advance(params, x, u), None

    x, _ = jax.lax.scan(body, x, inputs)
    return x


def _ridge_diag_rhs(ss, sy, xp, n_model, beta_res, beta_model, prior_val,
                    use_prior):
    """Shared ridge assembly: add the beta diagonal (beta with no prior,
    beta^2 with — fit_chunk_hybrid, mod_reservoir.f90:1235-1334) and the
    prior RHS. xp = numpy or jax.numpy."""
    na = ss.shape[-1]
    diag = xp.full((na,), beta_res if not use_prior else beta_res**2,
                   ss.dtype)
    if n_model > 0:
        if xp is np:
            diag[:n_model] = beta_model if not use_prior else beta_model**2
        else:
            diag = diag.at[:n_model].set(
                beta_model if not use_prior else beta_model**2)
    ss = ss + xp.diag(diag)[None]
    if use_prior and n_model > 0:
        n_out = sy.shape[1]
        k = min(n_model, n_out)
        if xp is np:
            sy = sy.copy()
            sy[:, np.arange(k), np.arange(k)] += prior_val * beta_model**2
        else:
            import jax.numpy as jnp
            sy = sy.at[:, jnp.arange(k), jnp.arange(k)].add(
                prior_val * beta_model**2)
    return ss, sy


def ridge_solve_device(acc: NormalEq, n_model: int, beta_res: float,
                       beta_model: float, prior_val: float = 0.0,
                       use_prior: bool = False,
                       sub_batch: int = 2) -> "jax.Array":
    """On-device f64 ridge solve: promote the compensated (hi, lo) f32
    accumulators to f64 ON DEVICE, Cholesky-factor (the system is SPD +
    ridge), and solve, so the (R, na, na) normal equations never cross to
    the host. Same math as ridge_solve; returns wout (R, n_out, na) float32
    ON DEVICE. x64 is enabled for the solve only, so the caller's process
    keeps its own dtype defaults.

    sub_batch: regions factored per solve launch — the blocked f64 Cholesky
    holds several (r, na, na) f64 copies live.
    """
    solve = _device_solver(n_model, beta_res, beta_model, prior_val,
                           use_prior)
    R = acc.ss_hi.shape[0]
    with jax.enable_x64(True):
        if R <= sub_batch:
            return solve(acc.ss_hi, acc.ss_lo, acc.sy_hi, acc.sy_lo)
        parts = []
        for i in range(0, R, sub_batch):
            j = min(i + sub_batch, R)
            parts.append(solve(acc.ss_hi[i:j], acc.ss_lo[i:j],
                               acc.sy_hi[i:j], acc.sy_lo[i:j]))
        return jnp.concatenate(parts, axis=0)


@_functools.lru_cache(maxsize=8)
def _device_solver(n_model, beta_res, beta_model, prior_val, use_prior):
    @jax.jit
    def solve(ss_hi, ss_lo, sy_hi, sy_lo):
        ss = ss_hi.astype(jnp.float64) + ss_lo.astype(jnp.float64)
        sy = sy_hi.astype(jnp.float64) + sy_lo.astype(jnp.float64)
        ss = 0.5 * (ss + jnp.swapaxes(ss, 1, 2))   # exact symmetry for chol
        ss, sy = _ridge_diag_rhs(ss, sy, jnp, n_model, beta_res, beta_model,
                                 prior_val, use_prior)
        c = jnp.linalg.cholesky(ss)
        wt = jax.scipy.linalg.cho_solve((c, True), jnp.swapaxes(sy, 1, 2))
        return jnp.swapaxes(wt, 1, 2).astype(jnp.float32)

    return solve


def ridge_solve(acc: NormalEq, n_model: int, beta_res: float,
                beta_model: float, prior_val: float = 0.0,
                use_prior: bool = False) -> np.ndarray:
    """Solve (SS + B) Wout^T = SY^T per region, in float64 on the host
    (fit_chunk_hybrid/ml, mod_reservoir.f90:1177-1334).

    Returns wout (R, n_out, na) float64 -> cast by caller.
    """
    ss = np.asarray(acc.ss_hi, np.float64) + np.asarray(acc.ss_lo, np.float64)
    sy = np.asarray(acc.sy_hi, np.float64) + np.asarray(acc.sy_lo, np.float64)
    ss, sy = _ridge_diag_rhs(ss, sy, np, n_model, beta_res, beta_model,
                             prior_val, use_prior)
    wout = np.linalg.solve(ss, np.swapaxes(sy, 1, 2))   # (R, na, n_out)
    return np.swapaxes(wout, 1, 2)
