"""Perf experiment: dycore ensemble throughput vs ensemble width and matmul
precision (f32 vs bf16 matmul inputs), with a drift check against the
f32 path so a faster-but-wrong configuration can't win.

Usage: python scripts/bench_sweep.py [--steps 96] [--chunks 3]
"""

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=96)
    ap.add_argument("--chunks", type=int, default=3)
    ap.add_argument("--ens", type=int, nargs="*", default=[64, 128, 256, 512])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from speedyml.core.config import ModelConfig
    from speedyml.dynamics.core import Dycore
    from speedyml.dynamics.initial import rest_state

    cfg = ModelConfig(dtype="float32")
    dy = Dycore(cfg)                  # flat aquaplanet surface
    state0 = dy.stepone(rest_state(dy), dy.zero_forcing())
    forcing = dy.zero_forcing()
    gp = cfg.ix * cfg.il * cfg.kx
    nsteps = args.steps

    def sync(s):
        np.asarray(s.ps[..., 0, 0, 0])

    def build(ens, precision):
        def step_one(s):
            return dy.step(s, forcing, 1, 1, "delt2")

        def run_chunk(s):
            def body(ss, _):
                return jax.vmap(step_one)(ss), None
            s, _ = jax.lax.scan(body, s, None, length=nsteps)
            return s

        def run(s):
            with jax.default_matmul_precision(precision):
                return run_chunk(s)

        state = jax.tree.map(
            lambda x: jnp.broadcast_to(x[None], (ens,) + x.shape) + 0.0,
            state0)
        return jax.jit(run), state

    results = {}
    for precision in ("float32", "bfloat16"):
        for ens in args.ens:
            run, state = build(ens, precision)
            state = run(state)
            sync(state)  # compile+warm
            t0 = time.perf_counter()
            for _ in range(args.chunks):
                state = run(state)
            sync(state)
            dt = time.perf_counter() - t0
            gps = ens * nsteps * args.chunks * gp / dt
            # sanity: finite and bounded after (chunks+1)*nsteps steps
            ps = np.asarray(state.ps[:, 0])
            ok = np.isfinite(ps).all() and float(np.abs(ps).max()) < 1.0
            results[(precision, ens)] = (gps, ok)
            print(f"precision={precision:9s} ens={ens:4d}: "
                  f"{gps:.3e} gp-steps/s  bounded={ok}", flush=True)

    # drift of bf16 vs f32 at the smallest width over one chunk
    ens = args.ens[0]
    run32, s32 = build(ens, "float32")
    runbf, sbf = build(ens, "bfloat16")
    s32, sbf = run32(s32), runbf(sbf)
    t32 = np.asarray(s32.t[:, 0])
    tbf = np.asarray(sbf.t[:, 0])
    rms = float(np.sqrt(np.mean((t32 - tbf) ** 2)))
    print(f"bf16 vs f32 temperature RMS drift after {nsteps} steps: "
          f"{rms:.4f} K (field std {float(t32.std()):.2f} K)")


if __name__ == "__main__":
    main()
