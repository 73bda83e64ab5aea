"""Sharded-reservoir scaling validation on a virtual device mesh.

Measures the batched ESN training-accumulation step at 1/2/4/8 (virtual CPU)
devices with regions sharded over dp — the mechanical validation of the
multi-chip path (real multi-card scaling is measured on the cards, by
`python chip_smoke.py --multichip`). On a virtual mesh all
"devices" share the same cores, so the expected curve is FLAT wall-time as
device count grows (work is fixed, parallelism is simulated); what this
script actually validates is that sharded execution has no hidden
serialization or replication blow-ups.

Usage: JAX_PLATFORMS=cpu python scripts/bench_scaling.py
"""

import os
import sys
import time

sys.path.insert(0, ".")

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main():
    from speedyml.parallel.mesh import (make_mesh, region_sharding,
                                        series_sharding, shard_params,
                                        state_sharding)
    from speedyml.reservoir.generate import generate_esn
    from speedyml.reservoir.training import (drive_and_accumulate,
                                             init_normal_eq)

    R, n_in, n_out, T, chunk = 32, 48, 16, 64, 16
    params0 = generate_esn(0, R, n_in, n_out, n_model=n_out,
                           m_target=4 * n_in, deg=4)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.normal(size=(T, R, n_in)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(T, R, n_out)), jnp.float32)
    m = jnp.asarray(rng.normal(size=(T, R, n_out)), jnp.float32)

    results = {}
    for nd in (1, 2, 4, 8):
        mesh = make_mesh(nd, tp=1)
        sp = shard_params(params0, mesh)
        us = jax.device_put(u, series_sharding(mesh))
        ys = jax.device_put(y, series_sharding(mesh))
        ms = jax.device_put(m, series_sharding(mesh))
        acc = init_normal_eq(sp, n_out)
        acc = jax.tree.map(
            lambda a: jax.device_put(a, region_sharding(mesh)), acc)
        acc = acc._replace(x=jax.device_put(acc.x, state_sharding(mesh)))
        f = jax.jit(lambda a, uu, yy, mm: drive_and_accumulate(
            sp, a, uu, yy, mm, chunk=chunk))
        out = f(acc, us, ys, ms)
        np.asarray(out.ss_hi[0, 0, :2])      # true sync
        t0 = time.perf_counter()
        for _ in range(3):
            out = f(acc, us, ys, ms)
        np.asarray(out.ss_hi[0, 0, :2])
        results[nd] = (time.perf_counter() - t0) / 3
        print(f"devices={nd}: {results[nd]*1e3:8.1f} ms/drive "
              f"(regions/device: {R // nd})")

    base = results[1]
    print("relative wall vs 1 device:",
          {k: round(v / base, 3) for k, v in results.items()})
    print("OK: sharded execution scales without serialization blow-up"
          if results[8] < 2.0 * base else
          "WARNING: sharded execution much slower than single device")


if __name__ == "__main__":
    main()
