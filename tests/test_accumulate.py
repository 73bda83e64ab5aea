"""Normal-equation accumulation (reservoir.training): the compensated XLA
path and its invariance to the chunk size."""

import jax.numpy as jnp
import numpy as np
import pytest

from speedyml.reservoir.training import accumulate_chunk


def test_compensation_improves_precision():
    """The hi/lo pair tracks many tiny increments that plain f32 loses."""
    rng = np.random.default_rng(1)
    R, na = 1, 64
    hi = jnp.full((R, na, na), 1e6, jnp.float32)
    lo = jnp.zeros((R, na, na), jnp.float32)
    ref64 = np.full((na, na), 1e6, np.float64)
    plain = np.full((na, na), 1e6, np.float32)
    for _ in range(20):
        aug = jnp.asarray(rng.normal(size=(8, R, na)) * 0.01, jnp.float32)
        hi, lo = accumulate_chunk(hi, lo, aug)
        a64 = np.asarray(aug, np.float64)
        d = np.einsum("tra,trb->rab", a64, a64)[0]
        ref64 += d
        plain = (plain + d.astype(np.float32)).astype(np.float32)
    tot = np.asarray(hi, np.float64)[0] + np.asarray(lo, np.float64)[0]
    err_comp = np.abs(tot - ref64).max()
    err_plain = np.abs(plain.astype(np.float64) - ref64).max()
    assert err_comp < err_plain / 4, (err_comp, err_plain)


def test_accumulate_chunk_matches_einsum():
    rng = np.random.default_rng(2)
    aug = jnp.asarray(rng.normal(size=(16, 3, 40)), jnp.float32)
    hi0 = jnp.asarray(rng.normal(size=(3, 40, 40)), jnp.float32)
    hi, lo = accumulate_chunk(hi0, jnp.zeros_like(hi0), aug)
    a64 = np.asarray(aug, np.float64)
    want = np.asarray(hi0, np.float64) + np.einsum("tra,trb->rab", a64, a64)
    np.testing.assert_allclose(np.asarray(hi, np.float64)
                               + np.asarray(lo, np.float64), want,
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("chunk", [8, 24])
def test_drive_and_accumulate_chunk_invariant(chunk):
    """Two chunk sizes that cover the same samples give the same normal
    equations and final state (chunking is an execution detail)."""
    from speedyml.reservoir.generate import generate_esn
    from speedyml.reservoir.training import (drive_and_accumulate,
                                             init_normal_eq)

    rng = np.random.default_rng(3)
    params = generate_esn(1, R=3, n_in=8, n_out=4, n_model=4, m_target=16,
                          deg=3)
    T = 48
    u = jnp.asarray(rng.normal(size=(T, 3, 8)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(T, 3, 4)), jnp.float32)
    m = jnp.asarray(rng.normal(size=(T, 3, 4)), jnp.float32)
    acc0 = init_normal_eq(params, 4)
    ref = drive_and_accumulate(params, acc0, u, y, m, chunk=T)
    got = drive_and_accumulate(params, acc0, u, y, m, chunk=chunk)
    tot = lambda a, b: np.asarray(a, np.float64) + np.asarray(b, np.float64)
    np.testing.assert_allclose(tot(got.ss_hi, got.ss_lo),
                               tot(ref.ss_hi, ref.ss_lo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tot(got.sy_hi, got.sy_lo),
                               tot(ref.sy_hi, ref.sy_lo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               rtol=1e-6, atol=1e-7)


def test_device_solve_scopes_x64_itself():
    """ridge_solve_device works in a process without global x64 and leaves
    the setting as it found it."""
    import jax

    from speedyml.reservoir.generate import generate_esn
    from speedyml.reservoir.training import (drive_and_accumulate,
                                             init_normal_eq, ridge_solve,
                                             ridge_solve_device)

    rng = np.random.default_rng(5)
    params = generate_esn(2, R=2, n_in=6, n_out=3, n_model=0, m_target=24,
                          deg=3)
    u = jnp.asarray(rng.normal(size=(64, 2, 6)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(64, 2, 3)), jnp.float32)
    acc = drive_and_accumulate(params, init_normal_eq(params, 3), u, y,
                               chunk=16)
    with jax.enable_x64(False):
        w = ridge_solve_device(acc, 0, 1e-3, 1.0)
        assert not jax.config.read("jax_enable_x64")
    assert w.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(w, np.float64),
                               ridge_solve(acc, 0, 1e-3, 1.0),
                               rtol=1e-4, atol=1e-5)


def test_device_solve_of_region_sharded_accumulators():
    """Region-sharded normal equations (the dp layout of parallel/mesh.py)
    solve to the single-device result."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from speedyml.parallel.mesh import make_mesh
    from speedyml.reservoir.generate import generate_esn
    from speedyml.reservoir.training import (drive_and_accumulate,
                                             init_normal_eq,
                                             ridge_solve_device)

    mesh = make_mesh(4)
    rng = np.random.default_rng(6)
    params = generate_esn(3, R=8, n_in=6, n_out=3, n_model=3, m_target=24,
                          deg=3)
    u, y, m = (jnp.asarray(rng.normal(size=(64, 8, k)), jnp.float32)
               for k in (6, 3, 3))
    acc = drive_and_accumulate(params, init_normal_eq(params, 3), u, y, m,
                               chunk=16)
    sharded = jax.device_put(acc, NamedSharding(mesh, P("dp")))
    want = np.asarray(ridge_solve_device(acc, 3, 1e-3, 1.0))
    got = np.asarray(ridge_solve_device(sharded, 3, 1e-3, 1.0))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
