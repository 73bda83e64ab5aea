"""Latitude-sharded step equivalence vs the replicated step (8-dev CPU mesh).

The scale-out design (parallel/spatial.py) must be bit-compatible-to-
tolerance with the single-device step: grid work sharded over latitude,
spectral replicated, one psum per forward transform.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from speedyml.core.config import ModelConfig
from speedyml.dynamics.core import Dycore
from speedyml.dynamics.initial import rest_state
from speedyml.parallel.spatial import SpatialDycore


@pytest.fixture(scope="module")
def mesh():
    devs = np.array(jax.devices()[:8])
    return Mesh(devs, ("lat",))


@pytest.fixture(scope="module")
def dycore(continent_boundary):
    return Dycore(ModelConfig(dtype="float64"), orog=continent_boundary.orog)


def _perturbed_state(dy, seed=0):
    """Rest state + smooth random perturbation (non-trivial dynamics)."""
    rng = np.random.default_rng(seed)
    state = rest_state(dy)

    def bump(a, scale):
        a = np.asarray(a)
        p = rng.normal(size=a.shape) * scale
        # keep only large scales: zero everything beyond n, m > 10
        p[..., 11:, :, :] = 0.0
        p[..., :, :, 11:] = 0.0
        return jnp.asarray(a + p)

    return state._replace(vor=bump(state.vor, 2e-6),
                          div=bump(state.div, 1e-6),
                          t=bump(state.t, 0.2),
                          ps=bump(state.ps, 1e-3))


def test_dry_step_equivalence(mesh, dycore):
    dy = dycore
    state = _perturbed_state(dy)
    forcing = dy.zero_forcing()

    ref = jax.jit(lambda s, f: dy.step(s, f, 1, 1, "delt2"))(state, forcing)
    sd = SpatialDycore(dy, mesh, axis="lat")
    got = jax.jit(sd.step_fn())(state, forcing)

    for name in ("vor", "div", "t", "ps", "tr"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(got, name))
        np.testing.assert_allclose(b, a, rtol=1e-11, atol=1e-13,
                                   err_msg=name)


def test_dry_multi_step_equivalence(mesh, dycore):
    """24 steps under one scan: error must not amplify (stable sharding)."""
    dy = dycore
    state = _perturbed_state(dy, seed=3)
    forcing = dy.zero_forcing()

    ref = jax.jit(lambda s, f: dy.run_steps(s, f, 24))(state, forcing)
    sd = SpatialDycore(dy, mesh, axis="lat")
    got = jax.jit(sd.run_steps_fn(24))(state, forcing)
    for name in ("vor", "div", "t", "ps"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(got, name))
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12,
                                   err_msg=name)


def test_physics_step_equivalence(mesh, continent_boundary):
    """Full-physics step: surf/rad sharded over latitude, fluxes compared
    shard-vs-replicated."""
    from speedyml.model import Speedy

    sp = Speedy(ModelConfig(dtype="float64"), boundary=continent_boundary)
    sp.initialize(year=1981, month=1)
    sp.run_days(1)                        # develop weather + rad carry
    dy = sp.dy
    state, rad, surf, forcing = sp.state, sp.rad, sp.surf, sp.forcing

    def phys_fn(dyf, fphy):
        tends, rad_new, fluxes = sp.phys.step_physics(
            dyf, fphy, surf, rad, jnp.asarray(True))
        return tends, (rad_new, fluxes)

    ref_state, (ref_rad, ref_fx) = jax.jit(
        lambda s, f: dy.step(s, f, 1, 1, "delt2", phys_fn))(state, forcing)

    sd = SpatialDycore(dy, mesh, axis="lat", phys=sp.phys)
    fn = sd.wrap_physics(surf, rad, lradsw=True)
    surf_sh = sd.shard_surface(surf)
    rad_sh = sd.shard_surface(rad)
    got_state, got_rad, got_fx = jax.jit(fn)(state, forcing, surf_sh, rad_sh)

    for name in ("vor", "div", "t", "ps", "tr"):
        a = np.asarray(getattr(ref_state, name))
        b = np.asarray(getattr(got_state, name))
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-11, err_msg=name)
    for name in ("precnv", "precls", "evap", "olr", "tsr", "hfluxn_s"):
        a = np.asarray(getattr(ref_fx, name))
        b = np.asarray(getattr(got_fx, name))
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(np.asarray(got_rad.tt_rsw),
                               np.asarray(ref_rad.tt_rsw),
                               rtol=1e-9, atol=1e-12)
