"""Random diabatic forcing (ini_inirdf / xs_rdf / setrdf equivalents)."""

import jax.numpy as jnp
import numpy as np
import pytest

from speedyml.core.config import ModelConfig
from speedyml.model import Speedy
from speedyml.physics.randfor import make_randfh, tt_rdf, xs_rdf


@pytest.fixture(scope="module")
def model():
    m = Speedy(ModelConfig(dtype="float64", rdf_on=True, rdf_index=7))
    m.initialize(year=1981, month=1)
    return m


class TestPattern:
    def test_shape_truncation_and_sign(self, model):
        T = model.dy.T
        gsin = np.asarray(model.dy.tables.gsin)
        rh1 = make_randfh(T, gsin, model.config.ix, seed=7)
        assert rh1.shape == (2, model.config.il, model.config.ix)
        assert np.isfinite(rh1).all() and np.abs(rh1).max() > 0.01

        # deterministic in the seed; sign flip for negative index
        rh1b = make_randfh(T, gsin, model.config.ix, seed=7)
        np.testing.assert_array_equal(rh1, rh1b)
        rhn = make_randfh(T, gsin, model.config.ix, seed=-7)
        np.testing.assert_allclose(rhn, -rh1)

        # T18 truncation: no spectral power above total wavenumber 18
        spec = np.asarray(T.grid_to_spec(jnp.asarray(rh1[0])))
        mx, _, nx = spec.shape
        ll = np.add.outer(np.arange(mx), np.arange(nx))
        hi = np.abs(spec[:, 0][ll > 18]).max() + np.abs(spec[:, 1][ll > 18]).max()
        lo = np.abs(spec[:, 0][ll <= 18]).max()
        assert hi < 1e-10 * lo

    def test_xs_rdf_constant_field(self, model):
        kx, il, ix = model.config.kx, model.config.il, model.config.ix
        sig = model.st.sig
        c = jnp.full((kx, il, ix), 0.5)
        z = jnp.zeros_like(c)
        p1 = np.asarray(xs_rdf(c, z, sig, 1))
        # smoothing preserves a latitude-constant profile exactly
        np.testing.assert_allclose(p1, 0.5, rtol=1e-12)
        p2 = np.asarray(xs_rdf(c, z, sig, 2))
        want = 0.5 * np.sin(2.0 * np.pi * np.asarray(sig))
        np.testing.assert_allclose(p2, np.broadcast_to(want[:, None], p2.shape),
                                   rtol=1e-9)

    def test_tt_rdf_bilinear_combine(self, model):
        kx, il, ix = 3, model.config.il, model.config.ix
        rh = np.zeros((2, il, ix))
        rh[0] = 1.0
        v1 = jnp.arange(kx * il, dtype=jnp.float64).reshape(kx, il)
        v2 = jnp.ones((kx, il))
        out = np.asarray(tt_rdf(jnp.asarray(rh), v1, v2))
        np.testing.assert_allclose(out, np.asarray(v1)[:, :, None]
                                   * np.ones((1, 1, ix)))


class TestModelIntegration:
    def test_forcing_perturbs_ttend(self, model):
        """step_physics with the pattern differs from without, stays finite,
        and only in the temperature tendency."""
        f = model.state.at_level(0)
        t_true = jnp.asarray(True)
        base, _, _ = model.phys.step_physics(model.dy, f, model.surf,
                                             model.rad, t_true, randfh=None)
        pert, _, _ = model.phys.step_physics(
            model.dy, f, model.surf, model.rad, t_true,
            randfh=jnp.asarray(model._randfh))
        du = np.abs(np.asarray(pert[0]) - np.asarray(base[0])).max()
        dt = np.abs(np.asarray(pert[2]) - np.asarray(base[2])).max()
        dq = np.abs(np.asarray(pert[3]) - np.asarray(base[3])).max()
        assert du == 0.0 and dq == 0.0
        assert 0.0 < dt < 1e-2            # K/s scale perturbation
        assert np.isfinite(np.asarray(pert[2])).all()

    def test_one_day_stable_with_rdf(self, model):
        model.run_day()
        g = model.grid_view()
        assert np.isfinite(g["t"]).all()
        assert 150.0 < g["t"].min() and g["t"].max() < 350.0
