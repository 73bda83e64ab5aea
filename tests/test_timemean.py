"""Time-mean diagnostics (mod_tmean/ppo_tminc/ppo_tmout equivalents).

Checks the accumulator algebra directly (means of constant samples,
central-moment identities) and the GrADS write of a one-day model run with
time means enabled.
"""

import numpy as np
import pytest

from speedyml.core.config import ModelConfig
from speedyml.model import Speedy
from speedyml.utils.timemean import (FLUX2D_NAMES, MEAN2D_NAMES, MEAN3D_NAMES,
                                     VAR3D_NAMES, finalize, init_timemean,
                                     tm_update, tm_update_fluxes)


@pytest.fixture(scope="module")
def model():
    m = Speedy(ModelConfig(dtype="float64", time_means_on=True))
    m.initialize(year=1981, month=1)
    return m


class TestAccumulatorAlgebra:
    def test_constant_samples_zero_variance(self, model):
        """N identical samples: mean == instantaneous, variance == 0."""
        tm = init_timemean(model.config.kx, model.config.il, model.config.ix,
                           model.dy.dtype)
        f = model.state.at_level(0)
        for _ in range(3):
            tm = tm_update(model.dy, model.st, f, tm)
        out = finalize(tm)
        assert float(np.asarray(tm.rnsave)) == 3.0
        for name in MEAN3D_NAMES + MEAN2D_NAMES:
            assert np.isfinite(out[name]).all(), name
        for name in ("u2", "v2", "t2", "q2"):
            # central moment of constant samples vanishes (up to f64 cancel)
            scale = max(1.0, float(np.abs(out[name[0]]).max()) ** 2)
            assert np.abs(out[name]).max() / scale < 1e-9, name
        # mean temperature is physical, mslp close to ps over oceans
        assert 150.0 < out["t"].min() and out["t"].max() < 350.0
        assert 0.5 < out["mslp"].mean() < 1.2   # p/p0 units

    def test_flux_accumulation_counts(self, model):
        tm = init_timemean(model.config.kx, model.config.il, model.config.ix,
                           model.dy.dtype)

        class FX:
            pass

        fx = FX()
        import jax.numpy as jnp
        ones = jnp.ones((model.config.il, model.config.ix), model.dy.dtype)
        for n in FLUX2D_NAMES:
            setattr(fx, n, 2.0 * ones)
        tm = tm_update_fluxes(fx, tm)
        tm = tm_update_fluxes(fx, tm)
        out = finalize(tm)
        for n in FLUX2D_NAMES:
            np.testing.assert_allclose(out[n], 2.0)


class TestModelIntegration:
    def test_one_day_run_and_grads_write(self, model, tmp_path):
        model.run_day()
        tm = model.time_means
        ns = float(np.asarray(tm.nstep))
        nr = float(np.asarray(tm.rnsave))
        assert ns == model.config.nsteps                 # every-step fluxes
        assert nr == model.config.nsteps // model.config.nstppr  # 6-step PP

        base = str(tmp_path / "tmean")
        fields = model.write_time_means(base)
        # reset semantics (tmout imode>0 then imode=0)
        assert float(np.asarray(model.time_means.rnsave)) == 0.0

        # all declared fields present, finite, physically plausible
        for name in MEAN3D_NAMES + VAR3D_NAMES + MEAN2D_NAMES + FLUX2D_NAMES:
            assert name in fields and np.isfinite(fields[name]).all(), name
        assert (fields["u2"] >= -1e-6).all()
        # q rings negative in spectral space (worst where qsat is tiny);
        # judge rh only at the lowest level where it is meaningful
        rh0 = fields["rh"][-1]
        assert rh0.min() > -0.2 and rh0.max() < 1.6 and rh0.mean() > 0.2
        assert 150.0 < fields["t0"].min() and fields["t0"].max() < 350.0

        # GrADS record round-trips with the right shapes
        from speedyml.io.grads import read_grads
        cfg = model.config
        a3, a2 = read_grads(base, cfg.kx, cfg.il, cfg.ix,
                            n3d=len(MEAN3D_NAMES) + len(VAR3D_NAMES),
                            n2d=len(MEAN2D_NAMES) + len(FLUX2D_NAMES))
        assert a3.shape == (1, 12, cfg.kx, cfg.il, cfg.ix)
        np.testing.assert_allclose(a3[0, 2], fields["t"], rtol=2e-6)
        # .ctl descriptor written and names the variables
        ctl = open(base + ".ctl").read()
        assert "mslp" in ctl and "vars 26" in ctl
