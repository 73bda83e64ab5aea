"""chip_smoke.py's CPU-checkable parts (device check, metric, compile
cache), and the `chip` tests that run its checks where a GPU is present."""

import os

import jax
import numpy as np
import pytest

import chip_smoke


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        chip_smoke.require_gpu(jax.devices("cpu"))
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])


def test_require_gpu_accepts_a_gpu_first():
    class Dev:
        platform = "gpu"
    chip_smoke.require_gpu([Dev()])


def test_rel_rms_is_scaled_by_field_variability():
    ref = np.array([250.0, 260.0, 270.0])
    assert chip_smoke.rel_rms(ref, ref) == 0.0
    # an offset of 1 against a field whose anomalies have norm sqrt(200)
    np.testing.assert_allclose(chip_smoke.rel_rms(ref + 1.0, ref),
                               np.sqrt(3.0 / 200.0))


def test_run_records_failed_checks_and_phases(capsys):
    run = chip_smoke.Run()
    assert run.check("fine", True)
    assert not run.compare("off", {"a": np.array([1.0, 3.0])},
                           {"a": np.array([1.0, 2.0])}, tol=1e-3)

    def boom(run):
        raise RuntimeError("phase failed")
    assert run.phase("broken", boom) is None
    assert run.failed == ["off", "broken"]
    out = capsys.readouterr().out
    assert "[broken] wall" in out and "FAILED" in out


@pytest.mark.parametrize("env", [None, "/some/where/cache"])
def test_compile_cache_location(monkeypatch, env):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code; otherwise
    the cache goes to the fixed .jax_cache/ in the checkout."""
    from speedyml.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    got = compile_cache.enable_compile_cache()
    if env is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(root, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", got)]
    else:
        assert got == env and calls == []


@pytest.mark.chip
def test_window_matches_cpu_f64_on_gpu(gpu_device):
    """The 6-h window on the GPU agrees with float64 on the CPU."""
    run = chip_smoke.Run()
    with jax.default_device(gpu_device):
        chip_smoke.phase_speedy(run)
    assert not run.failed, run.failed


@pytest.mark.chip
def test_ridge_solve_on_gpu_matches_host(gpu_device):
    from speedyml.reservoir.generate import generate_esn
    from speedyml.reservoir.training import (drive_and_accumulate,
                                             init_normal_eq, ridge_solve,
                                             ridge_solve_device)

    rng = np.random.default_rng(0)
    with jax.default_device(gpu_device):
        params = generate_esn(0, 2, 16, 4, 4, m_target=256)
        u, y, m = (rng.normal(size=(128, 2, k)).astype(np.float32)
                   for k in (16, 4, 4))
        acc = drive_and_accumulate(params, init_normal_eq(params, 4), u, y,
                                   m, chunk=64)
        w = np.asarray(ridge_solve_device(acc, 4, 1e-3, 1.0), np.float64)
    want = ridge_solve(acc, 4, 1e-3, 1.0)
    assert np.linalg.norm(w - want) / np.linalg.norm(want) < \
        chip_smoke.TOL_RIDGE
