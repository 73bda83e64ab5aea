"""Weight persistence + checkpoint round-trip tests (reference:
write_trained_res/read_trained_res, mod_reservoir.f90:1703-1781,
mod_io.f90:2938-3036)."""

import numpy as np
import jax.numpy as jnp

from speedyml.core.calendar import ModelDate
from speedyml.io.checkpoint import load_prediction, save_prediction
from speedyml.io.weights import (coo_to_ell, ell_to_coo, export_worker_files,
                                 import_worker_files, load_model, save_model)

from tests.test_hybrid import (_small_layout, _small_rcfg, _synthetic_truth)
from speedyml.hybrid.experiment import train_hybrid, transform_and_pack


def _trained_model(ml_only=True, seed=11):
    L = _small_layout()
    rcfg = _small_rcfg(noise_std=0.0)
    atmo, logp, precip, sst, tisr = _synthetic_truth(L, 200, seed=seed)
    gv = transform_and_pack(L, atmo, logp, precip, sst, tisr,
                            rcfg.precip_epsilon)
    hm = train_hybrid(L, rcfg, gv, None if ml_only else gv + 0.1, seed=seed)
    return hm, gv


def test_ell_coo_roundtrip():
    rng = np.random.default_rng(0)
    n, deg = 16, 3
    a_idx = rng.integers(0, n, (n, deg)).astype(np.int32)
    a_val = rng.uniform(0.1, 1.0, (n, deg)).astype(np.float32)
    rows, cols, vals = ell_to_coo(a_idx, a_val)
    assert rows.min() >= 1 and cols.min() >= 1
    i2, v2 = coo_to_ell(rows, cols, vals, n, deg)
    # matvec equivalence (ordering within a row may differ)
    x = rng.normal(size=n)
    y1 = np.einsum("nd,nd->n", a_val, x[a_idx])
    y2 = np.einsum("nd,nd->n", v2, x[i2])
    np.testing.assert_allclose(y1, y2, rtol=1e-6)


def test_native_save_load_roundtrip(tmp_path):
    hm, gv = _trained_model()
    p = str(tmp_path / "model.nc")
    save_model(p, hm)
    hm2 = load_model(p)
    np.testing.assert_array_equal(np.asarray(hm.params.a_idx),
                                  np.asarray(hm2.params.a_idx))
    np.testing.assert_allclose(np.asarray(hm.params.wout),
                               np.asarray(hm2.params.wout), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(hm.stz.in_mean),
                               np.asarray(hm2.stz.in_mean), rtol=1e-6)
    assert hm2.ml_only == hm.ml_only
    assert hm2.params.q == hm.params.q
    assert hm2.rcfg.precip_epsilon == hm.rcfg.precip_epsilon
    # loaded model predicts identically
    x1 = hm.synchronize(gv[:50])
    x2 = hm2.synchronize(gv[:50])
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-6)


def test_worker_files_roundtrip(tmp_path):
    """Reference-schema per-worker export -> import preserves predictions
    (the stats go through the reference's compact per-(var,level) vector)."""
    hm, gv = _trained_model(seed=13)
    d = str(tmp_path / "weights")
    export_worker_files(d, hm, trial_name="t1")
    hm2 = import_worker_files(d, hm.layout, hm.rcfg, trial_name="t1",
                              ml_only=hm.ml_only)
    np.testing.assert_allclose(np.asarray(hm.stz.in_mean),
                               np.asarray(hm2.stz.in_mean), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(hm.stz.out_std),
                               np.asarray(hm2.stz.out_std), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(hm.params.win),
                               np.asarray(hm2.params.win), rtol=1e-6)
    x1 = hm.synchronize(gv[:50])
    x2 = hm2.synchronize(gv[:50])
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-5)
    out1 = hm.step(x1, jnp.asarray(gv[50]))
    out2 = hm2.step(x2, jnp.asarray(gv[50]))
    np.testing.assert_allclose(np.asarray(out1[1]), np.asarray(out2[1]),
                               atol=1e-4)


def test_run_checkpoint_resume_exact(tmp_path):
    """3 steps + checkpoint + resume 3 == 6 straight steps (bitwise), and
    the incremental NetCDF writer records every frame."""
    import jax.numpy as jnp
    from speedyml.core.calendar import ModelDate
    from speedyml.hybrid.experiment import HybridRunner
    from speedyml.io.output import ForecastWriter, read_forecast

    hm, gv = _trained_model(ml_only=True, seed=17)
    L = hm.layout
    x = hm.synchronize(gv[:60])
    s = L.gv_sizes
    last = gv[60]
    atmo0 = last[s["atmo3d"][0]:s["atmo3d"][1]].reshape(4, L.kx, L.il, L.ix)
    logp0 = last[s["logp"][0]:s["logp"][1]].reshape(L.il, L.ix)
    pr0 = last[s["precip"][0]:s["precip"][1]].reshape(L.il, L.ix)
    sst0 = last[s["sst"][0]:s["sst"][1]].reshape(L.il, L.ix)

    class _R(HybridRunner):
        def _sst_tisr(self, date):
            return sst0.copy(), np.zeros((L.il, L.ix))

    ck = str(tmp_path / "pred.npz")
    nc = str(tmp_path / "fc.nc")
    r1 = _R(hm, None, clim=object(), dy=object())
    with ForecastWriter(nc, L.kx, L.il, L.ix, with_sst=True) as w:
        full = r1.run(x, atmo0, logp0, pr0, ModelDate(1999, 1, 1, 0), 6,
                      writer=w)
    r2 = _R(hm, None, clim=object(), dy=object())
    r2.run(x, atmo0, logp0, pr0, ModelDate(1999, 1, 1, 0), 3,
           checkpoint_path=ck, checkpoint_every=3)
    resumed = r2.resume_from(ck, 3)
    np.testing.assert_array_equal(full["atmo"][3:], resumed["atmo"])
    np.testing.assert_array_equal(full["logp"][5], resumed["logp"][2])
    data = read_forecast(nc)
    assert data["Temperature"].shape[0] == 6
    np.testing.assert_allclose(data["Temperature"][4], full["atmo"][4][0],
                               rtol=1e-6)


def test_prediction_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(18, 64)).astype(np.float32)
    atmo = rng.normal(size=(4, 2, 6, 12)).astype(np.float32)
    logp = rng.normal(size=(6, 12)).astype(np.float32)
    pr = np.abs(rng.normal(size=(6, 12))).astype(np.float32)
    p = str(tmp_path / "ckpt.npz")
    save_prediction(p, x, atmo, logp, pr,
                    ModelDate(1999, 12, 31, 18), step=42,
                    extra={"sst": logp})
    st = load_prediction(p)
    np.testing.assert_array_equal(st["x"], x)
    np.testing.assert_array_equal(st["precip_t"], pr)
    assert st["date"].iyear == 1999 and st["date"].ihour == 18
    assert st["step"] == 42
    np.testing.assert_array_equal(st["extra"]["sst"], logp)


def test_ncstream_o1_append_roundtrip(tmp_path):
    """The O(1) record appender (io.ncstream) produces files scipy reads
    back exactly, keeps records on crash (no close), and its header
    patching survives an empty-file create (10-year runs
    cannot pay scipy's O(T^2) record path)."""
    from scipy.io import netcdf_file

    from speedyml.io.output import ForecastWriter, read_forecast

    path = str(tmp_path / "stream.nc")
    rng = np.random.default_rng(3)
    kx, il, ix = 3, 4, 5
    w = ForecastWriter(path, kx, il, ix, with_sst=True)
    atmos, logps, prs, ssts = [], [], [], []
    for t in range(7):
        a = rng.normal(size=(4, kx, il, ix)).astype(np.float32)
        lp = rng.normal(size=(il, ix)).astype(np.float32)
        pr = rng.uniform(0, 5, size=(il, ix)).astype(np.float32)
        ss = rng.uniform(270, 300, size=(il, ix)).astype(np.float32)
        w.append(a, lp, precip_mm=pr, sst=ss)
        atmos.append(a); logps.append(lp); prs.append(pr); ssts.append(ss)
    # crash-incrementality: read BEFORE close
    g = netcdf_file(path, "r", mmap=False)
    assert g.variables["Temperature"].shape[0] == 7
    np.testing.assert_allclose(np.asarray(g.variables["SST"][:]),
                               np.stack(ssts), rtol=1e-7)
    g.close()
    w.close()
    out = read_forecast(path)
    np.testing.assert_allclose(out["Temperature"],
                               np.stack([a[0] for a in atmos]), rtol=1e-7)
    np.testing.assert_allclose(out["U-wind"],
                               np.stack([a[1] for a in atmos]), rtol=1e-7)
    np.testing.assert_allclose(out["logp"], np.stack(logps), rtol=1e-7)
    np.testing.assert_allclose(out["p6hr"], np.stack(prs), rtol=1e-7)
    # coordinate (non-record) variables intact after appends
    assert out["Sigma_Level"].shape == (kx,)
    assert out["Lat"].shape == (il,)
