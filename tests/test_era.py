"""ERA5-schema IO, restart checkpoint, calendar markers, linalg parity."""

import numpy as np

from speedyml.core.calendar import ModelDate, prediction_markers
from speedyml.io.era import (era_file_name, read_era_year, read_model_states,
                             write_era_year)
from speedyml.reservoir.linalg import mldivide, pinv_svd


def test_era_write_read_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    T, kx, il, ix = 5, 3, 4, 8
    atmo = rng.normal(size=(T, 4, kx, il, ix)).astype(np.float32)
    atmo[:, 3] = np.abs(atmo[:, 3]) * 1e-3        # q in kg/kg
    logp = rng.normal(size=(T, il, ix)).astype(np.float32)
    sst = (290 + rng.normal(size=(T, il, ix))).astype(np.float32)
    p = era_file_name(str(tmp_path), 1999, suffix="")
    write_era_year(p, atmo, logp, sst=sst)

    d = read_era_year(p)
    np.testing.assert_allclose(d["atmo"][:, :3], atmo[:, :3], rtol=1e-6)
    # q converted to g/kg with [0, 25] clamp
    np.testing.assert_allclose(d["atmo"][:, 3],
                               np.clip(atmo[:, 3] * 1000, 0, 25), rtol=1e-5)
    np.testing.assert_allclose(d["logp"], logp, rtol=1e-6)
    np.testing.assert_allclose(d["sst"], sst, rtol=1e-6)

    m = read_model_states(p)                      # no unit conversion
    np.testing.assert_allclose(m["atmo"][:, 3], atmo[:, 3], rtol=1e-6)


def test_era_orientation_detection(tmp_path):
    """Fortran-ordered / permuted files are reoriented, not read transposed
    (_to_tzyx was once a no-op)."""
    from scipy.io import netcdf_file
    from speedyml.io.era import _to_tzyx

    rng = np.random.default_rng(3)
    T, kx, il, ix = 5, 3, 4, 8
    a = rng.normal(size=(T, kx, il, ix)).astype(np.float32)

    # named dims in any permutation -> exact reorientation
    perm = (3, 1, 0, 2)   # (lon, lev, time, lat)
    dims = np.array(("time", "lev", "lat", "lon"))[list(perm)]
    got = _to_tzyx(np.transpose(a, perm), tuple(dims))
    np.testing.assert_array_equal(got, a)

    # unnamed dims, distinct sizes -> shape heuristic (lon = 2*lat)
    got = _to_tzyx(np.transpose(a, (3, 2, 1, 0)), ("a", "b", "c", "d"))
    np.testing.assert_array_equal(got, a)

    # 3-D field
    lp = rng.normal(size=(T, il, ix)).astype(np.float32)
    got = _to_tzyx(np.transpose(lp, (2, 1, 0)), ())
    np.testing.assert_array_equal(got, lp)

    # ambiguous (duplicate sizes, unnamed dims) -> hard error
    amb = rng.normal(size=(8, 3, 4, 8)).astype(np.float32)
    try:
        _to_tzyx(amb, ("a", "b", "c", "d"))
        assert False, "expected ValueError"
    except ValueError:
        pass

    # end-to-end: a file written Fortran-style (lon, lat, lev, time) reads
    # back identical to the C-style writer's output
    p = str(tmp_path / "fort_order.nc")
    f = netcdf_file(p, "w")
    f.createDimension("Lon", ix)
    f.createDimension("Lat", il)
    f.createDimension("Sigma_Level", kx)
    f.createDimension("Timestep", T)
    for i, name in enumerate(("Temperature", "U-wind", "V-wind",
                              "Specific_Humidity")):
        v = f.createVariable(name, "f4", ("Lon", "Lat", "Sigma_Level",
                                          "Timestep"))
        v[:] = np.transpose((a + i).astype(np.float32), (3, 2, 1, 0))
    v = f.createVariable("logp", "f4", ("Lon", "Lat", "Timestep"))
    v[:] = np.transpose(lp, (2, 1, 0))
    f.close()
    d = read_era_year(p, q_to_gkg=False)
    for i in range(4):
        np.testing.assert_allclose(d["atmo"][:, i], a + i, rtol=1e-6)
    np.testing.assert_allclose(d["logp"], lp, rtol=1e-6)


def test_speedy_restart_roundtrip(tmp_path):
    from speedyml.io.checkpoint import (load_speedy_restart,
                                        save_speedy_restart)
    from speedyml.dynamics.state import zero_state
    import types

    st = zero_state(2, 5, 6, 1, np.float32)
    st = st._replace(vor=st.vor + 1.5)
    cpl = types.SimpleNamespace(sst_am=np.full((4, 8), 290.0),
                                stl_am=np.full((4, 8), 280.0))
    p = str(tmp_path / "restart.npz")
    save_speedy_restart(p, st, cpl, ModelDate(1990, 6, 15, 12))
    st2, cpl2, date = load_speedy_restart(p)
    np.testing.assert_array_equal(np.asarray(st.vor), st2.vor)
    np.testing.assert_array_equal(cpl2["sst_am"], cpl.sst_am)
    assert (date.iyear, date.imonth, date.iday, date.ihour) == (1990, 6, 15, 12)


def test_prediction_markers():
    marks = prediction_markers(ModelDate(1999, 12, 31, 18), 4, 12)
    assert (marks[0].iday, marks[0].ihour) == (31, 18)
    assert (marks[1].iyear, marks[1].imonth, marks[1].iday,
            marks[1].ihour) == (2000, 1, 1, 6)
    assert marks[3].ihour == 6 and marks[3].iday == 2


def test_linalg_parity():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(6, 6)) + 6 * np.eye(6)
    X_true = rng.normal(size=(3, 6))
    B = X_true @ A
    np.testing.assert_allclose(mldivide(A, B), X_true, rtol=1e-8)
    # pinv on a diagonal matrix (the reference's unit test,
    # tests/mod_unit_test.f90:16-47)
    D = np.diag([2.0, 4.0, 8.0])
    np.testing.assert_allclose(pinv_svd(D), np.diag([0.5, 0.25, 0.125]),
                               rtol=1e-10)


def test_observed_boundary_by_date(tmp_path):
    """File-backed SST/TISR-by-date at prediction (io.era.ObservedBoundary;
    the reference's get_sst_by_date/get_tisr_by_date, mpires.f90:1676-1710):
    reference-schema companion files served by date, multi-year."""
    import pytest
    from speedyml.io.era import (ObservedBoundary, tisr_file_name,
                                 write_era_year, write_tisr_year)

    rng = np.random.default_rng(1)
    kx, il, ix = 2, 4, 8
    n1995 = 365 * 4          # 6-hourly
    n1996 = 366 * 4          # leap year
    sst = {}
    tisr = {}
    for y, T in ((1995, n1995), (1996, n1996)):
        atmo = rng.normal(size=(T, 4, kx, il, ix)).astype(np.float32) * 1e-3
        logp = rng.normal(size=(T, il, ix)).astype(np.float32)
        sst[y] = (290 + rng.normal(size=(T, il, ix))).astype(np.float32)
        tisr[y] = np.abs(rng.normal(size=(T, il, ix))).astype(np.float32)
        write_era_year(era_file_name(str(tmp_path), y), atmo, logp,
                       sst=sst[y])
        write_tisr_year(tisr_file_name(str(tmp_path), y), tisr[y])

    ob = ObservedBoundary(str(tmp_path), 1995, 1996,
                          tisr_dir=str(tmp_path))
    # start of the window
    np.testing.assert_array_equal(ob.sst_fn(ModelDate(1995, 1, 1, 0)),
                                  sst[1995][0])
    # 6-hour cadence: Jan 2 1995, 18:00 -> index 7
    np.testing.assert_array_equal(ob.sst_fn(ModelDate(1995, 1, 2, 18)),
                                  sst[1995][7])
    # crosses into the second year (365-day first year)
    np.testing.assert_array_equal(ob.tisr_fn(ModelDate(1996, 1, 1, 6)),
                                  tisr[1996][1])
    # mid-cadence dates floor to the previous record
    np.testing.assert_array_equal(ob.sst_fn(ModelDate(1995, 1, 1, 5)),
                                  sst[1995][0])
    # out-of-window dates raise rather than silently wrapping
    with pytest.raises(IndexError):
        ob.sst_fn(ModelDate(1997, 1, 1, 0))
    with pytest.raises(IndexError):
        ob.tisr_fn(ModelDate(1994, 12, 31, 18))
