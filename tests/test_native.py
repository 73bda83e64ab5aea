"""Native IO runtime tests: C++ decoder/gather vs numpy oracle
(native/speedy_io.cpp; reference role: mod_io.f90 parallel readers +
ini_inbcon.f90:463-495 load_boundary_file)."""

import numpy as np
import pytest

from speedyml.io.native_loader import (GvStream, get_lib, mem_gather,
                                       read_records_native)


@pytest.fixture(autouse=True)
def native_lib():
    """Build (or load) the library inside the test, never at import: the
    xdist workers must all collect the same tests."""
    if get_lib() is None:
        pytest.skip("native toolchain unavailable")


def test_read_records_matches_numpy(tmp_path):
    rng = np.random.default_rng(0)
    ix, il, nrec = 16, 8, 5
    data = rng.normal(size=(nrec, il, ix)).astype("<f4")
    data[0, 2, 3] = -999.0
    data[1, 0, 0] = -1e4
    p = str(tmp_path / "fort.99")
    data.tofile(p)

    native = read_records_native(p, ix, il)
    ref = data.astype(np.float64)[:, ::-1, :]
    ref[ref <= -999] = 0.0
    np.testing.assert_array_equal(native, ref)


def test_boundary_reader_uses_native(tmp_path, continent_boundary):
    """A fort.20 written from the test continent decodes identically through
    both paths."""
    bd = continent_boundary
    recs = np.stack([bd.orog, bd.fmask, bd.alb0, bd.veg_low, bd.veg_high])
    path = str(tmp_path / "fort.20")
    recs[:, ::-1, :].astype("<f4").tofile(path)   # stored north -> south
    native = read_records_native(path, 96, 48)
    raw = np.fromfile(path, dtype="<f4").reshape(-1, 48, 96)[:, ::-1, :]
    ref = raw.astype(np.float64)
    ref[ref <= -999] = 0.0
    np.testing.assert_array_equal(native, ref)
    np.testing.assert_array_equal(native, recs.astype(np.float32))


def test_stream_gather_matches_numpy(tmp_path):
    rng = np.random.default_rng(1)
    T, width = 50, 200
    series = rng.normal(size=(T, width)).astype(np.float32)
    p = str(tmp_path / "gv.cache")
    st = GvStream.write_cache(p, series)
    idx = rng.integers(0, width, size=(7, 13)).astype(np.int32)
    out = st.gather(idx, t0=5, nt=20)
    np.testing.assert_array_equal(out, series[5:25][:, idx])
    with pytest.raises(IndexError):
        st.gather(idx, t0=40, nt=20)
    st.close()


def test_mem_gather_matches_numpy():
    rng = np.random.default_rng(2)
    series = np.ascontiguousarray(
        rng.normal(size=(30, 100)).astype(np.float32))
    idx = rng.integers(0, 100, size=(4, 9)).astype(np.int32)
    out = mem_gather(series, idx, 3, 10)
    np.testing.assert_array_equal(out, series[3:13][:, idx])
