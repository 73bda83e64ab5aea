"""Boundary conditions: the APE aquaplanet provider, the fort.2x reader and
how Speedy resolves its `boundary=` argument."""

import numpy as np
import pytest

from speedyml.io.boundary import (APE_ALB0, BoundaryData, ape_control_sst,
                                  gaussian_latitudes, load_boundary)


@pytest.fixture(scope="module")
def ape():
    return BoundaryData.aquaplanet(96, 48)


def test_ape_sst_profile_values():
    """27 (1 - sin^2(3 phi/2)) degC inside 60 degrees, 0 degC poleward."""
    deg = np.radians
    np.testing.assert_allclose(ape_control_sst(deg(0.0)), 300.15)
    np.testing.assert_allclose(ape_control_sst(deg(30.0)), 273.15 + 13.5)
    np.testing.assert_allclose(ape_control_sst(deg(-30.0)), 273.15 + 13.5)
    # continuous at 60 degrees (sin^2(90 deg) = 1), flat 0 degC poleward
    np.testing.assert_allclose(ape_control_sst(deg(59.999)), 273.15,
                               atol=1e-6)
    np.testing.assert_allclose(ape_control_sst(deg([60.0, 75.0, -88.0])),
                               273.15)


def test_aquaplanet_fields(ape):
    lat = np.degrees(gaussian_latitudes(48))
    assert lat[0] < -85.0 and lat[-1] > 85.0 and np.all(np.diff(lat) > 0)
    for name in ("orog", "fmask", "alb0", "veg_low", "veg_high"):
        assert getattr(ape, name).shape == (48, 96), name
    for name in ("sst12", "sice12", "stl12", "snowd12", "swl1_12",
                 "swl2_12"):
        assert getattr(ape, name).shape == (12, 48, 96), name
    for name in ("orog", "fmask", "veg_low", "veg_high", "sice12",
                 "snowd12", "swl1_12", "swl2_12"):
        assert not getattr(ape, name).any(), name
    np.testing.assert_array_equal(ape.alb0, APE_ALB0)
    # zonally symmetric, equatorially symmetric, the same every month
    assert np.all(ape.sst12 == ape.sst12[0])
    np.testing.assert_array_equal(
        ape.sst12[0], np.broadcast_to(ape.sst12[0][:, :1], (48, 96)))
    np.testing.assert_allclose(ape.sst12[0], ape.sst12[0][::-1])
    eq = np.argmin(np.abs(lat))
    assert 299.0 < ape.sst12[0, eq, 0] < 300.15
    np.testing.assert_allclose(ape.sst12[0][np.abs(lat) >= 60.0], 273.15)


def test_aquaplanet_field_overrides_and_unknown_names():
    orog = np.ones((48, 96))
    bd = BoundaryData.aquaplanet(orog=orog)
    np.testing.assert_array_equal(bd.orog, 1.0)
    assert bd.orog is not orog                      # copied, float64
    with pytest.raises(TypeError, match="bogus"):
        BoundaryData.aquaplanet(bogus=orog)


def test_climatology_masks_on_the_aquaplanet(ape):
    """All sea: no land fraction, full sea fraction, no ice, and the SST
    survives the reference's preprocessing unchanged."""
    from speedyml.coupler.climatology import build_climatology
    from speedyml.transforms.tables import build_tables

    t = build_tables()
    clim = build_climatology(ape, t.gcos, t.radang)
    assert not clim.fmask_l.any() and not clim.bmask_l.any()
    np.testing.assert_array_equal(clim.fmask_s, 1.0)
    np.testing.assert_array_equal(clim.bmask_s, 1.0)
    assert not clim.sice12.any()
    np.testing.assert_allclose(clim.sst12, ape.sst12)
    assert np.all(clim.cdsea > 0.0)


def _write_fort(dirpath, bd):
    """The reference's file layout: <f4 records, rows north -> south."""
    def put(unit, recs):
        np.asarray(recs)[..., ::-1, :].astype("<f4").tofile(
            str(dirpath / f"fort.{unit}"))
    put(20, np.stack([bd.orog, bd.fmask, bd.alb0, bd.veg_low, bd.veg_high]))
    put(21, bd.sst12)
    put(22, bd.sice12)
    put(23, bd.stl12)
    put(24, bd.snowd12)
    put(26, np.stack([bd.swl1_12, bd.swl2_12, bd.swl2_12], axis=1))


def test_from_dir_reads_back_the_reference_layout(tmp_path,
                                                  continent_boundary):
    bd = continent_boundary
    _write_fort(tmp_path, bd)
    got = load_boundary(str(tmp_path))
    for name in ("orog", "fmask", "alb0", "veg_low", "veg_high", "sst12",
                 "sice12", "stl12", "snowd12", "swl1_12", "swl2_12"):
        np.testing.assert_array_equal(
            getattr(got, name), getattr(bd, name).astype(np.float32),
            err_msg=name)


@pytest.mark.parametrize("case", ["missing_dir", "missing_file"])
def test_explicit_boundary_path_never_falls_back(tmp_path, case):
    from speedyml.core.config import ModelConfig
    from speedyml.model import Speedy

    path = tmp_path / "nowhere"
    if case == "missing_file":
        path = tmp_path
        _write_fort(path, BoundaryData.aquaplanet())
        (path / "fort.23").unlink()
    with pytest.raises(FileNotFoundError):
        Speedy(ModelConfig(dtype="float64"), boundary=str(path))


def test_load_boundary_defaults_and_passthrough(continent_boundary):
    assert load_boundary(continent_boundary) is continent_boundary
    ape = load_boundary(None, 96, 48)
    assert not ape.fmask.any() and ape.sst12.shape == (12, 48, 96)
