"""Test configuration: force the CPU backend with an 8-device virtual mesh.

Multi-device sharding is validated on the virtual CPU mesh; float64 is
enabled for oracle-precision checks. Tests marked `chip` need an NVIDIA GPU;
each decides inside the test whether one is present and skips here.
"""

import os
import sys

import numpy as np
import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skips on the CPU (the same "
        "checks run on the card in chip_smoke.py)")


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when JAX has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("no GPU: run python chip_smoke.py on the card")
    return gpus[0]


@pytest.fixture(scope="session")
def continent_boundary():
    """The aquaplanet with the Earth-like fields that the orography, land
    and sea-ice code paths need: a 5 km mountain continent at (30N, 90E), a
    2.5 km ridge at 70W, and sea ice poleward of 70 degrees over 270 K
    water."""
    from speedyml.io.boundary import (BoundaryData, ape_control_sst,
                                      gaussian_latitudes)

    il, ix = 48, 96
    lat = np.degrees(gaussian_latitudes(il))[:, None]
    lon = (np.arange(ix) * 360.0 / ix)[None, :]
    orog = (5000.0 * np.exp(-0.5 * (((lat - 30.0) / 12.0) ** 2
                                    + ((lon - 90.0) / 20.0) ** 2))
            + 2500.0 * np.exp(-0.5 * (((lat + 20.0) / 25.0) ** 2
                                      + ((lon - 290.0) / 5.0) ** 2)))
    fmask = np.clip(orog / 500.0, 0.0, 1.0)
    polar = np.broadcast_to(np.abs(lat) > 70.0, (il, ix))
    sst = np.broadcast_to(ape_control_sst(np.radians(lat)), (il, ix)).copy()
    sst[polar] = 270.0
    stl = sst - 0.0065 * orog               # standard lapse rate over land
    land = fmask > 0.0
    return BoundaryData.aquaplanet(
        ix, il, orog=orog, fmask=fmask,
        alb0=np.where(land, 0.2, 0.07), veg_low=0.5 * fmask,
        veg_high=0.3 * fmask, sst12=np.broadcast_to(sst, (12, il, ix)),
        sice12=np.broadcast_to(np.where(polar, 0.8, 0.0), (12, il, ix)),
        stl12=np.broadcast_to(stl, (12, il, ix)),
        snowd12=np.broadcast_to(np.where(orog > 3000.0, 50.0, 0.0),
                                (12, il, ix)),
        swl1_12=np.broadcast_to(0.25 * fmask, (12, il, ix)),
        swl2_12=np.broadcast_to(0.25 * fmask, (12, il, ix)))
