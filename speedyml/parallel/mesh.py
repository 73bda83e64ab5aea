"""Device-mesh sharding for the batched reservoirs + dycore ensemble.

Replacement of the reference's MPI layer (src/mpires.f90,
src/res_domain.f90 processor_decomposition): instead of 1152 ranks with a
hub-and-spoke exchange through rank 0 (mpires.f90:218-804), the region batch
axis R is SHARDED over the mesh ("dp"), the reservoir node axis over ("tp"),
and the global supervector is replicated (it is ~0.7 MB — the halo exchange
the reference does with MPI_SEND/RECV becomes a gather from a replicated
array, and the reverse scatter an all-gather XLA inserts automatically).

Mesh axes:
  dp: regions (embarrassingly parallel reservoirs, res_domain.f90:31-94)
  tp: reservoir node dimension (rows of A, win, and the wout/normal-equation
      augmented axis) — model parallelism within a reservoir.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..reservoir.esn import EsnParams


def make_mesh(n_devices: Optional[int] = None, tp: int = 1,
              devices=None) -> Mesh:
    """Build a (dp, tp) mesh over the first n_devices devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    assert n_devices % tp == 0
    dp = n_devices // tp
    arr = np.array(devices[:n_devices]).reshape(dp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))


def shard_params(params: EsnParams, mesh: Mesh) -> EsnParams:
    """Place the batched ESN parameters with (dp=regions, tp=nodes)
    shardings. wout's augmented axis is tp-sharded: the readout einsum
    reduces over it, so XLA inserts a psum over tp (the model-parallel
    replacement for the reference's per-rank DGEMV)."""
    ns = lambda *spec: NamedSharding(mesh, P(*spec))
    return EsnParams(
        a_idx=jax.device_put(params.a_idx, ns("dp", "tp", None)),
        a_val=jax.device_put(params.a_val, ns("dp", "tp", None)),
        win=jax.device_put(params.win, ns("dp", "tp")),
        wout=jax.device_put(params.wout, ns("dp", None, "tp")),
        node_map=jax.device_put(params.node_map, ns("tp")),
        leakage=params.leakage,
        a_shift=(None if params.a_shift is None
                 else jax.device_put(params.a_shift, ns())))


def region_sharding(mesh: Mesh) -> NamedSharding:
    """(R, ...) arrays sharded over regions."""
    return NamedSharding(mesh, P("dp"))


def state_sharding(mesh: Mesh) -> NamedSharding:
    """Reservoir state (R, n): regions over dp, nodes over tp."""
    return NamedSharding(mesh, P("dp", "tp"))


def series_sharding(mesh: Mesh) -> NamedSharding:
    """Training series (T, R, n_in): time replicated, regions over dp."""
    return NamedSharding(mesh, P(None, "dp", None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
