"""Multi-host bring-up and mesh construction.

The reference has no distributed execution (MPI discovery commented out,
``common/cmake-common.cmake:17-19``); this is the layer SURVEY.md §5
prescribes: single-controller-per-host JAX via
``jax.distributed.initialize``, and a device mesh with a fast intra-host
axis ``"x"`` plus an optional cross-host axis ``"dcn"``.  The devices of
one host (e.g. four GPUs joined all to all by NVLink) form the 1D
``("x",)`` mesh; the 2D mesh is for several hosts.

Bring-up is env-driven and a NO-OP on a single host, so the same entry
points work everywhere: set ``JAX_COORDINATOR_ADDRESS`` (host:port),
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` to wire several processes
together.
"""

from __future__ import annotations

import os

import numpy as np

import jax
from jax.sharding import Mesh

_initialized = False


def maybe_initialize_distributed() -> bool:
    """Initialize multi-process JAX when the environment asks for it.

    Returns True when running multi-process (after initialization), False
    for plain single-process runs.  Safe to call more than once.
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coord:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
            process_id=int(os.environ["JAX_PROCESS_ID"]),
        )
        _initialized = True
    return _initialized and jax.process_count() > 1


def make_mesh(n_ici: int | None = None, n_dcn: int = 1,
              devices=None) -> Mesh:
    """Device mesh for the sharded solvers.

    ``n_dcn == 1``: a 1D ``("x",)`` mesh (single host).
    ``n_dcn > 1``: a 2D ``("dcn", "x")`` mesh — the leading grid axis is
    sharded dcn-major so halo ppermutes stay within a host except at group
    edges.

    Default device order is ``jax.devices()``, which lists each host's
    devices contiguously — the layout the dcn-major row partition wants.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    if n_ici is None:
        n_ici = len(devices) // n_dcn
    need = n_ici * n_dcn
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.array(devices[:need])
    if n_dcn == 1:
        return Mesh(arr, axis_names=("x",))
    return Mesh(arr.reshape(n_dcn, n_ici), axis_names=("dcn", "x"))
