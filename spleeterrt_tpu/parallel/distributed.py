"""Multi-host initialization and mesh construction.

The reference is strictly single-process shared memory (its "distributed
backend" is mutex/condvar signalling, Executable/cpthread.c). Here
`jax.distributed.initialize` brings up the cross-host runtime, and the
global mesh orders the "data" (sequence/tile) axis host-major, so the only
cross-host traffic in the time-sharded pipeline is the 3072-sample halo
permutes at chunk boundaries (parallel/timeshard.py), and stem-model
parallelism stays inside a host.

Multi-host hardware is unavailable in this environment; this module is
exercised single-process (n_processes=1) and via the virtual CPU mesh.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up jax.distributed when running multi-process.

    No-op for single-process runs. Arguments default from the standard env
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID); nothing
    else describes the cluster, so multi-process runs must set them.
    """
    num = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address
        or os.environ.get("JAX_COORDINATOR_ADDRESS"),
        num_processes=num,
        process_id=process_id
        if process_id is not None
        else int(os.environ.get("JAX_PROCESS_ID", "0")),
    )


def global_mesh(stem_parallel: int = 1) -> Mesh:
    """(stem, data) mesh over ALL devices (all hosts).

    The data axis is ordered host-major so contiguous signal chunks map to
    contiguous hosts: halo ppermutes between chunk neighbors stay inside a
    host and cross the network only once per host boundary. Within a host
    the cards are all to all (NVLink), so no topology enters the mesh.
    """
    devices = np.asarray(jax.devices())
    n = devices.size
    if n % stem_parallel:
        raise ValueError(f"{n} devices not divisible by stem_parallel")
    # jax.devices() is already process-major (host-major) order.
    arr = devices.reshape(stem_parallel, n // stem_parallel)
    return Mesh(arr, ("stem", "data"))


def is_coordinator() -> bool:
    return jax.process_index() == 0
