"""Device mesh helpers for multi-chip/multi-host scaling.

The reference has no distributed layer (SURVEY.md §2.3); this is the
addition demanded by the north star: gaussians sharded over a
1D "data" mesh axis, tiles strip-partitioned over the same axis, XLA
collectives over the interconnect (NVLink within a host). Multi-host initialization goes through
``jax.distributed.initialize`` before building the mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

DATA_AXIS = "data"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> int:
    """Bring up the multi-host JAX runtime and return the process index.

    Thin wrapper over ``jax.distributed.initialize`` so the launch recipe
    is one call per host (see docs/ARCHITECTURE.md "Multi-host launch").
    Pass the coordinator, the process count and this process's index
    explicitly:

        # host 0 and host 1, same command with different process_id:
        initialize_multihost("10.0.0.1:8476", num_processes=2, process_id=i)
        mesh = make_mesh()           # global: all chips on all hosts
        ... render_sharded(..., mesh)

    Safe to call twice (the second call is a no-op); returns
    ``jax.process_index()``.
    """
    already = getattr(jax.distributed.initialize, "_gs3d_done", False)
    if not already:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                local_device_ids=local_device_ids,
            )
        except RuntimeError as e:
            # Already initialized (e.g. by the launcher) — keep going.
            if "already initialized" not in str(e).lower():
                raise
        jax.distributed.initialize._gs3d_done = True
    return jax.process_index()


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1D mesh over the first n devices (default: all, across all hosts)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def gaussian_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (gaussian) axis over the data axis."""
    return NamedSharding(mesh, PartitionSpec(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad an array along ``axis`` so shards divide evenly."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(np.asarray(x), widths), n
