"""Multi-host process group + collectives for distributed rendering.

JAX-native replacement for the reference's shared-address-space threading
model (/root/reference/camera.hpp:556-573 std::thread fan-out/join,
main.cpp:245 atomic flags). On a pod slice every host runs this same
program under `jax.distributed`; pixel tiles shard over the global device
mesh (parallel/render.py), per-image statistics reduce with `psum` instead
of the reference's host-side full-image loop
(/root/reference/color_processing.hpp:150-182), and preview/export gather
to process 0 only (the analog of the UI thread's accumulator snapshot,
main.cpp:1575).

Environment contract (standard jax.distributed variables):
  COORDINATOR_ADDRESS  host:port of process 0 (required for >1 process)
  NUM_PROCESSES        total process count
  PROCESS_ID           this process's rank

`init_distributed()` is a no-op for single-process runs, so every entry
point can call it unconditionally.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

HOST_AXIS = "hosts"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize the jax.distributed process group (idempotent).

    Arguments default to the COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID environment variables. Returns True when running
    multi-process, False for the single-process fast path.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get("NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", "0"))
    global _initialized
    if num_processes <= 1 or coordinator_address is None:
        return False
    if _initialized:
        return True
    # NOTE: no jax.* probes here — even jax.process_count() initializes
    # the XLA backend, after which jax.distributed.initialize refuses to
    # run. The module flag is the idempotency guard.
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return True


_initialized = False


def make_global_mesh(axis_name: str = "tiles") -> Mesh:
    """1-D mesh over ALL devices of the process group (local or global).

    Pixel tiles shard over this single axis: tile traffic inside a host
    rides ICI, and only the final host-0 gather crosses DCN — the layout
    SURVEY §5.8 prescribes. A (host, chip) 2-D factorization adds nothing
    for this embarrassingly parallel axis, so the mesh stays 1-D.
    """
    return Mesh(np.asarray(jax.devices()), axis_names=(axis_name,))


def local_shard(global_ids: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Rows of `global_ids` owned by this process's local devices."""
    n_shards = mesh.devices.size
    per = -(-global_ids.shape[0] // n_shards)
    local = []
    for i, dev in enumerate(mesh.devices.flat):
        if dev.process_index == jax.process_index():
            local.append(global_ids[i * per:(i + 1) * per])
    return np.concatenate(local) if local else global_ids[:0]


def gather_to_host0(tree):
    """Fetch a (possibly sharded) device pytree as host numpy on process 0.

    Single-process: plain device_get. Multi-process: all-gather across
    processes (every process receives the full value; only process 0's
    copy is used — the multihost_utils contract).
    """
    if jax.process_count() == 1:
        return jax.tree.map(np.asarray, tree)
    from jax.experimental import multihost_utils

    return jax.tree.map(
        np.asarray, multihost_utils.process_allgather(tree, tiled=True)
    )


def is_host0() -> bool:
    return jax.process_index() == 0
