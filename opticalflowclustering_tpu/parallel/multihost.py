"""Multi-host scale-out: `jax.distributed` initialization and
cross-host work partitioning for the multi-video queue.

SURVEY.md §2.4/§5 call for the reference's (nonexistent) comm layer to be
rebuilt as XLA collectives *within* a host plus `jax.distributed` over
the network *across* hosts. Intra-host sharding lives in
parallel/temporal.py / parallel/spatial.py; this module adds the across-
hosts story:

  * `initialize(...)` — one-call `jax.distributed.initialize` wrapper
    (coordinator address, process count/id from args or the standard env
    vars) after which `jax.devices()` spans every host's devices and any
    Mesh built from them communicates between hosts automatically.
  * `host_shard(...)` — deterministic partition of a video list across
    processes: each host decodes and processes only its own videos (media
    I/O stays host-local; nothing ships raw frames between hosts — the SURVEY
    §7 step-7 fan-out design).
  * `global_mesh(...)` — a dp×sp Mesh over all global devices, dp-major
    across hosts so each video's temporal halo ppermutes stay inside one
    host and only whole-video data parallelism crosses hosts.

tests/test_multihost.py exercises the real thing: it spawns two OS
processes, each `initialize`s into a 2-process CPU cluster, builds the
global mesh, and runs a psum + the dp-sharded hue pipeline across both
processes.
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
    """`jax.distributed.initialize` with env-var fallbacks.

    Args default to JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID (the recipe documented in docs/ARCHITECTURE.md). With
    none of them given, JAX's own cluster auto-detection decides; on
    CPU/GPU clusters without a scheduler they are required."""
    kwargs = {}
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kwargs["coordinator_address"] = addr
    n = num_processes if num_processes is not None else os.environ.get(
        "JAX_NUM_PROCESSES"
    )
    if n is not None:
        kwargs["num_processes"] = int(n)
    pid = process_id if process_id is not None else os.environ.get(
        "JAX_PROCESS_ID"
    )
    if pid is not None:
        kwargs["process_id"] = int(pid)
    jax.distributed.initialize(**kwargs)


def host_shard(items: list, process_id: int | None = None,
               num_processes: int | None = None) -> list:
    """The items this host owns: deterministic round-robin so every process
    computes the same assignment without communicating (the queue driver
    passes its video list through this before decoding anything)."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    return [it for i, it in enumerate(items) if i % n == pid]


def global_mesh(sp: int | None = None, axis_names=("dp", "sp")) -> Mesh:
    """dp×sp Mesh over ALL processes' devices, dp-major across hosts.

    jax.devices() orders devices process-major, so reshaping to
    (n_global // sp, sp) keeps each sp group (the temporal-halo ring)
    within one process/host whenever sp divides the per-host device count —
    ppermute halos stay inside a host, only dp crosses hosts."""
    devs = jax.devices()
    if sp is None:
        sp = jax.local_device_count()
    if len(devs) % sp:
        raise ValueError(f"{len(devs)} devices not divisible by sp={sp}")
    arr = np.array(devs).reshape(len(devs) // sp, sp)
    return Mesh(arr, axis_names)


def local_submesh(mesh: Mesh, dp_axis: str = "dp") -> Mesh:
    """This process's slice of a dp-major global mesh: the dp rows whose
    devices are ALL addressable locally, as a Mesh with the same axis names.

    This is what lets host-local data (decoded video frames that never
    leave their host) drive mesh-sharded jits under `jax.distributed`:
    a jit over a mesh of purely-addressable devices is an ordinary
    single-controller computation, so plain numpy inputs are legal — no
    `make_array_from_callback` global-array assembly, and no cross-host
    collectives (each host's work is independent by construction; the
    video queue partitions the work list with `host_shard` first).

    Every dp row must be entirely local or entirely remote (true for any
    `global_mesh(...)` whenever sp divides the per-host device count);
    a row mixing processes would strand its local devices, so it raises.
    Single-process meshes pass through unchanged."""
    pid = jax.process_index()
    names = list(mesh.axis_names)
    di = names.index(dp_axis)
    devs = np.moveaxis(mesh.devices, di, 0)
    rows_local = [
        all(d.process_index == pid for d in devs[r].flat)
        for r in range(devs.shape[0])
    ]
    mixed = [
        r
        for r in range(devs.shape[0])
        if not rows_local[r]
        and any(d.process_index == pid for d in devs[r].flat)
    ]
    if mixed:
        raise ValueError(
            f"mesh rows {mixed} along {dp_axis!r} mix local and remote "
            "devices; build the mesh dp-major across hosts "
            "(e.g. multihost.global_mesh) so each host owns whole dp rows"
        )
    keep = [r for r in range(devs.shape[0]) if rows_local[r]]
    if not keep:
        raise ValueError(
            f"process {pid} owns no complete {dp_axis!r} row of the mesh"
        )
    sub = np.moveaxis(devs[keep], 0, di)
    return Mesh(sub, mesh.axis_names)
