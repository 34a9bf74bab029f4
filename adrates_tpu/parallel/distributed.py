"""Multi-host initialization and mesh construction.

SURVEY §7.7's scale-out obligation: single-host GSPMD is proven by the
sharded multibook (`multibook.py`); this module adds the multi-process
story — `jax.distributed` runtime init plus a mesh builder that lays the
book axis out so collectives stay within a host and only the final
O(N + N²) delta/gamma psum crosses hosts.

Design: the book's ROWS are the only large axis, so shard rows over every
device; replicate quotes, curve params and the aggregate. Within a host
the per-trade scatter-add reduces over the cards' links (NVLink, all to
all on a multi-GPU host, so the row axis alone shapes the mesh); across
hosts only the [S, N] delta and [S, N, N] gamma reductions touch the
network — at N=184, ~270 KB per scenario. There is NO pipeline/tensor
split to place: the curve graph is a few hundred KB of f64 and recomputes
per device faster than it could be communicated.

Usage (one process per host, e.g. under SLURM):

    from adrates_tpu.parallel import distributed as dist
    dist.init_distributed()              # env-driven; no-op single-host
    mesh = dist.book_mesh()              # 1-D ("book",) or 2-D
                                         # ("host", "book") across hosts
    fn = make_sharded_multibook_fn(mb, mesh,
                                   axis=("host", "book") if "host" in
                                   mesh.axis_names else "book")

The CPU-mesh dryrun (`__graft_entry__.dryrun_multichip`) exercises both
mesh shapes without hardware.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Initialize the JAX distributed runtime for multi-host meshes.

    Without a ``coordinator_address`` (or ``JAX_COORDINATOR_ADDRESS``),
    only a SLURM job is detected; elsewhere pass the coordinator address
    (``host:port``), ``num_processes`` and ``process_id`` explicitly.
    Returns True when a multi-process runtime is active after the call.
    Safe to call when single-process (no-op) or already initialized
    (idempotent)."""
    import jax

    already = getattr(jax.distributed.global_state, "client", None)
    if already is not None:
        return jax.process_count() > 1

    explicit = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if not explicit and not os.environ.get("SLURM_JOB_ID"):
        return False          # single-process: nothing to initialize

    jax.distributed.initialize(
        coordinator_address=explicit,
        num_processes=num_processes,
        process_id=process_id)
    return jax.process_count() > 1


def book_mesh(book_axis: str = "book", host_axis: str = "host",
              devices=None):
    """A mesh for row-sharded books.

    One process: 1-D ``(book,)`` over all devices. Several processes
    (one per host): 2-D ``(host, book)`` via
    ``mesh_utils.create_hybrid_device_mesh(..., process_is_granule=True)``
    so the ``book`` axis maps onto the devices within a host and ``host``
    onto the processes — row shards never straddle a network hop."""
    import jax
    from jax.experimental import mesh_utils
    from jax.sharding import Mesh

    devices = list(devices) if devices is not None else jax.devices()
    n_hosts = jax.process_count()
    if n_hosts <= 1:
        return Mesh(np.asarray(devices), (book_axis,))

    mesh_devices = mesh_utils.create_hybrid_device_mesh(
        mesh_shape=(1, len(devices) // n_hosts),
        dcn_mesh_shape=(n_hosts, 1),
        devices=devices,
        process_is_granule=True)
    return Mesh(mesh_devices, (host_axis, book_axis))
