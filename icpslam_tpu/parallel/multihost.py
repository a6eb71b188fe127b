"""Multi-host initialization and process-level utilities.

The reference is strictly single-process (SURVEY.md §1 middleware note).
This framework's multi-host story follows the standard JAX recipe:

- **process coordination**: ``jax.distributed.initialize`` connects the
  host processes (one per GPU host); afterwards ``jax.devices()`` spans
  every card and every jitted/shard_mapped computation in ``parallel/``
  runs SPMD across hosts, its collectives handed to NCCL.
- **host-side scan feed**: each process feeds only its local shard of any
  globally-sharded input via ``jax.make_array_from_process_local_data``;
  for the streaming SLAM loop the scan stream is broadcast (small) while
  map/graph state lives sharded on device.

On GPU hosts nothing detects the cluster by itself: pass the coordinator
address (``host:port``), the process count and this process's id, or run
under a cluster environment JAX recognises (e.g. SLURM). On CI it
initializes a single-process "cluster" and the same code paths run on the
8-virtual-device CPU mesh.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Connect this process to the multi-host cluster.

    On GPU hosts pass ``coordinator_address`` (``host:port`` of process 0),
    ``num_processes`` and ``process_id``. With no arguments JAX's own
    cluster auto-detection is tried (a SLURM or similar environment); where
    it finds none the process stays single-process and says so in the log.
    No-op if already initialized.
    """
    # NOTE: must not touch the XLA backend (jax.devices / process_count)
    # before jax.distributed.initialize — backend init pins single-process.
    try:
        already = jax.distributed.is_initialized()
    except AttributeError:  # older jax
        already = getattr(jax._src.distributed.global_state, "client", None) is not None
    if already:
        return
    if coordinator_address is not None:
        # explicit cluster spec: a failure to rendezvous is a real error —
        # do NOT swallow it (a silently-single process would shard wrong)
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return
    try:
        jax.distributed.initialize()
    except (RuntimeError, ValueError) as e:
        # auto-detection path only: single-process / already-initialized
        # environments are normal here, but say so instead of hiding it
        import logging

        logging.getLogger(__name__).info(
            "jax.distributed found no cluster environment (%s); running "
            "single-process — on GPU hosts pass coordinator_address, "
            "num_processes and process_id",
            e,
        )


def global_mesh(axis: str = "dp") -> Mesh:
    """1-D mesh over every device in the (possibly multi-host) slice."""
    return Mesh(np.array(jax.devices()), (axis,))


def replicate_to_global(x, mesh: Mesh):
    """Place a host-local array replicated across the global mesh."""
    return jax.device_put(x, NamedSharding(mesh, P()))


def is_coordinator() -> bool:
    return jax.process_index() == 0
