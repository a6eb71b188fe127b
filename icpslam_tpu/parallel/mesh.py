"""Device-mesh helpers for multi-chip / multi-host execution.

The reference has no distribution at all (SURVEY.md §2.3: a single ROS
process; README admits even thread safety is unfinished). This framework's
scaling story is JAX-native: a named 1-D ``Mesh`` over the devices,
explicit shardings, and XLA collectives (NCCL over NVLink between GPUs) —
no hand-written communication.

Axis conventions used across ``parallel/``:
- ``"dp"``  — data parallel over independent work items (scan pairs,
  graph-edge shards, NN query blocks)
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (all by default)."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def shard_leading(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Sharding that splits the leading array axis across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, k: int) -> int:
    return (n + k - 1) // k * k
