"""Fixed-capacity padded point clouds.

XLA compiles for static shapes, so a cloud is a ``(capacity, 3)`` float array
plus a ``(capacity,)`` validity mask; every op is mask-aware. This replaces
PCL's dynamically-sized ``PointCloud<PointXYZ>`` used throughout the
reference (e.g. ``/root/reference/src/icpslam/icp_odometer.cpp:96-101``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from icpslam_tpu.geometry.se3 import Pose, transform_points


class PointCloud(NamedTuple):
    points: jnp.ndarray  # (N, 3) float; padded entries are zeros
    mask: jnp.ndarray    # (N,) bool; True where the point is real

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    def count(self) -> jnp.ndarray:
        """Number of valid points (traced scalar)."""
        return jnp.sum(self.mask.astype(jnp.int32), axis=-1)


def empty(capacity: int, dtype=jnp.float32) -> PointCloud:
    return PointCloud(
        points=jnp.zeros((capacity, 3), dtype=dtype),
        mask=jnp.zeros((capacity,), dtype=bool),
    )


def from_points(points, capacity: Optional[int] = None, dtype=jnp.float32) -> PointCloud:
    """Pad a host-side (n, 3) array into a fixed-capacity cloud."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    capacity = n if capacity is None else capacity
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    buf = np.zeros((capacity, 3), dtype=np.float32)
    buf[:n] = points
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return PointCloud(points=jnp.asarray(buf, dtype=dtype), mask=jnp.asarray(mask))


def to_numpy(cloud: PointCloud) -> np.ndarray:
    """Extract the valid points as a host-side (n, 3) array."""
    pts = np.asarray(cloud.points)
    mask = np.asarray(cloud.mask)
    return pts[mask]


def transform(pose: Pose, cloud: PointCloud) -> PointCloud:
    """Rigidly transform a cloud; padding stays zeroed."""
    moved = transform_points(pose, cloud.points)
    return PointCloud(points=jnp.where(cloud.mask[..., None], moved, 0.0), mask=cloud.mask)


def masked_centroid(cloud: PointCloud) -> jnp.ndarray:
    w = cloud.mask.astype(cloud.points.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    return jnp.sum(cloud.points * w[..., None], axis=-2) / n
