"""Global map as a sorted voxel array with occupancy dedup and approx-NN.

Replaces PCL's ``OctreePointCloudSearch`` used by the reference's
``OctreeMapper`` (``/root/reference/src/icpslam/octree_mapper.cpp``):

- occupancy-gated insertion (one representative point per voxel — the
  semantic of ``addPointsToMap``'s ``isVoxelOccupiedAtPoint`` gate,
  ``octree_mapper.cpp:63-70``)
- approximate nearest neighbor per query point (``approxNearestSearch``
  per-point tree descent at ``:84``) — here a gather over the 3³ voxel
  neighborhood of each query, which is *less* approximate than PCL's
  single-leaf descent while being fully vectorized
- full reset (``resetMap``, ``:56-60``)

Formulation: the map is a fixed-capacity array of integer voxel
coordinates kept lexicographically sorted (empty slots hold a +SENTINEL key
and sort last). Membership and neighbor queries are vectorized binary
searches (log₂C rounds of gathers); insertion concatenates the deduped new
voxels and re-sorts — O((C+n)·log) XLA sort, no pointers, no host sync.
Capacity overflow is *counted* (never silent, SURVEY.md "no silent caps").
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from icpslam_tpu.cloud.pointcloud import PointCloud
from icpslam_tpu.cloud.voxel import SENTINEL, lexsort_order, voxel_coords, voxel_downsample


class VoxelMap(NamedTuple):
    keys: jnp.ndarray     # (C, 3) int32, lexicographically sorted; SENTINEL = empty
    points: jnp.ndarray   # (C, 3) float32 representative point per voxel
    size: jnp.ndarray     # int32 live voxels
    overflow: jnp.ndarray  # int32 voxels dropped because the map was full

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def occupancy_mask(self) -> jnp.ndarray:
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.size

    def as_cloud(self) -> PointCloud:
        return PointCloud(points=self.points, mask=self.occupancy_mask())


def empty_map(capacity: int, dtype=jnp.float32) -> VoxelMap:
    return VoxelMap(
        keys=jnp.full((capacity, 3), SENTINEL, jnp.int32),
        points=jnp.zeros((capacity, 3), dtype),
        size=jnp.asarray(0, jnp.int32),
        overflow=jnp.asarray(0, jnp.int32),
    )


def reset(vmap_: VoxelMap) -> VoxelMap:
    """Discard all map content — ``resetMap`` (``octree_mapper.cpp:56-60``)."""
    return empty_map(vmap_.capacity, vmap_.points.dtype)


def _lex_less(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Lexicographic a < b over trailing axis of 3."""
    return (a[..., 0] < b[..., 0]) | (
        (a[..., 0] == b[..., 0])
        & (
            (a[..., 1] < b[..., 1])
            | ((a[..., 1] == b[..., 1]) & (a[..., 2] < b[..., 2]))
        )
    )


def _lower_bound(keys: jnp.ndarray, queries: jnp.ndarray) -> jnp.ndarray:
    """Vectorized binary search: first index with keys[i] >= q (lex order).

    keys: (C, 3) sorted; queries: (Q, 3). Returns (Q,) int32 in [0, C].
    """
    C = keys.shape[0]
    Q = queries.shape[0]
    lo = jnp.zeros((Q,), jnp.int32)
    hi = jnp.full((Q,), C, jnp.int32)
    steps = max(C.bit_length(), 1) + 1  # enough rounds to close any [lo, hi)
    for _ in range(steps):
        mid = (lo + hi) // 2
        km = keys[jnp.clip(mid, 0, C - 1)]
        less = _lex_less(km, queries)
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    return lo


def lookup(vmap_: VoxelMap, coords: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Membership test for voxel coords (Q, 3).

    Returns (found (Q,) bool, idx (Q,) int32 — slot index when found,
    clamped otherwise).
    """
    C = vmap_.capacity
    idx = _lower_bound(vmap_.keys, coords)
    idx_c = jnp.clip(idx, 0, C - 1)
    hit = jnp.all(vmap_.keys[idx_c] == coords, axis=-1) & (idx < vmap_.size)
    return hit, idx_c


def insert(
    vmap_: VoxelMap, cloud: PointCloud, resolution: float
) -> VoxelMap:
    """Occupancy-gated insert of a (map-frame) cloud.

    One representative (centroid of this scan's points) per new voxel;
    voxels already occupied keep their existing point — matching the
    reference's first-wins semantics (``octree_mapper.cpp:66-68``).

    (A concatenate + lexsort, not a merge-by-rank scatter of map-sized
    arrays. The ``point_map`` backend skips sorted maintenance entirely
    and is the default.)
    """
    C = vmap_.capacity
    # one representative per incoming voxel
    filt, _ = voxel_downsample(cloud, resolution, cloud.capacity)
    coords = voxel_coords(filt.points, resolution, filt.mask)
    occupied, _ = lookup(vmap_, coords)
    new_mask = filt.mask & ~occupied

    new_keys = jnp.where(new_mask[:, None], coords, SENTINEL)
    all_keys = jnp.concatenate([vmap_.keys, new_keys], axis=0)
    all_pts = jnp.concatenate([vmap_.points, filt.points], axis=0)
    order = lexsort_order(all_keys)
    kept = order[:C]

    n_new = jnp.sum(new_mask.astype(jnp.int32))
    total = vmap_.size + n_new
    dropped = jnp.maximum(total - C, 0)
    return VoxelMap(
        keys=all_keys[kept],
        points=all_pts[kept],
        size=jnp.minimum(total, C),
        overflow=vmap_.overflow + dropped,
    )


def _neighbor_offsets(radius: int) -> jnp.ndarray:
    r = jnp.arange(-radius, radius + 1, dtype=jnp.int32)
    gx, gy, gz = jnp.meshgrid(r, r, r, indexing="ij")
    return jnp.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)  # (k, 3)


class MapNNResult(NamedTuple):
    points: jnp.ndarray  # (Q, 3) nearest map point (zeros when not found)
    dist2: jnp.ndarray   # (Q,) squared distance (inf when not found)
    found: jnp.ndarray   # (Q,) bool


def approx_nn(
    vmap_: VoxelMap,
    points: jnp.ndarray,
    mask: jnp.ndarray,
    resolution: float,
    radius: int = 1,
) -> MapNNResult:
    """Approximate NN of each query against the map: search the (2r+1)³
    voxel neighborhood of the query's voxel (reference analog:
    ``approxNearestNeighbors``, ``octree_mapper.cpp:73-90``)."""
    base = voxel_coords(points, resolution, mask)  # (Q, 3)
    offs = _neighbor_offsets(radius)  # (k, 3)
    cand = (base[:, None, :] + offs[None, :, :]).reshape(-1, 3)
    hit, idx = lookup(vmap_, cand)
    k = offs.shape[0]
    Q = points.shape[0]
    hit = hit.reshape(Q, k)
    cand_pts = vmap_.points[idx].reshape(Q, k, 3)
    d2 = jnp.sum((points[:, None, :] - cand_pts) ** 2, axis=-1)
    d2 = jnp.where(hit, d2, jnp.inf)
    best = jnp.argmin(d2, axis=-1)
    best_d2 = jnp.take_along_axis(d2, best[:, None], axis=-1)[:, 0]
    best_pts = jnp.take_along_axis(cand_pts, best[:, None, None], axis=1)[:, 0]
    found = jnp.isfinite(best_d2) & mask
    return MapNNResult(
        points=jnp.where(found[:, None], best_pts, 0.0),
        dist2=jnp.where(found, best_d2, jnp.inf),
        found=found,
    )
