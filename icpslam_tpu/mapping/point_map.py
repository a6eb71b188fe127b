"""Append-only point map with distance-gated dedup — the default backend.

The sorted ``VoxelMap`` maintains a spatial index so CPU-style voxel
lookups work; but a brute-force exact NN over the live map (the fused
kernel ``ops.pallas.nn_kernel`` on the GPU) answers map queries without
any index, which leaves index maintenance (sort/merge scatters) as pure
cost. This backend drops it entirely:

- the map is a flat (C, 3) array + size; insertion appends
- dedup is *distance-gated*: a candidate point is added only if no
  existing map point lies within ``resolution`` — the same density bound
  as the reference's voxel-occupancy gate (two points in one voxel are at
  most √3·res apart), enforced with one exact-NN pass
- per-scan self-dedup still uses the voxel downsample (one centroid per
  voxel), so a single insert cannot flood a region
- each map point optionally carries its **GICP surface covariance**
  (packed symmetric components, map frame), stored at insert time from the scan
  whose neighborhood already computed it — so scan-to-map plane ICP
  *gathers* target covariances with the NN result instead of re-running
  a neighborhood pass over the NN cloud every scan (the reference
  recomputes them inside PCL GICP each call,
  ``octree_mapper.cpp:101-124``; same surface, same statistic, computed
  once instead of per-query)

Insert cost ≈ one NN pass + one small append scatter; queries are the
same exact-NN kernel. Selected with ``config.map_backend == 'point'``
(the default); the voxel backend remains for CPU-heavy use and for the
spatially-sharded multi-device map.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from icpslam_tpu.cloud.pointcloud import PointCloud
from icpslam_tpu.cloud.voxel import voxel_downsample
from icpslam_tpu.mapping.voxel_map import MapNNResult
from icpslam_tpu.ops import nn as nn_ops
from icpslam_tpu.ops.covariance import EYE6 as _EYE6


class PointMap(NamedTuple):
    points: jnp.ndarray    # (C, 3)
    covs: jnp.ndarray      # (6, C) packed GICP covariances, map frame
                           # (linalg3.mat_to_sym6 component order)
    size: jnp.ndarray      # int32 live points
    overflow: jnp.ndarray  # int32 points dropped at capacity

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def occupancy_mask(self) -> jnp.ndarray:
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.size

    def as_cloud(self) -> PointCloud:
        return PointCloud(points=self.points, mask=self.occupancy_mask())


def empty_map(capacity: int, dtype=jnp.float32) -> PointMap:
    return PointMap(
        points=jnp.zeros((capacity, 3), dtype),
        covs=jnp.broadcast_to(jnp.asarray(_EYE6, dtype)[:, None], (6, capacity)),
        size=jnp.asarray(0, jnp.int32),
        overflow=jnp.asarray(0, jnp.int32),
    )


def reset(pmap: PointMap) -> PointMap:
    return empty_map(pmap.capacity, pmap.points.dtype)


def _append(
    pmap: PointMap,
    points: jnp.ndarray,
    new: jnp.ndarray,
    covs: Optional[jnp.ndarray],
    eviction: str = "none",
) -> PointMap:
    """Scatter-append the ``new``-masked points (and covariances).

    ``eviction='ring'``: at capacity, overwrite the OLDEST points (FIFO)
    instead of dropping the new ones — ``overflow`` then counts
    evictions. The write cursor needs no extra state: ``size + overflow``
    is the monotone count of points ever written, so ``% capacity`` IS
    the ring position (``size`` saturates at capacity, ``overflow``
    keeps growing).
    """
    C = pmap.capacity
    n_new = jnp.sum(new.astype(jnp.int32))
    if eviction == "ring":
        rank = jnp.cumsum(new.astype(jnp.int32))  # 1-based among new
        # a single insert larger than the whole map would wrap the ring
        # onto itself (duplicate scatter indices → undefined winner);
        # keep only the NEWEST C points of the batch — the older extras
        # are evictions like any other and stay in the overflow count
        new = new & ((n_new - rank) < C)
        start = pmap.size + pmap.overflow        # points ever written
        pos = start + jnp.cumsum(new.astype(jnp.int32)) - 1
        pos = jnp.where(new, pos % C, C)         # wrap; masked -> dropped
    else:
        pos = pmap.size + jnp.cumsum(new.astype(jnp.int32)) - 1
        pos = jnp.where(new & (pos < C), pos, C)
    out_points = pmap.points.at[pos].set(points, mode="drop")
    if covs is None:
        packed = jnp.broadcast_to(
            jnp.asarray(_EYE6, pmap.covs.dtype)[:, None], (6, points.shape[0])
        )
    else:
        packed = covs  # (6, N) components-first
    out_covs = pmap.covs.at[:, pos].set(packed, mode="drop")
    total = pmap.size + n_new
    return PointMap(
        points=out_points,
        covs=out_covs,
        size=jnp.minimum(total, C),
        overflow=pmap.overflow + jnp.maximum(total - C, 0),
    )


def insert(
    pmap: PointMap,
    cloud: PointCloud,
    resolution: float,
    covs: Optional[jnp.ndarray] = None,
    eviction: str = "none",
) -> PointMap:
    """Distance-gated append of a (map-frame) cloud.

    ``covs``: optional packed (6, N) map-frame surface covariances stored
    with the inserted points (identity when omitted). Note the voxel
    downsample inside reorders points, so ``covs`` given here must match
    the *downsampled* order — callers with per-point covariances should
    pre-downsample and use ``insert_with_nn`` instead.
    """
    filt, _ = voxel_downsample(cloud, resolution, cloud.capacity)
    res = nn_ops.nearest_neighbors(
        filt.points, pmap.points, pmap.occupancy_mask(), valid_len=pmap.size
    )
    # no existing map point within `resolution` → genuinely new surface
    far = ~(res.dist2 < resolution * resolution)  # True also when dist2=inf
    new = filt.mask & far
    return _append(pmap, filt.points, new, covs, eviction=eviction)


def insert_with_nn(
    pmap: PointMap,
    cloud: PointCloud,
    resolution: float,
    nn_dist2: jnp.ndarray,
    covs: Optional[jnp.ndarray] = None,
    eviction: str = "none",
) -> PointMap:
    """Distance-gated append reusing a precomputed NN distance per point.

    ``nn_dist2`` is each cloud point's squared distance to the current map
    (inf where no map point / invalid query). Callers that just ran a map
    NN query for registration (``scan_to_map.refine_and_grow``) pass it
    here to skip the second full NN sweep ``insert`` would pay. The
    distances may be measured at a slightly different pose (pre-refinement)
    — the dedup gate is a density bound, not an exact occupancy test (the
    reference's voxel gate is equally approximate), and the refinement
    correction is ≪ resolution for accepted scans. The cloud must already
    be self-deduplicated (one point per ``resolution`` cell — true for
    voxel-filtered scans with leaf ≥ resolution).

    ``covs``: optional packed (6, N) map-frame covariances, aligned with
    ``cloud`` (identity when omitted).
    """
    far = ~(nn_dist2 < resolution * resolution)  # True also when dist2=inf
    new = cloud.mask & far
    return _append(pmap, cloud.points, new, covs, eviction=eviction)


def exact_nn(pmap: PointMap, points: jnp.ndarray, mask: jnp.ndarray) -> MapNNResult:
    """Exact NN of query points against the map (fused kernel on the GPU).

    The append-only map is prefix-filled, so the kernel sweeps only the
    live prefix — query cost scales with map *fill*, not capacity."""
    res, _ = _exact_nn_idx(pmap, points, mask)
    return res


def exact_nn_with_covs(
    pmap: PointMap, points: jnp.ndarray, mask: jnp.ndarray,
) -> Tuple[MapNNResult, jnp.ndarray]:
    """Exact NN plus the stored (map-frame) covariance of each winner.

    Returns ``(MapNNResult, covs packed (6, Q))`` — identity covariance
    where nothing was found.
    """
    res, idx = _exact_nn_idx(pmap, points, mask)
    packed = pmap.covs[:, idx]  # (6, Q)
    eye6 = jnp.asarray(_EYE6, pmap.covs.dtype)
    return res, jnp.where(res.found[None, :], packed, eye6[:, None])


def _exact_nn_idx(
    pmap: PointMap, points: jnp.ndarray, mask: jnp.ndarray,
) -> Tuple[MapNNResult, jnp.ndarray]:
    res = nn_ops.nearest_neighbors(
        points, pmap.points, pmap.occupancy_mask(), valid_len=pmap.size,
    )
    found = mask & jnp.isfinite(res.dist2)
    return (
        MapNNResult(
            points=jnp.where(found[:, None], pmap.points[res.idx], 0.0),
            dist2=jnp.where(found, res.dist2, jnp.inf),
            found=found,
        ),
        res.idx,
    )
