"""Map-backend dispatch: 'point' (append-only + exact NN, the default),
'voxel' (sorted voxel hash with spatial lookups, reference-style), or
'sharded' (the voxel hash spatially sharded over a device mesh).

The choice is static (``config.map_backend``), so the SLAM state pytree
simply contains whichever map type the config selects — no runtime
branching, no shape unions. The sharded backend's map carries a leading
device axis (``(D, ...)`` leaves, one voxel-hash shard per device); its
operations take the ``mesh`` the pipeline runs under and use
``shard_map`` + collectives (``parallel/sharded_map.py``) — the
streaming analog of the reference's single global octree
(``src/icpslam/octree_mapper.cpp:19`` of the reference) across cards.
"""

from __future__ import annotations

from typing import Optional, Union

import jax.numpy as jnp
from jax.sharding import Mesh

from icpslam_tpu.cloud.pointcloud import PointCloud
from icpslam_tpu.config import SlamConfig
from icpslam_tpu.mapping import point_map as pm
from icpslam_tpu.mapping import voxel_map as vm

MapState = Union[pm.PointMap, vm.VoxelMap]


def is_sharded(map_: MapState) -> bool:
    """Sharded maps are VoxelMap pytrees with a leading device axis."""
    return isinstance(map_, vm.VoxelMap) and map_.keys.ndim == 3


def _sharded_ops():
    # local import: parallel/ imports mapping/ for the shard kernels
    from icpslam_tpu.parallel import sharded_map as sm

    return sm


def empty(config: SlamConfig) -> MapState:
    if config.map_backend == "point":
        return pm.empty_map(config.max_map_points)
    if config.map_backend == "sharded":
        # per-shard capacity = max_map_points: total capacity scales
        # linearly with devices — the point of sharding (SURVEY §5.7)
        return _sharded_ops().empty_sharded_map(
            config.max_map_points, config.map_shards
        )
    return vm.empty_map(config.max_map_points)


def reset(map_: MapState) -> MapState:
    if isinstance(map_, pm.PointMap):
        return pm.reset(map_)
    if is_sharded(map_):
        return _sharded_ops().reset(map_)
    return vm.reset(map_)


def total_size(map_: MapState) -> jnp.ndarray:
    """Live entries across all shards (scalar for local backends)."""
    return jnp.sum(map_.size)


def total_overflow(map_: MapState) -> jnp.ndarray:
    return jnp.sum(map_.overflow)


def insert(
    map_: MapState,
    cloud: PointCloud,
    resolution: float,
    covs: jnp.ndarray | None = None,
    mesh: Optional[Mesh] = None,
    eviction: str = "none",
) -> MapState:
    """``covs``: optional packed (6, N) map-frame surface covariances
    (``linalg3.mat_to_sym6`` layout) stored with the points (point backend
    only; the voxel backends ignore them — their plane-mode queries
    recompute covariances from the NN cloud). ``eviction``: full-map
    policy (``config.map_eviction``; point backend only — the voxel
    backends keep counted drops)."""
    if isinstance(map_, pm.PointMap):
        return pm.insert(map_, cloud, resolution, covs=covs, eviction=eviction)
    if is_sharded(map_):
        assert mesh is not None, "sharded map ops need the mesh"
        return _sharded_ops().insert(map_, cloud, resolution, mesh)
    return vm.insert(map_, cloud, resolution)


def insert_reusing_nn(
    map_: MapState,
    cloud: PointCloud,
    resolution: float,
    nn_dist2: jnp.ndarray,
    covs: jnp.ndarray | None = None,
    mesh: Optional[Mesh] = None,
    eviction: str = "none",
) -> MapState:
    """Insert with a precomputed per-point NN distance to the map.

    Point backend: skips the dedup NN sweep (``point_map.insert_with_nn``).
    Voxel backends: the sorted index must be rebuilt anyway, so this is
    the plain insert.
    """
    if isinstance(map_, pm.PointMap):
        return pm.insert_with_nn(
            map_, cloud, resolution, nn_dist2, covs=covs, eviction=eviction
        )
    return insert(map_, cloud, resolution, mesh=mesh)


def query_nn(
    map_: MapState,
    points: jnp.ndarray,
    mask: jnp.ndarray,
    config: SlamConfig,
    mesh: Optional[Mesh] = None,
) -> vm.MapNNResult:
    if isinstance(map_, pm.PointMap):
        return pm.exact_nn(map_, points, mask)
    if is_sharded(map_):
        assert mesh is not None, "sharded map ops need the mesh"
        return _sharded_ops().approx_nn(
            map_, points, mask, config.map_resolution, mesh,
            radius=config.map_nn_radius,
        )
    return vm.approx_nn(
        map_, points, mask, config.map_resolution, radius=config.map_nn_radius
    )


def query_nn_with_covs(
    map_: MapState,
    points: jnp.ndarray,
    mask: jnp.ndarray,
    config: SlamConfig,
    mesh: Optional[Mesh] = None,
):
    """NN query returning stored covariances when the backend carries them.

    Returns ``(MapNNResult, covs_or_None)`` — ``covs`` is packed (6, Q) in
    the *map* frame for the point backend, ``None`` for the voxel/sharded
    backends (whose callers recompute from the NN cloud).
    """
    if isinstance(map_, pm.PointMap):
        return pm.exact_nn_with_covs(map_, points, mask)
    return query_nn(map_, points, mask, config, mesh=mesh), None
