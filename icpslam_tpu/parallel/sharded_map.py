"""Spatially-sharded voxel map over a device mesh.

The reference holds one global octree in one process
(``/root/reference/src/icpslam/octree_mapper.cpp:19``); its unbounded
growth is the pipeline's "sequence length" (SURVEY.md §5.7). Here the map
is partitioned across devices by *spatial block*: voxel coordinates are
grouped into coarse blocks (``2^block_shift`` voxels per side) and each
block is owned by exactly one device via a spatial hash. Consequences:

- **insert** needs no communication at all: the scan is replicated, each
  device keeps only the points whose block it owns and runs the normal
  occupancy-deduped local insert.
- **approx-NN** is a replicated query + local 3³-neighborhood search per
  shard + a min-reduction across the mesh (``pmin`` on distances with a
  lowest-device tie-break, ``psum`` to materialize the winning point).

Capacity scales linearly with devices (each shard has its own capacity),
which is the point: several cards hold a city-scale map no single card
could.
"""

from __future__ import annotations

from functools import partial


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from icpslam_tpu.cloud.pointcloud import PointCloud
from icpslam_tpu.mapping import voxel_map as vm
from icpslam_tpu.cloud.voxel import voxel_coords

BLOCK_SHIFT = 4  # 16^3 voxels per ownership block


def owner_of(coords: jnp.ndarray, n_devices: int, block_shift: int = BLOCK_SHIFT) -> jnp.ndarray:
    """Owning device id (…,) for voxel coords (…, 3)."""
    b = coords >> block_shift
    h = (
        b[..., 0] * jnp.int32(73856093)
        ^ b[..., 1] * jnp.int32(19349663)
        ^ b[..., 2] * jnp.int32(83492791)
    )
    return jnp.abs(h) % n_devices


def empty_sharded_map(capacity_per_shard: int, n_devices: int) -> vm.VoxelMap:
    """A VoxelMap pytree with a leading device axis (D, ...)."""
    one = vm.empty_map(capacity_per_shard)
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n_devices,) + x.shape), one
    )


def shard_placement(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    return NamedSharding(mesh, P(axis))


def insert(
    smap: vm.VoxelMap,
    cloud: PointCloud,
    resolution: float,
    mesh: Mesh,
    axis: str = "dp",
    block_shift: int = BLOCK_SHIFT,
) -> vm.VoxelMap:
    """Occupancy-deduped insert into the owning shards (no collectives)."""
    n = mesh.shape[axis]

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=P(axis),
    )
    def run(local_map, pts, msk):
        local_map = jax.tree_util.tree_map(lambda x: x[0], local_map)
        dev = jax.lax.axis_index(axis)
        coords = voxel_coords(pts, resolution, msk)
        own = owner_of(coords, n, block_shift) == dev
        local_cloud = PointCloud(points=pts, mask=msk & own)
        out = vm.insert(local_map, local_cloud, resolution)
        return jax.tree_util.tree_map(lambda x: x[None], out)

    return run(smap, cloud.points, cloud.mask)


def approx_nn(
    smap: vm.VoxelMap,
    points: jnp.ndarray,
    mask: jnp.ndarray,
    resolution: float,
    mesh: Mesh,
    axis: str = "dp",
    radius: int = 1,
) -> vm.MapNNResult:
    """Approximate NN against the sharded map; replicated result."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=(P(), P(), P()),
    )
    def run(local_map, pts, msk):
        # the NN reduce routes through dist_graph's ablation shim so the
        # scaling harness's comm-vs-compute attribution covers the map
        # collectives too, not just the solver's (ADVICE r4)
        from icpslam_tpu.parallel import dist_graph as dg

        def pmin(x):
            return x if dg.ABLATE_COLLECTIVES else jax.lax.pmin(x, axis)

        def psum(x):
            return x if dg.ABLATE_COLLECTIVES else jax.lax.psum(x, axis)

        local_map = jax.tree_util.tree_map(lambda x: x[0], local_map)
        res = vm.approx_nn(local_map, pts, msk, resolution, radius=radius)
        dev = jax.lax.axis_index(axis)
        # global best distance; lowest device id wins ties
        best_d2 = pmin(res.dist2)
        is_winner = (res.dist2 == best_d2) & res.found
        ndev = jax.lax.axis_size(axis)
        win_dev = pmin(jnp.where(is_winner, dev, ndev))
        final = is_winner & (dev == win_dev)
        pts_out = psum(jnp.where(final[:, None], res.points, 0.0))
        found = psum(final.astype(jnp.int32)) > 0
        return pts_out, best_d2, found

    pts_out, d2, found = run(smap, points, mask)
    d2 = jnp.where(found, d2, jnp.inf)
    return vm.MapNNResult(points=pts_out, dist2=d2, found=found)


def total_size(smap: vm.VoxelMap) -> jnp.ndarray:
    return jnp.sum(smap.size)


def reset(smap: vm.VoxelMap) -> vm.VoxelMap:
    n, cap = smap.keys.shape[0], smap.keys.shape[1]
    return empty_sharded_map(cap, n)
