"""Voxel-grid operations on padded clouds.

``voxel_downsample`` replaces PCL's ``VoxelGrid`` filter
(``/root/reference/src/icpslam/icp_odometer.cpp:96-101``): one centroid per
occupied voxel. The formulation is sort-based — pack voxel coordinates
into one 32-bit key, sort keys with the point components as payload, and
reduce each sorted segment to its centroid via cumulative-sum differences
— all static shapes, no host round-trip, no colliding scatters.

The voxel-coordinate helpers here are shared with the mapping layer
(occupancy dedup and approximate NN in ``mapping/voxel_map.py``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from icpslam_tpu.cloud.pointcloud import PointCloud

# Sentinel voxel coordinate for invalid (padding) points: sorts after any
# real voxel. Real coords are bounded by |x| / resolution; 2**24 leaves a
# huge margin for e.g. ±800 km extent at 0.05 m resolution.
SENTINEL: int = 2**24


def voxel_coords(points: jnp.ndarray, resolution: float, mask=None) -> jnp.ndarray:
    """Integer voxel coordinates (..., 3) int32; invalid points → SENTINEL."""
    coords = jnp.floor(points / resolution).astype(jnp.int32)
    if mask is not None:
        coords = jnp.where(mask[..., None], coords, SENTINEL)
    return coords


def lexsort_order(coords: jnp.ndarray) -> jnp.ndarray:
    """Sort order over rows of (N, 3) int32 coords (x primary, then y, z)."""
    return jnp.lexsort((coords[:, 2], coords[:, 1], coords[:, 0]))


def segment_starts(sorted_coords: jnp.ndarray, sorted_valid: jnp.ndarray) -> jnp.ndarray:
    """Boolean (N,) marking the first row of each run of equal coords.

    Only valid rows can start a segment; invalid rows (all-SENTINEL) are
    excluded via ``sorted_valid``.
    """
    prev = jnp.roll(sorted_coords, 1, axis=0)
    differs = jnp.any(sorted_coords != prev, axis=-1)
    differs = differs.at[0].set(True)
    return differs & sorted_valid


# Packed-key sort: a single scan has bounded extent, so voxel coordinates
# relative to the scan's min corner fit in 11+11+10 bits (2048×2048×1024
# cells — e.g. 409×409×204 m at 0.2 m leaves). One 32-bit sort replaces
# the 3-pass lexsort. Out-of-range cells (gigantic scans / tiny leaves)
# clamp into the boundary cell; that merges only the pathological fringe.
_PACK_BITS = (11, 11, 10)

# Invalid points carry int32 max as their key. Validity is *encoded in the
# key itself* (key != _INVALID_KEY) so the sort needs no separate mask
# payload — one fewer sort operand. The
# single valid bit pattern that would collide (rel cell 1023/2047/1023)
# is remapped to its −z neighbor below — one more fringe-merge cell on
# top of the clamping caveat.
# plain Python int (NOT a jnp scalar): a module-level device array would
# initialize the XLA backend at import time, which breaks
# jax.distributed.initialize in multi-process runs (it must run first)
_INVALID_KEY = 2**31 - 1


def _packed_keys(coords: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """(N,) int32 sort keys from relative voxel coords; invalid → max key."""
    bx, by, bz = _PACK_BITS
    base = jnp.min(jnp.where(valid[:, None], coords, 2**22), axis=0)
    rel = coords - base
    rx = jnp.clip(rel[:, 0], 0, (1 << bx) - 1)
    ry = jnp.clip(rel[:, 1], 0, (1 << by) - 1)
    rz = jnp.clip(rel[:, 2], 0, (1 << bz) - 1)
    key = (rx << (by + bz)) | (ry << bz) | rz
    key = jnp.where(key == _INVALID_KEY, key - 1, key)
    return jnp.where(valid, key, _INVALID_KEY)


def voxel_downsample(
    cloud: PointCloud, resolution: float, capacity: int
) -> Tuple[PointCloud, jnp.ndarray]:
    """Downsample to one centroid per occupied voxel.

    Returns ``(filtered_cloud, num_voxels)`` where ``filtered_cloud`` has the
    given static ``capacity`` and ``num_voxels`` is the true number of
    occupied voxels — callers can detect overflow via
    ``num_voxels > capacity`` (voxels beyond capacity are dropped in sorted
    coordinate order; SURVEY.md "no silent caps").

    Formulation: one multi-operand ``lax.sort`` carries the point
    components with the packed keys (no post-sort index gathers), segment
    sums come from cumulative-sum differences at segment boundaries, and
    the only scatter is a *collision-free* start-position scatter instead
    of a colliding per-point ``.at[].add`` (and no index-gather of the
    payload).
    """
    coords = voxel_coords(cloud.points, resolution, cloud.mask)
    keys = _packed_keys(coords, cloud.mask)
    p = cloud.points
    n = keys.shape[0]
    # validity rides the key (_INVALID_KEY ⇔ masked) — no mask payload
    sk, px, py, pz = jax.lax.sort(
        (keys, p[:, 0], p[:, 1], p[:, 2]), num_keys=1
    )
    sv = sk != _INVALID_KEY

    # packed keys are injective over the bounded extent, so a key change
    # in sorted order IS a voxel boundary (clamped fringe cells merge —
    # same caveat as the packed sort itself)
    starts = (sk != jnp.roll(sk, 1)).at[0].set(True) & sv
    slot = jnp.cumsum(starts.astype(jnp.int32)) - 1
    num_voxels = jnp.where(jnp.any(sv), slot[-1] + 1, 0)

    # Cumulative sums run over voxel-RELATIVE offsets (point − its own
    # voxel corner, each ∈ [0, res)): a cumsum of absolute coordinates
    # reaches ~N·|x| and its segment differences would cancel to ~cm
    # noise in f32. Offsets keep the running sum ≤ N·res.
    w = sv.astype(p.dtype)
    ox = jnp.floor(px / resolution) * resolution
    oy = jnp.floor(py / resolution) * resolution
    oz = jnp.floor(pz / resolution) * resolution
    cw = jnp.cumsum(w)
    cx = jnp.cumsum(w * (px - ox))
    cy = jnp.cumsum(w * (py - oy))
    cz = jnp.cumsum(w * (pz - oz))

    # start row of each voxel slot (collision-free scatter: one start per
    # slot); unused slots keep N so their segments are empty
    pos = jnp.full((capacity + 1,), n, jnp.int32).at[
        jnp.where(starts & (slot < capacity), slot, capacity + 1)
    ].set(jnp.arange(n, dtype=jnp.int32), mode="drop")
    nxt = pos[1:]
    pos = pos[:capacity]
    # segment sum over [pos, nxt): invalid rows carry zero weight, so the
    # sorted invalid tail never contaminates the last segment
    end = jnp.minimum(nxt - 1, n - 1)
    prev_i = jnp.maximum(pos - 1, 0)
    has_prev = pos > 0

    def seg(c):
        return c[end] - jnp.where(has_prev, c[prev_i], 0.0)

    counts = seg(cw)
    occupied = counts > 0
    denom = jnp.maximum(counts, 1.0)
    pos_c = jnp.minimum(pos, n - 1)  # safe gather index for empty slots
    # segment corner = the first row's voxel corner (all rows in a segment
    # share it, except clamped fringe cells — the documented merge caveat)
    corner = jnp.stack([ox[pos_c], oy[pos_c], oz[pos_c]], axis=-1)
    centroids = corner + (
        jnp.stack([seg(cx), seg(cy), seg(cz)], axis=-1) / denom[:, None]
    )
    centroids = jnp.where(occupied[:, None], centroids, 0.0)
    return PointCloud(points=centroids, mask=occupied), num_voxels
