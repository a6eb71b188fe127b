"""Nearest-neighbor search: exact 1-NN and k-NN over small point clouds.

PCL's GICP finds correspondences with a k-d tree per query point
(the reference's ``src/icpslam/icp_odometer.cpp:188-199`` internals). For
scan-sized clouds (≤ ~16k points) a *blocked brute-force* search is the
accelerator formulation: exact (not approximate) NN, so better
correspondences than the reference's tree.

Two implementations of one contract, chosen in one place
(``fused_nn_enabled``):

- the plain path below: ``d²(q, t) = |q|² − 2·q@tᵀ + |t|²`` per block of
  queries (``lax.map``), masked targets at +inf before the argmin. It runs
  everywhere and is the reference the kernel is checked against;
- on the GPU, the fused Triton kernel ``ops.pallas.nn_kernel`` that keeps
  the running argmin on-chip and stops at ``valid_len``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

_INF = jnp.inf


class NNResult(NamedTuple):
    idx: jnp.ndarray    # (N,) int32 index into target of the nearest point
    dist2: jnp.ndarray  # (N,) squared distance (inf where no valid target)


def _pad_blocks(n: int, block: int) -> int:
    return (n + block - 1) // block * block


def fused_nn_enabled(platform: str | None = None) -> bool:
    """The kernel choice: the fused NN kernel on the GPU, the plain path
    elsewhere (the CPU, which the tests use, is a supported platform).

    ``platform`` defaults to where computations are placed: the device of
    an active ``jax.default_device`` context, else the default backend.
    """
    if platform is None:
        dev = jax.config.jax_default_device
        platform = (getattr(dev, "platform", dev) if dev is not None
                    else jax.default_backend())
    return platform in ("gpu", "cuda")


def nearest_neighbors(
    query: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
    block: int = 1024,
    fused: bool | None = None,
    valid_len: jnp.ndarray | None = None,
) -> NNResult:
    """Exact 1-NN of each query point in the (masked) target cloud.

    query: (N, 3); target: (M, 3); target_mask: (M,) bool.
    Returns idx (N,) and dist2 (N,). Queries are not masked here — callers
    combine ``dist2`` with their own query mask.

    ``valid_len``: optional traced scalar — live-prefix length of a
    fixed-capacity target buffer (everything past it must also be masked
    out). The fused kernel stops there, so cost scales with fill, not
    capacity; the plain path ignores it (masking already guarantees
    correctness).

    ``fused``: None picks by platform (``fused_nn_enabled``); True/False
    force the kernel or the plain path.
    """
    if fused is None:
        fused = fused_nn_enabled()
    if fused:
        from icpslam_tpu.ops.pallas import nn_kernel  # local: avoids a cycle

        return nn_kernel.nearest_neighbors_triton(
            query, target, target_mask, valid_len=valid_len
        )
    n = query.shape[0]
    np_ = _pad_blocks(n, block)
    # center on the query centroid: NN is translation-invariant; small
    # coordinates curb cancellation in |q|² − 2q·t + |t|² when the map
    # frame has drifted far from the origin
    center = jnp.mean(query, axis=0, keepdims=True)
    query = query - center
    target = target - center
    qpad = jnp.pad(query, ((0, np_ - n), (0, 0)))
    qblocks = qpad.reshape(np_ // block, block, 3)

    t_norm2 = jnp.sum(target * target, axis=-1)
    t_norm2 = jnp.where(target_mask, t_norm2, _INF)
    tT = target.T  # (3, M)

    def one_block(qb):
        # (B, M) distance via the cross term. HIGHEST: a reduced-precision
        # f32 product (TF32 or bf16 operands) mis-selects neighbors and
        # corrupts d² by O(|t||q|/2⁸) at map-scale coordinates.
        cross = jnp.dot(
            qb, tT, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        d2 = jnp.sum(qb * qb, axis=-1)[:, None] - 2.0 * cross + t_norm2[None, :]
        idx = jnp.argmin(d2, axis=-1).astype(jnp.int32)
        best = jnp.take_along_axis(d2, idx[:, None], axis=-1)[:, 0]
        return idx, best

    idxs, d2s = jax.lax.map(one_block, qblocks)
    idx = idxs.reshape(np_)[:n]
    d2 = d2s.reshape(np_)[:n]
    # numerical noise can push tiny distances slightly negative
    d2 = jnp.where(jnp.isfinite(d2), jnp.maximum(d2, 0.0), d2)
    return NNResult(idx=idx, dist2=d2)


def knn(
    query: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
    k: int,
    block: int = 512,
    precision=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact k-NN: returns (idx (N, k) int32, dist2 (N, k)), nearest first.

    Blocked distance matmul + ``lax.top_k`` per block of queries. Invalid
    targets sort last with +inf distance; if fewer than k valid targets
    exist the trailing neighbors have inf dist2 (callers mask).

    ``precision`` overrides the distance-matmul precision — HIGHEST by
    default (exact selection); statistics consumers (GICP covariances)
    pass HIGH, which is TF32 on the GPU.
    """
    n = query.shape[0]
    np_ = _pad_blocks(n, block)
    center = jnp.mean(query, axis=0, keepdims=True)
    query = query - center
    target = target - center
    qpad = jnp.pad(query, ((0, np_ - n), (0, 0)))
    qblocks = qpad.reshape(np_ // block, block, 3)

    t_norm2 = jnp.sum(target * target, axis=-1)
    t_norm2 = jnp.where(target_mask, t_norm2, _INF)
    tT = target.T

    prec = jax.lax.Precision.HIGHEST if precision is None else precision

    def one_block(qb):
        cross = jnp.dot(
            qb, tT, preferred_element_type=jnp.float32, precision=prec,
        )
        d2 = jnp.sum(qb * qb, axis=-1)[:, None] - 2.0 * cross + t_norm2[None, :]
        neg_top, idx = jax.lax.top_k(-d2, k)
        return idx.astype(jnp.int32), -neg_top

    idxs, d2s = jax.lax.map(one_block, qblocks)
    idx = idxs.reshape(np_, k)[:n]
    d2 = d2s.reshape(np_, k)[:n]
    d2 = jnp.where(jnp.isfinite(d2), jnp.maximum(d2, 0.0), d2)
    return idx, d2
