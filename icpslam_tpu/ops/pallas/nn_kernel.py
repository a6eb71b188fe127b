"""Fused exact 1-NN for the GPU: Pallas through Triton.

The plain path (``ops.nn``) computes ``d² = |q|² − 2q·tᵀ + |t|²`` for a
block of queries against the whole target buffer and argmins it: XLA writes
each (B, M) distance block to device memory and reads it back, and sweeps
the full capacity of a fixed-size map buffer whatever its fill. This kernel
keeps the running minimum of a query block in registers while it walks over
the target tiles, so no distance ever leaves the chip, and the walk stops at
``valid_len``: map-query cost scales with fill.

Design (one program per query block; blocks run in no order):

- ``d² = Σ_c (t_c − q_c)²`` in float32 on the CUDA cores. With three
  coordinates there is no work for the tensor cores, and the subtraction
  form has no cancellation, so far-from-origin map frames need no
  re-centring.
- A ``fori_loop`` inside the program walks the live target tiles; its trip
  count comes from ``valid_len``, which the program loads itself.
- The running best is kept per (query, lane) — a (BQ, BT) pair of
  registers updated elementwise with a strict ``<`` — and reduced over the
  lanes once, after the walk (lowest target index on ties, as in the plain
  path). A per-tile min/argmin would pay a cross-lane reduction on every
  step.
- Masked targets carry ``+inf`` in a fourth penalty row; query and target
  counts are padded to whole tiles, so any N and M are accepted.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from icpslam_tpu.ops.nn import NNResult

# the fastest tiling of a sweep on the H100 at the odometry (8192²) and
# map (8192 × 262144, partial and full fill) shapes
BQ = 32     # queries per program
BT = 128    # targets per loop step (the lanes of the running best)
NUM_WARPS = 8


def _nn_kernel(vl_ref, q_ref, t_ref, idx_ref, d2_ref, *, bt: int):
    """Program i: query block i against targets [0, valid_len).

    vl_ref: (1,) int32 live-target count; q_ref: (4, BQ) query block
    (rows x, y, z, unused); t_ref: (4, M) whole target buffer (rows x, y,
    z, penalty: 0 live, +inf masked); idx_ref/d2_ref: (BQ,) outputs.
    """
    n_tiles = (vl_ref[0] + bt - 1) // bt
    q0 = q_ref[0, :][:, None]
    q1 = q_ref[1, :][:, None]
    q2 = q_ref[2, :][:, None]
    shape = (q0.shape[0], bt)

    def step(j, carry):
        best, tile = carry
        sl = pl.ds(j * bt, bt)
        e0 = t_ref[0, sl][None, :] - q0
        e1 = t_ref[1, sl][None, :] - q1
        e2 = t_ref[2, sl][None, :] - q2
        d2 = e0 * e0 + e1 * e1 + e2 * e2 + t_ref[3, sl][None, :]
        better = d2 < best
        return jnp.where(better, d2, best), jnp.where(better, j, tile)

    best, tile = jax.lax.fori_loop(
        0, n_tiles, step,
        (jnp.full(shape, jnp.inf, jnp.float32), jnp.zeros(shape, jnp.int32)),
    )
    lane = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    idx = tile * bt + lane
    d2 = jnp.min(best, axis=1)
    # lowest target index among the lanes that reach the minimum
    big = jnp.iinfo(jnp.int32).max
    idx = jnp.min(jnp.where(best == d2[:, None], idx, big), axis=1)
    idx_ref[...] = jnp.where(idx == big, 0, idx)
    d2_ref[...] = d2


@functools.partial(
    jax.jit, static_argnames=("bq", "bt", "interpret")
)
def nearest_neighbors_triton(
    query: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
    valid_len: jnp.ndarray | None = None,
    bq: int = BQ,
    bt: int = BT,
    interpret: bool = False,
) -> NNResult:
    """Exact 1-NN of each query in the masked target buffer.

    Same contract as ``ops.nn.nearest_neighbors``: query (N, 3), target
    (M, 3), target_mask (M,); any N and M. ``valid_len`` (traced int32
    scalar): targets at or past it are never visited and must be masked.
    """
    n, m = query.shape[0], target.shape[0]
    n_pad = pl.cdiv(n, bq) * bq
    m_pad = pl.cdiv(m, bt) * bt
    qT = jnp.pad(query.astype(jnp.float32).T, ((0, 1), (0, n_pad - n)))
    pen = jnp.where(target_mask, 0.0, jnp.inf).astype(jnp.float32)
    tT = jnp.concatenate([target.astype(jnp.float32).T, pen[None, :]])
    tT = jnp.pad(tT, ((0, 0), (0, m_pad - m)))
    tT = tT.at[3, m:].set(jnp.inf)
    vl = jnp.asarray(m if valid_len is None else valid_len, jnp.int32)
    vl = jnp.clip(vl, 0, m).reshape(1)

    idx, d2 = pl.pallas_call(
        functools.partial(_nn_kernel, bt=bt),
        grid=(n_pad // bq,),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (0,)),
            pl.BlockSpec((4, bq), lambda i: (0, i)),
            pl.BlockSpec((4, m_pad), lambda i: (0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((bq,), lambda i: (i,)),
            pl.BlockSpec((bq,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n_pad,), jnp.int32),
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="nn_fused",
    )(vl, qT, tT)
    return NNResult(idx=idx[:n], dist2=d2[:n])
