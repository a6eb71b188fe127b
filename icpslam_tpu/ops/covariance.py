"""Per-point surface covariances for GICP (plane-to-plane) registration.

PCL's GICP estimates a covariance from each point's k nearest neighbors and
regularizes its eigenvalues to ``(1, 1, ε)`` — treating every local surface
patch as a disk (GICP, Segal et al.). Here all covariances are computed at
once: blocked k-NN (distance matmuls) → neighbor gather → closed-form
symmetric-3×3 eigen-solve → eigenvalue replacement.

Covariances are returned **components-first**: a ``(6, N)`` array packed as
``[xx, xy, xz, yy, yz, zz]`` (see ``ops.linalg3.mat_to_sym6``). The batch
axis is the last, contiguous one, so the whole pipeline — estimation here,
fusion/inversion inside ``ops.icp`` — runs elementwise over (N,) vectors
with no ``(N, 3, 3)`` intermediates. Convert with ``linalg3.sym6_to_mat``
when a dense matrix view is needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from icpslam_tpu.cloud.pointcloud import PointCloud
from icpslam_tpu.ops import nn as nn_ops
from icpslam_tpu.ops.linalg3 import (
    smallest_eigenvector_sym3_comps,
    sym3_comps,
)

# packed identity covariance [xx, xy, xz, yy, yz, zz]
EYE6 = (1.0, 0.0, 0.0, 1.0, 0.0, 1.0)


def _regularize_comps(comps, good, epsilon: float, dtype) -> jnp.ndarray:
    """GICP disk regularization ``I − (1−ε)·n nᵀ`` from the patch normal.

    ``comps``: six (N,) covariance components; ``good``: (N,) bool — points
    with a usable neighborhood (identity covariance otherwise). Returns the
    packed (6, N) regularized covariances.
    """
    nx, ny, nz = smallest_eigenvector_sym3_comps(*comps)
    s = jnp.asarray(1.0 - epsilon, dtype)
    reg = (
        1.0 - s * nx * nx,
        -s * nx * ny,
        -s * nx * nz,
        1.0 - s * ny * ny,
        -s * ny * nz,
        1.0 - s * nz * nz,
    )
    eye = jnp.asarray(EYE6, dtype)
    return jnp.stack(
        [jnp.where(good, r, e) for r, e in zip(reg, eye)]
    )


def gicp_covariances(
    cloud: PointCloud,
    k: int = 10,
    epsilon: float = 1e-3,
    block: int = 512,
    precision=jax.lax.Precision.HIGH,
) -> jnp.ndarray:
    """GICP-regularized covariances, packed (6, N), for every cloud point.

    Key identity exploited for speed: the GICP regularization
    ``U diag(ε,1,1) Uᵀ`` depends only on the surface normal n (the
    smallest eigenvector), since it equals ``I − (1−ε)·n nᵀ``. The normal
    comes from a closed-form symmetric-3×3 eigen-solve (``ops.linalg3``) —
    no LAPACK ``eigh`` in the per-scan hot path — and neighbor search is
    the exact blocked k-NN (``ops.nn.knn``).

    Padding points get identity covariances (they are masked out of the
    registration cost anyway). ``precision`` is that of the neighbor
    distance product: neighborhood statistics tolerate a reduced-precision
    product (``chip_smoke.py`` checks the normals against HIGHEST).
    """
    pts = cloud.points
    dtype = pts.dtype
    idx, d2 = nn_ops.knn(
        pts, pts, cloud.mask, k=k, block=block, precision=precision,
    )

    # Gather neighbors as (N, k, 3) rows — XLA lowers row gathers well —
    # then transpose to the (k, N) lane layout for the moment reductions
    # (N on the 128-wide lane axis; scalar-indexed gathers like
    # ``px[idx.T]`` measured 8x slower, (N, k, 3) einsum moments 2.5x).
    neigh = pts[idx]  # (N, k, 3)
    w = jnp.isfinite(d2).T.astype(dtype)  # (k, N); False when < k neighbors
    nxk = neigh[..., 0].T  # (k, N)
    nyk = neigh[..., 1].T
    nzk = neigh[..., 2].T

    count = jnp.maximum(jnp.sum(w, axis=0), 1.0)  # (N,)
    mx = jnp.sum(w * nxk, axis=0) / count
    my = jnp.sum(w * nyk, axis=0) / count
    mz = jnp.sum(w * nzk, axis=0) / count
    cx, cy, cz = nxk - mx, nyk - my, nzk - mz
    comps = (
        jnp.sum(w * cx * cx, axis=0) / count,
        jnp.sum(w * cx * cy, axis=0) / count,
        jnp.sum(w * cx * cz, axis=0) / count,
        jnp.sum(w * cy * cy, axis=0) / count,
        jnp.sum(w * cy * cz, axis=0) / count,
        jnp.sum(w * cz * cz, axis=0) / count,
    )
    # Degenerate points (too few neighbors) → identity covariance.
    good = (jnp.sum(w, axis=0) >= 3) & cloud.mask
    return _regularize_comps(comps, good, epsilon, dtype)


def radius_moments(
    query: jnp.ndarray,
    target: jnp.ndarray,
    target_mask: jnp.ndarray,
    radius: float,
    sigma: float = 0.0,
    block: int = 512,
):
    """Per-query moments of the masked targets within ``radius``.

    Returns ``(count (N,), mean (N, 3), cov (N, 3, 3))``: the neighbor
    count and the mean and centered second moment (population covariance)
    of the in-radius targets; zero count → zero mean/cov. ``sigma > 0``
    replaces the hard indicator with a radius-truncated Gaussian weight
    ``exp(−d²/2σ²)`` (count is then the weight sum Σw). One blocked pass:
    per query block, the distance matmul, the weights, and one
    ``feats @ wᵀ`` product accumulate [1, x, y, z, xx, yy, zz, xy, xz, yz].
    """
    # center on the query centroid: membership and covariance are
    # translation-invariant, and small coordinates keep E[ppᵀ] − μμᵀ from
    # cancelling when |p| ≫ the neighborhood scale
    center = jnp.mean(query, axis=0, keepdims=True)
    query = query - center
    target = target - center
    tn2 = jnp.sum(target * target, axis=-1)
    tn2 = jnp.where(target_mask, tn2, jnp.inf)
    n = query.shape[0]
    npad = (n + block - 1) // block * block
    qpad = jnp.pad(query, ((0, npad - n), (0, 0)))
    qblocks = qpad.reshape(npad // block, block, 3)
    r2 = radius * radius
    inv2s2 = 0.0 if sigma <= 0 else 1.0 / (2.0 * float(sigma) ** 2)

    x, y, z = target[:, 0], target[:, 1], target[:, 2]
    feats = jnp.stack(
        [jnp.ones_like(x), x, y, z, x * x, y * y, z * z, x * y, x * z, y * z]
    )  # (10, M)

    def one(qb):
        cross = jnp.dot(
            qb, target.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        d2 = jnp.sum(qb * qb, -1)[:, None] - 2.0 * cross + tn2[None, :]
        inside = d2 < r2
        if inv2s2 > 0.0:
            w = jnp.where(inside, jnp.exp(-jnp.minimum(d2, r2) * inv2s2), 0.0)
        else:
            w = inside.astype(jnp.float32)
        return jnp.dot(feats, w.T, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)  # (10, B)

    acc = jax.lax.map(one, qblocks)  # (nb, 10, B)
    acc = jnp.moveaxis(acc, 1, 0).reshape(10, npad)[:, :n]
    count = acc[0]
    safe = jnp.maximum(count, 1.0)
    mean = (acc[1:4] / safe).T
    xx, yy, zz = acc[4] / safe, acc[5] / safe, acc[6] / safe
    xy, xz, yz = acc[7] / safe, acc[8] / safe, acc[9] / safe
    second = jnp.stack(
        [
            jnp.stack([xx, xy, xz], -1),
            jnp.stack([xy, yy, yz], -1),
            jnp.stack([xz, yz, zz], -1),
        ],
        axis=-2,
    )
    cov = second - mean[:, :, None] * mean[:, None, :]
    has = count > 0
    return (
        count,
        jnp.where(has[:, None], mean + center, 0.0),
        jnp.where(has[:, None, None], cov, 0.0),
    )


def gicp_covariances_radius(
    cloud: PointCloud,
    radius: float,
    epsilon: float = 1e-3,
    sigma: float = 0.0,
) -> jnp.ndarray:
    """GICP covariances, packed (6, N), from *fixed-radius* neighborhoods.

    The neighborhood covariance is recovered from moment statistics
    (count, Σp, Σppᵀ, ``radius_moments``); the surface normal and the
    ``I − (1−ε)·n nᵀ`` regularization follow as in the k-NN variant. On
    voxel-downsampled clouds a radius of ~2-3 leaf sizes yields the same
    ~10-20 neighbors PCL's k-NN would find, with no top-k.

    ``sigma > 0`` applies a Gaussian distance taper inside the radius —
    near neighbors dominate the normal estimate like in kNN mode, removing
    the hard-cutoff noise of the plain radius weight.
    """
    pts = cloud.points
    count, _, cov = radius_moments(pts, pts, cloud.mask, radius, sigma=sigma)

    # need ≥3 neighbors (the point itself is always in-radius; with a
    # Gaussian taper `count` is the effective weight sum Σw, so the
    # equivalent threshold is lower — the self-weight alone is 1)
    good = (count >= (2.0 if sigma > 0 else 3.0)) & cloud.mask
    return _regularize_comps(sym3_comps(cov), good, epsilon, pts.dtype)
