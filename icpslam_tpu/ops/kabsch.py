"""Weighted rigid alignment (Kabsch/Horn) for correspondence sets.

Estimates the SE(3) transform minimizing ``Σ w_i |R s_i + t − d_i|²`` via
Horn's closed-form quaternion method: build the 4×4 symmetric matrix from
the weighted cross-covariance and take its top eigenvector. ``eigh`` on a
single 4×4 is cheap; unlike 3×3 SVD there is no
reflection-sign fixup needed (the quaternion parameterization can only
produce proper rotations).

This is the per-iteration transform estimate inside scan-to-scan ICP,
replacing the internal solver of PCL's GICP
(``/root/reference/src/icpslam/icp_odometer.cpp:188-199``).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from icpslam_tpu.geometry import quaternion as quat
from icpslam_tpu.geometry.se3 import Pose


def weighted_rigid_align_comps(
    px, py, pz, dx, dy, dz, weights: jnp.ndarray,
    min_total_weight: float = 1e-6,
) -> Tuple[Pose, jnp.ndarray]:
    """Structure-of-arrays :func:`weighted_rigid_align`.

    Takes source/destination coordinates as six (N,) component arrays —
    the layout the ICP inner loop keeps its data in (elementwise work, no
    (N, 3) intermediates). Same math and results as the
    array form: weighted centroids, cross-covariance from 9 scalar
    reductions, Horn 4×4 eigendecomposition.
    """
    w = weights.astype(px.dtype)
    # 13 reductions fused into one pass: Σw, Σw·s, Σw·d, Σw·s_a·d_b
    terms = jnp.stack(
        [jnp.ones_like(px), px, py, pz, dx, dy, dz,
         px * dx, px * dy, px * dz,
         py * dx, py * dy, py * dz,
         pz * dx, pz * dy, pz * dz]
    )
    s = jnp.sum(terms * w, axis=1)
    W = s[0]
    ok = W > min_total_weight
    Wsafe = jnp.maximum(W, min_total_weight)
    cs = s[1:4] / Wsafe
    cd = s[4:7] / Wsafe
    # centered cross-covariance: Σw s dᵀ − (Σw s)(Σw d)ᵀ / W
    S = s[7:16].reshape(3, 3) - s[1:4, None] * s[None, 4:7] / Wsafe
    Sxx, Sxy, Sxz = S[0, 0], S[0, 1], S[0, 2]
    Syx, Syy, Syz = S[1, 0], S[1, 1], S[1, 2]
    Szx, Szy, Szz = S[2, 0], S[2, 1], S[2, 2]
    N = jnp.stack(
        [
            jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx]),
            jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz]),
            jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy]),
            jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz]),
        ]
    )
    eigvals, eigvecs = jnp.linalg.eigh(N)
    q = eigvecs[:, -1]
    q = quat.normalize(jnp.where(q[0] < 0, -q, q))
    t = cd - quat.rotate(q, cs)
    pose = Pose(t=jnp.where(ok, t, 0.0), q=jnp.where(ok, q, quat.identity()))
    return pose, ok


def weighted_rigid_align(
    src: jnp.ndarray,
    dst: jnp.ndarray,
    weights: jnp.ndarray,
    min_total_weight: float = 1e-6,
) -> Tuple[Pose, jnp.ndarray]:
    """Best-fit pose mapping ``src`` onto ``dst`` under per-pair weights.

    src, dst: (N, 3); weights: (N,) ≥ 0 (zero disables a pair).
    Returns ``(pose, ok)`` where ``ok`` is False when the total weight is
    (numerically) zero — in that case the identity pose is returned.
    """
    w = weights.astype(src.dtype)
    W = jnp.sum(w)
    ok = W > min_total_weight
    Wsafe = jnp.maximum(W, min_total_weight)

    cs = jnp.sum(src * w[:, None], axis=0) / Wsafe
    cd = jnp.sum(dst * w[:, None], axis=0) / Wsafe
    s = src - cs
    d = dst - cd

    # Weighted cross-covariance S = Σ w s dᵀ — one (3,N)@(N,3) matmul.
    S = jnp.dot((s * w[:, None]).T, d, preferred_element_type=jnp.float32)
    Sxx, Sxy, Sxz = S[0, 0], S[0, 1], S[0, 2]
    Syx, Syy, Syz = S[1, 0], S[1, 1], S[1, 2]
    Szx, Szy, Szz = S[2, 0], S[2, 1], S[2, 2]

    # Horn's N matrix: the quaternion maximizing qᵀNq rotates src → dst.
    N = jnp.stack(
        [
            jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx]),
            jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz]),
            jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy]),
            jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz]),
        ]
    )

    eigvals, eigvecs = jnp.linalg.eigh(N)
    q = eigvecs[:, -1]  # eigenvector of the largest eigenvalue
    q = quat.normalize(jnp.where(q[0] < 0, -q, q))

    t = cd - quat.rotate(q, cs)
    pose = Pose(t=jnp.where(ok, t, 0.0), q=jnp.where(ok, q, quat.identity()))
    return pose, ok
