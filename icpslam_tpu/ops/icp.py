"""Iterative closest point registration (point-to-point and GICP-style
plane-to-plane), fully jit-compiled with static shapes.

Replaces PCL ``GeneralizedIterativeClosestPoint`` at both reference use
sites: scan-to-scan odometry (10 iters,
``/root/reference/src/icpslam/icp_odometer.cpp:188-199``) and scan-to-map
refinement (30 iters, ``/root/reference/src/icpslam/octree_mapper.cpp:101-124``).

Structure per outer iteration (under ``lax.while_loop``; early exit on the
transform-epsilon test like PCL):

1. transform source by the current pose estimate (component form)
2. exact 1-NN correspondences via the fused Pallas kernel (``ops.nn``)
3. gate by max correspondence distance + validity masks
4. Huber robust weights on residual norms
5. transform update:
   - ``point``: closed-form weighted Kabsch/Horn (``ops.kabsch``)
   - ``plane``: one Gauss-Newton step on se(3) with GICP fused covariance
     weighting ``(C_dst + R C_src Rᵀ)⁻¹`` — all in structure-of-arrays
     component form on (N,) lane-aligned arrays (see the layout note
     inside ``icp``), solved by an unrolled 6×6 Cholesky

Outputs mirror the reference's acceptance inputs: ``converged`` flag and a
``fitness`` score (mean squared correspondence distance, like PCL's
``getFitnessScore`` used in the ``fitness < 20`` gate at
``icp_odometer.cpp:201``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from icpslam_tpu.cloud.pointcloud import PointCloud
from icpslam_tpu.config import IcpConfig
from icpslam_tpu.geometry import quaternion as quat
from icpslam_tpu.geometry import se3
from icpslam_tpu.geometry.se3 import Pose
from icpslam_tpu.ops import nn as nn_ops
from icpslam_tpu.ops.kabsch import weighted_rigid_align_comps
from icpslam_tpu.ops.linalg3 import (
    inv_sym3_comps,
    rotate_sym3_comps,
    solve_chol_unrolled,
)

MIN_CORRESPONDENCES = 10


class IcpResult(NamedTuple):
    pose: Pose                      # maps source frame → target frame
    fitness: jnp.ndarray            # mean squared correspondence distance
    converged: jnp.ndarray          # bool: enough correspondences & finite
    num_correspondences: jnp.ndarray
    iterations: jnp.ndarray
    # (6, 6) Gauss-Newton Hessian JᵀWJ at the final pose (t before rot
    # ordering, matching se3 twists) — the registration's information
    # matrix, the principled source for pose-graph edge weights the
    # reference fakes with fixed configured diagonals
    # (``src/icpslam/icpslam.cpp:28-40``). None unless ``want_hessian``.
    hessian: Optional[jnp.ndarray] = None


def _huber_weights(dist: jnp.ndarray, delta: float) -> jnp.ndarray:
    """IRLS weights for the Huber loss on residual norms; 1 inside delta."""
    if delta <= 0:
        return jnp.ones_like(dist)
    safe = jnp.maximum(dist, 1e-12)
    return jnp.where(dist <= delta, 1.0, delta / safe)


def _gn_terms(Wa, Wb, Wc, Wd, We, Wf, px, py, pz, rx, ry, rz):
    """(27, N) per-point accumulators of the se(3) Gauss-Newton system
    with per-point symmetric 3×3 information W and J_i = [I | −skew(p_i)]:
    rows 0-20 build JᵀWJ, rows 21-26 build JᵀW r (see ``_gn_hessian``)."""
    ux = Wa * rx + Wb * ry + Wc * rz
    uy = Wb * rx + Wd * ry + We * rz
    uz = Wc * rx + We * ry + Wf * rz
    # With J_i = [I | −skew(p_i)]: JᵀWJ = [[W, −M],[−Mᵀ, −skew(p)·M]]
    # where M = W·skew(p); b_i = JᵀW r = [u; p×u].
    m00 = Wb * pz - Wc * py
    m01 = Wc * px - Wa * pz
    m02 = Wa * py - Wb * px
    m10 = Wd * pz - We * py
    m11 = We * px - Wb * pz
    m12 = Wb * py - Wd * px
    m20 = We * pz - Wf * py
    m21 = Wf * px - Wc * pz
    m22 = Wc * py - We * px
    br00 = pz * m10 - py * m20
    br01 = pz * m11 - py * m21
    br02 = pz * m12 - py * m22
    br11 = px * m21 - pz * m01
    br12 = px * m22 - pz * m02
    br22 = py * m02 - px * m12
    cx = py * uz - pz * uy
    cy = pz * ux - px * uz
    cz = px * uy - py * ux
    return jnp.stack(
        [Wa, Wb, Wc, Wd, We, Wf,
         m00, m01, m02, m10, m11, m12, m20, m21, m22,
         br00, br01, br02, br11, br12, br22,
         ux, uy, uz, cx, cy, cz]
    )


def _gn_hessian(s):
    """6×6 H from the 21 reduced accumulator sums (``_gn_terms`` rows)."""
    return jnp.stack(
        [
            jnp.stack([s[0], s[1], s[2], -s[6], -s[7], -s[8]]),
            jnp.stack([s[1], s[3], s[4], -s[9], -s[10], -s[11]]),
            jnp.stack([s[2], s[4], s[5], -s[12], -s[13], -s[14]]),
            jnp.stack([-s[6], -s[9], -s[12], s[15], s[16], s[17]]),
            jnp.stack([-s[7], -s[10], -s[13], s[16], s[18], s[19]]),
            jnp.stack([-s[8], -s[11], -s[14], s[17], s[19], s[20]]),
        ]
    )


class _Carry(NamedTuple):
    pose: Pose
    it: jnp.ndarray
    delta: jnp.ndarray    # norm of last update twist
    idx: jnp.ndarray      # (N,) target index of each source point's match
    matched: jnp.ndarray  # (N,) bool: the NN search found a valid target
    d2: jnp.ndarray       # (N,) correspondence distances at the last-used pose
    corr: jnp.ndarray     # (N,) bool correspondence validity at that pose


def icp(
    source: PointCloud,
    target: PointCloud,
    config: IcpConfig,
    init: Optional[Pose] = None,
    source_covs: Optional[jnp.ndarray] = None,
    target_covs: Optional[jnp.ndarray] = None,
    nn_block: int = 1024,
    target_valid_len: Optional[jnp.ndarray] = None,
    fixed_correspondences: bool = False,
    want_hessian: bool = False,
) -> IcpResult:
    """Register ``source`` onto ``target``; returns target-frame pose of source.

    ``fixed_correspondences``: the match of source point ``i`` is target
    point ``i`` for the whole registration — no NN search at all. For the
    scan-to-map refinement the target IS the per-point map-NN cloud of
    the source at the initial pose (``octree_mapper.cpp:148-155``), so the
    identity pairing starts exact and only degrades by the (sub-voxel)
    correction the refinement itself applies; the distance gate +
    Huber weights still down-weight pairs the update invalidates. Saves
    every per-iteration NN sweep — the dominant cost of the mapping ICP.

    For ``config.mode == 'plane'`` the per-point covariances must be
    precomputed with ``ops.covariance.gicp_covariances`` (they depend only
    on each cloud, so callers cache them per scan), in the canonical
    components-first packing: ``source_covs`` (6, N) / ``target_covs``
    (6, M) as ``[xx, xy, xz, yy, yz, zz]`` (``linalg3.mat_to_sym6``).

    ``target_valid_len``: traced scalar — pass ONLY when the target cloud
    is prefix-packed (all valid points before all padding, e.g. any
    ``voxel_downsample`` output): the fused NN kernel then skips the dead
    capacity tiles, so each sweep costs fill, not capacity.
    """
    if init is None:
        init = se3.identity(dtype=source.points.dtype)
    plane = config.mode == "plane"
    if plane and (source_covs is None or target_covs is None):
        raise ValueError("plane mode requires source_covs and target_covs")

    max_d2 = config.max_correspondence_distance**2

    # Structure-of-arrays views: all inner-loop math runs elementwise on
    # (N,) component arrays, with no (N, 3) / (N, 3, 3) / (N, 3, 6)
    # intermediates whose short trailing dims waste memory traffic.
    sx, sy, sz = source.points[:, 0], source.points[:, 1], source.points[:, 2]
    tp3 = target.points.T  # (3, M): one-gather layout for matched points
    if plane:
        sc = tuple(source_covs[i] for i in range(6))  # 6 × (N,)
        tc6 = target_covs                             # (6, M)

    def transform_comps(pose: Pose):
        R = quat.to_matrix(pose.q)
        px = R[0, 0] * sx + R[0, 1] * sy + R[0, 2] * sz + pose.t[0]
        py = R[1, 0] * sx + R[1, 1] * sy + R[1, 2] * sz + pose.t[1]
        pz = R[2, 0] * sx + R[2, 1] * sy + R[2, 2] * sz + pose.t[2]
        return R, px, py, pz

    def fresh_nn(px, py, pz):
        src_t = jnp.stack([px, py, pz], axis=-1)
        res = nn_ops.nearest_neighbors(
            src_t, target.points, target.mask, block=nn_block,
            valid_len=target_valid_len,
        )
        return res.idx, jnp.isfinite(res.dist2)

    def match_eval(idx, matched, px, py, pz):
        """Residuals + validity of the matches at the current pose."""
        d = tp3[:, idx]  # (3, N) gathered match coordinates
        rx, ry, rz = px - d[0], py - d[1], pz - d[2]
        d2 = rx * rx + ry * ry + rz * rz
        corr = source.mask & matched & (d2 <= max_d2)
        return (rx, ry, rz), d2, corr

    refresh = max(1, config.correspondence_refresh)

    if fixed_correspondences:
        if target.points.shape[0] != source.points.shape[0]:
            raise ValueError(
                "fixed_correspondences requires target and source of equal size"
            )
        ident_idx = jnp.arange(source.points.shape[0], dtype=jnp.int32)
        ident_matched = target.mask

    def step(carry: _Carry) -> _Carry:
        pose = carry.pose
        R, px, py, pz = transform_comps(pose)
        if fixed_correspondences:
            idx, matched = ident_idx, ident_matched
        elif refresh == 1:
            idx, matched = fresh_nn(px, py, pz)
        else:
            # refresh the NN search only every `refresh` iterations; in
            # between, keep the matches and just re-evaluate them at the
            # updated pose. `matched` rides the carry so stale indices of
            # never-matched queries can't sneak through the distance gate.
            idx, matched = jax.lax.cond(
                carry.it % refresh == 0,
                lambda _: fresh_nn(px, py, pz),
                lambda _: (carry.idx, carry.matched),
                operand=None,
            )
        (rx, ry, rz), d2, corr = match_eval(idx, matched, px, py, pz)
        dist = jnp.sqrt(jnp.maximum(d2, 0.0))
        w = _huber_weights(dist, config.huber_delta) * corr.astype(px.dtype)

        if not plane:
            d = tp3[:, idx]
            delta_pose, ok = weighted_rigid_align_comps(
                px, py, pz, d[0], d[1], d[2], w
            )
        else:
            # fused covariance C = C_dst + R C_src Rᵀ, inverted in
            # symmetric component form
            ba, bb, bc, bd, be, bf = rotate_sym3_comps(R, sc)
            tg = tc6[:, idx]  # (6, N) gathered target covariances
            Wa, Wb, Wc, Wd, We, Wf = inv_sym3_comps(
                tg[0] + ba, tg[1] + bb, tg[2] + bc,
                tg[3] + bd, tg[4] + be, tg[5] + bf,
            )
            # one fused weighted-reduction pass over all 27 accumulators
            terms = _gn_terms(Wa, Wb, Wc, Wd, We, Wf, px, py, pz, rx, ry, rz)
            s = jnp.sum(terms * w, axis=1)
            H = _gn_hessian(s)
            delta = solve_chol_unrolled(H, -s[21:27], damping=1e-6)
            ok = jnp.sum(corr) >= MIN_CORRESPONDENCES
            delta = jnp.where(ok, delta, 0.0)
            delta_pose = se3.se3_exp(delta)

        new_pose = se3.normalize(se3.compose(delta_pose, pose))
        if plane:
            # the GN twist *is* the log of the update — skip the se3_log
            dnorm = jnp.linalg.norm(delta)
        else:
            dnorm = jnp.linalg.norm(se3.se3_log(delta_pose))
        return _Carry(
            pose=new_pose, it=carry.it + 1, delta=dnorm,
            idx=idx, matched=matched, d2=d2, corr=corr,
        )

    def cond(carry: _Carry):
        small = carry.delta <= config.transformation_epsilon
        if refresh > 1 and not fixed_correspondences:
            # a small step against *stale* matches is not convergence —
            # only exit when the epsilon test passes on an iteration that
            # ran a fresh NN search. (Fixed correspondences are never
            # stale — the identity pairing holds every iteration.)
            fresh_last = ((carry.it - 1) % refresh) == 0
            small = small & fresh_last
        return (carry.it < config.max_iterations) & ~small

    n_src = source.points.shape[0]
    init_carry = _Carry(
        pose=init,
        it=jnp.zeros((), jnp.int32),
        delta=jnp.asarray(jnp.inf, source.points.dtype),
        idx=jnp.zeros((n_src,), jnp.int32),
        matched=jnp.zeros((n_src,), bool),
        d2=jnp.full((n_src,), jnp.inf, source.points.dtype),
        corr=jnp.zeros((n_src,), bool),
    )
    final = jax.lax.while_loop(cond, step, init_carry)

    if config.exact_fitness:
        # Extra correspondence pass at the final pose (exact PCL
        # getFitnessScore semantics) — costs one more NN sweep.
        _, px, py, pz = transform_comps(final.pose)
        if fixed_correspondences:
            idx, matched = ident_idx, ident_matched
        else:
            idx, matched = fresh_nn(px, py, pz)
        _, d2, corr = match_eval(idx, matched, px, py, pz)
    else:
        # Reuse the correspondences from the last executed iteration:
        # fitness is evaluated one Gauss-Newton step stale, which is far
        # below the coarse accept gate (fitness < 20) — and saves a full
        # NN pass (~1/8 of ICP time at 10 iterations).
        d2, corr = final.d2, final.corr
    n_corr = jnp.sum(corr.astype(jnp.int32))
    fitness = jnp.where(
        n_corr > 0,
        jnp.sum(jnp.where(corr, d2, 0.0)) / jnp.maximum(n_corr, 1),
        jnp.asarray(jnp.inf, d2.dtype),
    )
    pose_finite = jnp.all(jnp.isfinite(final.pose.t)) & jnp.all(jnp.isfinite(final.pose.q))
    converged = (n_corr >= MIN_CORRESPONDENCES) & pose_finite
    safe_pose = Pose(
        t=jnp.where(pose_finite, final.pose.t, 0.0),
        q=jnp.where(pose_finite, final.pose.q, quat.identity()),
    )

    hessian = None
    if want_hessian:
        # Assemble JᵀWJ once more at the FINAL pose with the final
        # correspondences — no NN sweep, one reduction pass. Point
        # mode uses W = I per point (the Kabsch objective's GN
        # information); plane mode re-evaluates the fused GICP weights at
        # the final rotation.
        Rf, fpx, fpy, fpz = transform_comps(safe_pose)
        fidx, fmatched = (
            (ident_idx, ident_matched) if fixed_correspondences
            else (final.idx, final.matched)
        )
        (frx, fry, frz), fd2, fcorr = match_eval(fidx, fmatched, fpx, fpy, fpz)
        fdist = jnp.sqrt(jnp.maximum(fd2, 0.0))
        fw = _huber_weights(fdist, config.huber_delta) * fcorr.astype(fpx.dtype)
        if plane:
            ba, bb, bc, bd, be, bf = rotate_sym3_comps(Rf, sc)
            tg = tc6[:, fidx]
            Wa, Wb, Wc, Wd, We, Wf = inv_sym3_comps(
                tg[0] + ba, tg[1] + bb, tg[2] + bc,
                tg[3] + bd, tg[4] + be, tg[5] + bf,
            )
        else:
            one = jnp.ones_like(fpx)
            zero = jnp.zeros_like(fpx)
            Wa, Wb, Wc, Wd, We, Wf = one, zero, zero, one, zero, one
        terms = _gn_terms(Wa, Wb, Wc, Wd, We, Wf, fpx, fpy, fpz, frx, fry, frz)
        s = jnp.sum(terms * fw, axis=1)
        hessian = _gn_hessian(s)
        hessian = jnp.where(jnp.all(jnp.isfinite(hessian)), hessian, 0.0)

    return IcpResult(
        pose=safe_pose,
        fitness=fitness,
        converged=converged,
        num_correspondences=n_corr,
        iterations=final.it,
        hessian=hessian,
    )
