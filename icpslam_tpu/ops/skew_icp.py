"""Skew-aware ICP: jointly estimate the inter-scan pose AND the
intra-sweep motion of the source scan in one 12-DoF Gauss-Newton.

Why: a spinning lidar smears each sweep by the platform's motion DURING
that sweep. De-skewing needs the *current* interval's motion, which no
causal pipeline has measured yet — the constant-velocity seed (previous
interval) fails exactly at turns, where de-skew matters most
(``docs/DESIGN.md`` §13-14: gt-previous-interval de-skew is no better
than none; gt-current-interval reaches 0.019 m). The current motion IS
observable from a single scan pair, because the smear leaves a
capture-time-correlated structure in the registration residuals: points
at sweep fraction u≈0 constrain the start-to-start pose alone, points at
u≈1 constrain pose∘motion, and the gradient in between separates the
two. This solver exploits that.

Model (small-angle intra-sweep warp — ≤ ~0.15 rad at 10 Hz urban rates,
cubic error < 1e-3):

    p'(u) = p + u · (t_m + ω_m × p)            # de-skew by twist M
    P     = R_pose · p' + t_pose               # into the target frame
    r     = P − d(match)

Unknowns ξ = (δpose, δM) ∈ R¹²: J_pose = [I | −skew(P)] (left
perturbation, as ``ops/icp.py``), J_M = u · R_pose · [I | −skew(p)].
A weak prior pulls M toward its constant-velocity seed (keeps the system
well-posed when the scene or the u-coverage under-constrains the split).
Weights: Huber on residual norms; optional fused GICP plane weighting
``(C_dst + R C_src Rᵀ)⁻¹`` like the 6-DoF solver.

Layout note: this solver builds (N, 3, 12) Jacobians with einsum rather
than the hand-unrolled SoA component form of ``ops/icp.py`` — it runs
only in the opt-in no-INS de-skew mode (``config.deskew_rounds`` +
``deskew_mode='joint'``), where clarity of the 12-DoF assembly wins over
hand-unrolled speed. Replaces nothing in the reference (which
has no de-skew at all); capability parity target is LOAM-class ingest.
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
from icpslam_tpu.ops.icp import MIN_CORRESPONDENCES, _huber_weights
from icpslam_tpu.ops.linalg3 import inv_sym3_comps, rotate_sym3_comps


def coupled_deskew_icp(
    source: PointCloud,
    target: PointCloud,
    target_u: jnp.ndarray,
    config: IcpConfig,
    source_u: Optional[jnp.ndarray] = None,
    init: Optional[Pose] = None,
    source_covs: Optional[jnp.ndarray] = None,
    target_covs: Optional[jnp.ndarray] = None,
    nn_block: int = 1024,
    target_valid_len: Optional[jnp.ndarray] = None,
    free_source_twist: bool = False,
    source_twist_prior_weight: float = 1.0,
    prior_huber_delta: float = 0.0,
    auto_prior: tuple | None = None,
    want_hessian: bool = False,
):
    """6-DoF registration that de-skews BOTH sweeps with the very
    transform being solved.

    The physical identity this exploits: a continuously spinning lidar's
    sweep ``i`` spans the full inter-scan interval, so the smear of the
    *previous* scan IS the relative motion that registering the *current*
    scan against it measures — the target warp is exact, not modeled.
    The source's own smear is the NEXT interval; under one-step constant
    velocity it is warped by the SAME transform. Every registration is
    therefore self-contained (raw current + raw previous + one unknown):
    no previous *estimate* ever enters, so the estimate-error feedback
    loop that makes seed-based de-skew oscillate and diverge
    (DESIGN §13-14) cannot form. Leaving the source smear un-modeled
    instead is measurably fatal: consecutive sweeps' smears are
    azimuth-correlated, and ~0.7 of the source smear aliases straight
    into the estimate (0.8 m of motion → +0.55 m bias, DESIGN §14).

    Model, with ``m = log(rel)``:
      ``p'(u) = p + u·(t_m + ω_m × p)``   (source de-skew, CV tie)
      ``q'(v) = q + v·(t_m + ω_m × q)``   (target de-skew, exact)
      ``r = R·p' + t − q'``
      ``J = [I | −skew(P)] + u·R·[I | −skew(p)] − v·[I | −skew(q)]``
    (left perturbation; small-angle δm ≈ δ). ``source_u=None`` treats
    the source as clean (pre-de-skewed by the caller). Returns the same
    ``SkewIcpResult`` shape (``skew_twist`` = the source's estimated
    sweep twist: log(pose) under the CV tie, or the free estimate).

    ``free_source_twist``: the CV tie on the SOURCE warp is the one
    modeling assumption left, and it is wrong exactly at step velocity
    changes (the proxy's corners are instantaneous turns: CV twist error
    p95 ≈ 0 but max 0.83). This option frees the source twist M_src as
    6 extra unknowns — target still warped by rel exactly — with a
    RELATIVE prior ``M_src → log(rel)`` (weight
    ``source_twist_prior_weight``, scaled like the joint solver's): the
    prior resolves the azimuth-correlated near-degeneracy between M_src
    and rel on straights, while at corners the u-gradient of the
    residuals pulls M_src away from rel where the data demands it.
    """
    if init is None:
        init = se3.identity(dtype=source.points.dtype)
    plane = config.mode == "plane"
    if plane and (source_covs is None or target_covs is None):
        raise ValueError("plane mode requires source_covs and target_covs")
    if free_source_twist and source_u is None:
        raise ValueError(
            "free_source_twist requires source_u — a clean source has no "
            "sweep twist to estimate"
        )

    pts = source.points
    N = pts.shape[0]
    q_pts = target.points                      # (M, 3) skewed target
    v_all = target_u.astype(pts.dtype)         # (M,)
    u_src = None if source_u is None else source_u.astype(pts.dtype)
    max_d2 = config.max_correspondence_distance**2

    class Carry(NamedTuple):
        pose: Pose
        M: jnp.ndarray        # (6,) free source twist (zeros unless freed)
        it: jnp.ndarray
        delta: jnp.ndarray
        d2: jnp.ndarray
        corr: jnp.ndarray
        H6: jnp.ndarray       # (6, 6) pose block of the data GN Hessian
        #                       (edge-information source, ops/icp.py parity)
        relaxed: jnp.ndarray  # bool: auto-prior latch — once a turn is
        #                       detected in this solve the prior STAYS at
        #                       the corner weight (a two-way gate was
        #                       measured to oscillate the GN: the iterate
        #                       crossing the threshold flips the
        #                       objective, the solution jumps back, and
        #                       long missions diverge — 2000-scan tree
        #                       ATE 520 two-way vs 0.5 latched)

    ndof = 12 if free_source_twist else 6
    _n_scale = jnp.maximum(jnp.sum(source.mask), 1.0) / 1000.0

    def _turning(pose: Pose) -> jnp.ndarray:
        if auto_prior is None:
            return jnp.asarray(False)
        _, _, thresh = auto_prior
        return jnp.linalg.norm(se3.so3_log(pose.q)) > thresh

    def prior_weight(relaxed: jnp.ndarray) -> jnp.ndarray:
        """Prior information under the auto latch.

        The gate lives INSIDE the registration on the current pose
        iterate — lag-free: even under a stiff prior the 6-DoF pose is
        unconstrained, so a corner shows up in the estimate within 1-2
        GN iterations and the prior relaxes for the remaining iterations
        of the SAME solve. (Gating on the *last accepted* transform
        instead lagged corner entries and diverged long corner-heavy
        missions: 2000-scan tree ATE 14.3 vs 0.54 fixed.) Relaxation
        latches for the rest of the solve; the latch's failure mode is
        the fixed corner weight — the safe all-regime setting.
        """
        if auto_prior is None:
            w = jnp.asarray(source_twist_prior_weight, pts.dtype)
        else:
            w_straight, w_turn, _ = auto_prior
            w = jnp.where(relaxed, w_turn, w_straight).astype(pts.dtype)
        return w * _n_scale


    def warp_exact(p, u, pose):
        """Exact sweep warp R_axis(u·θ)·p + u·t — matches the sensor's
        slerp-rotation/lerp-translation smear. The solver's Jacobian
        stays first-order, but the RESIDUAL must be exact: the linear
        warp's second-order term (uθ)²r/2 is ~0.8 m at 80 m range on an
        8°/scan corner — far above the registration noise floor."""
        from icpslam_tpu.cloud import deskew as _dsk

        return _dsk.deskew_points(p, u, pose)

    def step(c: Carry) -> Carry:
        R = quat.to_matrix(c.pose.q)
        if u_src is None:
            p_warp = pts
        elif free_source_twist:
            p_warp = warp_exact(pts, u_src, se3.se3_exp(c.M))
        else:
            p_warp = warp_exact(pts, u_src, c.pose)
        P = p_warp @ R.T + c.pose.t[None, :]   # (N, 3) in target-start frame
        q_warp = warp_exact(q_pts, v_all, c.pose)
        res = nn_ops.nearest_neighbors(
            P, q_warp, target.mask, block=nn_block,
            valid_len=target_valid_len,
        )
        idx = res.idx
        matched = jnp.isfinite(res.dist2)
        qw = q_warp[idx]
        q0 = q_pts[idx]
        v = v_all[idx]
        r = P - qw
        d2 = jnp.sum(r * r, axis=-1)
        corr = source.mask & matched & (d2 <= max_d2)
        w = _huber_weights(jnp.sqrt(jnp.maximum(d2, 0.0)), config.huber_delta)
        w = w * corr.astype(pts.dtype)

        if plane:
            sc = tuple(source_covs[i] for i in range(6))
            ba, bb, bc, bd, be, bf = rotate_sym3_comps(R, sc)
            tg = target_covs[:, idx]
            Wa, Wb, Wc, Wd, We, Wf = inv_sym3_comps(
                tg[0] + ba, tg[1] + bb, tg[2] + bc,
                tg[3] + bd, tg[4] + be, tg[5] + bf,
            )
            W = jnp.stack(
                [
                    jnp.stack([Wa, Wb, Wc], -1),
                    jnp.stack([Wb, Wd, We], -1),
                    jnp.stack([Wc, We, Wf], -1),
                ],
                -2,
            )
        else:
            W = jnp.broadcast_to(jnp.eye(3, dtype=pts.dtype), (N, 3, 3))

        eyeN = jnp.broadcast_to(jnp.eye(3, dtype=pts.dtype), (N, 3, 3))
        J_rel = (
            jnp.concatenate([eyeN, -_skew_mats(P)], axis=-1)
            - v[:, None, None]
            * jnp.concatenate([eyeN, -_skew_mats(q0)], axis=-1)
        )                                      # (N, 3, 6)
        if u_src is not None:
            J_src = u_src[:, None, None] * jnp.einsum(
                "ab,nbk->nak",
                R,
                jnp.concatenate([eyeN, -_skew_mats(pts)], axis=-1),
            )
            if free_source_twist:
                J = jnp.concatenate([J_rel, J_src], axis=-1)  # (N, 3, 12)
            else:
                J = J_rel + J_src
        else:
            J = J_rel
        WJ = jnp.einsum("nab,nbk->nak", W, J)
        H = jnp.einsum("nak,nal,n->kl", J, WJ, w)
        g = jnp.einsum("nak,na,n->k", WJ, r, w)
        if free_source_twist:
            # relative prior M_src → log(rel): residual (M − m), Jacobian
            # [−I | I] over (δrel, δM) — couples the two blocks so the
            # azimuth-correlated near-degeneracy stays conditioned.
            # Optionally Huber-robust (prior_huber_delta > 0): full
            # stiffness while the twist tracks the CV tie (straights —
            # where the split is noise), IRLS-downweighted once the
            # deviation is real (corner instants — where the data must
            # win). The twist-norm units mix m and rad like the solver's
            # own epsilon test.
            m = se3.se3_log(c.pose)
            rp = c.M - m
            if prior_huber_delta > 0:
                dev = jnp.linalg.norm(rp)
                w_pr = jnp.where(
                    dev <= prior_huber_delta,
                    1.0,
                    prior_huber_delta / jnp.maximum(dev, 1e-12),
                )
            else:
                w_pr = 1.0
            pw = prior_weight(c.relaxed) * w_pr
            eye6 = jnp.eye(6, dtype=pts.dtype)
            H = H.at[:6, :6].add(pw * eye6)
            H = H.at[6:, 6:].add(pw * eye6)
            H = H.at[:6, 6:].add(-pw * eye6)
            H = H.at[6:, :6].add(-pw * eye6)
            g = g.at[:6].add(-pw * rp)
            g = g.at[6:].add(pw * rp)
        if free_source_twist:
            # pose information = Schur complement H_pp − H_pm H_mm⁻¹ H_mp
            # of the freed twist block (prior included in H_mm). The raw
            # H[:6,:6] data block overstates pose information exactly
            # where the azimuth-correlated pose/twist near-degeneracy
            # lives — the case this mode targets (ADVICE r4). A pure
            # relative prior Schur-eliminates to zero absolute pose
            # information, as it must.
            Hmm = H[6:, 6:]
            ridge = 1e-6 * jnp.trace(Hmm) / 6.0 + 1e-12
            Hmm_i = jnp.linalg.inv(
                Hmm + ridge * jnp.eye(6, dtype=pts.dtype)
            )
            H6 = H[:6, :6] - H[:6, 6:] @ Hmm_i @ H[6:, :6]
        else:
            H6 = H[:6, :6]  # data-only pose information
        H = H + 1e-6 * jnp.trace(H) / ndof * jnp.eye(ndof, dtype=pts.dtype)
        delta = -jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(H, lower=True), g
        )
        ok = jnp.sum(corr) >= MIN_CORRESPONDENCES
        delta = jnp.where(ok, delta, 0.0)
        # LEFT update — matches J_pose = [I | −skew(P)] and the δm ≈ δ
        # linearization of the target warp above
        new_pose = se3.normalize(se3.compose(se3.se3_exp(delta[:6]), c.pose))
        new_M = c.M + delta[6:] if free_source_twist else c.M
        return Carry(
            pose=new_pose, M=new_M, it=c.it + 1,
            delta=jnp.linalg.norm(delta), d2=d2, corr=corr, H6=H6,
            relaxed=c.relaxed | _turning(new_pose),
        )

    def cond(c: Carry):
        return (c.it < config.max_iterations) & (
            c.delta > config.transformation_epsilon
        )

    c0 = Carry(
        pose=init,
        M=se3.se3_log(init) if free_source_twist else jnp.zeros((6,), pts.dtype),
        it=jnp.zeros((), jnp.int32),
        delta=jnp.asarray(jnp.inf, pts.dtype),
        d2=jnp.full((N,), jnp.inf, pts.dtype),
        corr=jnp.zeros((N,), bool),
        H6=jnp.zeros((6, 6), pts.dtype),
        # entering with a turning CV seed starts relaxed
        relaxed=_turning(init),
    )
    final = jax.lax.while_loop(cond, step, c0)

    n_corr = jnp.sum(final.corr.astype(jnp.int32))
    fitness = jnp.where(
        n_corr > 0,
        jnp.sum(jnp.where(final.corr, final.d2, 0.0)) / jnp.maximum(n_corr, 1),
        jnp.asarray(jnp.inf, pts.dtype),
    )
    finite = (
        jnp.all(jnp.isfinite(final.pose.t))
        & jnp.all(jnp.isfinite(final.pose.q))
        & jnp.all(jnp.isfinite(final.M))
    )
    converged = (n_corr >= MIN_CORRESPONDENCES) & finite
    safe_pose = Pose(
        t=jnp.where(finite, final.pose.t, 0.0),
        q=jnp.where(finite, final.pose.q, quat.identity()),
    )
    twist = (
        jnp.where(finite, final.M, 0.0)
        if free_source_twist else se3.se3_log(safe_pose)
    )
    return SkewIcpResult(
        pose=safe_pose,
        skew_twist=twist,
        fitness=fitness,
        converged=converged,
        num_correspondences=n_corr,
        iterations=final.it,
        hessian=(
            jnp.where(jnp.all(jnp.isfinite(final.H6)), final.H6, 0.0)
            if want_hessian else None
        ),
    )


class SkewIcpResult(NamedTuple):
    pose: Pose                # sweep-START pose of source in target frame
    skew_twist: jnp.ndarray   # (6,) [t_m | ω_m] motion across the sweep
    fitness: jnp.ndarray
    converged: jnp.ndarray
    num_correspondences: jnp.ndarray
    iterations: jnp.ndarray
    # (6, 6) pose block of the final data Gauss-Newton Hessian — the
    # adaptive edge-information source (ops/icp.py ``want_hessian``
    # parity); None unless requested
    hessian: Optional[jnp.ndarray] = None


def _skew_mats(v: jnp.ndarray) -> jnp.ndarray:
    """(N, 3) → (N, 3, 3) cross-product matrices."""
    zeros = jnp.zeros_like(v[:, 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -v[:, 2], v[:, 1]], -1),
            jnp.stack([v[:, 2], zeros, -v[:, 0]], -1),
            jnp.stack([-v[:, 1], v[:, 0], zeros], -1),
        ],
        -2,
    )


def skew_aware_icp(
    source: PointCloud,
    target: PointCloud,
    config: IcpConfig,
    sweep_u: jnp.ndarray,
    init: Optional[Pose] = None,
    init_skew: Optional[jnp.ndarray] = None,
    source_covs: Optional[jnp.ndarray] = None,
    target_covs: Optional[jnp.ndarray] = None,
    nn_block: int = 1024,
    target_valid_len: Optional[jnp.ndarray] = None,
    skew_prior_weight: float = 1.0,
    skew_prior_t_factor: float = 100.0,
    want_hessian: bool = False,
) -> SkewIcpResult:
    """Register ``source`` (a skewed sweep with per-point capture
    fractions ``sweep_u``) onto ``target``, solving pose + sweep motion.

    ``init_skew``: (6,) constant-velocity seed for the sweep twist (e.g.
    ``se3.se3_log`` of the last accepted transform); also the prior mean.
    ``skew_prior_weight``: per-unit information of that prior relative to
    one unit-weight point correspondence (scaled by N internally so the
    prior strength is resolution-independent).
    ``skew_prior_t_factor``: extra prior factor on the twist's
    TRANSLATION block. The translation of the sweep motion is nearly
    collinear with the pose translation in the normal equations (their
    Jacobians differ only by the u-weighting), so freeing both trades
    noise between them; the platform's translational velocity is also
    accel-limited (constant velocity is a good model) while its YAW RATE
    is exactly what spikes at corners. Defaulting to a stiff translation
    prior + free rotation estimates the piece that matters and keeps the
    system well-conditioned (measured: free-t lands at 0.6 m ATE on the
    60-pose physics proxy vs 0.095 alternate; see DESIGN §14).
    """
    if init is None:
        init = se3.identity(dtype=source.points.dtype)
    if init_skew is None:
        init_skew = jnp.zeros((6,), source.points.dtype)
    plane = config.mode == "plane"
    if plane and (source_covs is None or target_covs is None):
        raise ValueError("plane mode requires source_covs and target_covs")

    pts = source.points                       # (N, 3) sensor/capture frame
    N = pts.shape[0]
    u = sweep_u.astype(pts.dtype)
    max_d2 = config.max_correspondence_distance**2
    skew_p = _skew_mats(pts)                  # (N, 3, 3), constant
    # J_M = u · R [I | −skew(p)] → per-point basis B = [I | −skew(p)]
    B = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3, dtype=pts.dtype), (N, 3, 3)), -skew_p],
        axis=-1,
    )                                         # (N, 3, 6)
    # prior strength: resolution-independent (≈ weight of `prior_w`
    # unit-weight correspondences per DoF at any N)
    prior_w = jnp.asarray(
        skew_prior_weight * jnp.maximum(jnp.sum(source.mask), 1.0) / 1000.0,
        pts.dtype,
    )

    class Carry(NamedTuple):
        pose: Pose
        M: jnp.ndarray        # (6,) twist
        it: jnp.ndarray
        delta: jnp.ndarray
        d2: jnp.ndarray
        corr: jnp.ndarray
        H6: jnp.ndarray       # (6, 6) pose block of the data GN Hessian

    def warp(M):
        """De-skewed source points p' = p + u (t_m + ω_m × p)."""
        tm, wm = M[:3], M[3:]
        return pts + u[:, None] * (
            tm[None, :] + jnp.cross(jnp.broadcast_to(wm, pts.shape), pts)
        )

    def step(c: Carry) -> Carry:
        R = quat.to_matrix(c.pose.q)
        p_warp = warp(c.M)                    # (N, 3)
        P = p_warp @ R.T + c.pose.t[None, :]  # (N, 3) target frame

        res = nn_ops.nearest_neighbors(
            P, target.points, target.mask, block=nn_block,
            valid_len=target_valid_len,
        )
        idx = res.idx
        matched = jnp.isfinite(res.dist2)
        d = target.points[idx]
        r = P - d                             # (N, 3)
        d2 = jnp.sum(r * r, axis=-1)
        corr = source.mask & matched & (d2 <= max_d2)
        w = _huber_weights(jnp.sqrt(jnp.maximum(d2, 0.0)), config.huber_delta)
        w = w * corr.astype(pts.dtype)

        # per-point 3×3 information
        if plane:
            sc = tuple(source_covs[i] for i in range(6))
            ba, bb, bc, bd, be, bf = rotate_sym3_comps(R, sc)
            tg = target_covs[:, idx]
            Wa, Wb, Wc, Wd, We, Wf = inv_sym3_comps(
                tg[0] + ba, tg[1] + bb, tg[2] + bc,
                tg[3] + bd, tg[4] + be, tg[5] + bf,
            )
            W = jnp.stack(
                [
                    jnp.stack([Wa, Wb, Wc], -1),
                    jnp.stack([Wb, Wd, We], -1),
                    jnp.stack([Wc, We, Wf], -1),
                ],
                -2,
            )                                 # (N, 3, 3)
        else:
            W = jnp.broadcast_to(jnp.eye(3, dtype=pts.dtype), (N, 3, 3))

        # J = [J_pose | J_M]: (N, 3, 12)
        J_pose = jnp.concatenate(
            [jnp.broadcast_to(jnp.eye(3, dtype=pts.dtype), (N, 3, 3)),
             -_skew_mats(P)],
            axis=-1,
        )
        J_M = u[:, None, None] * jnp.einsum("ab,nbk->nak", R, B)
        J = jnp.concatenate([J_pose, J_M], axis=-1)

        WJ = jnp.einsum("nab,nbk->nak", W, J)
        H = jnp.einsum("nak,nal,n->kl", J, WJ, w)    # (12, 12)
        g = jnp.einsum("nak,na,n->k", WJ, r, w)      # (12,)
        H6 = H[:6, :6]  # data-only pose information (before priors)

        # block-wise prior M → seed: stiff on translation (collinear
        # with the pose translation; CV is a good model), weak on
        # rotation (the corner signal this solver exists to estimate)
        pw = prior_w * jnp.concatenate(
            [jnp.full((3,), skew_prior_t_factor), jnp.ones((3,))]
        ).astype(pts.dtype)
        H = H.at[6:, 6:].add(jnp.diag(pw))
        g = g.at[6:].add(pw * (c.M - init_skew))

        H = H + 1e-6 * jnp.trace(H) / 12.0 * jnp.eye(12, dtype=pts.dtype)
        delta = -jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(H, lower=True), g
        )
        ok = jnp.sum(corr) >= MIN_CORRESPONDENCES
        delta = jnp.where(ok, delta, 0.0)

        new_pose = se3.normalize(
            se3.compose(se3.se3_exp(delta[:6]), c.pose)
        )
        new_M = c.M + delta[6:]
        return Carry(
            pose=new_pose, M=new_M, it=c.it + 1,
            delta=jnp.linalg.norm(delta), d2=d2, corr=corr, H6=H6,
        )

    def cond(c: Carry):
        return (c.it < config.max_iterations) & (
            c.delta > config.transformation_epsilon
        )

    c0 = Carry(
        pose=init, M=init_skew,
        it=jnp.zeros((), jnp.int32),
        delta=jnp.asarray(jnp.inf, pts.dtype),
        d2=jnp.full((N,), jnp.inf, pts.dtype),
        corr=jnp.zeros((N,), bool),
        H6=jnp.zeros((6, 6), pts.dtype),
    )
    final = jax.lax.while_loop(cond, step, c0)

    n_corr = jnp.sum(final.corr.astype(jnp.int32))
    fitness = jnp.where(
        n_corr > 0,
        jnp.sum(jnp.where(final.corr, final.d2, 0.0)) / jnp.maximum(n_corr, 1),
        jnp.asarray(jnp.inf, pts.dtype),
    )
    finite = (
        jnp.all(jnp.isfinite(final.pose.t))
        & jnp.all(jnp.isfinite(final.pose.q))
        & jnp.all(jnp.isfinite(final.M))
    )
    converged = (n_corr >= MIN_CORRESPONDENCES) & finite
    safe_pose = Pose(
        t=jnp.where(finite, final.pose.t, 0.0),
        q=jnp.where(finite, final.pose.q, quat.identity()),
    )
    return SkewIcpResult(
        pose=safe_pose,
        skew_twist=jnp.where(finite, final.M, 0.0),
        fitness=fitness,
        converged=converged,
        num_correspondences=n_corr,
        iterations=final.it,
        hessian=(
            jnp.where(jnp.all(jnp.isfinite(final.H6)), final.H6, 0.0)
            if want_hessian else None
        ),
    )
