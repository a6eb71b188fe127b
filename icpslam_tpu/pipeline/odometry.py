"""ICP scan-to-scan odometry front-end.

Functional equivalent of the reference's ``IcpOdometer``
(``/root/reference/src/icpslam/icp_odometer.cpp``): voxel-filter the
incoming cloud, register it against the previous cloud, and accumulate the
relative transform into an odometry pose — but as a pure
``state' , out = odometry_step(state, scan)`` function under ``jit``
instead of a racy ROS callback (SURVEY.md §5.2: single-owner functional
state replaces the reference's unlocked shared mutables).

Behavioral contract preserved:
- cloud skipping for high-rate sensors (``icp_odometer.cpp:154-159``)
- first-cloud bootstrap stash (``:179-182``)
- accept gate ``converged && fitness < threshold`` (``:201``); a rejected
  scan does not advance the pose (graceful degradation, SURVEY §5.3)
- a drainable relative-transform accumulator mirroring
  ``icp_latest_transform_`` handed out by ``getEstimates`` (``:82-94``)
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from icpslam_tpu.cloud import pointcloud as pc
from icpslam_tpu.cloud.voxel import voxel_downsample
from icpslam_tpu.config import SlamConfig
from icpslam_tpu.geometry import se3
from icpslam_tpu.geometry.se3 import Pose
from icpslam_tpu.ops import covariance as cov_ops
from icpslam_tpu.ops import icp as icp_ops

def compute_covariances(cloud, icfg):
    """Covariances for a cloud per the ICP config (radius or knn mode)."""
    if icfg.covariance_mode == "radius":
        return cov_ops.gicp_covariances_radius(
            cloud,
            radius=icfg.covariance_radius,
            epsilon=icfg.covariance_epsilon,
            sigma=icfg.covariance_sigma,
        )
    return cov_ops.gicp_covariances(
        cloud, k=icfg.covariance_knn, epsilon=icfg.covariance_epsilon
    )



class OdometryState(NamedTuple):
    initialized: jnp.ndarray   # bool: first cloud stashed
    pose: Pose                 # accumulated odometry pose (odom frame)
    accum: Pose                # relative-transform accumulator (drained by back-end)
    prev_cloud: pc.PointCloud  # last processed (filtered) cloud — in
    #                            deskew_mode='coupled' this is the SKEWED
    #                            filtered sweep (the next registration
    #                            de-skews it self-consistently)
    prev_covs: jnp.ndarray     # (6, N) packed GICP covariances of prev_cloud
    prev_u: jnp.ndarray        # (N,) capture fractions of prev_cloud
    #                            (used by deskew_mode='coupled'; zeros
    #                            otherwise)
    last_transform: Pose       # last accepted relative motion (constant-velocity prior)
    skip_count: jnp.ndarray    # int32 remaining clouds to skip
    scan_count: jnp.ndarray    # int32 total scans seen


class OdometryOutput(NamedTuple):
    pose: Pose                 # odometry pose after this scan
    transform: Pose            # accepted relative transform (identity if rejected)
    processed: jnp.ndarray     # bool: scan was registered (not skipped/bootstrap)
    accepted: jnp.ndarray      # bool: passed the convergence+fitness gate
    fitness: jnp.ndarray
    num_correspondences: jnp.ndarray
    iterations: jnp.ndarray
    num_voxels: jnp.ndarray    # occupied voxels before capacity clipping
    filtered: pc.PointCloud    # the downsampled scan (consumed by mapping)
    filtered_covs: jnp.ndarray  # (6, N) packed GICP covariances of
                               # `filtered` (linalg3.mat_to_sym6 layout;
                               # meaningful only in plane mode — identity
                               # placeholders otherwise)
    hessian: jnp.ndarray       # (6, 6) final GN Hessian of the accepted
                               # registration (zeros unless
                               # config.adaptive_information and accepted)


def init_state(config: SlamConfig, initial_pose: Pose | None = None) -> OdometryState:
    if initial_pose is None:
        initial_pose = se3.identity()
    n = config.max_points
    return OdometryState(
        initialized=jnp.asarray(False),
        pose=initial_pose,
        accum=se3.identity(),
        prev_cloud=pc.empty(n),
        prev_covs=jnp.broadcast_to(
            jnp.asarray(cov_ops.EYE6, jnp.float32)[:, None], (6, n)
        ),
        prev_u=jnp.zeros((n,), jnp.float32),
        last_transform=se3.identity(),
        skip_count=jnp.asarray(0, jnp.int32),
        scan_count=jnp.asarray(0, jnp.int32),
    )


def set_initial_pose(state: OdometryState, pose: Pose) -> OdometryState:
    """Bootstrap from external (wheel) odometry — ``setInitialPose``
    (``icp_odometer.cpp:69-72``)."""
    return state._replace(pose=pose)


def drain_accumulator(state: OdometryState) -> Tuple[Pose, OdometryState]:
    """Hand out the accumulated relative transform since the last drain and
    reset it to identity — ``getEstimates`` semantics (``:82-94``)."""
    return state.accum, state._replace(accum=se3.identity())


def run_scans(
    state: OdometryState, scans: pc.PointCloud, config: SlamConfig
) -> Tuple[OdometryState, OdometryOutput]:
    """Process a chunk of scans in one device program (``lax.scan``).

    ``scans`` is a batched PointCloud (leading time axis, e.g. stacked with
    ``jax.tree_util.tree_map(lambda *x: jnp.stack(x), *clouds)``); outputs
    gain the same leading axis. Chunked driving amortizes the per-call
    host dispatch over step-by-step calls. Jit with
    ``static_argnums=(2,)``.
    """

    def f(st, scan):
        return odometry_step(st, scan, config)

    return jax.lax.scan(f, state, scans)


def odometry_step(
    state: OdometryState, raw_scan: pc.PointCloud, config: SlamConfig
) -> Tuple[OdometryState, OdometryOutput]:
    """Process one raw sensor-frame scan. Jit with ``static_argnums=(2,)``."""
    icfg = config.icp_odometry
    plane = icfg.mode == "plane"

    # sensor extrinsic: express the laser-frame scan in the robot frame
    # before filtering — the reference's per-cloud tf2 transform
    # (``icp_odometer.cpp:162-174``). Static identity check: the common
    # identity-extrinsic case adds no ops to the compiled step.
    if config.has_laser_extrinsic:
        ext = Pose(
            t=jnp.asarray(config.laser_extrinsic_t, raw_scan.points.dtype),
            q=jnp.asarray(config.laser_extrinsic_q, raw_scan.points.dtype),
        )
        raw_scan = pc.transform(ext, raw_scan)

    skip = state.initialized & (state.skip_count > 0)
    do_register = state.initialized & ~skip

    def make_register(filtered, covs, init_pose):
        def register(_):
            res = icp_ops.icp(
                filtered,
                state.prev_cloud,
                icfg,
                init=init_pose,
                source_covs=covs if plane else None,
                target_covs=state.prev_covs if plane else None,
                # voxel_downsample outputs are prefix-packed -> the NN
                # kernel can skip dead-capacity tiles (cost scales with
                # fill)
                target_valid_len=jnp.sum(state.prev_cloud.mask.astype(jnp.int32)),
                want_hessian=config.adaptive_information,
            )
            accepted = res.converged & (res.fitness < icfg.fitness_threshold)
            # icp maps current scan into the previous frame → relative motion
            transform = Pose(
                t=jnp.where(accepted, res.pose.t, 0.0),
                q=jnp.where(accepted, res.pose.q, se3.identity().q),
            )
            hess = (
                res.hessian * accepted.astype(jnp.float32)
                if config.adaptive_information
                else jnp.zeros((6, 6), jnp.float32)
            )
            return (
                transform, accepted, res.fitness, res.num_correspondences,
                res.iterations, hess,
            )

        return register

    def no_register(_):
        ident = se3.identity()
        return (
            ident,
            jnp.asarray(False),
            jnp.asarray(jnp.inf, jnp.float32),
            jnp.asarray(0, jnp.int32),
            jnp.asarray(0, jnp.int32),
            jnp.zeros((6, 6), jnp.float32),
        )

    def filter_and_covs(scan):
        filtered, num_voxels = voxel_downsample(
            scan, config.voxel_leaf_size, config.max_points
        )
        covs = (
            compute_covariances(filtered, icfg)
            if plane
            else state.prev_covs  # unused placeholder keeps pytree shape static
        )
        return filtered, num_voxels, covs

    stash_cloud = None  # coupled mode stashes the SKEWED filtered cloud
    stash_u = None
    if config.deskew_rounds > 0 and config.deskew_mode == "coupled":
        # self-consistent de-skew (no INS, DESIGN §14): a continuously
        # spinning lidar's sweep spans the full inter-scan interval, so
        # the PREVIOUS scan's smear IS the relative motion this
        # registration measures — the solver warps the (skewed) target
        # by the transform being solved (ops/skew_icp.coupled_deskew_icp)
        # and no constant-velocity estimate of the target's motion ever
        # enters (the feedback loop that diverges seed-based de-skew
        # cannot form). The source's own smear (the NEXT interval) is
        # pre-corrected with the CV seed; its residual error is solved
        # one step later when it becomes the target.
        from icpslam_tpu.cloud import deskew as deskew_ops
        from icpslam_tpu.ops import skew_icp

        filtered_s, num_voxels, covs = filter_and_covs(raw_scan)  # skewed
        u_f = deskew_ops.sweep_fraction(filtered_s.points)

        # auto prior stiffness: straight segments keep the twist stiffly
        # tied toward the solved transform (measured best there) while
        # turns relax to the corner-tuned weight. The gate lives INSIDE
        # the registration on the current pose iterate (lag-free —
        # ops/skew_icp.prior_weight_at); gating on the last accepted
        # transform instead lagged corner entries and diverged long
        # missions (DESIGN §18).
        auto_prior = (
            (config.deskew_auto_straight_weight,
             config.deskew_prior_weight,
             config.deskew_auto_turn_threshold)
            if (config.deskew_free_twist and config.deskew_auto_prior)
            else None
        )

        def register_coupled(_):
            res = skew_icp.coupled_deskew_icp(
                filtered_s,
                state.prev_cloud,
                state.prev_u,
                icfg,
                source_u=u_f,
                init=state.last_transform,
                source_covs=covs if plane else None,
                target_covs=state.prev_covs if plane else None,
                target_valid_len=jnp.sum(state.prev_cloud.mask.astype(jnp.int32)),
                free_source_twist=config.deskew_free_twist,
                source_twist_prior_weight=config.deskew_prior_weight,
                prior_huber_delta=config.deskew_prior_huber,
                auto_prior=auto_prior,
                want_hessian=config.adaptive_information,
            )
            accepted = res.converged & (res.fitness < icfg.fitness_threshold)
            transform = Pose(
                t=jnp.where(accepted, res.pose.t, 0.0),
                q=jnp.where(accepted, res.pose.q, se3.identity().q),
            )
            twist = jnp.where(
                accepted, res.skew_twist, se3.se3_log(state.last_transform)
            )
            hess = (
                res.hessian * accepted.astype(jnp.float32)
                if config.adaptive_information
                else jnp.zeros((6, 6), jnp.float32)
            )
            return (
                transform, accepted, res.fitness, res.num_correspondences,
                res.iterations, hess, twist,
            )

        def no_register_coupled(_):
            return no_register(None) + (se3.se3_log(state.last_transform),)

        (transform, accepted, fitness, n_corr, iters, hessian,
         src_twist) = jax.lax.cond(
            do_register, register_coupled, no_register_coupled, operand=None
        )
        # mapping consumes the current scan de-skewed with the freshest
        # causal estimate of ITS interval: the solver's source-twist
        # estimate (free mode) — which equals the measured transform
        # under the CV tie
        map_pts = deskew_ops.deskew_points(
            filtered_s.points, u_f, se3.se3_exp(src_twist)
        )
        filtered = pc.PointCloud(
            points=jnp.where(filtered_s.mask[:, None], map_pts, 0.0),
            mask=filtered_s.mask,
        )
        # The output cloud keeps the SKEWED cloud's covariances —
        # deliberately, and measured: recomputing them on the de-skewed
        # points is locally "correct" (500-pose RPE_t 0.070 vs 0.099)
        # but globally WORSE (ATE 0.50 vs 0.33). The smeared-neighborhood
        # covariances are elongated along exactly the directions the
        # residual twist-estimate error lives in, so the mapping GICP's
        # fused weighting (C_dst + R C_src Rᵀ)⁻¹ soft-gates the component
        # of scan-to-map innovation that de-skew error contaminates — an
        # uncertainty envelope the recomputed covariances destroy.
        out_covs = covs
        stash_cloud, stash_u = filtered_s, u_f
    elif config.deskew_rounds > 0 and config.deskew_mode == "joint":
        # joint 12-DoF skew-aware registration (no INS, DESIGN §14): the
        # smeared sweep is registered AS smeared, with per-point capture
        # fractions, and the solver separates the inter-scan pose from
        # the current sweep's own motion via the u-correlated residual
        # structure (ops/skew_icp.py). The de-skewed cloud handed to
        # mapping (and stashed as prev) uses the estimated twist.
        from icpslam_tpu.cloud import deskew as deskew_ops
        from icpslam_tpu.ops import skew_icp

        # exact capture fractions from RAW azimuth (the sensor reports
        # ray angles, so the skewed cloud's azimuth IS capture azimuth)
        u_raw = deskew_ops.sweep_fraction(raw_scan.points)
        # register the SKEWED filtered cloud — its azimuths are still
        # capture azimuths, so per-point u stays exact after filtering
        filtered_s, _, covs_s = filter_and_covs(raw_scan)
        u_f = deskew_ops.sweep_fraction(filtered_s.points)
        cv_seed = se3.se3_log(state.last_transform)

        def register_joint(_):
            res = skew_icp.skew_aware_icp(
                filtered_s,
                state.prev_cloud,
                icfg,
                sweep_u=u_f,
                init=state.last_transform,
                init_skew=cv_seed,
                source_covs=covs_s if plane else None,
                target_covs=state.prev_covs if plane else None,
                target_valid_len=jnp.sum(state.prev_cloud.mask.astype(jnp.int32)),
                # the joint mode is kept at its MEASURED operating point
                # (weight 1.0, DESIGN §14 table) — config.deskew_prior_weight
                # was re-tuned for coupled free-twist mode (default 100)
                # and would silently re-tune this comparison baseline
                skew_prior_weight=1.0,
                want_hessian=config.adaptive_information,
            )
            accepted = res.converged & (res.fitness < icfg.fitness_threshold)
            transform = Pose(
                t=jnp.where(accepted, res.pose.t, 0.0),
                q=jnp.where(accepted, res.pose.q, se3.identity().q),
            )
            twist = jnp.where(accepted, res.skew_twist, cv_seed)
            hess = (
                res.hessian * accepted.astype(jnp.float32)
                if config.adaptive_information
                else jnp.zeros((6, 6), jnp.float32)
            )
            return (
                transform, accepted, res.fitness, res.num_correspondences,
                res.iterations, hess, twist,
            )

        def no_register_joint(_):
            return no_register(None) + (cv_seed,)

        (transform, accepted, fitness, n_corr, iters, hessian,
         skew_twist) = jax.lax.cond(
            do_register, register_joint, no_register_joint, operand=None
        )
        # mapping + prev stash consume the de-skewed cloud
        pts_d = deskew_ops.deskew_points(
            raw_scan.points, u_raw, se3.se3_exp(skew_twist)
        )
        scan_d = pc.PointCloud(
            points=jnp.where(raw_scan.mask[:, None], pts_d, 0.0),
            mask=raw_scan.mask,
        )
        filtered, num_voxels, covs = filter_and_covs(scan_d)
        out_covs = covs
    elif config.deskew_rounds > 0:
        # in-loop iterative de-skew, alternating variant (DESIGN §14):
        # re-skew ↔ register, seeded by constant velocity. Each round
        # undoes the sweep smear with the CURRENT motion estimate and
        # re-registers against the previous (clean) cloud; the constant-
        # velocity feedback error that diverges open-loop (DESIGN §13's
        # negative result) is re-anchored here by registration within
        # the same scan. Rounds are a static unroll. Estimates only the
        # PREVIOUS interval's motion — 'joint' lifts that limit.
        from icpslam_tpu.cloud import deskew as deskew_ops

        u_raw = deskew_ops.sweep_fraction(raw_scan.points)
        rel = state.last_transform
        for _round in range(config.deskew_rounds):
            pts_k = deskew_ops.deskew_points(raw_scan.points, u_raw, rel)
            scan_k = pc.PointCloud(
                points=jnp.where(raw_scan.mask[:, None], pts_k, 0.0),
                mask=raw_scan.mask,
            )
            filtered, num_voxels, covs = filter_and_covs(scan_k)
            transform, accepted, fitness, n_corr, iters, hessian = jax.lax.cond(
                do_register, make_register(filtered, covs, rel), no_register,
                operand=None,
            )
            rel = Pose(
                t=jnp.where(accepted, transform.t, rel.t),
                q=jnp.where(accepted, transform.q, rel.q),
            )
        out_covs = covs
    else:
        filtered, num_voxels, covs = filter_and_covs(raw_scan)
        transform, accepted, fitness, n_corr, iters, hessian = jax.lax.cond(
            do_register,
            make_register(filtered, covs, state.last_transform),
            no_register,
            operand=None,
        )
        out_covs = covs

    new_pose = se3.normalize(se3.compose(state.pose, transform))
    new_accum = se3.normalize(se3.compose(state.accum, transform))

    # prev cloud/covs update on bootstrap or *successful* registration only —
    # on rejection the reference keeps the old cloud (icp_odometer.cpp keeps
    # prev_cloud_ unless converged && fitness ok), so the next registration
    # spans the full motion instead of silently dropping a step
    take_cloud = ~state.initialized | (do_register & accepted)
    sel = lambda new, old: jax.tree_util.tree_map(
        lambda a, b: jnp.where(take_cloud, a, b), new, old
    )
    new_prev_cloud = sel(stash_cloud if stash_cloud is not None else filtered,
                         state.prev_cloud)
    new_prev_covs = jnp.where(take_cloud, covs, state.prev_covs) if plane else state.prev_covs
    new_prev_u = (
        jnp.where(take_cloud, stash_u, state.prev_u)
        if stash_u is not None else state.prev_u
    )

    new_skip = jnp.where(
        skip,
        state.skip_count - 1,
        jnp.asarray(config.num_clouds_skip, jnp.int32),
    )

    new_last = Pose(
        t=jnp.where(accepted, transform.t, state.last_transform.t),
        q=jnp.where(accepted, transform.q, state.last_transform.q),
    )
    new_state = OdometryState(
        initialized=jnp.asarray(True),
        pose=new_pose,
        accum=new_accum,
        prev_cloud=new_prev_cloud,
        prev_covs=new_prev_covs,
        prev_u=new_prev_u,
        last_transform=new_last,
        skip_count=new_skip,
        scan_count=state.scan_count + 1,
    )
    out = OdometryOutput(
        pose=new_pose,
        transform=transform,
        processed=do_register,
        accepted=accepted,
        fitness=fitness,
        num_correspondences=n_corr,
        iterations=iters,
        num_voxels=num_voxels,
        filtered=filtered,
        filtered_covs=out_covs,
        hessian=hessian,
    )
    return new_state, out
