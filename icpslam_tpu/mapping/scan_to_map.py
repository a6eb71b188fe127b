"""Scan-to-map refinement and map growth.

Functional equivalent of ``OctreeMapper::refineTransformAndGrowMap``
(``/root/reference/src/icpslam/octree_mapper.cpp:133-173``):

1. transform the scan into the map frame with the raw odometry pose
2. empty map → just seed it with the scan, no refinement (``:138-142``)
3. approx-NN of every scan point against the map (``:148``)
4. pull the matched NN points back into the robot frame and register the
   scan against them with ICP (``:149-155``, 30 iters)
5. on success: refined pose = raw ∘ correction; grow the map with the
   re-transformed scan (occupancy dedup); on failure: leave pose and map
   unchanged (the orchestrator falls back to the raw transform,
   ``icpslam.cpp:136-140``)

Everything is a single jit-compatible function with ``lax.cond`` routing —
the empty-map and failure branches stay data-dependent but compiled.

Plane-mode target covariances: the reference re-estimates GICP
covariances inside PCL for the NN cloud on every call
(``octree_mapper.cpp:101-124`` internals). Here the point-map backend
*stores* each map point's covariance at insert time (rotated from the
sensor frame of the scan that contributed it) and the NN query gathers it
— same surface statistic, computed once per point instead of once per
query, saving a full neighborhood pass per scan. The voxel backend keeps
the recompute path.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from icpslam_tpu.cloud import pointcloud as pc
from icpslam_tpu.config import SlamConfig
from icpslam_tpu.geometry import quaternion as quat
from icpslam_tpu.geometry import se3
from icpslam_tpu.geometry.se3 import Pose
from icpslam_tpu.mapping import backend as map_backend
from icpslam_tpu.mapping import point_map as pm
from icpslam_tpu.ops import icp as icp_ops
from icpslam_tpu.ops.linalg3 import rotate_sym3_comps


class RefineResult(NamedTuple):
    success: jnp.ndarray      # bool: refinement accepted (False for empty map / failure)
    refined_pose: Pose        # map-frame pose (== raw_pose unless success)
    correction: Pose          # robot-frame correction transform (identity unless success)
    fitness: jnp.ndarray
    nn_found: jnp.ndarray     # int32: scan points with a map NN
    map: map_backend.MapState  # grown (or seeded) map
    nn_points: jnp.ndarray    # (N, 3) robot-frame NN cloud — the reference's
    nn_mask: jnp.ndarray      # nn_cloud debug topic (octree_mapper.cpp:160);
    #                           zeros/False on the empty-map seed branch
    hessian: jnp.ndarray      # (6, 6) final GN Hessian of the accepted
    #                           registration (zeros unless
    #                           config.adaptive_information and success)
    icp_iterations: jnp.ndarray = None  # int32 iterations the round-1
    #                           registration actually ran (early-exit
    #                           observability — the mapper budget is 30)


def _rotate_covs(covs6: jnp.ndarray, R: jnp.ndarray) -> jnp.ndarray:
    """R C Rᵀ for packed (6, N) covariances (component form, elementwise)."""
    return jnp.stack(rotate_sym3_comps(R, tuple(covs6[i] for i in range(6))))


def refine_and_grow(
    map_: map_backend.MapState,
    scan: pc.PointCloud,
    raw_pose: Pose,
    config: SlamConfig,
    scan_covs: jnp.ndarray | None = None,
    mesh=None,
) -> RefineResult:
    """Refine ``raw_pose`` against the map and grow the map with the scan.

    ``scan`` is the *downsampled* sensor-frame cloud (the odometry
    front-end's ``filtered`` output), matching the reference feeding the
    odometer's cloud into the mapper (``icpslam.cpp:130-135``).
    ``scan_covs`` lets callers reuse GICP covariances the front-end
    already computed for the same cloud (same knn/epsilon required) —
    packed (6, N), ``linalg3.mat_to_sym6`` layout.

    ``mesh``: device mesh for ``config.map_backend == 'sharded'`` — the
    NN query reduces over it (pmin/psum) and the insert routes points to
    their owning shards; the scan itself stays replicated.
    """
    icfg = config.icp_mapping
    res_m = config.map_resolution
    plane = icfg.mode == "plane"
    point_backend = isinstance(map_, pm.PointMap)
    # the point backend stores covariances only when a plane-mode mapper
    # will consume them; identity covs otherwise (zero cost either way)
    store_covs = plane and point_backend
    # a cloud already one-point-per-cell (leaf ≥ map resolution) can be
    # appended without the reordering voxel pass, which keeps per-point
    # covariances aligned
    aligned_insert = point_backend and config.voxel_leaf_size >= res_m

    if plane and scan_covs is None:
        # local import: pipeline.odometry imports nothing from mapping,
        # but the package __init__ chain would cycle at module load
        from icpslam_tpu.pipeline.odometry import compute_covariances

        scan_covs = compute_covariances(scan, icfg)

    cloud_in_map = pc.transform(raw_pose, scan)
    map_empty = map_backend.total_size(map_) == 0

    def seed(_):
        if store_covs and aligned_insert:
            covs_map = _rotate_covs(scan_covs, quat.to_matrix(raw_pose.q))
            grown = map_backend.insert_reusing_nn(
                map_, cloud_in_map, res_m,
                jnp.full((scan.capacity,), jnp.inf, jnp.float32),
                covs=covs_map,
                eviction=config.map_eviction,
            )
        else:
            grown = map_backend.insert(
                map_, cloud_in_map, res_m, mesh=mesh,
                eviction=config.map_eviction,
            )
        return RefineResult(
            success=jnp.asarray(False),
            refined_pose=raw_pose,
            correction=se3.identity(),
            fitness=jnp.asarray(jnp.inf, jnp.float32),
            nn_found=jnp.asarray(0, jnp.int32),
            map=grown,
            nn_points=jnp.zeros((scan.capacity, 3), jnp.float32),
            nn_mask=jnp.zeros((scan.capacity,), bool),
            hessian=jnp.zeros((6, 6), jnp.float32),
            icp_iterations=jnp.asarray(0, jnp.int32),
        )

    def refine(_):
        def one_round(pose):
            """Map query at ``pose`` + one registration against the NN
            cloud; returns the correction in the robot frame."""
            in_map = pc.transform(pose, scan)
            nn, map_covs = map_backend.query_nn_with_covs(
                map_, in_map.points, in_map.mask, config, mesh=mesh,
            )
            # NN points back into the robot frame (reference ``:149``)
            inv = se3.inverse(pose)
            nn_robot = pc.PointCloud(
                points=jnp.where(
                    nn.found[:, None], se3.transform_points(inv, nn.points), 0.0
                ),
                mask=nn.found,
            )
            kwargs = {}
            if plane:
                if map_covs is not None:
                    # stored map-frame covariances → robot frame: Rᵀ C R
                    R = quat.to_matrix(pose.q)
                    target_covs = _rotate_covs(map_covs, R.T)
                else:
                    from icpslam_tpu.pipeline.odometry import compute_covariances

                    target_covs = compute_covariances(nn_robot, icfg)
                kwargs = dict(source_covs=scan_covs, target_covs=target_covs)
            icp_res = icp_ops.icp(
                scan, nn_robot, icfg,
                fixed_correspondences=config.mapping_fixed_correspondences,
                want_hessian=config.adaptive_information,
                **kwargs,
            )
            return icp_res, nn, nn_robot

        def res_hess(r):
            return (
                r.hessian if config.adaptive_information
                else jnp.zeros((6, 6), jnp.float32)
            )

        icp_res, nn, nn_robot = one_round(raw_pose)
        hess = res_hess(icp_res)
        # reference accepts on hasConverged() alone here (no fitness gate,
        # ``octree_mapper.cpp:117``)
        success = icp_res.converged
        correction = Pose(
            t=jnp.where(success, icp_res.pose.t, 0.0),
            q=jnp.where(success, icp_res.pose.q, se3.identity().q),
        )
        refined = se3.normalize(se3.compose(raw_pose, correction))

        # outer re-query rounds (fixed-correspondence mode): when the
        # round-1 correction is large relative to the map cell, the
        # identity pairing was computed at a meaningfully wrong pose —
        # re-query the MAP at the corrected pose and register again.
        # This replaces the reference's per-iteration re-matching within
        # the STALE NN cloud with re-matching against the real map, and
        # only pays for it when the correction says it matters.
        extra_rounds = (
            config.mapping_requery_rounds - 1
            if config.mapping_fixed_correspondences else 0
        )
        if extra_rounds > 0:
            # fire whenever the correction is non-trivial relative to the
            # map cell: the fixed pairing recovers only part of a large
            # error per round (the pairing was biased by the error
            # itself), so rounds must continue until the correction
            # settles well below the cell size. Magnitude = MEAN SCAN-
            # POINT DISPLACEMENT under the correction, not |t| alone — a
            # rotation-dominant correction moves far points by many
            # cells at near-zero translation and needs re-pairing just
            # as much.
            thresh = 0.1 * res_m

            def corr_displacement(corr):
                moved = se3.transform_points(corr, scan.points)
                d = jnp.linalg.norm(moved - scan.points, axis=-1)
                n = jnp.maximum(jnp.sum(scan.mask.astype(d.dtype)), 1.0)
                return jnp.sum(jnp.where(scan.mask, d, 0.0)) / n

            def rq_cond(carry):
                pose, corr_mag, rounds, ok, _f, _nn_p, _nn_m, _d2, _fnd, _h = carry
                return (rounds < extra_rounds) & ok & (corr_mag > thresh)

            def rq_body(carry):
                pose, _mag, rounds, ok, _f, _nn_p, _nn_m, _d2, _fnd, _h = carry
                res2, nn2, nn_robot2 = one_round(pose)
                ok2 = res2.converged
                corr2 = Pose(
                    t=jnp.where(ok2, res2.pose.t, 0.0),
                    q=jnp.where(ok2, res2.pose.q, se3.identity().q),
                )
                pose2 = se3.normalize(se3.compose(pose, corr2))
                mag2 = corr_displacement(corr2) * ok2.astype(pose.t.dtype)
                return (
                    pose2, mag2, rounds + 1, ok | ok2,
                    jnp.where(ok2, res2.fitness, _f),
                    jnp.where(ok2, nn_robot2.points, _nn_p),
                    jnp.where(ok2, nn_robot2.mask, _nn_m),
                    jnp.where(ok2, nn2.dist2, _d2),
                    jnp.where(ok2, nn2.found, _fnd),
                    jnp.where(ok2, res_hess(res2), _h),
                )

            carry0 = (
                refined, corr_displacement(correction),
                jnp.asarray(0, jnp.int32),
                success, icp_res.fitness, nn_robot.points, nn_robot.mask,
                nn.dist2, nn.found, hess,
            )
            (refined, _, _, success, fit_final,
             nn_pts_f, nn_mask_f, nn_d2_f, nn_found_f, hess) = jax.lax.while_loop(
                rq_cond, rq_body, carry0
            )
            rel_final = se3.relative(raw_pose, refined)
            correction = Pose(
                t=jnp.where(success, rel_final.t, 0.0),
                q=jnp.where(success, rel_final.q, se3.identity().q),
            )
            nn = nn._replace(dist2=nn_d2_f, found=nn_found_f)
            nn_robot = pc.PointCloud(points=nn_pts_f, mask=nn_mask_f)
            icp_res = icp_res._replace(fitness=fit_final)

        grow_cloud = pc.transform(refined, scan)
        grow_covs = (
            _rotate_covs(scan_covs, quat.to_matrix(refined.q))
            if store_covs and aligned_insert
            else None
        )
        if aligned_insert:
            # the scan is already one-point-per-res_m-cell (leaf ≥ map
            # resolution) and we just measured every point's distance to
            # the map — reuse it for the dedup gate instead of paying a
            # second full NN sweep inside insert
            grown = map_backend.insert_reusing_nn(
                map_, grow_cloud, res_m, nn.dist2, covs=grow_covs,
                eviction=config.map_eviction,
            )
        else:
            grown = map_backend.insert(
                map_, grow_cloud, res_m, mesh=mesh,
                eviction=config.map_eviction,
            )
        # on failure the reference does not grow the map (``:155-169``)
        final_map = jax.tree_util.tree_map(
            lambda a, b: jnp.where(success, a, b), grown, map_
        )
        return RefineResult(
            success=success,
            refined_pose=Pose(
                t=jnp.where(success, refined.t, raw_pose.t),
                q=jnp.where(success, refined.q, raw_pose.q),
            ),
            correction=correction,
            fitness=icp_res.fitness,
            nn_found=jnp.sum(nn.found.astype(jnp.int32)),
            map=final_map,
            nn_points=nn_robot.points,
            nn_mask=nn_robot.mask,
            hessian=hess * success.astype(jnp.float32),
            icp_iterations=icp_res.iterations,
        )

    return jax.lax.cond(map_empty, seed, refine, operand=None)
