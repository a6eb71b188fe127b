"""Tests for NN search, Kabsch, GICP covariances, and the ICP driver:
brute-force numpy references and known-transform recovery (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icpslam_tpu import cloud as pc
from icpslam_tpu.config import IcpConfig
from icpslam_tpu.geometry import quaternion as quat
from icpslam_tpu.geometry import se3
from icpslam_tpu.geometry.se3 import Pose
from icpslam_tpu.ops import covariance, icp as icp_mod, nn as nn_ops
from icpslam_tpu.ops.kabsch import weighted_rigid_align
from icpslam_tpu.ops.linalg3 import sym6_to_mat


def random_pose(seed, t_scale=1.0, angle=0.3):
    rng = np.random.RandomState(seed)
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    return Pose(
        t=jnp.asarray(rng.randn(3) * t_scale, jnp.float32),
        q=quat.from_axis_angle(jnp.asarray(axis, jnp.float32), jnp.asarray(angle, jnp.float32)),
    )


class TestNN:
    def test_matches_bruteforce(self):
        rng = np.random.RandomState(0)
        q = rng.randn(100, 3).astype(np.float32)
        t = rng.randn(80, 3).astype(np.float32)
        res = nn_ops.nearest_neighbors(jnp.asarray(q), jnp.asarray(t), jnp.ones(80, bool), block=32)
        d2_full = ((q[:, None] - t[None]) ** 2).sum(-1)
        np.testing.assert_array_equal(np.asarray(res.idx), d2_full.argmin(1))
        np.testing.assert_allclose(np.asarray(res.dist2), d2_full.min(1), atol=1e-4)

    def test_masked_targets_excluded(self):
        q = jnp.zeros((1, 3))
        t = jnp.array([[0.1, 0, 0], [5.0, 0, 0]])
        mask = jnp.array([False, True])
        res = nn_ops.nearest_neighbors(q, t, mask)
        assert int(res.idx[0]) == 1
        np.testing.assert_allclose(float(res.dist2[0]), 25.0, atol=1e-5)

    def test_all_masked(self):
        res = nn_ops.nearest_neighbors(jnp.zeros((4, 3)), jnp.ones((4, 3)), jnp.zeros(4, bool))
        assert np.all(np.isinf(np.asarray(res.dist2)))

    def test_knn_matches_bruteforce(self):
        rng = np.random.RandomState(1)
        q = rng.randn(50, 3).astype(np.float32)
        t = rng.randn(64, 3).astype(np.float32)
        idx, d2 = nn_ops.knn(jnp.asarray(q), jnp.asarray(t), jnp.ones(64, bool), k=5, block=16)
        d2_full = ((q[:, None] - t[None]) ** 2).sum(-1)
        expect = np.sort(d2_full, axis=1)[:, :5]
        np.testing.assert_allclose(np.sort(np.asarray(d2), axis=1), expect, atol=1e-4)


class TestKabsch:
    def test_recovers_exact_transform(self):
        rng = np.random.RandomState(2)
        src = rng.randn(200, 3).astype(np.float32)
        gt = random_pose(3, t_scale=2.0, angle=0.8)
        dst = se3.transform_points(gt, jnp.asarray(src))
        est, ok = weighted_rigid_align(jnp.asarray(src), dst, jnp.ones(200))
        assert bool(ok)
        np.testing.assert_allclose(est.t, gt.t, atol=1e-4)
        np.testing.assert_allclose(
            np.abs(np.sum(np.asarray(est.q) * np.asarray(gt.q))), 1.0, atol=1e-5
        )

    def test_weights_reject_outliers(self):
        rng = np.random.RandomState(4)
        src = rng.randn(100, 3).astype(np.float32)
        gt = random_pose(5, t_scale=1.0, angle=0.4)
        dst = np.array(se3.transform_points(gt, jnp.asarray(src)))
        dst[:10] += 50.0  # corrupt
        w = np.ones(100, np.float32)
        w[:10] = 0.0
        est, ok = weighted_rigid_align(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
        np.testing.assert_allclose(est.t, gt.t, atol=1e-4)

    def test_zero_weights_fallback(self):
        src = jnp.ones((8, 3))
        est, ok = weighted_rigid_align(src, src, jnp.zeros(8))
        assert not bool(ok)
        np.testing.assert_allclose(est.q, [1, 0, 0, 0], atol=1e-6)

    def test_degenerate_single_point(self):
        # one point: translation-only fit, must not NaN
        src = jnp.array([[1.0, 2.0, 3.0]])
        dst = jnp.array([[2.0, 2.0, 3.0]])
        est, ok = weighted_rigid_align(src, dst, jnp.ones(1))
        assert bool(ok)
        assert not np.any(np.isnan(np.asarray(est.t)))
        moved = se3.transform_points(est, src)
        np.testing.assert_allclose(moved, dst, atol=1e-5)


class TestCovariance:
    def test_planar_covariances(self):
        # points on z=0 plane → smallest eigenvector ≈ z, eigvals (eps,1,1)
        rng = np.random.RandomState(6)
        pts = np.c_[rng.uniform(-1, 1, (128, 2)), np.zeros(128)].astype(np.float32)
        cloud = pc.from_points(pts, capacity=128)
        covs = sym6_to_mat(covariance.gicp_covariances(cloud, k=8, epsilon=1e-3))
        vals, vecs = np.linalg.eigh(np.asarray(covs))
        np.testing.assert_allclose(vals[:, 0], 1e-3, atol=1e-4)
        np.testing.assert_allclose(vals[:, 1:], 1.0, atol=1e-4)
        # normal direction = z
        normals = np.abs(vecs[:, :, 0])
        np.testing.assert_allclose(normals[:, 2], 1.0, atol=1e-3)

    def test_padding_gets_identity(self):
        pts = np.random.RandomState(7).randn(10, 3).astype(np.float32)
        cloud = pc.from_points(pts, capacity=16)
        covs = np.asarray(sym6_to_mat(covariance.gicp_covariances(cloud, k=4)))
        np.testing.assert_allclose(covs[10:], np.broadcast_to(np.eye(3), (6, 3, 3)))


def make_scan_pair(seed, n=400, noise=0.0, capacity=512, t_scale=0.2, angle=0.15):
    """Structured 3D scene (two walls + floor) seen from two poses."""
    rng = np.random.RandomState(seed)
    floor = np.c_[rng.uniform(-3, 3, (n // 2, 2)), np.zeros(n // 2)]
    wall1 = np.c_[rng.uniform(-3, 3, n // 4), np.full(n // 4, 3.0), rng.uniform(0, 2, n // 4)]
    wall2 = np.c_[np.full(n - n // 2 - n // 4, -3.0), rng.uniform(-3, 3, n - n // 2 - n // 4), rng.uniform(0, 2, n - n // 2 - n // 4)]
    world = np.concatenate([floor, wall1, wall2]).astype(np.float32)
    gt = random_pose(seed + 100, t_scale=t_scale, angle=angle)
    # target = world seen at identity; source = world seen from gt⁻¹
    # so transforming source by gt aligns it with target.
    src_pts = np.asarray(se3.transform_points(se3.inverse(gt), jnp.asarray(world)))
    if noise:
        src_pts = src_pts + rng.randn(*src_pts.shape).astype(np.float32) * noise
        world = world + rng.randn(*world.shape).astype(np.float32) * noise
    return (
        pc.from_points(src_pts, capacity=capacity),
        pc.from_points(world, capacity=capacity),
        gt,
    )


class TestIcp:
    @pytest.mark.parametrize("mode", ["point", "plane"])
    def test_recovers_transform(self, mode):
        source, target, gt = make_scan_pair(10)
        cfg = IcpConfig(mode=mode, max_iterations=30)
        kwargs = {}
        if mode == "plane":
            kwargs = dict(
                source_covs=covariance.gicp_covariances(source, k=8),
                target_covs=covariance.gicp_covariances(target, k=8),
            )
        res = icp_mod.icp(source, target, cfg, **kwargs)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.pose.t), np.asarray(gt.t), atol=2e-2)
        assert float(se3.distance_rotation(res.pose, gt)) < 2e-2
        assert float(res.fitness) < 0.01

    @pytest.mark.parametrize("refresh", [2, 3])
    def test_correspondence_refresh_converges(self, refresh):
        # reusing matches between NN refreshes must still recover the pose
        source, target, gt = make_scan_pair(10)
        cfg = IcpConfig(
            mode="point", max_iterations=30, correspondence_refresh=refresh
        )
        res = icp_mod.icp(source, target, cfg)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.pose.t), np.asarray(gt.t), atol=3e-2)
        assert float(se3.distance_rotation(res.pose, gt)) < 3e-2

    def test_noisy_scans(self):
        source, target, gt = make_scan_pair(11, noise=0.02)
        cfg = IcpConfig(mode="point", max_iterations=30)
        res = icp_mod.icp(source, target, cfg)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.pose.t), np.asarray(gt.t), atol=0.1)

    def test_identity_for_same_cloud(self):
        source, _, _ = make_scan_pair(12)
        cfg = IcpConfig(mode="point")
        res = icp_mod.icp(source, source, cfg)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.pose.t), np.zeros(3), atol=1e-5)
        # |q|²−2q·t+|t|² in float32 leaves ~1e-7 cancellation noise
        assert float(res.fitness) < 1e-5
        # early exit: should not burn all iterations on identical clouds
        assert int(res.iterations) < 10

    def test_no_overlap_not_converged(self):
        rng = np.random.RandomState(13)
        a = pc.from_points(rng.randn(50, 3).astype(np.float32), capacity=64)
        b = pc.from_points(rng.randn(50, 3).astype(np.float32) + 100.0, capacity=64)
        res = icp_mod.icp(a, b, IcpConfig(mode="point"))
        assert not bool(res.converged)
        assert np.isinf(float(res.fitness))

    def test_jit_compiles(self):
        source, target, gt = make_scan_pair(14)
        cfg = IcpConfig(mode="point", max_iterations=10)
        f = jax.jit(lambda s, t: icp_mod.icp(s, t, cfg))
        res = f(source, target)
        assert bool(res.converged)

    def test_empty_source(self):
        source = pc.empty(64)
        _, target, _ = make_scan_pair(15)
        res = icp_mod.icp(source, target, IcpConfig(mode="point"))
        assert not bool(res.converged)


class TestLinalg3:
    def test_eigvals_isotropic(self):
        # regression: isotropic matrices must return (q, q, q), not the
        # dummy guarded-p values
        from icpslam_tpu.ops.linalg3 import eigvals_sym3
        np.testing.assert_allclose(np.asarray(eigvals_sym3(jnp.eye(3))), 1.0, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(eigvals_sym3(2.0 * jnp.eye(3))), 2.0, atol=1e-6
        )

    def test_eigvals_match_numpy(self):
        from icpslam_tpu.ops.linalg3 import eigvals_sym3
        rng = np.random.RandomState(0)
        A = rng.randn(64, 3, 3).astype(np.float32)
        A = A @ A.transpose(0, 2, 1)
        got = np.asarray(eigvals_sym3(jnp.asarray(A)))
        expect = np.linalg.eigvalsh(A)
        np.testing.assert_allclose(got, expect, atol=1e-3, rtol=1e-3)

    def test_inv_sym3_comps_matches_inv3(self):
        from icpslam_tpu.ops.linalg3 import inv3, inv_sym3_comps, sym3_comps
        rng = np.random.RandomState(1)
        A = rng.randn(128, 3, 3).astype(np.float32)
        A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3)  # SPD
        Aj = jnp.asarray(A)
        a, b, c, d, e, f = inv_sym3_comps(*sym3_comps(Aj))
        got = np.stack(
            [np.stack([a, b, c], -1), np.stack([b, d, e], -1),
             np.stack([c, e, f], -1)], axis=-2)
        np.testing.assert_allclose(got, np.asarray(inv3(Aj)), rtol=2e-4, atol=2e-4)

    def test_rotate_sym3_comps_matches_einsum(self):
        from icpslam_tpu.geometry import quaternion as quat
        from icpslam_tpu.ops.linalg3 import rotate_sym3_comps, sym3_comps
        rng = np.random.RandomState(2)
        C = rng.randn(64, 3, 3).astype(np.float32)
        C = C @ C.transpose(0, 2, 1)
        q = quat.normalize(jnp.asarray(rng.randn(4), jnp.float32))
        R = quat.to_matrix(q)
        expect = np.einsum("ij,njk,lk->nil", np.asarray(R), C, np.asarray(R))
        a, b, c, d, e, f = rotate_sym3_comps(R, sym3_comps(jnp.asarray(C)))
        got = np.stack(
            [np.stack([a, b, c], -1), np.stack([b, d, e], -1),
             np.stack([c, e, f], -1)], axis=-2)
        np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)

    def test_kabsch_comps_matches_array_form(self):
        from icpslam_tpu.ops.kabsch import (
            weighted_rigid_align, weighted_rigid_align_comps)
        rng = np.random.RandomState(3)
        src = jnp.asarray(rng.randn(200, 3), jnp.float32)
        dst = jnp.asarray(rng.randn(200, 3), jnp.float32)
        w = jnp.asarray(rng.rand(200), jnp.float32)
        p1, ok1 = weighted_rigid_align(src, dst, w)
        p2, ok2 = weighted_rigid_align_comps(
            src[:, 0], src[:, 1], src[:, 2],
            dst[:, 0], dst[:, 1], dst[:, 2], w)
        assert bool(ok1) == bool(ok2)
        np.testing.assert_allclose(np.asarray(p1.t), np.asarray(p2.t), atol=1e-5)
        np.testing.assert_allclose(np.asarray(p1.q), np.asarray(p2.q), atol=1e-5)


class TestRadiusCovariance:
    def test_moments_match_bruteforce(self):
        rng = np.random.RandomState(0)
        pts = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
        mask = np.ones(256, bool)
        mask[250:] = False
        r = 0.6
        count, mean, cov = covariance.radius_moments(
            jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(mask), r
        )
        for i in [0, 17, 99]:
            d = np.linalg.norm(pts[mask] - pts[i], axis=-1)
            nb = pts[mask][d < r]
            assert int(count[i]) == len(nb)
            np.testing.assert_allclose(np.asarray(mean[i]), nb.mean(0), atol=1e-4)
            np.testing.assert_allclose(
                np.asarray(cov[i]), np.cov(nb.T, bias=True), atol=1e-4
            )

    @pytest.mark.parametrize("sigma", [0.0, 0.3], ids=["hard", "gaussian"])
    def test_moments_far_from_origin_match_numpy(self, sigma):
        # map frames drift far from the origin: the query-centroid
        # re-centring keeps E[ppᵀ] − μμᵀ from cancelling
        rng = np.random.RandomState(6)
        pts = (rng.uniform(-2, 2, (300, 3)) + [400.0, -250.0, 30.0]).astype(
            np.float32)
        mask = rng.rand(300) > 0.1
        r = 0.7
        count, mean, cov = covariance.radius_moments(
            jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(mask), r,
            sigma=sigma, block=128,
        )
        p64 = pts.astype(np.float64)[mask]
        for i in [3, 50, 211]:
            d2 = np.sum((p64 - pts[i].astype(np.float64)) ** 2, axis=-1)
            w = (d2 < r * r).astype(np.float64)
            if sigma > 0:
                w = w * np.exp(-d2 / (2 * sigma**2))
            m = (w[:, None] * p64).sum(0) / w.sum()
            c = np.einsum("n,ni,nj->ij", w, p64 - m, p64 - m) / w.sum()
            np.testing.assert_allclose(float(count[i]), w.sum(), rtol=1e-4)
            np.testing.assert_allclose(np.asarray(mean[i]), m, atol=1e-3)
            np.testing.assert_allclose(np.asarray(cov[i]), c, atol=2e-3)

    def test_planar_normals(self):
        rng = np.random.RandomState(2)
        plane = np.c_[rng.uniform(-1, 1, (256, 2)), np.zeros(256)].astype(np.float32)
        cloud = pc.from_points(plane, capacity=256)
        covs = sym6_to_mat(covariance.gicp_covariances_radius(cloud, radius=0.4))
        vals, vecs = np.linalg.eigh(np.asarray(covs))
        np.testing.assert_allclose(np.abs(vecs[:, 2, 0]), 1.0, atol=1e-2)

    def test_gaussian_moments_match_bruteforce(self):
        rng = np.random.RandomState(3)
        pts = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
        mask = np.ones(256, bool)
        mask[250:] = False
        r, sigma = 0.6, 0.3
        count, mean, cov = covariance.radius_moments(
            jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(mask), r, sigma=sigma
        )
        for i in [0, 17, 99]:
            d2 = np.sum((pts[mask] - pts[i]) ** 2, axis=-1)
            w = np.where(d2 < r * r, np.exp(-d2 / (2 * sigma**2)), 0.0)
            sw = w.sum()
            m = (w[:, None] * pts[mask]).sum(0) / sw
            c = (w[:, None, None] * np.einsum(
                "ni,nj->nij", pts[mask] - m, pts[mask] - m
            )).sum(0) / sw
            np.testing.assert_allclose(float(count[i]), sw, rtol=1e-4)
            np.testing.assert_allclose(np.asarray(mean[i]), m, atol=1e-4)
            np.testing.assert_allclose(np.asarray(cov[i]), c, atol=1e-4)

    def test_gaussian_planar_normals(self):
        # noisy plane: the Gaussian taper must still recover the normal
        rng = np.random.RandomState(5)
        plane = np.c_[
            rng.uniform(-1, 1, (256, 2)), rng.normal(0, 0.005, 256)
        ].astype(np.float32)
        cloud = pc.from_points(plane, capacity=256)
        covs = sym6_to_mat(
            covariance.gicp_covariances_radius(cloud, radius=0.4, sigma=0.2))
        vals, vecs = np.linalg.eigh(np.asarray(covs))
        np.testing.assert_allclose(np.abs(vecs[:, 2, 0]), 1.0, atol=5e-2)

    def test_sparse_points_identity(self):
        # isolated points (< 3 neighbors in radius) get identity covariance
        pts = np.array([[0, 0, 0], [10, 0, 0], [20, 0, 0]], np.float32)
        cloud = pc.from_points(pts, capacity=4)
        covs = np.asarray(
            sym6_to_mat(covariance.gicp_covariances_radius(cloud, radius=0.5)))
        np.testing.assert_allclose(covs[:3], np.broadcast_to(np.eye(3), (3, 3, 3)))


class TestIcpHessian:
    """``want_hessian``: the final-pose GN Hessian JᵀWJ (the edge
    information source replacing the reference's fixed diagonals,
    ``icpslam.cpp:28-40``)."""

    def test_point_mode_matches_numpy(self):
        # identical clouds at identity: every point matches itself with
        # w=1 and H = Σ [[I, −skew(p)], [skew(p)ᵀ·... ]] — build directly
        rng = np.random.RandomState(0)
        pts = rng.uniform(-2, 2, (64, 3)).astype(np.float32)
        cloud = pc.from_points(pts, capacity=64)
        cfg = IcpConfig(mode="point", max_iterations=3, huber_delta=0.0)
        res = icp_mod.icp(cloud, cloud, cfg, want_hessian=True)
        assert res.hessian is not None

        def skew(p):
            return np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]])

        H_ref = np.zeros((6, 6))
        for p in pts:
            J = np.concatenate([np.eye(3), -skew(p)], axis=1)  # (3, 6)
            H_ref += J.T @ J
        np.testing.assert_allclose(
            np.asarray(res.hessian), H_ref, rtol=1e-3, atol=1e-2
        )

    def test_plane_mode_symmetric_pd(self):
        source, target, gt = make_scan_pair(11)
        covs_s = covariance.gicp_covariances(source, k=8)
        covs_t = covariance.gicp_covariances(target, k=8)
        cfg = IcpConfig(mode="plane", max_iterations=15)
        res = icp_mod.icp(
            source, target, cfg, source_covs=covs_s, target_covs=covs_t,
            want_hessian=True,
        )
        H = np.asarray(res.hessian)
        np.testing.assert_allclose(H, H.T, atol=1e-2 * np.abs(H).max())
        w = np.linalg.eigvalsh(0.5 * (H + H.T))
        assert w.min() > 0, w  # registered overlap constrains all 6 DoF

    def test_off_by_default(self):
        source, target, _ = make_scan_pair(12)
        cfg = IcpConfig(mode="point", max_iterations=3)
        res = icp_mod.icp(source, target, cfg)
        assert res.hessian is None
