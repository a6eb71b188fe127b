"""Checkpoint/resume round-trip: state survives serialization, the resumed
pipeline continues identically, and the map re-renders from keyframes."""

import os

import jax
import numpy as np
import pytest

from icpslam_tpu.config import IcpConfig, tiny_config
from icpslam_tpu.geometry import se3
from icpslam_tpu.io import synthetic
from icpslam_tpu.pipeline import slam
from icpslam_tpu.utils import checkpoint


def make_cfg():
    return tiny_config(
        voxel_leaf_size=0.3,
        map_resolution=0.3,
        icp_odometry=IcpConfig(mode="point", max_iterations=10),
        icp_mapping=IcpConfig(mode="point", max_iterations=10),
        max_points=512,
        max_raw_points=2048,
        max_map_points=4096,
        max_keyframes=32,
        max_edges=64,
    )


@pytest.fixture(scope="module")
def run_ctx():
    cfg = make_cfg()
    world = synthetic.make_room_world(seed=0, n_points=8000)
    gt = synthetic.make_loop_trajectory(n_poses=12, radius=5.0, laps=0.4)
    scans = list(
        synthetic.scan_stream(world, gt, capacity=2048, n_points=800, seed=0)
    )
    return cfg, gt, scans


class TestCheckpoint:
    def test_roundtrip_and_resume(self, run_ctx, tmp_path):
        cfg, gt, scans = run_ctx
        step = jax.jit(slam.slam_step, static_argnums=(2,))
        state = slam.init_state(cfg, initial_pose=se3.index(gt, 0))
        for scan in scans[:6]:
            state, _ = step(state, scan, cfg)

        path = os.path.join(tmp_path, "ckpt.npz")
        checkpoint.save(path, state)
        restored = checkpoint.load(path, slam.init_state(cfg))

        # leaves identical
        for (p1, a), (p2, b) in zip(
            jax.tree_util.tree_flatten_with_path(state)[0],
            jax.tree_util.tree_flatten_with_path(restored)[0],
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

        # resumed run continues bit-identically to the uninterrupted one
        state_c, resumed_c = state, restored
        for scan in scans[6:]:
            state_c, _ = step(state_c, scan, cfg)
            resumed_c, _ = step(resumed_c, scan, cfg)
        np.testing.assert_allclose(
            np.asarray(state_c.slam_pose.t), np.asarray(resumed_c.slam_pose.t)
        )
        assert int(state_c.keyframes.count) == int(resumed_c.keyframes.count)

    def test_shape_mismatch_rejected(self, run_ctx, tmp_path):
        cfg, gt, scans = run_ctx
        state = slam.init_state(cfg)
        path = os.path.join(tmp_path, "ckpt2.npz")
        checkpoint.save(path, state)
        other_cfg = make_cfg().replace(max_keyframes=16)
        with pytest.raises(ValueError):
            checkpoint.load(path, slam.init_state(other_cfg))

    def test_rerender_map(self, run_ctx):
        cfg, gt, scans = run_ctx
        step = jax.jit(slam.slam_step, static_argnums=(2,))
        state = slam.init_state(cfg, initial_pose=se3.index(gt, 0))
        for scan in scans:
            state, out = step(state, scan, cfg)
        n_kf = int(state.keyframes.count)
        assert n_kf > 2
        rendered = checkpoint.rerender_map(state, cfg)
        # the re-rendered map covers at least the current regrown map
        assert int(rendered.map.size) >= int(state.map.size)
        assert int(rendered.map.size) > 0


class TestResumeWorkParity:
    """A resumed mission once measured slower per step; the cause was the
    measuring service, not the code (the slowdown followed run ORDER). The
    in-code invariant this pins: a resumed pipeline performs the SAME
    per-scan work (data-dependent ICP iterations, refinement successes,
    keyframe/optimize cadence) as the uninterrupted run over the same
    scans — so per-step cost parity holds wherever the backend itself is
    stable."""

    def test_resumed_work_matches_full_run(self, run_ctx, tmp_path):
        cfg, gt, scans = run_ctx
        step = jax.jit(slam.slam_step, static_argnums=(2,))

        def work_stats(out):
            return (
                int(out.odom_out.iterations),
                bool(out.refined),
                bool(out.new_keyframe),
                bool(out.optimized),
            )

        # full run, recording tail work
        state = slam.init_state(cfg, initial_pose=se3.index(gt, 0))
        tail_full = []
        for i, scan in enumerate(scans):
            state, out = step(state, scan, cfg)
            if i >= 6:
                tail_full.append(work_stats(out))

        # interrupted run: checkpoint at 6, reload (the endurance B2
        # path: load + rerender), drive the same tail
        state2 = slam.init_state(cfg, initial_pose=se3.index(gt, 0))
        for scan in scans[:6]:
            state2, _ = step(state2, scan, cfg)
        path = os.path.join(tmp_path, "ckpt.npz")
        checkpoint.save(path, state2)
        restored = checkpoint.load(path, slam.init_state(cfg))
        restored = checkpoint.rerender_map(restored, cfg)
        tail_resumed = []
        for scan in scans[6:]:
            restored, out = step(restored, scan, cfg)
            tail_resumed.append(work_stats(out))

        # identical keyframe/optimize cadence; ICP iteration counts may
        # differ slightly where the re-rendered map changes fixed-point
        # trajectories at float level — bound the drift instead
        it_f = np.asarray([w[0] for w in tail_full], np.float64)
        it_r = np.asarray([w[0] for w in tail_resumed], np.float64)
        assert abs(it_f.mean() - it_r.mean()) <= 1.0, (it_f, it_r)
        assert [w[2] for w in tail_full] == [w[2] for w in tail_resumed]
        assert [w[3] for w in tail_full] == [w[3] for w in tail_resumed]
