"""Streaming multi-device SLAM: the sequential ``slam_step`` consuming the
spatially-sharded map over a mesh must match the single-device voxel
pipeline (VERDICT r2 item 1; SURVEY §5.7 — the reference's single global
octree, ``/root/reference/src/icpslam/octree_mapper.cpp:19``, scaled out).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from icpslam_tpu.config import IcpConfig, tiny_config
from icpslam_tpu.geometry import se3
from icpslam_tpu.geometry.se3 import Pose
from icpslam_tpu.io import synthetic
from icpslam_tpu.mapping import backend as map_backend
from icpslam_tpu.parallel import mesh as mesh_lib
from icpslam_tpu.pipeline import slam


def make_cfg(backend: str, shards: int = 1, **over):
    base = dict(
        voxel_leaf_size=0.3,
        map_resolution=0.3,
        icp_odometry=IcpConfig(mode="plane", max_iterations=8),
        icp_mapping=IcpConfig(mode="point", max_iterations=15),
        max_points=1024,
        max_raw_points=2048,
        max_map_points=8192,
        max_keyframes=32,
        max_edges=128,
        keyframes_window=4,
        map_backend=backend,
        map_shards=shards,
    )
    base.update(over)
    return tiny_config(**base)


def make_stream(cfg, n_poses=14, laps=0.75):
    world = synthetic.make_room_world(seed=0, n_points=12000)
    gt = synthetic.make_loop_trajectory(n_poses=n_poses, radius=5.0, laps=laps)
    scans = list(
        synthetic.scan_stream(
            world, gt, capacity=cfg.max_raw_points, max_range=12.0,
            n_points=1200, noise=0.01,
        )
    )
    return scans, gt


def drive(cfg, scans, gt, mesh=None):
    step = jax.jit(
        functools.partial(slam.slam_step, mesh=mesh), static_argnums=(2,)
    )
    st = slam.init_state(cfg, initial_pose=se3.index(gt, 0))
    poses = []
    for i, s in enumerate(scans):
        st, out = step(st, s, cfg)
        poses.append(out.pose_map)
        # Bound the in-flight queue of multi-device programs: XLA:CPU's
        # in-process collectives rendezvous over a shared thread pool,
        # and a deep async queue of 8-device shard_map steps can starve
        # it (3/8 participants arrive → 40 s timeout → SIGABRT; see
        # tools/xla_cpu_collective_deadlock_repro.py). ~16 in flight is
        # reliably safe on this host; GPU meshes hand collectives to NCCL
        # and do not rendezvous through a host thread pool.
        if i % 8 == 7:
            jax.block_until_ready(st)
    # Consolidate the trajectory HOST-side: an eager se3.stack over the
    # retained multi-device pose outputs is itself an 8-device program
    # dispatched on top of whatever is still in flight, and aborted
    # deterministically here once r5's extra per-step output raised the
    # queue pressure (same rendezvous class as the bound above). One
    # fetch per pose after a full sync is cheap on the local CPU mesh.
    jax.block_until_ready(st)
    t = np.stack([np.asarray(p.t) for p in poses])
    q = np.stack([np.asarray(p.q) for p in poses])
    return st, Pose(t=jnp.asarray(t), q=jnp.asarray(q))


class TestShardedStreamingSlam:
    def test_matches_single_device_voxel_pipeline(self):
        """Same scans, same config: the mesh-sharded map must produce the
        same trajectory and the same map content as the local voxel map
        (ownership partitions voxels, so the union of per-shard 3^3
        lookups equals the global 3^3 lookup)."""
        cfg_v = make_cfg("voxel")
        scans, gt = make_stream(cfg_v)
        st_v, traj_v = drive(cfg_v, scans, gt)

        mesh = mesh_lib.make_mesh(8)
        cfg_s = make_cfg("sharded", shards=8)
        st_s, traj_s = drive(cfg_s, scans, gt, mesh=mesh)

        assert int(st_s.keyframes.count) == int(st_v.keyframes.count)
        np.testing.assert_allclose(
            np.asarray(traj_s.t), np.asarray(traj_v.t), atol=1e-4
        )
        # identical voxel content (size per shard sums to the local size)
        assert int(jnp.sum(st_s.map.size)) == int(st_v.map.size)
        assert int(jnp.sum(st_s.map.overflow)) == int(st_v.map.overflow)
        # loop closures / optimizations follow the same schedule
        assert int(st_s.num_optimizations) == int(st_v.num_optimizations)
        assert int(st_s.num_loop_closures) == int(st_v.num_loop_closures)

    def test_shards_partition_ownership(self):
        """Each live voxel key lives on exactly the shard that owns it —
        no duplicates across shards."""
        from icpslam_tpu.parallel import sharded_map as sm

        mesh = mesh_lib.make_mesh(8)
        cfg = make_cfg("sharded", shards=8)
        scans, gt = make_stream(cfg, n_poses=8, laps=0.4)
        st, _ = drive(cfg, scans, gt, mesh=mesh)

        keys = np.asarray(st.map.keys)      # (D, C, 3)
        sizes = np.asarray(st.map.size)     # (D,)
        for d in range(keys.shape[0]):
            live = keys[d, : sizes[d]]
            if live.size == 0:
                continue
            owners = np.asarray(
                sm.owner_of(jnp.asarray(live), keys.shape[0])
            )
            assert (owners == d).all(), f"shard {d} holds foreign voxels"
        # and across shards, keys are globally unique
        all_live = np.concatenate(
            [keys[d, : sizes[d]] for d in range(keys.shape[0])], axis=0
        )
        uniq = np.unique(all_live, axis=0)
        assert uniq.shape[0] == all_live.shape[0]

    def test_reset_on_optimize_clears_all_shards(self):
        mesh = mesh_lib.make_mesh(4)
        cfg = make_cfg("sharded", shards=4, keyframes_window=3)
        scans, gt = make_stream(cfg, n_poses=10, laps=0.5)
        st, _ = drive(cfg, scans, gt, mesh=mesh)
        assert int(st.num_optimizations) >= 1
        # the map regrows between optimizations but never exceeds what the
        # post-reset scans inserted; a reset-at-window pipeline keeps the
        # per-shard sizes bounded by the recent-scan content
        assert int(jnp.sum(st.map.size)) > 0

    def test_checkpoint_roundtrip_with_sharded_map(self, tmp_path):
        """Save/load a sharded-map state and re-render the map across the
        mesh on resume (SURVEY §5.4 at multi-device scale)."""
        from icpslam_tpu.utils import checkpoint

        mesh = mesh_lib.make_mesh(4)
        cfg = make_cfg("sharded", shards=4)
        scans, gt = make_stream(cfg, n_poses=8, laps=0.4)
        st, _ = drive(cfg, scans, gt, mesh=mesh)

        path = str(tmp_path / "sharded_state.npz")
        checkpoint.save(path, st)
        restored = checkpoint.load(path, slam.init_state(cfg))
        assert int(restored.keyframes.count) == int(st.keyframes.count)
        np.testing.assert_allclose(
            np.asarray(restored.slam_pose.t), np.asarray(st.slam_pose.t),
            atol=1e-6,
        )
        # map shape round-trips with the device axis intact
        assert restored.map.keys.shape == st.map.keys.shape

        rerendered = checkpoint.rerender_map(restored, cfg, mesh=mesh)
        assert int(jnp.sum(rerendered.map.size)) > 0
        # rebuilt content is spatially sharded again (ownership partition)
        from icpslam_tpu.parallel import sharded_map as sm

        keys = np.asarray(rerendered.map.keys)
        sizes = np.asarray(rerendered.map.size)
        for d in range(keys.shape[0]):
            live = keys[d, : sizes[d]]
            if live.size:
                owners = np.asarray(sm.owner_of(jnp.asarray(live), keys.shape[0]))
                assert (owners == d).all()

    def test_run_scans_chunked_matches_stepwise(self):
        """The lax.scan chunked driver accepts the mesh too."""
        mesh = mesh_lib.make_mesh(4)
        cfg = make_cfg("sharded", shards=4)
        scans, gt = make_stream(cfg, n_poses=8, laps=0.4)
        st_step, _ = drive(cfg, scans, gt, mesh=mesh)

        run = jax.jit(
            functools.partial(slam.run_scans, mesh=mesh), static_argnums=(2,)
        )
        stacked = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *scans)
        st_chunk, outs = run(
            slam.init_state(cfg, initial_pose=se3.index(gt, 0)), stacked, cfg
        )
        np.testing.assert_allclose(
            np.asarray(st_chunk.slam_pose.t),
            np.asarray(st_step.slam_pose.t),
            atol=1e-4,
        )
        assert int(jnp.sum(st_chunk.map.size)) == int(jnp.sum(st_step.map.size))


class TestDistributedStreamingSolve:
    """The streaming slam_step's windowed optimize routed through the
    edge-sharded distributed solvers (VERDICT r3 item 1): with
    ``graph_linear_solver='dist-*'`` and a mesh, the one blocking solve of
    the reference (``icpslam.cpp:171``) runs distributed — and must be
    trajectory-identical to the replicated solver."""

    def test_dist_direct_matches_replicated(self):
        # full solves every window (incremental off) so the dist path is
        # exercised at every optimize, not only after loop closures
        cfg_r = make_cfg("voxel", graph_incremental=False,
                         graph_linear_solver="direct")
        scans, gt = make_stream(cfg_r)
        st_r, traj_r = drive(cfg_r, scans, gt)

        mesh = mesh_lib.make_mesh(8)
        cfg_d = make_cfg("voxel", graph_incremental=False,
                         graph_linear_solver="dist-direct")
        st_d, traj_d = drive(cfg_d, scans, gt, mesh=mesh)

        assert int(st_d.num_optimizations) == int(st_r.num_optimizations)
        assert int(st_d.num_optimizations) >= 1
        # edge-sharded assembly + psum reduces in a different order than
        # the single-device scatter-add — float-level tolerance only
        np.testing.assert_allclose(
            np.asarray(traj_d.t), np.asarray(traj_r.t), atol=1e-3
        )

    def test_dist_pcg_with_sharded_map_and_incremental(self):
        """Everything on the mesh at once: spatially-sharded map +
        distributed PCG full solves + incremental window solves between
        loop closures."""
        mesh = mesh_lib.make_mesh(8)
        cfg = make_cfg(
            "sharded", shards=8, graph_linear_solver="dist-pcg",
            loop_closure_min_id_gap=6,
        )
        scans, gt = make_stream(cfg)
        st, traj = drive(cfg, scans, gt, mesh=mesh)
        assert int(st.num_optimizations) >= 1
        assert bool(jnp.all(jnp.isfinite(st.slam_pose.t)))
        # trajectory stays loop-consistent
        err = np.linalg.norm(
            np.asarray(traj.t) - np.asarray(gt.t)[: traj.t.shape[0]], axis=-1
        )
        assert err.max() < 0.6, err.max()

    def test_dist_requires_mesh(self):
        cfg = make_cfg("voxel", graph_linear_solver="dist-pcg")
        scans, gt = make_stream(cfg, n_poses=2, laps=0.1)
        try:
            drive(cfg, scans, gt, mesh=None)
            assert False, "expected ValueError without a mesh"
        except ValueError as e:
            assert "mesh" in str(e)


class TestShardedPressure:
    """Streaming sharded pipeline at capacity pressure (VERDICT r3 weak
    #4/item 6): a long run with per-shard capacities small enough to
    overflow must keep tracking, count every dropped voxel, and degrade
    like the single-device backend (reference contract
    ``octree_mapper.cpp:63-70`` — except the reference grows unbounded;
    we bound with counted overflow)."""

    def test_overflow_counted_and_tracking_survives(self):
        mesh = mesh_lib.make_mesh(8)
        # 8 shards x 512 voxels (per-shard capacity = max_map_points;
        # total scales with devices); resets disabled so the map
        # actually fills (the optimize-reset normally bounds it)
        cfg_s = make_cfg(
            "sharded", shards=8, max_map_points=512,
            reset_map_on_optimize=False, enable_loop_closure=True,
        )
        scans, gt = make_stream(cfg_s, n_poses=60, laps=2.5)
        st_s, traj_s = drive(cfg_s, scans, gt, mesh=mesh)

        sizes = np.asarray(st_s.map.size)          # (8,)
        overflow = np.asarray(st_s.map.overflow)   # (8,)
        assert sizes.sum() > 0
        # pressure actually happened: at least one shard hit capacity and
        # dropped voxels into its counter
        cap = st_s.map.keys.shape[1]
        assert (sizes == cap).any(), sizes
        assert overflow.sum() > 0, overflow
        # tracking survived: finite poses, bounded error over 2.5 laps
        assert bool(jnp.all(jnp.isfinite(traj_s.t)))
        err = np.linalg.norm(
            np.asarray(traj_s.t) - np.asarray(gt.t)[: traj_s.t.shape[0]],
            axis=-1,
        )
        assert err.max() < 1.0, err.max()

        # single-device voxel backend at the SAME total capacity: same
        # graceful-degradation contract (overflow counted, tracking holds)
        cfg_v = make_cfg(
            "voxel", max_map_points=4096,
            reset_map_on_optimize=False, enable_loop_closure=True,
        )
        st_v, traj_v = drive(cfg_v, scans, gt)
        assert int(st_v.map.overflow) > 0
        err_v = np.linalg.norm(
            np.asarray(traj_v.t) - np.asarray(gt.t)[: traj_v.t.shape[0]],
            axis=-1,
        )
        assert err_v.max() < 1.0, err_v.max()
        # sharded capacity is per shard: the shard owning the densest
        # region saturates first, so the sharded map never holds MORE
        # than shards x per-shard cap and overflow totals are of the
        # same order as the single-device drop count
        assert sizes.sum() <= 8 * cap

    def test_dist_schur_matches_replicated(self):
        """The chunk↔device Schur solver, driven from the STREAMING step
        (graph_linear_solver='dist-schur'); node capacity (32) divides
        the mesh (8) as the distributed elimination requires."""
        cfg_r = make_cfg("voxel", graph_incremental=False,
                         graph_linear_solver="direct")
        scans, gt = make_stream(cfg_r, n_poses=10, laps=0.5)
        st_r, traj_r = drive(cfg_r, scans, gt)

        mesh = mesh_lib.make_mesh(8)
        cfg_d = make_cfg("voxel", graph_incremental=False,
                         graph_linear_solver="dist-schur")
        st_d, traj_d = drive(cfg_d, scans, gt, mesh=mesh)

        assert int(st_d.num_optimizations) == int(st_r.num_optimizations)
        assert int(st_d.num_optimizations) >= 1
        np.testing.assert_allclose(
            np.asarray(traj_d.t), np.asarray(traj_r.t), atol=2e-3
        )
