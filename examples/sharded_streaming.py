"""Streaming SLAM over a device mesh: the sequential pipeline with the
map spatially sharded across all available devices.

The reference holds one global octree in one process
(``/root/reference/src/icpslam/octree_mapper.cpp:19``); here each device
owns the voxel blocks its spatial hash assigns it — insert routes points
with no communication, NN queries reduce over the mesh (pmin/psum), and
total map capacity scales linearly with devices (SURVEY §5.7).

Run on CPU with virtual devices (no pod needed):

    JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/sharded_streaming.py --poses 16
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from icpslam_tpu.config import IcpConfig, tiny_config
from icpslam_tpu.eval import metrics
from icpslam_tpu.geometry import se3
from icpslam_tpu.io import synthetic
from icpslam_tpu.parallel import mesh as mesh_lib
from icpslam_tpu.pipeline import slam


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--poses", type=int, default=16)
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size (default: all devices)")
    args = ap.parse_args()

    n_dev = args.devices or len(jax.devices())
    mesh = mesh_lib.make_mesh(n_dev)
    cfg = tiny_config(
        voxel_leaf_size=0.3,
        map_resolution=0.3,
        icp_odometry=IcpConfig(mode="plane", max_iterations=8),
        icp_mapping=IcpConfig(mode="point", max_iterations=15),
        max_points=1024,
        max_raw_points=2048,
        max_map_points=8192,   # PER SHARD — total capacity scales with mesh
        max_keyframes=64,
        max_edges=256,
        map_backend="sharded",
        map_shards=n_dev,
    )

    world = synthetic.make_room_world(seed=0, n_points=12000)
    gt = synthetic.make_loop_trajectory(n_poses=args.poses, radius=5.0, laps=0.9)
    step = jax.jit(
        functools.partial(slam.slam_step, mesh=mesh), static_argnums=(2,)
    )
    state = slam.init_state(cfg, initial_pose=se3.index(gt, 0))
    poses = []
    for i, scan in enumerate(synthetic.scan_stream(
        world, gt, capacity=cfg.max_raw_points, max_range=12.0, n_points=1200,
    )):
        state, out = step(state, scan, cfg)
        poses.append(out.pose_map)
        # bound the in-flight queue of multi-device programs (XLA:CPU
        # collective-rendezvous mitigation, tests/test_sharded_slam.py)
        if i % 8 == 7:
            jax.block_until_ready(state.slam_pose.t)

    # host-side trajectory consolidation (an eager stack over retained
    # multi-device outputs can abort the CPU rendezvous under pressure)
    jax.block_until_ready(state.slam_pose.t)
    traj = se3.Pose(
        t=jnp.asarray(np.stack([np.asarray(p.t) for p in poses])),
        q=jnp.asarray(np.stack([np.asarray(p.q) for p in poses])),
    )
    ate, _ = metrics.ate(traj, gt, align=False)
    per_shard = np.asarray(state.map.size)
    print(json.dumps({
        "devices": n_dev,
        "scans": args.poses,
        "ate_m": round(float(ate), 4),
        "keyframes": int(state.keyframes.count),
        "loop_closures": int(state.num_loop_closures),
        "map_voxels_total": int(per_shard.sum()),
        "map_voxels_per_shard": per_shard.tolist(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
