"""Multi-process (DCN) smoke test: two real OS processes rendezvous via
``jax.distributed`` on CPU and run a cross-process psum — exercising the
coordination path SURVEY §5.8 claims (the reference has no multi-process
story at all; its 'transport' is in-process ROS pub/sub)."""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from icpslam_tpu.parallel import multihost

    addr, pid = sys.argv[1], int(sys.argv[2])
    multihost.initialize(coordinator_address=addr, num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, jax.devices()  # 2 procs x 2 cpu devices

    mesh = multihost.global_mesh()
    # every device contributes its (global) index + 1; the psum must see
    # contributions from BOTH processes
    x = multihost.replicate_to_global(jnp.ones(()), mesh)

    import functools
    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=P(), out_specs=P()
    )
    def f(v):
        idx = jax.lax.axis_index("dp").astype(jnp.float32)
        return jax.lax.psum(v * (idx + 1.0), "dp")

    out = jax.jit(f)(x)
    total = float(np.asarray(jax.device_get(out)).ravel()[0])
    assert total == 10.0, total  # 1+2+3+4 over 4 global devices
    assert multihost.is_coordinator() == (pid == 0)
    print(f"proc{pid}: OK total={total}")
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_dcn_psum(tmp_path):
    addr = f"127.0.0.1:{_free_port()}"
    worker_py = tmp_path / "worker.py"
    worker_py.write_text(WORKER)
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), addr, str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process rendezvous timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out}"
        assert f"proc{pid}: OK total=10.0" in out, out


WORKER_SLAM = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    import jax.numpy as jnp
    import numpy as np

    from icpslam_tpu.geometry import se3
    from icpslam_tpu.graph import pose_graph as pg
    from icpslam_tpu.parallel import dist_graph, multihost, sharded_map as sm
    from icpslam_tpu.cloud.pointcloud import PointCloud

    addr, pid = sys.argv[1], int(sys.argv[2])
    multihost.initialize(coordinator_address=addr, num_processes=2, process_id=pid)
    mesh = multihost.global_mesh()
    n_dev = len(jax.devices())
    assert n_dev == 4

    # --- distributed pose-graph solve ACROSS PROCESSES (DCN): noisy
    # loop-closed chain, fully distributed PCG; every process holds the
    # same replicated inputs, the solve's collectives cross the process
    # boundary through the global mesh.
    K = 16
    rng = np.random.RandomState(0)
    rel_t = np.zeros((K - 1, 3), np.float32); rel_t[:, 0] = 1.0
    edges = pg.empty_edges(2 * K)
    for k in range(K - 1):
        edges = pg.add_edge(
            edges, k, k + 1,
            se3.Pose(t=jnp.asarray(rel_t[k]), q=se3.identity().q),
            100.0 * jnp.eye(6),
        )
    gt_t = np.zeros((K, 3), np.float32); gt_t[:, 0] = np.arange(K)
    edges = pg.add_edge(
        edges, 0, K - 1,
        se3.Pose(t=jnp.asarray(gt_t[K - 1]), q=se3.identity().q),
        100.0 * jnp.eye(6),
    )
    noise = rng.uniform(-0.4, 0.4, (K, 3)).astype(np.float32); noise[0] = 0
    nodes0 = se3.Pose(t=jnp.asarray(gt_t + noise), q=se3.identity((K,)).q)
    mask = jnp.ones((K,), bool)
    opt, stats = jax.jit(
        lambda n: dist_graph.optimize(
            n, edges, mask, mesh, iterations=8, mode="lm", linear_solver="pcg"
        )
    )(nodes0)
    c0, c1 = float(stats.initial_cost), float(stats.final_cost)
    assert c1 < 0.01 * c0, (c0, c1)
    err = float(jnp.max(jnp.abs(opt.t - jnp.asarray(gt_t))))
    assert err < 0.05, err

    # --- spatially-sharded map across the 2-process mesh: insert is
    # communication-free, the NN reduce (pmin/psum) crosses processes.
    pts = jnp.asarray(rng.uniform(-8, 8, (256, 3)).astype(np.float32))
    cloud = PointCloud(points=pts, mask=jnp.ones((256,), bool))
    smap = sm.empty_sharded_map(512, n_dev)
    smap = sm.insert(smap, cloud, 0.5, mesh)
    nn = sm.approx_nn(smap, pts, cloud.mask, 0.5, mesh)
    found = int(jnp.sum(nn.found))
    assert found == 256, found  # every point finds its voxel's entry
    # occupancy dedup keeps ONE representative per 0.5 m voxel, so the
    # self-query distance is bounded by the voxel diagonal, not zero
    d2max = float(jnp.max(jnp.where(nn.found, nn.dist2, 0.0)))
    assert d2max < 0.75 + 1e-6, d2max

    print(f"proc{pid}: SLAM-OK cost {c0:.2f}->{c1:.5f} err {err:.4f} nn {found}")
    """
)


def test_two_process_distributed_slam_computation(tmp_path):
    """SLAM computation (not just a psum) across two OS processes: the
    distributed PCG graph solve corrects a noisy loop-closed chain and the
    spatially-sharded map answers NN queries, with the collectives crossing
    the process boundary (VERDICT r2 §2.3 multihost 'partial')."""
    addr = f"127.0.0.1:{_free_port()}"
    worker_py = tmp_path / "worker_slam.py"
    worker_py.write_text(WORKER_SLAM)
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_py), addr, str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=360)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process SLAM computation timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out}"
        assert f"proc{pid}: SLAM-OK" in out, out


def test_initialize_explicit_failure_raises():
    """Explicit cluster spec + impossible coordinator must raise, not be
    silently swallowed (VERDICT r1: no bare-except dead code)."""
    import jax

    from icpslam_tpu.parallel import multihost

    if jax.process_count() > 1:
        pytest.skip("already in a multi-process cluster")
    with pytest.raises(Exception):
        # unroutable port with instant-fail timeout env: initialize must
        # propagate the rendezvous error
        os.environ["JAX_COORDINATOR_INIT_TIMEOUT_SECS"] = "1"
        try:
            multihost.initialize(
                coordinator_address="127.0.0.1:1", num_processes=2, process_id=1
            )
        finally:
            os.environ.pop("JAX_COORDINATOR_INIT_TIMEOUT_SECS", None)


class TestElasticRecovery:
    """Multi-host elastic recovery (SURVEY §5.3's last plan line): a
    worker killed mid-run is detected by the driver (exact-PID poll +
    hang watchdog) and the workload re-dispatches single-process with a
    degraded-mode artifact."""

    def test_fault_injected_crash_recovers_degraded(self, tmp_path):
        import json
        import subprocess
        import sys as _sys

        out = str(tmp_path / "elastic.json")
        proc = subprocess.run(
            [_sys.executable, os.path.join(REPO, "tools", "elastic_dcn.py"),
             "--inject-fault", "crash", "--watchdog", "45", "--out", out],
            capture_output=True, text=True, timeout=800,
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        art = json.load(open(out))
        assert art["degraded"] is True
        assert "died" in art["failure"]
        assert art["redispatch"]["mode"] == "single_process_degraded"
        assert art["redispatch"]["step_ms"] > 0
