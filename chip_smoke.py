#!/usr/bin/env python3
"""On-card smoke test: the SLAM main path on one NVIDIA GPU.

    python chip_smoke.py                # one card: device, kernel, main path
    python chip_smoke.py --four-cards   # four cards: sharded paths only

Phases, all in this one process (a JAX process reserves most of the card's
memory, so nothing else may open it meanwhile):

1. device  — a GPU must be JAX's device; with none the script exits
   non-zero and never falls back to the CPU.
2. kernel  — each kernel of the main path, compiled for the card, against
   the plain reference at real widths: the fused NN kernel vs the blocked
   ``ops.nn`` path at ``Precision.HIGHEST`` and vs float64 NumPy; the
   covariance k-NN's top-k choice; what ``Precision.HIGH`` is on the card.
3. main    — ``icpslam_tpu.io.runner.main`` on the KITTI proxy at
   ``kitti_config()`` width (131,072 raw points, 8,192 filtered, a
   262,144-point map), checked for tracking quality and against a CPU run
   of the same first scans.

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``; any failed
phase exits non-zero before it is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")  # git-ignored scratch in the checkout
EPS32 = float(np.finfo(np.float32).eps)
MAP_CAP = 262144  # kitti_config().max_map_points


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def timed(fn, *args, reps: int = 5) -> float:
    """Median wall time (ms) of ``fn(*args)`` after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------


def device_phase(n_expected: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"device phase: JAX found no GPU (platform {devs[0].platform!r})"
        )
    if len(devs) < n_expected:
        raise SystemExit(f"device phase: need {n_expected} GPUs, found {len(devs)}")
    card = card_line()
    log(f"# card: {card}")
    log(f"# device_kind: {devs[0].device_kind}  count: {len(devs)}  "
        f"jax {jax.__version__}")
    log(f"# XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    return devs, card


# --------------------------------------------------------------------------
# phase 2: kernels
# --------------------------------------------------------------------------


def urban_clouds(n_scans: int, max_points: int = 8192, leaf: float = 0.4):
    """Voxel-filtered KITTI-proxy scans in the world frame (the filter's
    output order, as odometry and the map see it)."""
    import jax
    import jax.numpy as jnp

    from icpslam_tpu.cloud import pointcloud as pc
    from icpslam_tpu.cloud.voxel import voxel_downsample
    from icpslam_tpu.geometry import se3
    from icpslam_tpu.io import synthetic

    world = synthetic.make_urban_world(seed=0)
    gt = synthetic.make_urban_drive(n_poses=n_scans)
    vox = jax.jit(lambda c: voxel_downsample(c, leaf, max_points)[0])
    out = []
    for i in range(n_scans):
        t, q = np.asarray(gt.t[i]), np.asarray(gt.q[i])
        raw = synthetic.render_velodyne_scan(world, t, q, seed=i)
        f = vox(pc.from_points(raw, capacity=131072))
        pts = se3.transform_points(se3.index(gt, i), f.points)
        out.append((jnp.where(f.mask[:, None], pts, 0.0), f.mask))
    return out


def check_nn(name, q, t, tm, vl, card):
    """Fused kernel vs the plain path at HIGHEST and vs float64 NumPy."""
    import jax
    import jax.numpy as jnp

    from icpslam_tpu.ops import nn as nn_ops

    kern = jax.jit(lambda q, t, tm, vl: nn_ops.nearest_neighbors(
        q, t, tm, fused=True, valid_len=vl))
    plain = jax.jit(lambda q, t, tm: nn_ops.nearest_neighbors(
        q, t, tm, fused=False))
    rk, rp = kern(q, t, tm, vl), plain(q, t, tm)
    ki, kd = np.asarray(rk.idx), np.asarray(rk.dist2)
    pi, pd = np.asarray(rp.idx), np.asarray(rp.dist2)
    qn, tn = np.asarray(q, np.float64), np.asarray(t, np.float64)
    # the plain path's |q|² − 2q·t + |t|² cancels: its own f32 error grows
    # with the squared distance of both points from the query centroid
    c = qn.mean(0)
    scale = ((qn - c) ** 2).sum(1) + ((tn[pi] - c) ** 2).sum(1)
    in_gate = np.isfinite(pd)
    tol_plain = 8 * EPS32 * scale + 1e-6
    # a different index is a tie when both picks are equally near within
    # the plain path's own error (measured in float64)
    dk64 = ((qn - tn[ki]) ** 2).sum(1)
    dp64 = ((qn - tn[pi]) ** 2).sum(1)
    same = (ki == pi) | (np.abs(dk64 - dp64) <= tol_plain)
    raw_match = float(np.mean(ki[in_gate] == pi[in_gate]))
    match = float(np.mean(same[in_gate]))
    d_ok = bool(np.all(np.abs(kd[in_gate] - pd[in_gate]) <= tol_plain[in_gate]))

    # float64 brute force on 512 queries: exact up to f32 rounding of the
    # subtraction form (each |t−q| component is rounded at the coordinate
    # magnitude, then squared and summed)
    sub = np.random.RandomState(0).choice(q.shape[0], 512, replace=False)
    live = np.asarray(tm)
    d64 = ((qn[sub, None] - tn[None]) ** 2).sum(-1)
    d64[:, ~live] = np.inf
    i64, m64 = d64.argmin(1), d64.min(1)
    g = np.isfinite(m64)
    mag = np.abs(qn).max() + 1.0
    tol64 = 6 * EPS32 * mag * np.sqrt(m64[g]) + 4 * EPS32 * m64[g] + 1e-9
    match64 = float(np.mean(ki[sub][g] == i64[g]))
    d64_ok = bool(np.all(np.abs(kd[sub][g] - m64[g]) <= tol64))

    ms_k = timed(kern, q, t, tm, vl)
    ms_p = timed(plain, q, t, tm)
    ok = match >= 0.999 and d_ok and match64 >= 0.999 and d64_ok
    log(json.dumps({
        "check": name, "ok": ok, "shape": [int(q.shape[0]), int(t.shape[0])],
        "valid_len": int(vl),
        "idx_match_vs_plain": round(raw_match, 6),
        "idx_match_vs_plain_ties_equal": round(match, 6),
        "dist2_within_tol": d_ok,
        "idx_match_vs_f64": round(match64, 6), "dist2_f64_within_tol": d64_ok,
        "kernel_ms": round(ms_k, 4), "plain_ms": round(ms_p, 4),
        "card": card,
    }))
    return ok


def kernel_phase(card) -> bool:
    import jax
    import jax.numpy as jnp

    from icpslam_tpu.cloud.pointcloud import PointCloud
    from icpslam_tpu.ops import covariance, nn as nn_ops

    if not nn_ops.fused_nn_enabled():
        raise SystemExit("kernel phase: the GPU did not select the fused NN kernel")
    clouds = urban_clouds(5)
    (p0, m0), (p1, m1) = clouds[0], clouds[1]
    ok = True

    # odometry shape: scan k+1 (pose guess 0.3 m off) vs scan k, 8192 × 8192
    q = p1 + jnp.asarray([0.3, -0.2, 0.05], jnp.float32)
    ok &= check_nn("nn_odometry", q, p0, m0, jnp.int32(p0.shape[0]), card)

    # map query: 8192 × 262144 at ~21k fill and at full fill
    cap = MAP_CAP
    live = [p[m] for p, m in clouds[:4]]
    part = np.concatenate([np.asarray(x) for x in live])[:21000]
    rng = np.random.RandomState(1)
    reps = cap // sum(len(x) for x in live) + 1
    full = np.concatenate([
        np.asarray(x) + rng.normal(0, 0.05, (len(x), 3)).astype(np.float32)
        for _ in range(reps) for x in live])[:cap]
    qm = clouds[4][0]
    for fill, pts in (("partial", part), ("full", full)):
        buf = np.zeros((cap, 3), np.float32)
        buf[: len(pts)] = pts
        mask = jnp.arange(cap) < len(pts)
        ok &= check_nn(f"nn_map_{fill}", qm, jnp.asarray(buf), mask,
                       jnp.int32(len(pts)), card)

    # covariance k-NN selection: exact lax.top_k (kept) vs approx_max_k,
    # each over 512-row blocks of the scan's negated distance matrix
    cloud = PointCloud(points=p1, mask=m1)
    hi = jax.lax.Precision.HIGH
    d = jnp.sum((p1[:, None, :] - p1[None, :, :]) ** 2, -1)
    neg = -jnp.where(m1[None, :], d, jnp.inf).reshape(-1, 512, d.shape[1])
    sel = {
        "top_k": jax.jit(lambda x: jax.lax.map(
            lambda b: jax.lax.top_k(b, 10)[1], x)),
        "approx_max_k": jax.jit(lambda x: jax.lax.map(
            lambda b: jax.lax.approx_max_k(b, 10, recall_target=0.9)[1], x)),
    }
    picks = {k: np.sort(np.asarray(f(neg)), -1) for k, f in sel.items()}
    log(json.dumps({
        "check": "knn_select",
        **{f"{k}_ms": round(timed(f, neg), 4) for k, f in sel.items()},
        "approx_equals_exact_frac": round(float(np.mean(
            picks["top_k"] == picks["approx_max_k"])), 6),
        "card": card,
    }))

    a = np.random.RandomState(2).uniform(-50, 50, (4096, 3)).astype(np.float32)
    exact = a.astype(np.float64) @ a.T.astype(np.float64)
    errs = {}
    for p in ("DEFAULT", "HIGH", "HIGHEST"):
        got = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(a).T,
                                 precision=getattr(jax.lax.Precision, p)))
        errs[p] = float(np.max(np.abs(got - exact)) / np.max(np.abs(exact)))
    # TF32 keeps 10 mantissa bits (~5e-4 relative), bf16×3 ~1e-5, fp32 ~1e-7
    kind = ("tf32" if errs["HIGH"] > 1e-4 else
            "bf16x3" if errs["HIGH"] > 1e-6 else "fp32")

    cov_hi = covariance.gicp_covariances(cloud, precision=hi)
    cov_hst = covariance.gicp_covariances(
        cloud, precision=jax.lax.Precision.HIGHEST)
    # regularized cov = I − (1−ε)·n nᵀ, so n nᵀ = (I − C)/(1−ε) and
    # |n·n'|² = Σ (n nᵀ)∘(n' n'ᵀ)
    eye = np.array([1, 0, 0, 1, 0, 1], np.float64)[:, None]
    w = np.array([1, 2, 2, 1, 2, 1], np.float64)[:, None]  # off-diagonals twice
    a6 = (eye - np.asarray(cov_hi, np.float64)) / (1 - 1e-3)
    b6 = (eye - np.asarray(cov_hst, np.float64)) / (1 - 1e-3)
    dots = np.sqrt(np.clip(np.sum(w * a6 * b6, 0), 0, None))[np.asarray(m1)]
    med, p5 = float(np.median(dots)), float(np.percentile(dots, 5))
    normals_ok = med > 0.999 and p5 > 0.99
    log(json.dumps({
        "check": "matmul_precision", "rel_err": errs, "HIGH_is": kind,
        "normals_HIGH_vs_HIGHEST": {"median": round(med, 6),
                                    "p5": round(p5, 6)},
        "ok": normals_ok, "card": card,
    }))
    return bool(ok and normals_ok)


# --------------------------------------------------------------------------
# phase 3: main path
# --------------------------------------------------------------------------


def main_path_phase(card, n_poses: int, n_cpu: int) -> bool:
    import jax
    import jax.numpy as jnp

    from icpslam_tpu.cloud import pointcloud as pc
    from icpslam_tpu.config import kitti_config
    from icpslam_tpu.eval import metrics
    from icpslam_tpu.geometry import se3
    from icpslam_tpu.geometry.se3 import Pose
    from icpslam_tpu.io import runner
    from icpslam_tpu.pipeline import slam

    os.makedirs(WORK, exist_ok=True)
    cache = os.path.join(WORK, f"proxy_ideal_{n_poses}.npz")
    summary = os.path.join(WORK, "summary.json")
    traj = os.path.join(WORK, "traj.npz")
    t0 = time.perf_counter()
    rc = runner.main([
        "--kitti-proxy", "--poses", str(n_poses), "--no-proxy-physics",
        "--scan-cache", cache, "--summary-out", summary, "--out", traj,
    ])
    wall = time.perf_counter() - t0
    if rc != 0:
        log(f"main path: runner exited {rc}")
        return False
    with open(summary) as f:
        s = json.load(f)
    tr = np.load(traj)
    est = Pose(t=jnp.asarray(tr["t"]), q=jnp.asarray(tr["q"]))
    gt = Pose(t=jnp.asarray(tr["gt_t"]), q=jnp.asarray(tr["gt_q"]))
    finite = bool(np.all(np.isfinite(tr["t"])) and np.all(np.isfinite(tr["q"])))
    ate, _ = metrics.ate(est, gt, align=False)
    ok = (finite and tr["t"].shape[0] == n_poses and ate < 0.15
          and s["keyframes"] >= 10 and s["optimizations"] >= 2
          and s["map_overflow"] == 0)

    # the first scans again on the host CPU, same stamps, plain NN path
    cpu = jax.devices("cpu")[0]
    cfg = kitti_config()
    data = np.load(cache)
    with jax.default_device(cpu):
        step = jax.jit(slam.slam_step, static_argnums=(2,))
        st = jax.device_put(slam.init_state(cfg, se3.index(gt, 0)), cpu)
        cpu_t = []
        for i in range(n_cpu):
            scan = jax.device_put(pc.from_points(
                data[f"s{i}"], capacity=cfg.max_raw_points), cpu)
            st, out = step(st, scan, cfg, jnp.float32(i / 10.0))
            cpu_t.append(np.asarray(out.pose_map.t))
    # ICP stops at a 1e-4 twist step, and the card's reduction order and
    # TF32 covariance distances differ from the CPU's: 2 cm is a tenth of
    # the voxel leaf and far inside the 0.15 m tracking bound
    dev = float(np.max(np.abs(np.stack(cpu_t) - tr["t"][:n_cpu])))
    cpu_ok = dev < 0.02
    log(json.dumps({
        "check": "main_path", "ok": bool(ok and cpu_ok),
        "scans": int(tr["t"].shape[0]), "ate_m_unaligned": round(ate, 5),
        "ate_m_aligned": s.get("ate_m"), "keyframes": s["keyframes"],
        "optimizations": s["optimizations"], "loop_closures": s["loop_closures"],
        "map_size": s["map_size"], "map_overflow": s["map_overflow"],
        "scans_per_sec_incl_compile": round(n_poses / wall, 3),
        "runner_step_ms_p50": s.get("step_ms_p50"),
        "cpu_vs_gpu_first_poses_max_m": dev, "cpu_scans": n_cpu,
        "card": card,
    }))
    return bool(ok and cpu_ok)


# --------------------------------------------------------------------------
# --four-cards: sharded map + edge-sharded solve
# --------------------------------------------------------------------------


def four_card_phase(card) -> bool:
    """``dryrun_multichip(4)``, then the streaming ``slam_step`` with the
    map sharded over four cards and the graph solve edge-sharded
    (``dist-pcg``) against the single-card voxel-map pipeline."""
    import functools

    import jax

    import __graft_entry__ as graft
    from icpslam_tpu.config import kitti_config
    from icpslam_tpu.geometry import se3
    from icpslam_tpu.io import synthetic
    from icpslam_tpu.parallel import mesh as mesh_lib
    from icpslam_tpu.pipeline import slam

    t0 = time.perf_counter()
    graft.dryrun_multichip(4)
    log(json.dumps({"check": "dryrun_multichip", "ok": True, "devices": 4,
                    "s": round(time.perf_counter() - t0, 2)}))

    n = 16
    world = synthetic.make_urban_world(seed=0)
    gt = synthetic.make_urban_drive(n_poses=n)
    base = kitti_config()
    scans = list(synthetic.velodyne_stream(
        world, gt, capacity=base.max_raw_points))
    mesh = mesh_lib.make_mesh(4)

    def drive(cfg, mesh=None):
        step = jax.jit(functools.partial(slam.slam_step, mesh=mesh),
                       static_argnums=(2,))
        st = slam.init_state(cfg, initial_pose=se3.index(gt, 0))
        ts = []
        for scan, stamp in scans:
            st, out = step(st, scan, cfg, stamp)
            ts.append(out.pose_map.t)
        jax.block_until_ready(st)
        return st, np.stack([np.asarray(t) for t in ts])

    st_v, tv = drive(base.replace(map_backend="voxel"))
    st_s, tsh = drive(base.replace(map_backend="sharded", map_shards=4,
                                   graph_linear_solver="dist-pcg"), mesh)
    placed = {d.id for d in st_s.map.size.sharding.device_set}
    dev = float(np.max(np.abs(tsh - tv)))
    size_s, size_v = int(np.sum(np.asarray(st_s.map.size))), int(st_v.map.size)
    # the sharded map answers the same 3³ voxel lookups; only reduction
    # order across cards differs, so poses agree to a millimetre, and a
    # point that close to a voxel boundary can land in the neighbouring
    # voxel: map sizes agree to 0.5%
    ok = (dev < 1e-3
          and int(st_s.keyframes.count) == int(st_v.keyframes.count)
          and abs(size_s - size_v) <= max(1, 0.005 * size_v)
          and len(placed) == 4)
    log(json.dumps({
        "check": "sharded_slam_vs_voxel", "ok": ok, "scans": n,
        "max_pose_dev_m": dev, "keyframes": int(st_s.keyframes.count),
        "keyframes_single": int(st_v.keyframes.count),
        "map_size": size_s, "map_size_single": size_v,
        "map_shard_sizes": np.asarray(st_s.map.size).tolist(),
        "map_devices": sorted(placed), "card": card,
    }))
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded paths")
    ap.add_argument("--poses", type=int, default=45,
                    help="KITTI-proxy scans in the main-path phase")
    ap.add_argument("--cpu-scans", type=int, default=4,
                    help="first scans replayed on the CPU for comparison")
    args = ap.parse_args(argv)

    n_cards = 4 if args.four_cards else 1
    devs, card = device_phase(n_cards)
    sys.path.insert(0, ROOT)
    from icpslam_tpu.utils import compile_cache

    log(f"# compile cache: {compile_cache.enable()}")
    if args.four_cards:
        ok = four_card_phase(card)
    else:
        ok = kernel_phase(card) and main_path_phase(
            card, args.poses, args.cpu_scans)
    if not ok:
        log("chip smoke: FAILED")
        return 1
    log(f"# card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
