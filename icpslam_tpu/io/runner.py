"""Host-side runner + CLI: stream scans through the jitted SLAM pipeline.

The process/entry layer replacing the reference's ROS node + launch file
(``/root/reference/src/icpslam_node.cpp``, ``launch/icpslam.launch``):
instead of topics and an AsyncSpinner, a host loop feeds padded scans into
``slam_step`` and collects structured per-scan metrics (SURVEY.md §5.5).

    python -m icpslam_tpu.io.runner --synthetic --poses 40 --out traj.npz
    python -m icpslam_tpu.io.runner --kitti /data/kitti --seq 04
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Iterable, List, Optional

import numpy as np

import jax

from icpslam_tpu.cloud import pointcloud as pc
from icpslam_tpu.config import IcpConfig, SlamConfig
from icpslam_tpu.eval import metrics
from icpslam_tpu.geometry import se3
from icpslam_tpu.io import prefetch as prefetch_mod
from icpslam_tpu.geometry.se3 import Pose
from icpslam_tpu.pipeline import slam
from icpslam_tpu.utils.logging import Logger


@dataclasses.dataclass
class RunResult:
    trajectory: Pose           # (T,) map-frame pose per scan
    per_scan: List[dict]       # structured metrics per scan
    state: slam.SlamState
    wall_time: float
    step_ms: List[float] = dataclasses.field(default_factory=list)
    # per-scan device+sync wall time (chunked: flush time / live scans);
    # EXCLUDES the first step/chunk (jit compile) — see compile_ms
    compile_ms: Optional[float] = None
    # first-dispatch wall time (dominated by jit compilation; kept out of
    # step_ms so mean/p95 are usable regression signals — VERDICT r2 #9)
    setup_ms: float = 0.0
    # run_slam entry → first loop iteration: initial state transfer to the
    # device + stream construction (wall_vs_step attribution)
    trailing_ms: float = 0.0
    # loop exit → return: final metric fetch + trajectory consolidation
    stamp_origin: Optional[float] = None
    # first sensor stamp of the stream (float64). Stamps threaded into the
    # float32 device state are origin-relative — epoch-scale timestamps
    # would lose ~100 µs-scale precision otherwise (ADVICE r2). Add this
    # back when exporting absolute times.

    def timing_summary(self) -> dict:
        """Percentile step-time stats for the run summary (SURVEY §5.1:
        per-scan timing; lets perf regressions be localized per run)."""
        out = {}
        if self.compile_ms is not None:
            out["compile_ms"] = round(self.compile_ms, 1)
        if not self.step_ms:
            return out
        a = np.sort(np.asarray(self.step_ms, np.float64))
        pick = lambda p: float(a[min(len(a) - 1, int(p * len(a)))])
        out.update({
            "step_ms_mean": round(float(a.mean()), 3),
            "step_ms_p50": round(pick(0.50), 3),
            "step_ms_p95": round(pick(0.95), 3),
            "step_ms_max": round(float(a[-1]), 3),
        })
        # wall-vs-step reconciliation (VERDICT r4 weak #1): every second
        # of the run is attributed — compile, the timed step loop, and
        # whatever host time was NOT overlapped with device compute
        # (stream setup, non-prefetched prep, trailing exports). A large
        # host_unoverlapped_s is the signal that the prefetcher is not
        # covering some host work.
        if self.wall_time:
            timed_s = float(a.sum()) / 1000.0
            comp_s = (self.compile_ms or 0.0) / 1000.0
            setup_s = self.setup_ms / 1000.0
            trail_s = self.trailing_ms / 1000.0
            host_s = max(
                self.wall_time - comp_s - timed_s - setup_s - trail_s, 0.0
            )
            out["wall_vs_step"] = {
                "wall_s": round(self.wall_time, 2),
                "compile_s": round(comp_s, 2),
                "timed_step_loop_s": round(timed_s, 2),
                "setup_s": round(setup_s, 2),       # state transfer + stream open
                "trailing_s": round(trail_s, 2),    # final fetch/consolidation
                "host_unoverlapped_s": round(host_s, 2),
                "host_ms_per_scan": round(host_s * 1000.0 / max(len(a), 1), 2),
            }
        return out


def _records_from_chunk(out: slam.SlamOutput, base: int, live: int) -> List[dict]:
    """Per-scan metric dicts from a stacked (chunked) SlamOutput."""
    get = lambda x: np.asarray(x)[:live]
    acc, fit = get(out.odom_out.accepted), get(out.odom_out.fitness)
    nc, it = get(out.odom_out.num_correspondences), get(out.odom_out.iterations)
    ref, nk = get(out.refined), get(out.new_keyframe)
    lc, opt = get(out.loop_closure), get(out.optimized)
    ms, kf = get(out.map_size), get(out.num_keyframes)
    cost = get(out.graph_cost)
    # (live, 6) registration-covariance diagonals — the covariance the
    # reference publishes with every odometry message
    # (``src/utils/messaging_utils.cpp:26-49``)
    cov_d = np.einsum("kii->ki", np.asarray(out.pose_cov)[:live])
    return [
        {
            "scan": base + i,
            "accepted": bool(acc[i]),
            "fitness": float(fit[i]),
            "correspondences": int(nc[i]),
            "icp_iterations": int(it[i]),
            "refined": bool(ref[i]),
            "new_keyframe": bool(nk[i]),
            "loop_closure": int(lc[i]),
            "optimized": bool(opt[i]),
            "graph_cost": float(cost[i]),
            "map_size": int(ms[i]),
            "num_keyframes": int(kf[i]),
            "pose_cov_diag": [round(float(x), 8) for x in cov_d[i]],
        }
        for i in range(live)
    ]


def _stack_clouds(clouds: List[pc.PointCloud]) -> pc.PointCloud:
    return jax.tree_util.tree_map(lambda *x: jax.numpy.stack(x), *clouds)


@jax.jit
def _write_rec(buf, rec, i):
    """On-device per-scan record accumulator (module-level jit: ONE
    executable shared across runs — a per-run closure would recompile,
    CLAUDE.md). The step's packed output is consumed immediately, so the
    host never retains per-scan device handles."""
    return buf.at[i].set(rec)


def _dump_debug_scan(
    debug_dir: str, i: int, out: slam.SlamOutput, reason: str
) -> None:
    """Write one failing scan's intermediate products (filtered cloud,
    map-NN cloud, poses, gates) — the offline analog of inspecting the
    reference's debug topics in rviz (``icp_odometer.cpp:212-219``,
    ``octree_mapper.cpp:160-168``)."""
    import os

    os.makedirs(debug_dir, exist_ok=True)
    filt = out.odom_out.filtered
    fm = np.asarray(filt.mask)
    payload = dict(
        scan=i,
        reason=reason,
        fitness=float(out.odom_out.fitness),
        correspondences=int(out.odom_out.num_correspondences),
        iterations=int(out.odom_out.iterations),
        filtered_points=np.asarray(filt.points)[fm],
        pose_map_t=np.asarray(out.pose_map.t),
        pose_map_q=np.asarray(out.pose_map.q),
    )
    if out.debug is not None:
        nm = np.asarray(out.debug.nn_mask)
        payload.update(
            nn_points=np.asarray(out.debug.nn_points)[nm],
            raw_pose_t=np.asarray(out.debug.raw_pose.t),
            raw_pose_q=np.asarray(out.debug.raw_pose.q),
        )
    np.savez_compressed(
        os.path.join(debug_dir, f"scan_{i:06d}_{reason}.npz"), **payload
    )


def run_slam(
    scans: Iterable,
    config: SlamConfig,
    initial_pose: Optional[Pose] = None,
    logger: Optional[Logger] = None,
    chunk: int = 1,
    state: Optional[slam.SlamState] = None,
    post_step=None,
    debug_dir: Optional[str] = None,
    debug_max_dumps: int = 200,
    snapshot_every: int = 0,
    snapshot_fn=None,
    prefetch_depth: int = 3,
) -> RunResult:
    """Drive the jitted pipeline over a scan stream.

    ``scans`` yields ``PointCloud``s, or ``(PointCloud, stamp)`` pairs to
    thread real sensor timestamps through the pipeline (stored in
    keyframes and exports; without stamps the state keeps a scan counter).

    ``post_step``: callable ``state -> state`` invoked after every step
    (chunked mode: after every chunk) — the hook for the pipelined
    deferred back-end
    (``pipeline/deferred.DeferredBackend.maybe_launch_or_fold``).

    ``chunk > 1`` feeds the device ``chunk`` scans per call through
    ``slam.run_scans`` (lax.scan) — amortizing per-call host dispatch and
    per-scan metric syncs. A trailing partial chunk is padded with empty
    (fully masked) scans; their outputs are discarded (an empty scan never
    registers, keyframes, or optimizes — only the internal scan counters
    advance, like dropped clouds in the reference).
    """
    log = logger or Logger(level=config.verbosity)
    if state is None:
        state = slam.init_state(config, initial_pose)
    # committed-ness is part of the jit cache key: an uncommitted fresh
    # state would make the SECOND step recompile the whole pipeline
    state = jax.device_put(state, jax.devices()[0])
    poses = []
    per_scan = []
    step_ms: List[float] = []
    compile_ms: Optional[float] = None
    stamp_origin: Optional[float] = None
    t0 = time.perf_counter()

    def split(item):
        # stamps stay float64 host-side; the float32 device state carries
        # origin-relative times (epoch-scale stamps would lose ~100 µs of
        # precision in float32 — ADVICE r2). RunResult.stamp_origin holds
        # the subtracted origin for absolute-time exports.
        nonlocal stamp_origin
        if isinstance(item, pc.PointCloud):
            return item, None
        cloud, stamp = item
        if stamp_origin is None:
            stamp_origin = float(stamp)
        return cloud, float(stamp) - stamp_origin

    if debug_dir is not None and chunk > 1:
        raise ValueError("--debug-dump requires chunk=1 (per-scan products)")
    n_dumps = 0
    prev_map_size: Optional[int] = None  # debug mode: reseed-vs-failure

    if chunk > 1:
        run = jax.jit(slam.run_scans, static_argnums=(2,))
        buf: List[pc.PointCloud] = []
        stamp_buf: List[Optional[float]] = []
        done = 0

        def flush(buf, stamp_buf, state, done):
            live = len(buf)
            stamped = stamp_buf[0] is not None
            while len(buf) < chunk:
                buf.append(pc.empty(config.max_raw_points))
                # pad with the last live stamp so discarded outputs don't
                # advance state.stamp past the stream
                stamp_buf.append(stamp_buf[-1])
            stamps = (
                jax.numpy.asarray(stamp_buf, jax.numpy.float32) if stamped else None
            )
            nonlocal compile_ms
            tf0 = time.perf_counter()
            state, outs = run(state, _stack_clouds(buf), config, stamps)
            recs = _records_from_chunk(outs, done, live)  # syncs on outputs
            dt_ms = (time.perf_counter() - tf0) * 1000.0
            if done == 0:
                compile_ms = dt_ms  # first chunk = jit compile; keep it
            else:                   # out of the step percentiles
                step_ms.extend([dt_ms / live] * live)
            per_scan.extend(recs)
            poses.append(
                Pose(t=outs.pose_map.t[:live], q=outs.pose_map.q[:live])
            )
            for rec in recs:
                log.debug(f"scan {rec['scan']}: {rec}")
                if rec["optimized"]:
                    log.info(
                        f"scan {rec['scan']}: optimized graph "
                        f"({rec['num_keyframes']} keyframes, "
                        f"cost {rec['graph_cost']:.4f})"
                    )
            if post_step is not None:
                # deferred back-end folds at chunk boundaries (the launch
                # trigger and the fold both operate on whole states)
                state = post_step(state)
            return state, done + live

        for item in scans:
            scan, stamp = split(item)
            buf.append(scan)
            stamp_buf.append(stamp)
            if len(buf) == chunk:
                state, done = flush(buf, stamp_buf, state, done)
                buf, stamp_buf = [], []
        if buf:
            state, done = flush(buf, stamp_buf, state, done)
        wall = time.perf_counter() - t0
        traj = (
            Pose(
                t=jax.numpy.concatenate([p.t for p in poses]),
                q=jax.numpy.concatenate([p.q for p in poses]),
            )
            if poses
            else se3.identity((0,))
        )
        return RunResult(
            trajectory=traj, per_scan=per_scan, state=state, wall_time=wall,
            step_ms=step_ms, compile_ms=compile_ms, stamp_origin=stamp_origin,
        )

    jnp = jax.numpy
    step = jax.jit(slam.slam_step, static_argnums=(2,))
    # Host loop closed (VERDICT r4 weak #1): scan prep (npz decompress /
    # .bin parse / padding) AND the host→device transfer run depth-ahead
    # in a background thread (io/prefetch.py), so the ~tens of ms of
    # per-scan host time overlaps device compute instead of serializing
    # with it. The device_put is async; committed placement also keeps
    # the jit cache key stable across scans.
    device = jax.devices()[0]

    def _prep(item):
        cloud, stamp = split(item)
        cloud = jax.device_put(cloud, device)
        if stamp is not None:
            stamp = jax.device_put(jnp.asarray(stamp, jnp.float32), device)
        return cloud, stamp

    scans = prefetch_mod.prefetch(scans, _prep, depth=prefetch_depth)
    # per-scan metrics handling: converting outputs to Python scalars
    # forces a device sync every scan, which stalls JAX's async pipeline.
    # Default: pack the 11 metric scalars into ONE device vector per scan
    # (async) and fetch them all in one transfer at the end. verbosity >= 2 keeps the synchronous per-scan
    # path (live debug logging needs the values now).
    sync_metrics = config.verbosity >= 2
    # Per-scan bookkeeping accumulates ON DEVICE: each step's ``packed``
    # (18,) record (packed inside the jit) is written into a rolling
    # (64, 18) device buffer by a tiny jitted writer — one extra async
    # dispatch per scan, ZERO retained handles — and the buffer is
    # fetched with ONE transfer at the sync boundary where the loop is
    # already blocked. The host-side alternatives — per-scan eager stacks
    # of scalar outputs, or one end-of-run stack over N-thousand operands
    # (tens of seconds of trace+compile) — retain a handle per scalar.
    _BLK = 64
    recbuf = jax.device_put(jnp.zeros((_BLK, 18), jnp.float32), device)
    n_in_buf = 0
    rec_blocks: List[np.ndarray] = []  # (n, 18) numpy per block

    def consolidate():
        nonlocal n_in_buf
        if n_in_buf:
            rec_blocks.append(np.asarray(recbuf)[:n_in_buf])
            n_in_buf = 0

    def traj_so_far() -> Pose:
        consolidate()
        if not rec_blocks:
            return se3.identity((0,))
        arr = (
            np.concatenate(rec_blocks) if len(rec_blocks) > 1 else rec_blocks[0]
        )
        return Pose(t=arr[:, :3], q=arr[:, 3:7])

    t_block = time.perf_counter()
    setup_ms = (t_block - t0) * 1000.0
    n_block = 0
    for i, (scan, stamp) in enumerate(scans):
        ts0 = time.perf_counter()
        if stamp is None:
            state, out = step(state, scan, config)
        else:
            state, out = step(state, scan, config, stamp)
        recbuf = _write_rec(recbuf, out.packed, n_in_buf)
        n_in_buf += 1
        if debug_dir is not None and n_dumps < debug_max_dumps:
            # debug mode syncs per scan by construction (the gates must be
            # read to decide); this is a debugging tool, not the hot path
            processed = bool(out.odom_out.processed)
            accepted = bool(out.odom_out.accepted)
            reason = None
            if processed and not accepted:
                reason = "odometry_reject"
            elif (
                accepted and config.enable_scan_to_map
                and not bool(out.refined) and int(out.num_keyframes) > 1
                # an empty map before this scan means the expected
                # optimize-reset reseed (refined=False by design,
                # octree_mapper.cpp:138-142), not a failure
                and (prev_map_size is None or prev_map_size > 0)
            ):
                reason = "refine_fail"
            prev_map_size = int(out.map_size)
            if reason is not None:
                _dump_debug_scan(debug_dir, i, out, reason)
                n_dumps += 1
                log.warn(f"scan {i}: {reason} — dumped debug products")
        if sync_metrics:
            rec = {
                "scan": i,
                "accepted": bool(out.odom_out.accepted),
                "fitness": float(out.odom_out.fitness),
                "correspondences": int(out.odom_out.num_correspondences),
                "icp_iterations": int(out.odom_out.iterations),
                "refined": bool(out.refined),
                "new_keyframe": bool(out.new_keyframe),
                "loop_closure": int(out.loop_closure),
                "optimized": bool(out.optimized),
                "graph_cost": float(out.graph_cost),
                "map_size": int(out.map_size),
                "num_keyframes": int(out.num_keyframes),
            }
            per_scan.append(rec)  # building rec syncs on the outputs
            log.debug(f"scan {i}: {rec}")
            if rec["optimized"]:
                log.info(
                    f"scan {i}: optimized graph ({rec['num_keyframes']} "
                    f"keyframes, cost {float(out.graph_cost):.4f})"
                )
        if post_step is not None:
            state = post_step(state)
        if snapshot_every and snapshot_fn is not None and (i + 1) % snapshot_every == 0:
            # in-run visualization refresh — the offline analog of the
            # reference publishing to rviz WHILE the node runs (syncs on
            # the state; cadence is the user's latency/throughput dial)
            snapshot_fn(i, state, traj_so_far())
        if sync_metrics:
            dt_ms = (time.perf_counter() - ts0) * 1000.0
            if i == 0:
                compile_ms = dt_ms  # first step = jit compile
            else:
                step_ms.append(dt_ms)
            if i % 64 == 63:
                consolidate()
        elif i == 0:
            # isolate the first-step compile from the timing blocks (it
            # was already a serialization point; blocking here is free)
            jax.block_until_ready(state.slam_pose.t)
            compile_ms = (time.perf_counter() - t_block) * 1000.0
            t_block = time.perf_counter()
        else:
            # async mode: per-scan wall times would be dispatch-only
            # artifacts (CLAUDE.md's 'absurdly low times' trap) — record
            # the honest per-scan average at each sync boundary instead
            n_block += 1
            if i % 64 == 63:
                # bounds the async in-flight queue + yields real timing
                jax.block_until_ready(state.slam_pose.t)
                dt_ms = (time.perf_counter() - t_block) * 1000.0
                step_ms.extend([dt_ms / n_block] * n_block)
                # consolidation dispatch stays OUTSIDE the timed block
                consolidate()
                t_block = time.perf_counter()
                n_block = 0
    if not sync_metrics and n_block:
        jax.block_until_ready(state.slam_pose.t)
        dt_ms = (time.perf_counter() - t_block) * 1000.0
        step_ms.extend([dt_ms / n_block] * n_block)
    t_trail = time.perf_counter()
    consolidate()
    if not sync_metrics and rec_blocks:
        allrec = np.concatenate(rec_blocks)  # already host-side per block
        for i, r in enumerate(allrec):
            # layout: SlamOutput.packed (pipeline/slam.py)
            per_scan.append({
                "scan": i,
                "accepted": bool(r[7]),
                "fitness": float(r[8]),
                "correspondences": int(r[9]),
                "icp_iterations": int(r[10]),
                "refined": bool(r[11]),
                "new_keyframe": bool(r[12]),
                "loop_closure": int(r[13]),
                "optimized": bool(r[14]),
                "map_size": int(r[15]),
                "num_keyframes": int(r[16]),
                "graph_cost": float(r[17]),
            })
    traj = traj_so_far()
    wall = time.perf_counter() - t0
    return RunResult(
        # a live (--watch) stream can legitimately yield zero scans
        trajectory=traj,
        per_scan=per_scan, state=state,
        wall_time=wall, step_ms=step_ms, compile_ms=compile_ms,
        stamp_origin=stamp_origin, setup_ms=setup_ms,
        trailing_ms=(time.perf_counter() - t_trail) * 1000.0,
    )


def _parse_extrinsic(spec: Optional[str]):
    """'x,y,z[,qw,qx,qy,qz]' → (t tuple, q tuple); identity when None."""
    if not spec:
        return (0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0)
    vals = [float(v) for v in spec.replace(",", " ").split()]
    if len(vals) == 3:
        return tuple(vals), (1.0, 0.0, 0.0, 0.0)
    if len(vals) == 7:
        q = np.asarray(vals[3:], np.float64)
        q = q / np.linalg.norm(q)
        return tuple(vals[:3]), tuple(float(x) for x in q)
    raise ValueError("--extrinsic expects 'x,y,z' or 'x,y,z,qw,qx,qy,qz'")


# CLI dest -> SlamConfig field for --config override precedence (the
# reference's launch args override its yaml the same way)
_CLI_CONFIG_FIELDS = {
    "voxel": "voxel_leaf_size",
    "map_resolution": "map_resolution",
    "skip": "num_clouds_skip",
    "keyframe_distance": "keyframe_distance",
    "window": "keyframes_window",
    "max_points": "max_points",
    "max_raw_points": "max_raw_points",
    "max_map_points": "max_map_points",
    "max_keyframes": "max_keyframes",
    "verbosity": "verbosity",
}

# overridable flags parse with default=None so PRESENCE, not value,
# decides precedence (ADVICE r2: '--voxel 0.2' passed explicitly must
# beat a yaml value even when it equals the parser default); these are
# the effective defaults applied when the flag is absent
_CLI_DEFAULTS = {
    "voxel": 0.2,
    "map_resolution": 0.2,
    "icp_mode": "plane",
    "skip": 0,
    "keyframe_distance": 0.3,
    "window": 4,
    "max_points": 8192,
    "max_raw_points": 131072,
    "max_map_points": 262144,
    "max_keyframes": 512,
    "verbosity": 1,
}


def _eff(args, dest):
    """Effective flag value: what was passed, else the documented default."""
    val = getattr(args, dest)
    return _CLI_DEFAULTS[dest] if val is None else val


def _explicit_overrides(ap, args) -> dict:
    """Config overrides for CLI flags the user explicitly passed
    (``default=None`` sentinel — presence, not value, decides; the
    reference's launch-arg-over-yaml precedence)."""
    overrides = {}
    for dest, field in _CLI_CONFIG_FIELDS.items():
        val = getattr(args, dest)
        if val is not None:
            overrides[field] = val
    if args.extrinsic:
        ext_t, ext_q = _parse_extrinsic(args.extrinsic)
        overrides.update(laser_extrinsic_t=ext_t, laser_extrinsic_q=ext_q)
    return overrides


def _apply_icp_mode(cfg: SlamConfig, ap, args) -> SlamConfig:
    """--icp-mode, when explicitly passed, overrides the odometry ICP
    mode on top of any config source."""
    if args.icp_mode is not None:
        import dataclasses as _dc

        cfg = cfg.replace(
            icp_odometry=_dc.replace(cfg.icp_odometry, mode=args.icp_mode)
        )
    return cfg


def _config_from_yaml_args(ap, args) -> SlamConfig:
    """--config yaml base + explicitly-passed CLI flags as overrides."""
    from icpslam_tpu import config as config_mod

    cfg = config_mod.from_yaml(args.config, **_explicit_overrides(ap, args))
    return _apply_icp_mode(cfg, ap, args)


def _build_config(args) -> SlamConfig:
    ext_t, ext_q = _parse_extrinsic(getattr(args, "extrinsic", None))
    return SlamConfig(
        laser_extrinsic_t=ext_t,
        laser_extrinsic_q=ext_q,
        voxel_leaf_size=_eff(args, "voxel"),
        map_resolution=_eff(args, "map_resolution"),
        icp_odometry=IcpConfig(mode=_eff(args, "icp_mode"), max_iterations=10),
        icp_mapping=IcpConfig(mode="point", max_iterations=30),
        num_clouds_skip=_eff(args, "skip"),
        max_points=_eff(args, "max_points"),
        max_raw_points=_eff(args, "max_raw_points"),
        max_map_points=_eff(args, "max_map_points"),
        max_keyframes=_eff(args, "max_keyframes"),
        max_edges=_eff(args, "max_keyframes") * 4,
        keyframe_distance=_eff(args, "keyframe_distance"),
        keyframes_window=_eff(args, "window"),
        verbosity=_eff(args, "verbosity"),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--synthetic", action="store_true")
    src.add_argument(
        "--kitti-proxy", action="store_true",
        help="synthetic KITTI-scale urban sequence: 64-beam occlusion-"
        "correct velodyne scans over a city-block world, 10 Hz drive "
        "(uses the kitti_config operating point)",
    )
    src.add_argument("--kitti", type=str, help="KITTI odometry root")
    src.add_argument(
        "--watch", type=str,
        help="LIVE ingest: consume velodyne-format .bin scans as they "
        "appear in this directory (producer renames files into place; "
        "STOP file or idle timeout ends the run) — the transport-free "
        "analog of the reference's live sensor topic",
    )
    ap.add_argument("--seq", type=str, default="04")
    ap.add_argument("--poses", type=int, default=40, help="synthetic trajectory length")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None)
    # overridable config flags parse with default=None (presence detection,
    # see _CLI_DEFAULTS); documented defaults live in that dict
    ap.add_argument("--voxel", type=float, default=None, help="default 0.2")
    ap.add_argument("--map-resolution", type=float, default=None, help="default 0.2")
    ap.add_argument("--icp-mode", choices=["point", "plane"], default=None,
                    help="default plane")
    ap.add_argument("--skip", type=int, default=None, help="default 0")
    ap.add_argument("--keyframe-distance", type=float, default=None,
                    help="default 0.3")
    ap.add_argument("--window", type=int, default=None, help="default 4")
    ap.add_argument("--max-points", type=int, default=None, help="default 8192")
    ap.add_argument("--max-raw-points", type=int, default=None,
                    help="default 131072")
    ap.add_argument("--max-map-points", type=int, default=None,
                    help="default 262144")
    ap.add_argument("--max-keyframes", type=int, default=None, help="default 512")
    ap.add_argument("--verbosity", type=int, default=None, help="default 1")
    ap.add_argument(
        "--extrinsic", type=str, default=None,
        help="laser pose in the robot frame, 'x,y,z' or 'x,y,z,qw,qx,qy,qz'"
        " — applied to every scan at ingest (tf laser->base_link)",
    )
    ap.add_argument(
        "--rate", type=float, default=10.0,
        help="synthetic scan rate in Hz (drives the synthetic timestamps)",
    )
    ap.add_argument(
        "--deferred-optimize", action="store_true",
        help="pipelined back-end: dispatch the windowed graph solve "
        "asynchronously and fold the correction back a few scans later "
        "instead of stalling the stream (with --chunk > 1 the fold "
        "happens at chunk boundaries)",
    )
    ap.add_argument(
        "--config", type=str, default=None,
        help="load a SlamConfig from YAML (accepts the reference's own "
        "config/icpslam.yaml keys); explicit CLI flags override it",
    )
    ap.add_argument(
        "--scan-cache", type=str, default=None,
        help="(--kitti-proxy) cache rendered scans to this .npz and reuse "
        "them on later runs (64-beam rendering is host-bound)",
    )
    ap.add_argument(
        "--no-proxy-physics", action="store_true",
        help="(--kitti-proxy) disable the sensor-physics render (motion "
        "distortion across the sweep, range-dependent noise, dropout, "
        "moving traffic) and use the idealized static render",
    )
    ap.add_argument(
        "--deskew", action="store_true",
        help="(--kitti-proxy) undo intra-sweep motion distortion at "
        "ingest using a noisy-INS relative-motion measurement (the "
        "causal de-skew a KITTI-style OXTS rig performs)",
    )
    ap.add_argument(
        "--deskew-rounds", type=int, default=None,
        help="in-loop iterative motion de-skew WITHOUT an INS: N "
        "alternating re-skew/register rounds per scan inside the "
        "odometry step (config.deskew_rounds; try 2). Unlike --deskew "
        "this needs no external motion measurement",
    )
    ap.add_argument(
        "--deskew-mode", choices=["coupled", "joint", "alternate"], default=None,
        help="in-loop de-skew estimator (with --deskew-rounds): 'coupled' "
        "(target de-skewed by the solved transform itself), 'joint' "
        "12-DoF pose+sweep-motion registration, or 'alternate' re-skew/"
        "register rounds (config.deskew_mode)",
    )
    ap.add_argument(
        "--deskew-prior-weight", type=float, default=None,
        help="(--deskew-mode coupled/joint) information of the prior "
        "tying the sweep twist to its seed (config.deskew_prior_weight)",
    )
    ap.add_argument(
        "--deskew-prior-huber", type=float, default=None,
        help="(--deskew-free-twist) Huber scale for the twist prior "
        "(config.deskew_prior_huber; 0 = quadratic — the measured "
        "default, see DESIGN §14's negative result)",
    )
    ap.add_argument(
        "--deskew-free-twist", action="store_true",
        help="(--deskew-mode coupled) free the source sweep twist as 6 "
        "extra unknowns with a relative prior toward the solved "
        "transform (config.deskew_free_twist)",
    )
    ap.add_argument(
        "--deskew-auto-prior", choices=["on", "off"], default=None,
        help="(--deskew-free-twist) latched in-loop gate: stiff twist "
        "prior on straights, corner weight once a turn is detected in "
        "the solve (config.deskew_auto_prior; default OFF — measured "
        "divergent at mission scale, DESIGN §18)",
    )
    ap.add_argument(
        "--keyframe-eviction", choices=["marginalize", "none"], default=None,
        help="full-keyframe-store policy (config.keyframe_eviction): "
        "'marginalize' (default) recycles the most redundant frozen "
        "keyframe so missions outlive max_keyframes; 'none' freezes the "
        "store at capacity (pre-r5 behavior)",
    )
    ap.add_argument(
        "--adaptive-information", action="store_true",
        help="derive sequential-edge information matrices from the "
        "registration's own GN Hessian instead of the fixed configured "
        "diagonals (config.adaptive_information)",
    )

    ap.add_argument(
        "--chunk", type=int, default=1,
        help="scans per device call (lax.scan chunking — chunk when "
        "per-scan host work dominates, see slam.run_scans)",
    )
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", type=str, default=None, help="write trajectory .npz")
    ap.add_argument(
        "--summary-out", type=str, default=None,
        help="also write the summary JSON (incl. ATE/RPE) to this file",
    )
    ap.add_argument(
        "--save-state", type=str, default=None,
        help="checkpoint the final SlamState to this .npz (resume with --resume)",
    )
    ap.add_argument(
        "--resume", type=str, default=None,
        help="resume from a --save-state checkpoint (same capacities "
        "required); the map is re-rendered from keyframes",
    )
    ap.add_argument(
        "--trace", type=str, default=None,
        help="capture a jax.profiler trace of the run into this directory "
        "(TensorBoard/Perfetto readable)",
    )
    ap.add_argument(
        "--debug-dump", type=str, default=None,
        help="write per-scan debug products (filtered cloud, map-NN "
        "cloud, poses) for scans failing the accept gate or refinement "
        "into this directory — the offline analog of the reference's "
        "debug topics (requires --chunk 1; forces per-scan sync)",
    )
    ap.add_argument(
        "--html", type=str, default=None,
        help="write a standalone interactive viewer (map + trajectories + "
        "pose graph) to this HTML file",
    )
    ap.add_argument(
        "--html-every", type=int, default=0,
        help="with --html: refresh the viewer file every N scans DURING "
        "the run (reload it in a browser — the reference's live-rviz "
        "analog; requires --chunk 1, syncs once per refresh)",
    )
    args = ap.parse_args(argv)

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from icpslam_tpu.utils import compile_cache

    compile_cache.enable()

    if args.config:
        cfg = _config_from_yaml_args(ap, args)
    elif args.kitti_proxy or args.kitti or args.watch:
        from icpslam_tpu.config import kitti_config

        # velodyne/urban operating point for both the real dataset and
        # the proxy (the room-scale defaults under-gate 80 m-range urban
        # scans); explicitly passed CLI flags override
        kw = _explicit_overrides(ap, args)
        if "max_keyframes" in kw:
            kw.setdefault("max_edges", kw["max_keyframes"] * 4)
        cfg = kitti_config(**kw)
        cfg = _apply_icp_mode(cfg, ap, args)
    else:
        cfg = _build_config(args)
    log = Logger(level=cfg.verbosity)
    gt = None

    if args.kitti_proxy:
        import os

        import jax.numpy as jnp

        from icpslam_tpu.io import synthetic

        physics = not args.no_proxy_physics
        if args.deskew and not physics:
            raise SystemExit(
                "--deskew undoes the motion distortion of the physics "
                "render; it does nothing with --no-proxy-physics"
            )
        # sensor-physics render options (VERDICT r2 item 5): per-azimuth
        # motion distortion, range-growing noise, dropout, moving traffic
        stream_kw = dict(
            distortion=physics,
            deskew=args.deskew,
            dynamic=synthetic.make_moving_objects(seed=0) if physics else None,
            noise_range_coeff=3e-4 if physics else 0.0,
            dropout=0.08 if physics else 0.0,
        )
        cache_tag = int(physics) * 1 + int(args.deskew and physics) * 2
        cache = getattr(args, "scan_cache", None)
        cached = None
        if cache and os.path.exists(cache):
            data = np.load(cache)
            if "tag" in data and int(data["tag"]) == cache_tag:
                cached = data
            else:
                log.warn(
                    f"scan cache {cache} was rendered with different "
                    "physics flags; re-rendering"
                )
        if args.start and cached is None:
            raise SystemExit(
                "--start with --kitti-proxy requires --scan-cache (the "
                "resume path replays a prefix-consistent rendered stream)"
            )
        if cached is not None:
            # re-use previously rendered scans (rendering 500 64-beam
            # scans costs ~3 min of host time; the pipeline does not)
            n = min(args.poses, int(cached["gt_t"].shape[0]))
            if n < args.poses:
                log.warn(
                    f"scan cache holds only {n} scans; running {n}, "
                    f"not the requested {args.poses}"
                )
            lo = min(args.start or 0, n)
            gt = Pose(
                t=jnp.asarray(cached["gt_t"][lo:n]),
                q=jnp.asarray(cached["gt_q"][lo:n]),
            )
            data = cached
            scans = (
                (pc.from_points(data[f"s{i}"], capacity=cfg.max_raw_points),
                 i / args.rate)
                for i in range(lo, n)
            )
            log.info(f"loaded cached proxy scans [{lo}, {n}) from {cache}")
        else:
            world = synthetic.make_urban_world(seed=0)
            gt = synthetic.make_urban_drive(n_poses=args.poses, rate_hz=args.rate)
            stream = synthetic.velodyne_stream(
                world, gt, capacity=cfg.max_raw_points, rate_hz=args.rate,
                **stream_kw,
            )
            if cache:
                rendered = [np.asarray(c.points)[np.asarray(c.mask)]
                            for c, _ in stream]
                os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
                np.savez_compressed(
                    cache, gt_t=np.asarray(gt.t), gt_q=np.asarray(gt.q),
                    tag=cache_tag,
                    **{f"s{i}": s for i, s in enumerate(rendered)},
                )
                log.info(f"rendered + cached {len(rendered)} scans to {cache}")
                scans = (
                    (pc.from_points(s, capacity=cfg.max_raw_points), i / args.rate)
                    for i, s in enumerate(rendered)
                )
            else:
                scans = stream
        init = se3.index(gt, 0)
    elif args.watch:
        from icpslam_tpu.io import live

        scans = live.directory_stream(
            args.watch, cfg.max_raw_points, with_stamps=True, logger=log
        )
        init = None
        log.info(f"watching {args.watch} for incoming scans")
    elif args.synthetic:
        from icpslam_tpu.io import synthetic

        world = synthetic.make_room_world(seed=0, n_points=40000)
        gt = synthetic.make_loop_trajectory(n_poses=args.poses, radius=5.0, laps=1.25)
        scans = synthetic.scan_stream(
            world, gt, capacity=cfg.max_raw_points, max_range=12.0,
            n_points=4000, noise=0.01, rate_hz=args.rate,
        )
        init = se3.index(gt, 0)
    else:
        from icpslam_tpu.io import kitti, native_loader

        # native prefetching loader when the C++ library is available
        scans = native_loader.scan_stream(
            args.kitti, args.seq, capacity=cfg.max_raw_points,
            start=args.start, end=args.end, with_stamps=True,
        )
        try:
            gt_all = kitti.ground_truth_velodyne(args.kitti, args.seq)
            gt = Pose(
                t=gt_all.t[args.start:args.end], q=gt_all.q[args.start:args.end]
            )
        except (FileNotFoundError, OSError):
            log.warn("no ground-truth poses found; skipping ATE")
        init = None

    if (
        args.kitti_proxy
        and not args.no_proxy_physics
        and not args.deskew
        and args.deskew_rounds is None
    ):
        # velodyne operating point (VERDICT r4 weak #4): physics-proxy
        # sweeps are motion-smeared, so the no-INS coupled de-skew with
        # the freed twist (fixed w=100 prior — the measured all-regime
        # robust setting, DESIGN §18) is the DEFAULT — no flags needed
        # (500-pose corner 0.33 m vs 7.78 raw; 2000-scan tree 0.54).
        # --deskew-rounds 0 restores raw smeared ingestion; --deskew
        # switches to the INS-measured path. Real --kitti odometry
        # clouds arrive motion-compensated, so this default is
        # proxy-physics-only.
        cfg = cfg.replace(deskew_rounds=1, deskew_free_twist=True)
        log.info("physics proxy: no-INS de-skew on by default "
                 "(coupled free-twist; --deskew-rounds 0 to disable)")
    if args.adaptive_information:
        cfg = cfg.replace(adaptive_information=True)
    if args.keyframe_eviction is not None:
        cfg = cfg.replace(keyframe_eviction=args.keyframe_eviction)
    if args.deskew_rounds is not None:
        cfg = cfg.replace(deskew_rounds=args.deskew_rounds)
    if args.deskew_mode is not None:
        cfg = cfg.replace(deskew_mode=args.deskew_mode)
    if args.deskew_free_twist:
        cfg = cfg.replace(deskew_free_twist=True)
    if args.deskew_prior_weight is not None:
        cfg = cfg.replace(deskew_prior_weight=args.deskew_prior_weight)
    if args.deskew_prior_huber is not None:
        cfg = cfg.replace(deskew_prior_huber=args.deskew_prior_huber)
    if args.deskew_auto_prior is not None:
        cfg = cfg.replace(deskew_auto_prior=args.deskew_auto_prior == "on")

    backend = None
    post_step = None
    if args.deferred_optimize:
        import dataclasses as _dc

        from icpslam_tpu.pipeline import deferred

        cfg = _dc.replace(cfg, defer_optimization=True)
        # chunked driving calls the hook once per chunk, so the trigger
        # cadence (and lag bound) is already in window-sized units there
        backend = deferred.DeferredBackend(
            cfg,
            check_every=cfg.keyframes_window if args.chunk == 1 else 1,
        )
        post_step = backend.maybe_launch_or_fold

    resume_state = None
    if args.resume:
        from icpslam_tpu.utils import checkpoint

        resume_state = checkpoint.load(args.resume, slam.init_state(cfg))
        resume_state = checkpoint.rerender_map(resume_state, cfg)
        log.info(f"resumed {int(resume_state.keyframes.count)} keyframes "
                 f"from {args.resume} (map re-rendered: "
                 f"{int(np.sum(np.asarray(resume_state.map.size)))} points)")

    if args.debug_dump:
        import dataclasses as _dc

        cfg = _dc.replace(cfg, collect_debug=True)
        if args.chunk != 1:
            raise SystemExit("--debug-dump requires --chunk 1")
    snapshot_every, snapshot_fn = 0, None
    if args.html and args.html_every:
        if args.chunk != 1:
            raise SystemExit("--html-every requires --chunk 1")
        from icpslam_tpu.viz import html as viz_html_live

        snapshot_every = args.html_every

        def snapshot_fn(i, st, traj):
            viz_html_live.export_state_html(
                args.html, st, trajectory=traj,
                title=f"icpslam_tpu — live (scan {i + 1})",
                config=cfg,
            )
            log.info(f"scan {i + 1}: refreshed live viewer {args.html}")
    if args.trace:
        from icpslam_tpu.utils import profiling

        with profiling.trace(args.trace):
            res = run_slam(scans, cfg, initial_pose=init, logger=log,
                           chunk=args.chunk, state=resume_state,
                           post_step=post_step, debug_dir=args.debug_dump,
                           snapshot_every=snapshot_every, snapshot_fn=snapshot_fn)
        log.info(f"wrote profiler trace to {args.trace}")
    else:
        res = run_slam(scans, cfg, initial_pose=init, logger=log,
                       chunk=args.chunk, state=resume_state,
                       post_step=post_step, debug_dir=args.debug_dump,
                       snapshot_every=snapshot_every, snapshot_fn=snapshot_fn)
    if backend is not None:
        res.state = backend.flush(res.state)
        log.info(f"deferred back-end: {backend.num_launched} solves "
                 f"launched, {backend.num_folded} folded")
    n = res.trajectory.t.shape[0]
    log.info(f"processed {n} scans in {res.wall_time:.2f}s "
             f"({n / res.wall_time:.2f} scans/s incl. compile)")

    summary = {
        "scans": n,
        "wall_time_s": round(res.wall_time, 3),
        "wall_scans_per_sec": round(n / res.wall_time, 2) if n else 0.0,
        "keyframes": int(res.state.keyframes.count),
        "keyframe_evictions": int(res.state.keyframes.evictions),
        "edges": int(res.state.edges.count),
        "edge_overflow": int(res.state.edges.overflow),
        "loop_closures": int(res.state.num_loop_closures),
        "optimizations": int(res.state.num_optimizations),
        "map_size": int(np.sum(np.asarray(res.state.map.size))),
        "map_overflow": int(np.sum(np.asarray(res.state.map.overflow))),
        **({"stamp_origin": res.stamp_origin}
           if res.stamp_origin is not None else {}),
        **res.timing_summary(),
    }
    if gt is not None and gt.t.shape[0] == n:
        ate_rmse, _ = metrics.ate(res.trajectory, gt, align=True)
        t_rpe, r_rpe = metrics.rpe(res.trajectory, gt)
        summary.update(
            ate_m=round(ate_rmse, 4), rpe_t=round(t_rpe, 4), rpe_r=round(r_rpe, 5)
        )
    print(json.dumps(summary))
    if args.summary_out:
        with open(args.summary_out, "w") as f:
            json.dump(
                {
                    **summary,
                    "workload": (
                        "kitti_proxy" if args.kitti_proxy
                        else "synthetic" if args.synthetic
                        else "live_watch" if args.watch
                        else f"kitti_{args.seq}"
                    ),
                    "poses": n,  # scans actually run (cache may be shorter)
                    "backend": jax.default_backend(),
                },
                f, indent=1,
            )
        log.info(f"wrote summary to {args.summary_out}")

    if args.save_state:
        from icpslam_tpu.utils import checkpoint

        checkpoint.save(args.save_state, res.state)
        log.info(f"checkpointed final state to {args.save_state}")
    if args.out:
        np.savez(
            args.out,
            t=np.asarray(res.trajectory.t),
            q=np.asarray(res.trajectory.q),
            **({"gt_t": np.asarray(gt.t), "gt_q": np.asarray(gt.q)} if gt is not None else {}),
        )
        log.info(f"wrote trajectory to {args.out}")
    if args.html:
        from icpslam_tpu.viz import html as viz_html

        viz_html.export_state_html(
            args.html,
            res.state,
            trajectory=res.trajectory,
            config=cfg,
            ground_truth=gt if (gt is not None and gt.t.shape[0] == n) else None,
            title="icpslam_tpu — " + (
                "synthetic" if args.synthetic
                else "KITTI-proxy" if args.kitti_proxy
                else "live watch" if args.watch
                else f"KITTI {args.seq}"
            ),
        )
        log.info(f"wrote viewer to {args.html}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
