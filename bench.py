"""Benchmark harness: prints ONE JSON line with the headline metric.

Headline: FULL SLAM pipeline throughput (scans/sec) through the jitted
``slam_step`` — voxel filter + covariance estimation + 10-iter GICP
odometry + scan-to-map refinement + keyframes/loop-closure/pose-graph —
at KITTI-like sizes (raw scans ~32k points, ~8k voxel-filtered), on the
GPU (it fails when JAX finds none), or on the CPU with --cpu. This is the
analog of the reference's operating loop
(``/root/reference/src/icpslam/icpslam.cpp:107-189``), not just the
front-end.

``vs_baseline`` compares against the reference operating point, MEASURED
per run by ``native/gicp_ref.cpp`` — a single-threaded C++ kd-tree GICP
at the reference's own knobs and matched cloud sizes (~5-8 scans/s on
this host CPU; built on demand, falls back to the documented 10 scans/s
estimate without a toolchain). The reference's full mainLoop (odometry
GICP + octree NN + 30-iter mapping GICP) is strictly slower than its
front-end alone, so using the front-end measurement as the denominator
*understates* our multiplier.

Secondary metrics (stderr, one JSON line each): front-end odometry
throughput, pose-graph solve latency, and optional on-device fused-kernel
vs plain-path verification (--verify-kernels).

Usage: python bench.py [--cpu] [--scans N] [--json-only] [--verify-kernels]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


REFERENCE_SCANS_PER_SEC = 10.0  # documented fallback estimate, see above


def measure_reference(timeout_s: float = 120.0):
    """Measured reference denominator: build + run the C++ kd-tree GICP
    micro-harness (``native/gicp_ref.cpp``) at matched sizes — the
    reference's PCL front-end operating point on this machine's CPU.
    Returns scans/s, or None if the toolchain/binary is unavailable."""
    import os
    import subprocess

    native = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
    binary = os.path.join(native, "gicp_ref")
    try:
        # always invoke make (incremental): a stale binary from an edited
        # gicp_ref.cpp — or a foreign host's ISA — must never be measured
        subprocess.run(
            ["make", "-C", native, "gicp_ref"],
            check=True, capture_output=True, timeout=timeout_s,
        )
        out = subprocess.run(
            [binary, "8192", "10"], check=True, capture_output=True,
            timeout=timeout_s, text=True,
        ).stdout
        return float(json.loads(out.splitlines()[-1])["value"])
    except Exception:
        return None


def _make_stream(jax, cfg, n_scans, warmup):
    """KITTI-like synthetic stream: big room, ~32k-point scans."""
    from icpslam_tpu.io import synthetic

    dev = jax.devices()[0]
    world = synthetic.make_room_world(seed=0, n_points=200000, size=40.0, height=4.0)
    gt = synthetic.make_loop_trajectory(n_poses=warmup + n_scans, radius=12.0, laps=0.5)
    scans = [
        jax.device_put(s, dev)
        for s in synthetic.scan_stream(
            world, gt, capacity=cfg.max_raw_points, max_range=25.0,
            n_points=30000, noise=0.02, seed=0,
        )
    ]
    return scans, gt


def bench_full_slam(jax, cfg, scans, gt, donate: bool = False):
    """Full slam_step throughput (odometry + scan-to-map + keyframes +
    loop closure + windowed graph solve) — the headline.

    Driven step-by-step (step-by-step exercises the per-scan dispatch
    path production streaming uses).
    """
    from icpslam_tpu.geometry import se3
    from icpslam_tpu.pipeline import slam

    # donation of the SlamState is opt-in (--donate)
    kw = dict(static_argnums=(2,))
    if donate:
        kw["donate_argnums"] = (0,)
    step = jax.jit(slam.slam_step, **kw)
    # committed state avoids a second compile (committed-ness is cache-key)
    state0 = jax.device_put(slam.init_state(cfg, se3.index(gt, 0)), jax.devices()[0])
    n_warm = min(3, len(scans) - 1)
    state = state0
    for i in range(n_warm):
        state, out = step(state, scans[i], cfg)
    jax.block_until_ready(state)
    # median of 3 full passes with the spread reported. Each pass replays
    # the same varied-input stream from the same warm state.
    runs = []
    for _ in range(3):
        st = state
        t0 = time.perf_counter()
        for i in range(n_warm, len(scans)):
            st, out = step(st, scans[i], cfg)
        jax.block_until_ready(st)
        runs.append((len(scans) - n_warm) / (time.perf_counter() - t0))
    runs.sort()
    return runs[1], {"min": round(runs[0], 3), "median": round(runs[1], 3),
                     "max": round(runs[2], 3)}


def _prefill_graph(jax, state, cfg, n_fill):
    """Late-mission state: ``n_fill`` keyframes already in the graph
    (placed far away so loop-closure proposals never fire), chained by
    consistent sequential edges. The next windowed solve runs at the
    full live size — the regime where back-end latency actually matters."""
    import jax.numpy as jnp
    import numpy as np

    from icpslam_tpu.geometry import se3
    from icpslam_tpu.graph import pose_graph as pg

    K = state.keyframes.capacity
    n_fill = min(n_fill, K - 4)
    t = np.zeros((K, 3), np.float32)
    t[:n_fill, 0] = np.arange(n_fill) * 2.0
    t[:n_fill, 2] = -1000.0  # far below the world: never a loop candidate
    poses = se3.Pose(t=jnp.asarray(t), q=se3.identity((K,)).q)
    store = state.keyframes._replace(
        pose_odom=poses, pose_graph=poses,
        count=jnp.asarray(n_fill, jnp.int32),
    )
    # build the sequential-edge arrays in one shot (a Python add_edge
    # loop would dispatch ~500 eager ops)
    E = state.edges.capacity
    ne = n_fill - 1
    ei = np.zeros((E,), np.int32)
    ej = np.zeros((E,), np.int32)
    ei[:ne] = np.arange(ne)
    ej[:ne] = np.arange(1, ne + 1)
    rel_t = np.zeros((E, 3), np.float32)
    rel_t[:ne, 0] = 2.0
    valid = np.zeros((E,), bool)
    valid[:ne] = True
    edges = state.edges._replace(
        i=jnp.asarray(ei), j=jnp.asarray(ej), rel_t=jnp.asarray(rel_t),
        rel_q=se3.identity((E,)).q,
        info=jnp.broadcast_to(100.0 * jnp.eye(6), (E, 6, 6)),
        valid=jnp.asarray(valid), count=jnp.asarray(ne, jnp.int32),
    )
    return state._replace(keyframes=store, edges=edges)


def bench_deferred_slam(jax, cfg, scans, gt):
    """Late-mission back-end comparison: inline vs pipelined solve.

    With ~500 live keyframes every windowed solve is a full-size
    factorization (~43 ms at K=512); the reference's loop (and our
    inline mode) stalls the stream for it, the deferred mode
    (``pipeline/deferred.py``) hides it behind the next scans' front-end
    work. Returns (inline_sps, deferred_sps)."""
    import dataclasses

    from icpslam_tpu.geometry import se3
    from icpslam_tpu.pipeline import deferred, slam

    # default back-end configuration (bucketing + auto solver) — the
    # late-mission number must reflect what a user actually gets; loop
    # closure stays off to isolate the back-end-latency scenario
    base = dataclasses.replace(cfg, enable_loop_closure=False)
    dcfg = dataclasses.replace(base, defer_optimization=True)
    # leave room for every timed scan to add a keyframe (once the store
    # is full, keyframing and therefore solving stops)
    n_fill = cfg.max_keyframes - 40
    dev = jax.devices()[0]

    def fresh(c):
        st = jax.device_put(slam.init_state(c, se3.index(gt, 0)), dev)
        return jax.device_put(_prefill_graph(jax, st, c, n_fill), dev)

    n_warm = min(4, len(scans) - 1)

    # inline: solve runs inside slam_step every keyframes_window
    step = jax.jit(slam.slam_step, static_argnums=(2,))
    state = fresh(base)
    for i in range(n_warm):
        state, _ = step(state, scans[i], base)
    jax.block_until_ready(state)
    state = fresh(base)
    for i in range(n_warm):
        state, _ = step(state, scans[i], base)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for i in range(n_warm, len(scans)):
        state, _ = step(state, scans[i], base)
    jax.block_until_ready(state)
    inline_sps = (len(scans) - n_warm) / (time.perf_counter() - t0)

    # deferred: solve dispatched async, trigger checked once per window
    dstep = jax.jit(slam.slam_step, static_argnums=(2,))

    def drive(state, backend, lo, hi):
        for i in range(lo, hi):
            state, _ = dstep(state, scans[i], dcfg)
            state = backend.maybe_launch_or_fold(state)
        return state

    backend = deferred.DeferredBackend(dcfg, check_every=cfg.keyframes_window)
    state = backend.flush(drive(fresh(dcfg), backend, 0, min(10, len(scans))))
    jax.block_until_ready(state)
    backend = deferred.DeferredBackend(dcfg, check_every=cfg.keyframes_window)
    state = drive(fresh(dcfg), backend, 0, n_warm)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state = backend.flush(drive(state, backend, n_warm, len(scans)))
    jax.block_until_ready(state)
    deferred_sps = (len(scans) - n_warm) / (time.perf_counter() - t0)
    return inline_sps, deferred_sps


def bench_odometry(jax, cfg, scans, gt, n_warm, chunk=10):
    """Front-end odometry throughput (chunked lax.scan driving)."""
    import jax.numpy as jnp
    import jax.tree_util as jtu

    from icpslam_tpu.geometry import se3
    from icpslam_tpu.pipeline import odometry

    run = jax.jit(odometry.run_scans, static_argnums=(2,), donate_argnums=(0,))
    # device_put: committed-ness is part of the jit cache key — an
    # uncommitted fresh state would recompile on the second call (whose
    # input is the committed output of the first)
    state = jax.device_put(odometry.init_state(cfg, se3.index(gt, 0)), jax.devices()[0])

    def stack(cs):
        return jtu.tree_map(lambda *x: jnp.stack(x), *cs)

    timed = scans[n_warm:]
    n = len(timed) // chunk * chunk
    warm_chunk = stack((scans[:n_warm] * chunk)[:chunk])
    chunks = [stack(timed[i : i + chunk]) for i in range(0, n, chunk)]

    state, out = run(state, warm_chunk, cfg)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for ch in chunks:
        state, out = run(state, ch, cfg)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    return n / dt


def bench_graph_solvers(jax, np):
    """Pose-graph solve latency (BASELINE.md secondary metric)."""
    import jax.numpy as jnp

    from icpslam_tpu.geometry import se3
    from icpslam_tpu.graph import pose_graph as pg

    K, E = 512, 2048
    rng = np.random.RandomState(0)
    ii = np.arange(E) % (K - 1)
    edges = pg.EdgeSet(
        i=jnp.asarray(ii, jnp.int32),
        j=jnp.asarray(ii + 1, jnp.int32),
        rel_t=jnp.asarray(rng.randn(E, 3) * 0.1, jnp.float32),
        rel_q=se3.identity((E,)).q,
        info=jnp.broadcast_to(100 * jnp.eye(6), (E, 6, 6)),
        valid=jnp.ones(E, bool),
        count=jnp.asarray(E, jnp.int32),
        overflow=jnp.asarray(0, jnp.int32),
    )
    mask = jnp.ones(K, bool)

    def mknodes(seed):
        r = np.random.RandomState(seed)
        return se3.Pose(
            t=jnp.asarray(r.randn(K, 3), jnp.float32) * 5,
            q=se3.identity((K,)).q,
        )

    nodes_list = [mknodes(s) for s in range(12)]
    out_ms = {}
    for solver in ("direct", "pcg", "schur"):
        f = jax.jit(
            lambda n: pg.optimize(
                n, edges, mask, iterations=5, mode="lm", linear_solver=solver
            )
        )
        out = f(nodes_list[-1])
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for n in nodes_list[:10]:
            out = f(n)
        jax.block_until_ready(out)
        out_ms[solver] = (time.perf_counter() - t0) / 10 * 1000
    return out_ms


def bench_stages(jax, np, cfg, scans, gt):
    """Per-stage device timings at headline shapes (SURVEY §5.1): each
    pipeline stage jitted separately and timed over varied inputs, so
    perf regressions are attributable to a stage. Stage sums exceed the
    fused step time (the full step overlaps/fuses across stages)."""
    import jax.numpy as jnp

    from icpslam_tpu.cloud.voxel import voxel_downsample
    from icpslam_tpu.geometry import se3
    from icpslam_tpu.mapping import backend as map_backend
    from icpslam_tpu.mapping import scan_to_map
    from icpslam_tpu.ops import icp as icp_ops
    from icpslam_tpu.pipeline import odometry as odo

    icfg = cfg.icp_odometry
    out = {}

    def timeit(name, f, inputs, n=10):
        outs = f(inputs[0])
        jax.block_until_ready(outs)
        t0 = time.perf_counter()
        for i in range(n):
            outs = f(inputs[i % len(inputs)])
        jax.block_until_ready(outs)
        out[name] = (time.perf_counter() - t0) / n * 1000.0

    vox = jax.jit(lambda s: voxel_downsample(s, cfg.voxel_leaf_size, cfg.max_points))
    timeit("voxel_filter", vox, scans)

    filtered = [vox(s)[0] for s in scans[:4]]
    cov = jax.jit(lambda c: odo.compute_covariances(c, icfg))
    timeit("covariances", cov, filtered)

    covs = [cov(c) for c in filtered]
    reg = jax.jit(
        lambda args: icp_ops.icp(
            args[0], args[1], icfg, source_covs=args[2], target_covs=args[3]
        )
    )
    pairs = [
        (filtered[i], filtered[i + 1], covs[i], covs[i + 1])
        for i in range(len(filtered) - 1)
    ]
    timeit("icp_odometry", reg, pairs)

    # scan-to-map at a representative fill: grow a map from the stream,
    # then time refine_and_grow against it
    refine = jax.jit(
        lambda args: scan_to_map.refine_and_grow(args[0], args[1], args[2], cfg)
    )
    st = map_backend.empty(cfg)
    rargs = []
    for i, c in enumerate(filtered):
        rargs.append((st, c, se3.index(gt, i)))
        st = refine(rargs[-1]).map
    timeit("scan_to_map_refine", refine, rargs[1:], n=6)

    # measured operating points for the roofline models. Reuse the
    # jitted stage closure: an eager icp call would dispatch hundreds of
    # individual ops.
    one_icp = reg(pairs[0])
    one_ref = refine(rargs[1])
    meta = {
        "odo_iterations": float(one_icp.iterations),
        # MEASURED mapping-GN iterations (r5): the epsilon exit fires at
        # 2-3 of the 30-iteration budget — the r4 roofline's "30.0 fixed
        # iters" was the config assumption, not a measurement
        "map_iterations": float(one_ref.icp_iterations),
        "map_fill": int(jnp.sum(st.size)),
    }
    return out, meta


def verify_kernels(jax, np):
    """On-device NN correctness check: same correspondences/distances
    from the fused kernel and the plain path, on the device this bench
    runs on."""
    import jax.numpy as jnp

    from icpslam_tpu.ops import nn as nn_ops

    rng = np.random.RandomState(7)
    checks = []
    for N, M in ((2048, 4096), (4096, 8192)):
        q = jnp.asarray(rng.uniform(-20, 20, (N, 3)).astype(np.float32))
        t = jnp.asarray(rng.uniform(-20, 20, (M, 3)).astype(np.float32))
        tm = jnp.asarray(np.arange(M) < M - 101)  # padded tail masked out
        res_p = nn_ops.nearest_neighbors(q, t, tm, fused=True)
        res_x = nn_ops.nearest_neighbors(q, t, tm, fused=False)
        # ties can legitimately differ in index — compare distances, and
        # indices only where the distance gap is meaningful
        d_ok = bool(jnp.max(jnp.abs(res_p.dist2 - res_x.dist2)) < 1e-3)
        idx_match = jnp.mean((res_p.idx == res_x.idx).astype(jnp.float32))
        checks.append({
            "shape": [N, M],
            "idx_match_frac": round(float(idx_match), 5),
            "dists_close": d_ok,
        })
    ok = all(c["dists_close"] and c["idx_match_frac"] > 0.999 for c in checks)
    return ok, checks


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--scans", type=int, default=33, help="timed scans (+warmup)")
    ap.add_argument("--json-only", action="store_true")
    ap.add_argument("--donate", action="store_true",
                    help="donate the SlamState in the headline loop")
    ap.add_argument("--suite", action="store_true",
                    help="also report odometry + graph-solve metrics (stderr)")
    ap.add_argument("--stages", action="store_true",
                    help="also report per-stage device timings as separate "
                    "stderr lines (they are ALWAYS folded into the stdout "
                    "JSON; this adds the verbose per-stage lines)")
    ap.add_argument("--no-stages", action="store_true",
                    help="skip the per-stage timing pass (4 extra jits)")
    ap.add_argument("--verify-kernels", action="store_true",
                    help="also report the fused-kernel check as a stderr "
                    "line (the check itself ALWAYS runs where the kernel "
                    "dispatches and gates the headline)")
    args = ap.parse_args()

    import jax

    from icpslam_tpu.utils import compile_cache

    compile_cache.enable()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from icpslam_tpu.config import IcpConfig, SlamConfig
    from icpslam_tpu.ops import nn as nn_ops

    dev = jax.devices()[0]
    if not args.cpu and dev.platform != "gpu":
        print(f"bench.py: JAX found no GPU (platform {dev.platform!r}); "
              "pass --cpu for a CPU smoke run", file=sys.stderr)
        return 2
    if not args.json_only:
        print(f"# device: {dev}", file=sys.stderr)

    cfg = SlamConfig(
        voxel_leaf_size=0.2,
        icp_odometry=IcpConfig(mode="plane", max_iterations=10),
        max_points=8192,
        max_raw_points=32768,
    )

    n_warm = 3
    scans, gt = _make_stream(jax, cfg, args.scans - n_warm, n_warm)

    # kernel verification ALWAYS runs where the fused kernel dispatches
    # and gates the headline — a silent kernel regression must not ship
    # behind a green number. On the CPU the kernel never dispatches.
    fused = nn_ops.fused_nn_enabled()
    if fused:
        kernels_ok, checks = verify_kernels(jax, np)
        kernel_status = "pass" if kernels_ok else "FAIL"
    else:
        kernels_ok, checks = True, []
        kernel_status = "skipped (the fused kernel dispatches on the GPU only)"
    if args.verify_kernels:
        print(
            json.dumps({"metric": "nn_kernel_verification",
                        "value": kernel_status, "checks": checks}),
            file=sys.stderr,
        )
    if not kernels_ok:
        print(json.dumps({"metric": "full_slam_step_scans_per_sec",
                          "value": 0.0, "unit": "scans/s",
                          "vs_baseline": 0.0, "kernel_verification": "FAIL",
                          "checks": checks,
                          "error": "kernel verification failed"}))
        return 1

    sps, spread = bench_full_slam(jax, cfg, scans, gt, donate=args.donate)

    ref_sps = measure_reference()
    baseline = ref_sps if ref_sps else REFERENCE_SCANS_PER_SEC
    result = {
        "metric": "full_slam_step_scans_per_sec",
        "value": round(sps, 3),
        "spread": spread,  # min/median/max of 3 passes
        "unit": "scans/s (voxel+GICP odometry+scan-to-map+keyframes+graph)",
        "vs_baseline": round(sps / baseline, 3),
        "baseline_scans_per_sec": round(baseline, 3),
        "baseline_source": (
            "measured (native/gicp_ref.cpp, 1-thread C++ kd-tree GICP)"
            if ref_sps else "estimate (toolchain unavailable)"
        ),
        "kernel_verification": kernel_status,
    }

    # per-stage device timings are ALWAYS folded into the headline JSON;
    # --no-stages opts out.
    if not args.no_stages:
        stage_ms, stage_meta = bench_stages(jax, np, cfg, scans, gt)
        result["stage_ms"] = {k: round(v, 3) for k, v in stage_ms.items()}
        # speed-of-light accounting: achieved GB/s + GFLOP/s per stage and
        # their fractions of this device's peaks (analytic minimum-traffic
        # models, utils/roofline.py; no fraction for an unknown device)
        from icpslam_tpu.utils import roofline

        result["roofline"] = roofline.stage_rooflines(
            stage_ms,
            raw_points=cfg.max_raw_points,
            n_points=cfg.max_points,
            covariance_knn=cfg.icp_odometry.covariance_knn,
            odo_iterations=max(stage_meta["odo_iterations"], 1.0),
            map_iterations=max(stage_meta["map_iterations"], 1.0),
            map_fill=max(stage_meta["map_fill"], cfg.max_points),
            plane=cfg.icp_odometry.mode == "plane",
            mapping_fixed_corr=cfg.mapping_fixed_correspondences,
            device_kind=dev.device_kind,
        )
        if args.stages:
            for stage, ms in stage_ms.items():
                print(
                    json.dumps({"metric": f"stage_ms_{stage}",
                                "value": round(ms, 3), "unit": "ms/scan"}),
                    file=sys.stderr,
                )

    # late-mission throughput is ALWAYS in the headline JSON on the GPU:
    # the default config must not halve at high keyframe counts. (CPU
    # smoke runs skip it — full-512-capacity solves take minutes there;
    # pass --suite to force.)
    if (fused and not args.no_stages) or args.suite:
        inline_sps, def_sps = bench_deferred_slam(jax, cfg, scans, gt)
        result["late_mission_scans_per_sec"] = {
            "inline_solve": round(inline_sps, 3),
            "pipelined_solve": round(def_sps, 3),
            "note": "~472 live keyframes; incremental back-end solves "
            "the trailing graph_window between loop closures "
            "(graph_incremental default, r4)",
        }

    if args.suite:
        if "late_mission_scans_per_sec" in result:
            print(
                json.dumps({"metric": "late_mission_slam_scans_per_sec",
                            "value": result["late_mission_scans_per_sec"]}),
                file=sys.stderr,
            )
        odo_sps = bench_odometry(jax, cfg, scans, gt, n_warm)
        print(
            json.dumps({"metric": "gicp_odometry_scans_per_sec",
                        "value": round(odo_sps, 3), "unit": "scans/s"}),
            file=sys.stderr,
        )
        for solver, ms in bench_graph_solvers(jax, np).items():
            print(
                json.dumps({"metric": f"pose_graph_solve_ms_{solver}",
                            "value": round(ms, 2),
                            "unit": "ms (K=512, E=2048, 5 LM iters)"}),
                file=sys.stderr,
            )

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
