"""Mission-scale endurance artifact (VERDICT r4 item 4).

Drives ≥2000 physics-proxy scans through the real runner at production
capacities, with a mid-mission checkpoint + resume, and writes ONE
artifact JSON proving:

- sustained tracking over the whole mission (ATE/RPE, finite poses)
- the keyframe store driven TO capacity and past it (the append-only
  store stops growing at max_keyframes — the bounded analog of the
  reference's unbounded std::vector growth, ``icpslam.cpp:88`` /
  ``octree_mapper.cpp:63-70``) with every overflow counter reported
- checkpoint/resume equivalence at scale: run A (all scans) vs run B
  (first half → checkpoint → resume second half) end near-identically
- late-mission throughput measured on the resumed half (the store is
  ≥ half full for all of it)

Usage (on the GPU; the first run renders the scans and compiles):
    python tools/endurance.py --scans 2000 \
        --cache .smoke/proxy2000.npz --out artifacts/endurance_2000.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_runner(args: list, timeout: float = 3000.0) -> dict:
    """Invoke the runner CLI; return its summary JSON (last stdout line)."""
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "icpslam_tpu.io.runner"] + args,
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"runner failed ({proc.returncode}):\n{proc.stderr[-3000:]}"
        )
    line = [l for l in proc.stdout.splitlines() if l.startswith("{")][-1]
    out = json.loads(line)
    out["_invocation_wall_s"] = round(time.time() - t0, 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scans", type=int, default=2000)
    ap.add_argument("--cache", type=str,
                    default=os.path.join(REPO, ".smoke", "proxy2000.npz"))
    ap.add_argument("--out", type=str, default="artifacts/endurance_2000.json")
    args = ap.parse_args()

    tmp = tempfile.mkdtemp(prefix="endurance_")
    half = args.scans // 2
    # healthy mission: 1024-keyframe capacity fits the ~800 keyframes a
    # 2.0 m gate wants over the ~1600 m route — loop closures (and
    # therefore bounded drift) all mission long. The physics proxy's
    # sweeps are motion-smeared, so the mission runs the no-INS coupled
    # de-skew (raw smeared tracking degrades to ~15-21 m ATE over 2 km —
    # measured; DESIGN §14)
    caps = [
        "--max-keyframes", "1024",
        "--deskew-rounds", "1", "--deskew-free-twist",
    ]
    base = [
        "--kitti-proxy", "--poses", str(args.scans),
        "--scan-cache", args.cache,
    ] + caps

    # --- run A: the full mission in one process -------------------------
    trajA = os.path.join(tmp, "trajA.npz")
    A = run_runner(base + ["--summary-out", os.path.join(tmp, "A.json"),
                           "--out", trajA])

    # --- run B: half the mission, checkpoint, resume the rest -----------
    ckpt = os.path.join(tmp, "ckpt.npz")
    B1 = run_runner([
        "--kitti-proxy", "--poses", str(half),
        "--scan-cache", args.cache,
        "--save-state", ckpt,
    ] + caps)
    trajB2 = os.path.join(tmp, "trajB2.npz")
    B2 = run_runner(base + [
        "--start", str(half), "--resume", ckpt, "--out", trajB2,
    ])

    # --- equivalence + drift metrics ------------------------------------
    a = np.load(trajA)["t"] if "t" in np.load(trajA) else np.load(trajA)["traj_t"]
    b2 = np.load(trajB2)
    b2t = b2["t"] if "t" in b2 else b2["traj_t"]
    tailA = a[half:]
    m = min(len(tailA), len(b2t))
    end_gap = float(np.linalg.norm(tailA[m - 1] - b2t[m - 1]))
    tail_rmse = float(np.sqrt(np.mean(np.sum((tailA[:m] - b2t[:m]) ** 2, -1))))

    # late-mission throughput: the resumed half runs with ≥ half-full
    # stores end to end; the runner's own wall_time_s excludes stream
    # setup, compile_ms the first-dispatch compile
    late_sps = (args.scans - half) / max(
        B2["wall_time_s"] - B2.get("compile_ms", 0.0) / 1000.0, 1e-9
    )

    # --- run C: capacity-EXHAUSTION phase — a 1.0 m gate wants ~1600
    # keyframes against the default 512 capacity, so the store hits
    # capacity a third of the way in. With keyframe_eviction='marginalize'
    # (the r5 default) the mission OUTLIVES the capacity: the most
    # redundant frozen keyframes are marginalized out (edges re-homed
    # covariance-correctly, graph/marginalize.py) so new nodes and loop
    # closures keep coming all mission long. C_frozen is the pre-r5 hard
    # stop for contrast (VERDICT r4 item 1: 1.13 m frozen vs <=0.6 target)
    cap_args = [
        "--kitti-proxy", "--poses", str(args.scans),
        "--keyframe-distance", "1.0",
        "--scan-cache", args.cache,
        "--deskew-rounds", "1", "--deskew-free-twist",
    ]
    C = run_runner(cap_args)
    C_frozen = run_runner(cap_args + ["--keyframe-eviction", "none"])

    # --- run D: the loop-closure-dense mission with the PIPELINED
    # back-end (VERDICT r4 weak #5: DESIGN §15's remaining deferred-mode
    # claim — "the right tool when full solves dominate" — was untested).
    # Same mission as run A, solves dispatched asynchronously and folded
    # back; compare wall/step against A's inline solves.
    D = run_runner(base + ["--deferred-optimize"])

    artifact = {
        "metric": "endurance_2000",
        "scans": args.scans,
        "full_run": A,
        "half_run": B1,
        "resumed_run": B2,
        "resume_equivalence": {
            "end_gap_m": round(end_gap, 4),
            "tail_rmse_m": round(tail_rmse, 4),
            "note": "full-run tail vs resumed-run trajectory; the resumed "
            "map is re-rendered from keyframes at graph poses, so "
            "bit-identity is not expected — near-identity is",
        },
        "late_mission_scans_per_sec": round(late_sps, 2),
        "capacity_exhaustion_run": {
            **C,
            "keyframe_capacity": 512,
            "at_capacity": C["keyframes"] >= 512,
            "note": "keyframe store intentionally driven past capacity "
            "(gate 1.0 m wants ~1600 keyframes vs 512 capacity); with "
            "keyframe_eviction='marginalize' (r5 default) redundant "
            "frozen keyframes are marginalized out — edges re-homed "
            "with covariance-correct SE(3) composition — so new nodes "
            "AND loop closures keep coming all mission long "
            "(keyframe_evictions counts the slots recycled)",
        },
        "capacity_exhaustion_frozen": {
            **C_frozen,
            "note": "pre-r5 behavior (--keyframe-eviction none): the "
            "store freezes at capacity — no new nodes or loop closures; "
            "tracking continues on odometry + scan-to-map only. The ATE "
            "delta vs the marginalizing run above is what eviction buys",
        },
        "deferred_backend_run": {
            **D,
            "note": "run A's mission with --deferred-optimize (solves "
            "dispatched async + folded back, pipeline/deferred.py). "
            "Compare step/wall stats against full_run to settle the "
            "deferred mode's loop-closure-dense niche claim (DESIGN "
            "§15)",
        },
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps({
        "endurance": "ok",
        "ate_full": A.get("ate_m"),
        "keyframes": A["keyframes"],
        "end_gap_m": artifact["resume_equivalence"]["end_gap_m"],
        "late_mission_scans_per_sec": late_sps,
        "out": args.out,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
