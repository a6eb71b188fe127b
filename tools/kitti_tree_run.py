"""Mission-scale REAL-loader artifact: write a full on-disk KITTI
odometry tree from rendered physics-proxy sweeps and drive it through
``runner --kitti`` (native prefetching loader, 4-column bins, non-trivial
``Tr``, times.txt, cam0 poses — the exact code path a mounted KITTI
dataset would take, ``launch/icpslam.launch:18`` analog).

Reuses a proxy scan cache (``tools/endurance.py`` / ``runner
--kitti-proxy --scan-cache``) so the sweeps carry the full sensor
physics (motion smear, range noise, dropout, traffic); the run enables
the no-INS coupled de-skew.

    python tools/kitti_tree_run.py --cache .smoke/proxy2000.npz \
        --out artifacts/kitti_tree_2000.json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cache", type=str,
                    default=os.path.join(REPO, ".smoke", "proxy2000.npz"))
    ap.add_argument("--out", type=str, default="artifacts/kitti_tree_2000.json")
    ap.add_argument("--scans", type=int, default=None,
                    help="limit (default: whole cache)")
    ap.add_argument("--root", type=str, default=None,
                    help="tree root (default: temp dir)")
    ap.add_argument("--extra-args", type=str, default="",
                    help="extra runner flags (space-separated)")
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    from icpslam_tpu.geometry.se3 import Pose
    from icpslam_tpu.io import kitti

    data = np.load(args.cache)
    n = int(data["gt_t"].shape[0])
    if args.scans:
        n = min(n, args.scans)
    root = args.root or tempfile.mkdtemp(prefix="kitti_tree_")
    gt = Pose(t=data["gt_t"][:n], q=data["gt_q"][:n])
    kitti.write_tree(root, "99", (data[f"s{i}"] for i in range(n)), gt)
    print(f"wrote {n}-scan KITTI tree to {root}", flush=True)

    proc = subprocess.run(
        [sys.executable, "-m", "icpslam_tpu.io.runner",
         "--kitti", root, "--seq", "99", "--end", str(n),
         "--max-keyframes", "1024",
         "--deskew-rounds", "1", "--deskew-free-twist"]
        + ([a for a in args.extra_args.split() if a]),
        cwd=REPO, capture_output=True, text=True, timeout=3600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"runner failed:\n{proc.stderr[-3000:]}")
    summary = json.loads(
        [l for l in proc.stdout.splitlines() if l.startswith("{")][-1]
    )
    artifact = {
        "metric": "kitti_tree_real_loader",
        "scans": n,
        "tree_root": root,
        "loader": "io/kitti.py + native/scanio.cpp prefetcher "
        "(4-col bins, Tr conversion, times.txt stamps)",
        "deskew": "no-INS coupled + free twist",
        **summary,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps({"kitti_tree": "ok", "scans": n,
                      "ate_m": summary.get("ate_m"), "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
