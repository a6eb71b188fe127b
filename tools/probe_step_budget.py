"""Fused-step budget attribution by config ablation.

Per-stage benches re-dispatch each stage separately (dispatch + duplicate
covariance work inflates them); this probe times the FUSED ``slam_step``
with pipeline pieces disabled via config, so each delta is that piece's
true contribution to the step's critical path on the device.

Run on an idle host: concurrent CPU load delays dispatch and inflates
every time.

    python tools/probe_step_budget.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import jax

    from icpslam_tpu.utils import compile_cache

    compile_cache.enable()

    from bench import _make_stream
    from icpslam_tpu.config import IcpConfig, SlamConfig
    from icpslam_tpu.geometry import se3
    from icpslam_tpu.pipeline import slam

    base = SlamConfig(
        voxel_leaf_size=0.2,
        icp_odometry=IcpConfig(mode="plane", max_iterations=10),
        max_points=8192,
        max_raw_points=32768,
    )
    scans, gt = _make_stream(jax, base, 30, 3)

    def timed(tag, cfg):
        step = jax.jit(slam.slam_step, static_argnums=(2,))
        state = jax.device_put(
            slam.init_state(cfg, se3.index(gt, 0)), jax.devices()[0]
        )
        for i in range(3):
            state, _ = step(state, scans[i], cfg)
        jax.block_until_ready(state)
        runs = []
        for _ in range(3):
            st = state
            t0 = time.perf_counter()
            for i in range(3, len(scans)):
                st, _ = step(st, scans[i], cfg)
            jax.block_until_ready(st)
            runs.append((time.perf_counter() - t0) / (len(scans) - 3) * 1e3)
        runs.sort()
        print(json.dumps({"variant": tag, "ms_per_scan": round(runs[1], 3),
                          "spread": [round(runs[0], 3), round(runs[2], 3)]}))
        return runs[1]

    full = timed("full", base)
    timed("no_loop_closure", base.replace(enable_loop_closure=False))
    timed("no_scan_to_map", base.replace(enable_scan_to_map=False))
    timed("no_eviction_branch", base.replace(keyframe_eviction="none"))
    timed("odometry_point_mode", base.replace(
        icp_odometry=dataclasses.replace(base.icp_odometry, mode="point"),
        icp_mapping=dataclasses.replace(base.icp_mapping, mode="point"),
    ))
    timed("mapping_requery_1", base.replace(mapping_requery_rounds=1))
    timed("graph_noninc", base.replace(graph_incremental=False))
    print(json.dumps({"variant": "full_baseline_scans_per_sec",
                      "value": round(1000.0 / full, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
