"""Probe the scan-to-map stage on the device: measured iterations +
per-knob timing (the roofline must not assume a flat 30-iteration GN).

    python tools/probe_scan_to_map.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import jax
    import jax.numpy as jnp

    from icpslam_tpu.utils import compile_cache

    compile_cache.enable()

    import dataclasses

    from icpslam_tpu.cloud.voxel import voxel_downsample
    from icpslam_tpu.config import IcpConfig, SlamConfig
    from icpslam_tpu.geometry import se3
    from icpslam_tpu.mapping import backend as map_backend
    from icpslam_tpu.mapping import scan_to_map
    from bench import _make_stream

    cfg = SlamConfig(
        voxel_leaf_size=0.2,
        icp_odometry=IcpConfig(mode="plane", max_iterations=10),
        max_points=8192,
        max_raw_points=32768,
    )
    scans, gt = _make_stream(jax, cfg, 12, 0)
    vox = jax.jit(lambda s: voxel_downsample(s, cfg.voxel_leaf_size, cfg.max_points))
    filtered = [vox(s)[0] for s in scans[:6]]

    def probe(tag, cfg):
        refine = jax.jit(
            lambda m, c, p: scan_to_map.refine_and_grow(m, c, p, cfg),
            static_argnums=(),
        )
        st = map_backend.empty(cfg)
        rargs = []
        for i, c in enumerate(filtered):
            rargs.append((st, c, se3.index(gt, i)))
            st = refine(*rargs[-1]).map
        # warm + iterate over varied inputs. Iteration counts are
        # fetched OUTSIDE the timed loop — an int() inside it forces a
        # per-call sync that poisons the timing
        out = refine(*rargs[1])
        jax.block_until_ready(out.refined_pose.t)
        n = 8
        outs = []
        t0 = time.perf_counter()
        for k in range(n):
            out = refine(*rargs[1 + k % (len(rargs) - 1)])
            outs.append(out.icp_iterations)
        jax.block_until_ready(out.refined_pose.t)
        ms = (time.perf_counter() - t0) / n * 1000.0
        iters = [int(x) for x in outs]
        print(json.dumps({
            "probe": tag, "ms": round(ms, 3),
            "iters": iters,
            "map_fill": int(jnp.sum(st.size)),
        }))
        return ms

    base = probe("default_30iter", cfg)
    for mi in (15, 10, 6, 4):
        c2 = cfg.replace(
            icp_mapping=dataclasses.replace(cfg.icp_mapping, max_iterations=mi)
        )
        probe(f"max_iter_{mi}", c2)
    # looser epsilon: exits earlier at equal budget
    c3 = cfg.replace(
        icp_mapping=dataclasses.replace(
            cfg.icp_mapping, transformation_epsilon=1e-3
        )
    )
    probe("eps_1e-3", c3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
