"""Speed-of-light accounting for the hot path.

Analytic FLOP / bytes-moved models for each pipeline stage at the bench
shapes, divided by measured stage times to give achieved GB/s and GFLOP/s,
and the fraction of the device's published peaks they reach. The models
are *minimum-traffic* derivations from the algorithms (not profiler
counters): a small fraction means the stage is bound by something else
(reported in ``bound``) — at scan sizes (8-32k points) usually latency or
sort passes, not bandwidth.

Peaks come from ``PEAKS``, keyed by ``jax.Device.device_kind``. A device
that is not in the table (the CPU included) gets no fraction (``None``):
no peak is ever assumed.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

# Published dense peaks (NVIDIA H100 SXM5 data sheet, at the 700 W limit):
# FLOP/s in TFLOP/s by unit, device memory in GB/s.
_H100_SXM = dict(
    hbm_gbps=3350.0,
    fp32_cuda_core_tflops=67.0,
    tf32_tensor_tflops=495.0,
    bf16_tensor_tflops=989.0,
)
PEAKS: Dict[str, dict] = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}

# the compute unit each ``bound`` label is measured against
_BOUND_UNIT = {
    "fp32-cuda-core": "fp32_cuda_core_tflops",
    "tf32-tensor": "tf32_tensor_tflops",
    "bf16-tensor": "bf16_tensor_tflops",
}

_F32 = 4  # bytes


def peaks(device_kind: Optional[str]) -> Optional[dict]:
    """The peak table row for ``device_kind``, or None if it is unknown."""
    return PEAKS.get(device_kind) if device_kind else None


def _stage(flops: float, bytes_: float, bound: str, note: str) -> dict:
    return {"flops": flops, "bytes": bytes_, "bound": bound, "note": note}


def nn_pairs_model(n: int, m: int, sweeps: float = 1.0) -> dict:
    """Fused 1-NN (``ops.pallas.nn_kernel``): per (query, target) pair the
    subtraction form costs ~11 float32 ops on the CUDA cores (3 sub + 3
    mul + 3 add + min/argmin compare and select). Minimum device-memory
    traffic per sweep: read both clouds once (target tiles are re-read by
    every query block, from L2) and write the (idx, d²) pair."""
    return _stage(
        flops=11.0 * n * m * sweeps,
        bytes_=(n * 3 + m * 4 + n * 2) * _F32 * sweeps,
        bound="fp32-cuda-core",
        note=f"{n}x{m} fused 1-NN, {sweeps:.1f} sweeps",
    )


def voxel_filter_model(raw: int) -> dict:
    """Sort-based voxel downsample: one lexsort of `raw` (key, payload)
    records dominates; traffic ~ 2·raw·record·log2(raw)."""
    rec = 16.0
    passes = math.log2(max(raw, 2))
    return _stage(
        flops=raw * passes * 4,  # compare/permute ops, not FMA flops
        bytes_=2.0 * raw * rec * passes,
        bound="sort",
        note=f"packed-key sort of {raw} records (~{passes:.0f} merge passes)",
    )


def covariance_model(n: int, k: int) -> dict:
    """GICP covariances: k-NN over a blocked N×N distance matmul (HIGH
    precision) + top-k select + (k·27·N) moment accumulation + 3×3
    eigendecomposition per point (~250 flops)."""
    matmul = 2.0 * 3 * n * n
    topk = 2.0 * n * n            # compare/select
    moments = 27.0 * k * n + 250.0 * n
    block = 512.0
    bytes_ = (n / block) * n * 3 * _F32 + n * (3 + 6) * _F32
    return _stage(
        flops=matmul + topk + moments,
        bytes_=bytes_,
        bound="fp32-cuda-core",
        note=f"kNN(k={k}) matmul + top-k + moments at N={n}",
    )


def icp_model(n: int, m: int, iterations: float, plane: bool,
              per_iter_nn: bool = True) -> dict:
    """GICP GN step: optional per-iteration NN sweep + SoA assembly
    (~200 flops/point for the fused 27-accumulator plane path, ~60 for
    Kabsch) + one 6×6 solve (negligible)."""
    assembly = (200.0 if plane else 60.0) * n * iterations
    out = _stage(0.0, 0.0, "fp32-cuda-core", "")
    if per_iter_nn:
        nn = nn_pairs_model(n, m, sweeps=iterations)
        out["flops"] = nn["flops"] + assembly
        out["bytes"] = nn["bytes"] + iterations * n * 15 * _F32
        out["note"] = f"{iterations:.1f} iters x ({nn['note']} + GN assembly)"
    else:
        out["flops"] = assembly
        out["bytes"] = iterations * n * 15 * _F32
        out["note"] = f"{iterations:.1f} fixed-correspondence GN iters at N={n}"
    return out


def scan_to_map_model(n: int, map_fill: int, iterations: float, plane: bool,
                      fixed_corr: bool) -> dict:
    """Refinement = one map-NN query (against the live fill, via
    valid_len) + the mapping ICP + one dedup/insert pass."""
    q = nn_pairs_model(n, max(map_fill, n))
    reg = icp_model(n, n, iterations, plane, per_iter_nn=not fixed_corr)
    insert = _stage(10.0 * n, 2.0 * n * 12 * _F32, "hbm", "append insert")
    return _stage(
        q["flops"] + reg["flops"] + insert["flops"],
        q["bytes"] + reg["bytes"] + insert["bytes"],
        "fp32-cuda-core" if not fixed_corr else "map-query+assembly",
        f"map NN at fill {map_fill} + {reg['note']}",
    )


def achieved(model: dict, ms: float, device_kind: Optional[str] = None) -> dict:
    """Achieved rates for a measured time, and the fractions of the
    device's peaks (None where the device or the unit has no peak)."""
    s = ms / 1e3
    gflops = model["flops"] / s / 1e9
    gbps = model["bytes"] / s / 1e9
    row = peaks(device_kind)
    frac_hbm = frac_compute = None
    if row is not None:
        frac_hbm = round(gbps / row["hbm_gbps"], 4)
        unit = _BOUND_UNIT.get(model["bound"], "fp32_cuda_core_tflops")
        frac_compute = round(gflops / (row[unit] * 1e3), 4)
    return {
        "ms": round(ms, 3),
        "gflops": round(gflops, 1),
        "gbps": round(gbps, 2),
        "frac_hbm": frac_hbm,
        "frac_compute": frac_compute,
        "bound": model["bound"],
        "note": model["note"],
    }


def stage_rooflines(
    stage_ms: Dict[str, float],
    raw_points: int,
    n_points: int,
    covariance_knn: int,
    odo_iterations: float,
    map_iterations: float,
    map_fill: int,
    plane: bool = True,
    mapping_fixed_corr: bool = True,
    device_kind: Optional[str] = None,
) -> Dict[str, dict]:
    """Roofline report for the bench's per-stage timings."""
    models = {
        "voxel_filter": voxel_filter_model(raw_points),
        "covariances": covariance_model(n_points, covariance_knn),
        "icp_odometry": icp_model(n_points, n_points, odo_iterations, plane),
        "scan_to_map_refine": scan_to_map_model(
            n_points, map_fill, map_iterations, plane, mapping_fixed_corr
        ),
    }
    return {
        name: achieved(models[name], ms, device_kind)
        for name, ms in stage_ms.items()
        if name in models
    }
