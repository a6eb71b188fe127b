"""Offline visualization exports — the rviz-profile replacement.

The reference's only visualization is live rviz displays of its ~15 topics
plus pose-graph MarkerArrays with id-ramped colors and elevated loop edges
(``/root/reference/src/icpslam/icpslam.cpp:191-280``,
``rviz/live_slam.rviz``). This pipeline is headless; the equivalent
products are files any viewer (CloudCompare, meshlab, evo, a notebook)
can read:

- ``save_ply``           — point clouds / the voxel map (binary PLY)
- ``export_trajectory_tum`` — TUM-format trajectories (evo-compatible)
- ``export_pose_graph_json`` — nodes + edges with the reference's marker
  semantics preserved as data: per-node color ramp position and the
  loop-edge flag (the reference's |id₁−id₂| > 2 elevation heuristic,
  ``icpslam.cpp:263-266``)
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np

from icpslam_tpu.cloud import pointcloud as pc
from icpslam_tpu.geometry.se3 import Pose


def save_ply(path: str, cloud: pc.PointCloud, colors: Optional[np.ndarray] = None) -> int:
    """Write the valid points of a cloud as binary little-endian PLY.

    Returns the number of points written.
    """
    pts = pc.to_numpy(cloud).astype("<f4")
    n = pts.shape[0]
    has_color = colors is not None
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
                  "property float x", "property float y", "property float z"]
        if has_color:
            header += ["property uchar red", "property uchar green", "property uchar blue"]
        header.append("end_header")
        f.write(("\n".join(header) + "\n").encode())
        if has_color:
            cols = np.asarray(colors, np.uint8)[: n]
            for i in range(n):
                f.write(struct.pack("<fff", *pts[i]) + struct.pack("BBB", *cols[i]))
        else:
            f.write(pts.tobytes())
    return n


def export_trajectory_tum(path: str, poses: Pose, stamps=None) -> int:
    """TUM format: ``stamp tx ty tz qx qy qz qw`` per line (evo-compatible)."""
    t = np.asarray(poses.t)
    q = np.asarray(poses.q)  # wxyz internally
    n = t.shape[0]
    stamps = np.arange(n, dtype=np.float64) if stamps is None else np.asarray(stamps)
    with open(path, "w") as f:
        for i in range(n):
            f.write(
                f"{stamps[i]:.6f} {t[i,0]:.6f} {t[i,1]:.6f} {t[i,2]:.6f} "
                f"{q[i,1]:.6f} {q[i,2]:.6f} {q[i,3]:.6f} {q[i,0]:.6f}\n"
            )
    return n


def export_pose_graph_json(path: str, state, config=None) -> dict:
    """Dump the keyframe graph: nodes (id, stamp, pose, color-ramp t) and
    edges (i, j, type) where type ∈ {'sequential','loop'} via the
    reference's id-gap heuristic."""
    store = state.keyframes
    n = int(store.count)
    t = np.asarray(store.pose_graph.t)[:n]
    q = np.asarray(store.pose_graph.q)[:n]
    stamps = np.asarray(store.stamp)[:n]
    # per-keyframe measurement covariance diagonal (Pose6DOF parity,
    # ``pose6DOF.h:15-126``); all-zero rows mean "not recorded"
    cov_diag = np.einsum("kii->ki", np.asarray(store.cov)[:n])
    nodes = [
        {
            "id": i,
            "stamp": float(stamps[i]),
            "t": [float(x) for x in t[i]],
            "q_wxyz": [float(x) for x in q[i]],
            "cov_diag": [float(x) for x in cov_diag[i]],
            # id-proportional color ramp position (``icpslam.cpp:260-275``)
            "ramp": i / max(n - 1, 1),
        }
        for i in range(n)
    ]
    ecount = int(state.edges.count)
    ei = np.asarray(state.edges.i)[:ecount]
    ej = np.asarray(state.edges.j)[:ecount]
    valid = np.asarray(state.edges.valid)[:ecount]
    edges = []
    for k in range(ecount):
        if not valid[k]:
            continue
        gap = abs(int(ej[k]) - int(ei[k]))
        edges.append(
            {
                "i": int(ei[k]),
                "j": int(ej[k]),
                # loop-edge heuristic |id1-id2| > 2 (``icpslam.cpp:263``)
                "type": "loop" if gap > 2 else "sequential",
            }
        )
    doc = {
        "nodes": nodes,
        "edges": edges,
        "num_loop_closures": int(state.num_loop_closures),
        "num_optimizations": int(state.num_optimizations),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc
