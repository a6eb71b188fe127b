"""icpslam_tpu — a LIDAR SLAM engine in JAX/XLA/Pallas, run on NVIDIA GPUs.

A from-scratch reimplementation of the capabilities of the classic C++/ROS
``icpslam`` pipeline (GICP scan-to-scan odometry, octree scan-to-map
refinement, g2o pose-graph back-end) as a functional, fixed-shape,
jit-compiled pipeline:

- ``geometry``  — batched SE(3)/quaternion algebra (replaces Eigen + Pose6DOF)
- ``cloud``     — fixed-capacity padded point clouds + voxel-grid downsampling
                  (replaces PCL VoxelGrid)
- ``ops``       — ICP/GICP registration kernels: blocked matmul NN search,
                  weighted Kabsch, plane-to-plane Gauss-Newton
                  (replaces PCL GeneralizedIterativeClosestPoint)
- ``mapping``   — voxel-hash occupancy map with approx-NN queries
                  (replaces PCL OctreePointCloudSearch)
- ``graph``     — keyframe store + SE(3) pose-graph Gauss-Newton/LM solver
                  (replaces g2o via pose_graph_utils)
- ``pipeline``  — the SLAM orchestrator as a pure ``slam_step`` function
                  (replaces the ROS node + main loop)
- ``parallel``  — device-mesh sharding: distributed graph solve, sharded NN
- ``io``/``eval`` — synthetic worlds, KITTI loading, ATE/RPE metrics
"""

import jax as _jax

# SLAM is geometry-bound, not FLOPs-bound: every matmul in this package is
# either tiny (3x3/6x6 pose algebra, Jacobian/Hessian einsums) or a fused
# kernel with its own explicit precision. An accelerator's DEFAULT f32
# matmul precision truncates operands (TF32 on the GPU keeps 10 mantissa
# bits), which mis-selects NN correspondences, corrupts squared distances
# by O(|t||q|/2^10) at map-scale coordinates, and degrades every
# rotation-matrix product — for negligible speed gain at these shapes.
# Full-f32 is the only correct default here; kernels that can tolerate
# lower precision must request it explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")

from icpslam_tpu import geometry, cloud, ops, mapping, graph, pipeline, io, eval, parallel, utils, viz  # noqa: E402,F401
from icpslam_tpu.config import SlamConfig  # noqa: E402,F401

__version__ = "0.1.0"
