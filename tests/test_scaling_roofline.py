"""Coverage for the round-3 measurement subsystems: the scaling-efficiency
harness (BASELINE metric 4) and the speed-of-light accounting."""

import numpy as np
import pytest

from icpslam_tpu.utils import roofline


class TestScalingHarness:
    def test_ladder_format_and_efficiency_math(self):
        from icpslam_tpu.parallel import scaling

        rungs = scaling.measure_scaling(
            [1, 2], pairs_per_device=1, n_points=500, capacity=1024,
            repeats=1, solver_nodes=8, icp_mode="point",
        )
        assert [r["devices"] for r in rungs] == [1, 2]
        assert rungs[0]["efficiency"] == 1.0
        for r in rungs:
            assert r["scans_per_sec"] > 0
            assert r["pairs"] == r["devices"]  # weak scaling: 1 pair/device
            assert set(r["solve_ms"]) == {"direct", "pcg", "schur"}
            assert all(v > 0 for v in r["solve_ms"].values())
        # efficiency = per-device throughput vs the 1-device rung
        expect = (rungs[1]["scans_per_sec"] / 2) / rungs[0]["scans_per_sec"]
        assert abs(rungs[1]["efficiency"] - expect) < 1e-3
        # comm-vs-compute attribution present on every rung (VERDICT r3
        # weak #2): collective ablation leaves the knob reset afterwards
        from icpslam_tpu.parallel import dist_graph

        for r in rungs:
            assert r["compute_ms"] > 0
            assert r["collective_ms"] >= 0
            assert 0.0 <= r["collective_frac"] < 1.0
        assert dist_graph.ABLATE_COLLECTIVES is False

    def test_oversized_rungs_are_dropped(self):
        from icpslam_tpu.parallel import scaling

        rungs = scaling.measure_scaling(
            [1, 10 ** 6], pairs_per_device=1, n_points=400, capacity=1024,
            repeats=1, solver_nodes=8, icp_mode="point",
        )
        assert [r["devices"] for r in rungs] == [1]


H100 = "NVIDIA H100 80GB HBM3"


class TestRoofline:
    def test_stage_models_yield_sane_fractions(self):
        report = roofline.stage_rooflines(
            {"voxel_filter": 3.8, "covariances": 3.1,
             "icp_odometry": 3.6, "scan_to_map_refine": 13.6},
            raw_points=32768, n_points=8192, covariance_knn=10,
            odo_iterations=5.0, map_iterations=30.0, map_fill=12075,
            device_kind=H100,
        )
        assert set(report) == {
            "voxel_filter", "covariances", "icp_odometry", "scan_to_map_refine"
        }
        for name, r in report.items():
            assert 0 <= r["frac_hbm"] <= 1.0, (name, r)
            assert 0 <= r["frac_compute"] <= 1.0, (name, r)
            assert r["gflops"] >= 0 and r["gbps"] >= 0
            assert r["bound"]

    def test_faster_stage_scores_higher_fraction(self):
        m = roofline.nn_pairs_model(8192, 8192)
        fast = roofline.achieved(m, 0.26, H100)
        slow = roofline.achieved(m, 1.09, H100)
        assert fast["frac_compute"] > slow["frac_compute"]
        assert fast["gbps"] > slow["gbps"]

    def test_fixed_corr_model_removes_nn_traffic(self):
        with_nn = roofline.icp_model(8192, 8192, 10, plane=True, per_iter_nn=True)
        without = roofline.icp_model(8192, 8192, 10, plane=True, per_iter_nn=False)
        assert without["flops"] < with_nn["flops"] / 10
        assert without["bytes"] < with_nn["bytes"]

    def test_h100_peaks_are_the_data_sheet(self):
        row = roofline.peaks(H100)
        assert row["hbm_gbps"] == 3350.0
        assert row["bf16_tensor_tflops"] == 989.0
        assert row["tf32_tensor_tflops"] == 495.0
        assert row["fp32_cuda_core_tflops"] == 67.0

    @pytest.mark.parametrize("kind", [None, "cpu", "TFRT_CPU_0", "NVIDIA A100"])
    def test_unknown_device_gets_no_fraction(self, kind):
        assert roofline.peaks(kind) is None
        r = roofline.achieved(roofline.nn_pairs_model(8192, 8192), 0.5, kind)
        assert r["frac_hbm"] is None and r["frac_compute"] is None
        assert r["gflops"] > 0  # achieved rates are still reported
