"""Fused NN kernel (Pallas through Triton) in interpret mode on the CPU,
the plain path against float64 brute force, and the kernel choice.

The same kernel runs compiled on the GPU; ``chip_smoke.py`` checks it there
at real widths against the plain path."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icpslam_tpu.ops import nn as nn_ops
from icpslam_tpu.ops.pallas.nn_kernel import nearest_neighbors_triton

# small tiles so a few hundred points span several programs and loop
# steps; every tiling must give the same, exact answer
KERNELS = [
    functools.partial(nearest_neighbors_triton, bq=bq, bt=bt, interpret=True)
    for bq, bt in ((32, 64), (16, 32))
]
IDS = ["32x64", "16x32"]


def brute(q, t, tm):
    d = ((np.asarray(q, np.float64)[:, None]
          - np.asarray(t, np.float64)[None]) ** 2).sum(-1)
    d[:, ~np.asarray(tm)] = np.inf
    return d


@pytest.mark.parametrize("kernel", KERNELS, ids=IDS)
class TestPallasNN:
    def test_matches_xla_path(self, kernel):
        rng = np.random.RandomState(0)
        q = jnp.asarray(rng.randn(512, 3), jnp.float32)
        t = jnp.asarray(rng.randn(512, 3), jnp.float32)
        tm = jnp.asarray(rng.rand(512) > 0.2)
        ref = nn_ops.nearest_neighbors(q, t, tm, fused=False)
        got = kernel(q, t, tm)
        np.testing.assert_array_equal(np.asarray(got.idx), np.asarray(ref.idx))
        np.testing.assert_allclose(
            np.asarray(got.dist2), np.asarray(ref.dist2), atol=1e-4
        )

    def test_far_from_origin(self, kernel):
        # map frames drift far from the origin: the subtraction form must
        # select exactly with no re-centring
        rng = np.random.RandomState(11)
        q = jnp.asarray(rng.randn(512, 3) * 5 + 300.0, jnp.float32)
        t = jnp.asarray(rng.randn(512, 3) * 5 + 300.0, jnp.float32)
        d = brute(q, t, np.ones(512, bool))
        got = kernel(q, t, jnp.ones(512, bool))
        np.testing.assert_array_equal(np.asarray(got.idx), d.argmin(1))
        np.testing.assert_allclose(np.asarray(got.dist2), d.min(1), rtol=1e-5,
                                   atol=1e-5)

    def test_all_masked_targets(self, kernel):
        got = kernel(jnp.zeros((256, 3)), jnp.ones((128, 3)),
                     jnp.zeros(128, bool))
        assert np.all(np.isinf(np.asarray(got.dist2)))

    def test_valid_len_prefix_matches_masked(self, kernel):
        # a prefix-filled buffer with valid_len gives the same result as
        # masking alone (and never visits the dead tiles)
        rng = np.random.RandomState(7)
        q = jnp.asarray(rng.randn(256, 3), jnp.float32)
        t = jnp.asarray(rng.randn(512, 3), jnp.float32)
        live = 200  # not tile-aligned on purpose
        tm = jnp.arange(512) < live
        ref = nn_ops.nearest_neighbors(q, t, tm, fused=False)
        got = kernel(q, t, tm, valid_len=jnp.asarray(live, jnp.int32))
        np.testing.assert_array_equal(np.asarray(got.idx), np.asarray(ref.idx))
        np.testing.assert_allclose(
            np.asarray(got.dist2), np.asarray(ref.dist2), atol=1e-4
        )

    def test_valid_len_zero_all_inf(self, kernel):
        got = kernel(jnp.zeros((256, 3)), jnp.ones((256, 3)),
                     jnp.zeros(256, bool), valid_len=jnp.asarray(0, jnp.int32))
        assert np.all(np.isinf(np.asarray(got.dist2)))

    def test_aabb_skip_spatially_sorted(self, kernel):
        # voxel-key-sorted slabs: the layout where pruning skips the most
        # tiles must still give exact results
        rng = np.random.RandomState(21)
        base = np.sort(rng.uniform(0, 40, 1024)).astype(np.float32)
        q = np.stack([base, rng.randn(1024).astype(np.float32),
                      rng.randn(1024).astype(np.float32)], -1)
        t = q + rng.randn(1024, 3).astype(np.float32) * 0.05
        t = t[np.argsort(t[:, 0])]
        qj, tj = jnp.asarray(q), jnp.asarray(t)
        tm = jnp.ones(1024, bool)
        d = brute(q, t, np.ones(1024, bool))
        got = kernel(qj, tj, tm)
        np.testing.assert_array_equal(np.asarray(got.idx), d.argmin(1))
        np.testing.assert_allclose(np.asarray(got.dist2), d.min(1), atol=1e-5)

    def test_aabb_skip_with_valid_len(self, kernel):
        # pruning + live-prefix walking together
        rng = np.random.RandomState(22)
        q = np.sort(rng.uniform(0, 20, 512)).astype(np.float32)
        q = np.stack([q, np.zeros(512, np.float32), np.zeros(512, np.float32)], -1)
        t = np.concatenate([q[:384] + 0.01, np.zeros((128, 3), np.float32)])
        tm = jnp.arange(512) < 384
        qj, tj = jnp.asarray(q), jnp.asarray(t)
        ref = nn_ops.nearest_neighbors(qj, tj, tm, fused=False)
        got = kernel(qj, tj, tm, valid_len=jnp.asarray(384))
        np.testing.assert_array_equal(np.asarray(got.idx), np.asarray(ref.idx))
        np.testing.assert_allclose(
            np.asarray(got.dist2), np.asarray(ref.dist2), atol=1e-4
        )

    def test_far_outlier_queries_exact(self, kernel):
        # queries far from every target (registration outliers) still get
        # their exact nearest target: the kernel has no don't-care radius
        rng = np.random.RandomState(30)
        t = np.sort(rng.uniform(0, 10, 512)).astype(np.float32)
        t = np.stack([t, np.zeros(512, np.float32), np.zeros(512, np.float32)], -1)
        qn = t[::2] + 0.01
        qf = qn.copy()
        qf[:, 0] += 500.0  # hopeless outliers
        q = np.concatenate([qn, qf])
        d2f = brute(q, t, np.ones(512, bool))
        got = kernel(jnp.asarray(q), jnp.asarray(t), jnp.ones(512, bool))
        np.testing.assert_array_equal(np.asarray(got.idx), d2f.argmin(1))
        np.testing.assert_allclose(np.asarray(got.dist2), d2f.min(1),
                                   rtol=1e-5, atol=1e-5)

    def test_odd_shapes_are_padded_and_exact(self, kernel):
        # any N and M: both are padded to whole tiles inside the wrapper
        rng = np.random.RandomState(5)
        q = rng.randn(100, 3).astype(np.float32)
        t = rng.randn(77, 3).astype(np.float32)
        tm = rng.rand(77) > 0.1
        d = brute(q, t, tm)
        got = kernel(jnp.asarray(q), jnp.asarray(t), jnp.asarray(tm))
        assert got.idx.shape == (100,) and got.dist2.shape == (100,)
        np.testing.assert_array_equal(np.asarray(got.idx), d.argmin(1))
        np.testing.assert_allclose(np.asarray(got.dist2), d.min(1), atol=1e-5)


def test_dispatcher_fallback_on_cpu():
    # on the CPU the dispatcher takes the plain path
    q = jnp.zeros((256, 3))
    t = jnp.ones((512, 3))
    res = nn_ops.nearest_neighbors(q, t, jnp.ones(512, bool))
    assert res.idx.shape == (256,)


@pytest.mark.parametrize("platform,fused", [
    ("gpu", True), ("cuda", True), ("cpu", False), ("rocm", False),
])
def test_kernel_choice_per_platform(monkeypatch, platform, fused):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert nn_ops.fused_nn_enabled() is fused
    assert nn_ops.fused_nn_enabled(platform) is fused


def test_kernel_choice_follows_default_device(monkeypatch):
    # a CPU-placed computation in a GPU process takes the plain path
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with jax.default_device(jax.devices("cpu")[0]):
        assert nn_ops.fused_nn_enabled() is False
    assert nn_ops.fused_nn_enabled() is True


def test_dispatcher_routes_to_kernel_when_chosen(monkeypatch):
    calls = []

    def fake(query, target, target_mask, valid_len=None):
        calls.append(valid_len)
        return nn_ops.NNResult(jnp.zeros(query.shape[0], jnp.int32),
                               jnp.zeros(query.shape[0]))

    from icpslam_tpu.ops.pallas import nn_kernel

    monkeypatch.setattr(nn_kernel, "nearest_neighbors_triton", fake)
    monkeypatch.setattr(nn_ops, "fused_nn_enabled", lambda platform=None: True)
    nn_ops.nearest_neighbors(jnp.zeros((8, 3)), jnp.ones((16, 3)),
                             jnp.ones(16, bool), valid_len=5)
    assert calls == [5]


def test_kernel_under_vmap():
    # loop-closure verification batches NN over candidates with vmap
    rng = np.random.RandomState(9)
    q = jnp.asarray(rng.randn(2, 96, 3), jnp.float32)
    t = jnp.asarray(rng.randn(2, 160, 3), jnp.float32)
    tm = jnp.asarray(rng.rand(2, 160) > 0.1)
    got = jax.vmap(lambda a, b, c: nearest_neighbors_triton(
        a, b, c, bq=32, bt=64, interpret=True))(q, t, tm)
    for k in range(2):
        d = brute(q[k], t[k], tm[k])
        np.testing.assert_array_equal(np.asarray(got.idx[k]), d.argmin(1))


@pytest.mark.parametrize("case", ["masked", "far", "valid_len", "ties"])
def test_plain_path_matches_float64(case):
    rng = np.random.RandomState(40)
    q = rng.randn(300, 3).astype(np.float32)
    t = rng.randn(200, 3).astype(np.float32)
    tm = np.ones(200, bool)
    vl = None
    if case == "masked":
        tm = rng.rand(200) > 0.3
    elif case == "far":
        q, t = q + 250.0, t + 250.0
    elif case == "valid_len":
        tm[150:] = False
        vl = jnp.int32(150)
    else:  # exact duplicate targets: the lowest index wins
        t[100:] = t[:100]
    res = nn_ops.nearest_neighbors(jnp.asarray(q), jnp.asarray(t),
                                   jnp.asarray(tm), block=128, fused=False,
                                   valid_len=vl)
    d = brute(q, t, tm)
    np.testing.assert_array_equal(np.asarray(res.idx), d.argmin(1))
    # the plain path's |q|² − 2q·t + |t|² form carries f32 cancellation
    # error proportional to the squared coordinates about the centroid
    tol = 1e-4 if case != "far" else 2e-3
    np.testing.assert_allclose(np.asarray(res.dist2), d.min(1), atol=tol)


@pytest.mark.gpu
def test_kernel_compiled_on_card(gpu_device):
    rng = np.random.RandomState(1)
    q = jax.device_put(jnp.asarray(rng.randn(1000, 3), jnp.float32), gpu_device)
    t = jax.device_put(jnp.asarray(rng.randn(3000, 3), jnp.float32), gpu_device)
    tm = jnp.ones(3000, bool)
    got = nearest_neighbors_triton(q, t, tm)
    d = brute(q, t, np.ones(3000, bool))
    np.testing.assert_array_equal(np.asarray(got.idx), d.argmin(1))
