"""Card tests: the GPU against the CPU backend at small widths.

Run on a machine with an NVIDIA GPU:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

Elsewhere every test here skips (the `gpu_device` fixture decides).
Bounds: flow mean EPE ≤ 1e-3 px and ≥ 99.9% of integer table cells equal
(the sources of difference are FMA contraction, reduction order and the
GPU's transcendental functions); matrix products run in full f32, so they
agree with the CPU to f32 rounding — a TF32 product would be off by ~1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from opticalflowclustering_tpu.cluster.kmeans import _pairwise_sqdist, kmeans
from opticalflowclustering_tpu.cluster.matcher import (
    cosine_similarity_matrix,
    sliding_cosine_similarity,
)
from opticalflowclustering_tpu.features.grid import GridParams
from opticalflowclustering_tpu.ops.slic import slic
from opticalflowclustering_tpu.pipeline.bounce import (
    PipelineConfig,
    classify_bounce,
)

pytestmark = pytest.mark.gpu

CFG = PipelineConfig(chunk=4, emit_flow_bgr=False, grid=GridParams(4, 6))


@pytest.fixture
def gpu_device():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")


def _on(device, fn, *args):
    with jax.default_device(device):
        return jax.device_get(fn(*args))


def _cpu():
    return jax.devices("cpu")[0]


def test_flow_and_tables_match_cpu(gpu_device):
    frames = chip_smoke.make_clip(CFG.chunk + 1, 120, 160)
    fn = jax.jit(chip_smoke._flow_and_tables, static_argnames="cfg")
    flow_g, tab_g = _on(gpu_device, lambda f: fn(f, CFG), frames)
    flow_c, tab_c = _on(_cpu(), lambda f: fn(f, CFG), frames)
    mean_epe, _ = chip_smoke.flow_epe(flow_g, flow_c)
    assert mean_epe <= chip_smoke.MAX_MEAN_EPE_PX
    chip_smoke.compare_tables(tab_g, tab_c, CFG.chunk, "gpu test")


def test_bounce_match_matches_float64(gpu_device):
    rng = np.random.default_rng(5)
    series = rng.integers(0, 180, 300).astype(np.float64)
    signature = series[137:149] + rng.integers(-3, 4, 12)
    sim, frame = _on(gpu_device, classify_bounce, signature, series)
    want_sim, want_frame = chip_smoke.cosine_match_f64(signature, series)
    assert frame == want_frame
    assert abs(sim - want_sim) <= chip_smoke.MAX_SIM_DIFF


@pytest.mark.parametrize(
    "fn",
    [
        lambda a, b: sliding_cosine_similarity(a[0, :40], a.ravel()),
        cosine_similarity_matrix,
        _pairwise_sqdist,
    ],
    ids=["sliding_cosine", "cosine_matrix", "kmeans_sqdist"],
)
def test_matmuls_run_in_full_f32(gpu_device, fn):
    rng = np.random.default_rng(0)
    a = rng.random((256, 64), np.float32) * 180
    b = rng.random((32, 64), np.float32) * 180
    got = _on(gpu_device, jax.jit(fn), a, b)
    want = _on(_cpu(), jax.jit(fn), a, b)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6 * np.abs(want).max())


def test_kmeans_labels_match_cpu(gpu_device):
    rng = np.random.default_rng(1)
    centers = rng.random((6, 4), np.float32) * 255
    pts = centers[rng.integers(0, 6, 4000)] + rng.normal(0, 20, (4000, 4))
    pts = jnp.asarray(pts.astype(np.float32))
    run = jax.jit(lambda p: kmeans(p, 6, jax.random.PRNGKey(0), n_iter=20))
    c_g, l_g = _on(gpu_device, run, pts)
    c_c, l_c = _on(_cpu(), run, pts)
    assert np.mean(l_g == l_c) >= 0.999
    np.testing.assert_allclose(c_g, c_c, rtol=1e-4, atol=1e-3)


def test_slic_labels_match_cpu(gpu_device):
    img = chip_smoke.make_clip(1, 96, 128)[0]
    run = jax.jit(lambda x: slic(x, n_segments=48))
    assert np.mean(_on(gpu_device, run, img) == _on(_cpu(), run, img)) >= 0.999
