"""Degenerate-input robustness of the full pipeline.

The production serving path must not emit NaN/Inf or crash on pathological
clips: constant frames (zero flow → zero-range normalize, guarded by
OpenCV's DBL_EPSILON rule, `ops/polar.py:normalize_minmax`), all-black
frames (threshold zeroes every pixel → alpha 0 → centroid 0/0 handled by
exact integer mean), and single-pair videos."""

import numpy as np

from opticalflowclustering_tpu.features.grid import GridParams
from opticalflowclustering_tpu.flow.farneback import FarnebackParams
from opticalflowclustering_tpu.pipeline.bounce import (
    PipelineConfig,
    process_frames,
)

CFG = PipelineConfig(
    chunk=3,
    grid=GridParams(4, 5),
    flow=FarnebackParams(levels=1),
    emit_flow_bgr=False,
)


def _check(out, n_pairs):
    assert out["hue_table"].shape[0] == n_pairs
    assert out["hue_table"].dtype == np.uint8
    assert np.all(out["hue_table"] < 180)
    assert np.all(np.isfinite(out["rgb_hue_table"]))
    assert np.all(np.isfinite(out["mean_magnitude"]))


def test_constant_frames_zero_flow():
    frames = np.full((5, 64, 96, 3), 127, np.uint8)
    out = process_frames(frames, CFG)
    _check(out, 4)
    # Identical frames → zero flow → zero magnitude everywhere.
    np.testing.assert_allclose(out["mean_magnitude"], 0.0, atol=1e-5)


def test_all_black_frames():
    frames = np.zeros((4, 64, 96, 3), np.uint8)
    out = process_frames(frames, CFG)
    _check(out, 3)


def test_all_white_frames():
    frames = np.full((4, 64, 96, 3), 255, np.uint8)
    out = process_frames(frames, CFG)
    _check(out, 3)


def test_single_pair_video():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    out = process_frames(frames, CFG)
    _check(out, 1)


def test_extreme_motion_does_not_nan():
    """A hard cut (uncorrelated frames) drives the solver to its spike
    regime — the out-of-image fallback must keep every output finite."""
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    frames = np.stack([a, b, a, b])
    out = process_frames(
        frames,
        PipelineConfig(
            chunk=3,
            grid=GridParams(4, 5),
            flow=FarnebackParams(levels=1),
            emit_flow_bgr=False,
        ),
    )
    _check(out, 3)
