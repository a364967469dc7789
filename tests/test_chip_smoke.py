"""chip_smoke.py on the CPU: its comparison helpers, each phase at a tiny
size with CPU devices standing in for the card, and its refusal to run
without a GPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from opticalflowclustering_tpu.features.grid import GridParams
from opticalflowclustering_tpu.pipeline.bounce import (
    PipelineConfig,
    classify_bounce,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = PipelineConfig(chunk=4, emit_flow_bgr=False, grid=GridParams(4, 6))


def test_flow_epe_and_equal_share():
    a = np.zeros((2, 3, 4, 2), np.float32)
    b = a.copy()
    b[0, 0, 0] = [3.0, 4.0]
    mean_epe, max_abs = chip_smoke.flow_epe(a, b)
    assert mean_epe == pytest.approx(5.0 / 24)
    assert max_abs == 4.0
    assert chip_smoke.equal_share(np.arange(4), np.array([0, 1, 2, 9])) == 0.75
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.equal_share(np.arange(4), np.arange(5))


def test_cosine_match_f64_agrees_with_classify_bounce():
    rng = np.random.default_rng(3)
    series = rng.integers(0, 180, 60).astype(np.float64)
    series[20:26] = 0.0  # zero-norm windows score 0
    signature = series[40:48].copy()
    sim, frame = chip_smoke.cosine_match_f64(signature, series)
    assert frame == 40 and sim == pytest.approx(1.0)
    got_sim, got_frame = classify_bounce(signature, series)
    assert got_frame == frame and abs(got_sim - sim) <= 1e-6
    # last tie wins, as in findCosineDifferentVectors.py
    assert chip_smoke.cosine_match_f64([1.0, 1.0], [2, 2, 2, 2]) == (
        pytest.approx(1.0), 2,
    )


@pytest.mark.parametrize(
    "change, passes",
    [(None, True), ("one_cell", True), ("six_cells", False),
     ("centroid_by_2", False)],
)
def test_compare_tables_bounds(change, passes):
    rng = np.random.default_rng(0)
    ref = {
        "hue_table": rng.integers(0, 180, (8, 350)),
        "rgb_hue_table": rng.integers(0, 180, (8, 350)).astype(np.float32),
        "centroids": rng.integers(0, 256, (8, 350, 4)),
    }
    dev = {k: v.copy() for k, v in ref.items()}
    if change == "one_cell":  # 2799 of 2800 cells equal: 99.96%
        dev["hue_table"][0, 0] += 1
    elif change == "six_cells":  # 2794 of 2800: 99.79%, under 99.9%
        dev["hue_table"][1, :6] += 1
    elif change == "centroid_by_2":
        dev["centroids"][0, 0, 0] += 2
    if passes:
        assert "equal cells hue" in chip_smoke.compare_tables(dev, ref, 8, "t")
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.compare_tables(dev, ref, 8, "t")


def test_make_clip_has_motion_and_is_seeded():
    a = chip_smoke.make_clip(4, 48, 80)
    assert a.shape == (4, 48, 80, 3) and a.dtype == np.uint8
    assert np.array_equal(a, chip_smoke.make_clip(4, 48, 80))
    assert not np.array_equal(a, chip_smoke.make_clip(4, 48, 80, seed=1))
    assert not np.array_equal(a[0], a[1])


def test_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_phases_a_to_c_on_cpu(capsys):
    cpu = jax.devices("cpu")[0]
    frames, out = chip_smoke.phase_a(cpu, (9, 64, 96), CFG, "cpu")
    assert out["hue_table"].shape == (8, 24)
    chip_smoke.phase_b(cpu, cpu, frames, out, CFG)
    chip_smoke.phase_c(cpu, CFG, {"small": (72, 128)})
    text = capsys.readouterr().out
    for tag in ("phase A ok", "phase B ok", "phase C ok: small"):
        assert tag in text
    assert "mean EPE 0.000e+00" in text


def test_phase_d_decodes_demo_clip(capsys):
    pytest.importorskip("cv2")
    chip_smoke.phase_d(jax.devices("cpu")[0], CFG)
    assert "phase D ok: 601_3.avi decoded by cv2" in capsys.readouterr().out


def test_phase_e_on_four_virtual_devices(capsys):
    pytest.importorskip("cv2")
    chip_smoke.phase_e(jax.devices(), CFG, clip=(8, 64, 96))
    out = capsys.readouterr().out
    assert "phase E ok" in out and "bitwise equal" in out


@pytest.mark.parametrize("fault", ["hue_range", "nan_magnitude", "still"])
def test_check_tables_rejects_bad_output(fault):
    rng = np.random.default_rng(0)
    out = {
        "hue_table": rng.integers(0, 180, (4, 6)),
        "rgb_hue_table": rng.integers(0, 180, (4, 6)).astype(np.float32),
        "centroids": rng.integers(0, 256, (4, 6, 4)),
        "mean_magnitude": np.full(4, 2.0, np.float32),
    }
    chip_smoke.check_tables(out, 4, 6, "t")
    if fault == "hue_range":
        out["hue_table"][0, 0] = 180
    elif fault == "nan_magnitude":
        out["mean_magnitude"][1] = np.nan
    else:
        out["mean_magnitude"][:] = 0.0
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_tables(out, 4, 6, "t")
