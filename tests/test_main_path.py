"""The main path (frames → process_frames → OutCSV) needs nothing beyond
JAX, NumPy, SciPy and the standard library, and the compile cache lives
where one helper says."""

import os
import subprocess
import sys

import jax
import pytest

from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_RUN = r"""
import sys
for name in ("cv2", "pandas", "flax", "sklearn"):
    sys.modules[name] = None  # any import of these now raises ImportError
import csv, os, tempfile
import numpy as np
import chip_smoke
from opticalflowclustering_tpu.compat.writers import write_hue_table_csv
from opticalflowclustering_tpu.features.grid import GridParams
from opticalflowclustering_tpu.pipeline.bounce import PipelineConfig, process_frames

frames = chip_smoke.make_clip(5, 64, 96)
out = process_frames(frames, PipelineConfig(chunk=2, grid=GridParams(4, 6), emit_flow_bgr=False))
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "OutCSV", "clip.csv")
    write_hue_table_csv(path, out["hue_table"])
    rows = list(csv.reader(open(path)))
assert len(rows) == 5 and len(rows[0]) == 24, rows[:2]
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("cv2", "pandas", "flax", "sklearn") and sys.modules[m] is not None)
assert not loaded, loaded
print("main path ok")
"""


def test_main_path_runs_with_cv2_pandas_flax_sklearn_blocked():
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "main path ok" in r.stdout


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(tmp_path, monkeypatch, env_set):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        want = str(tmp_path / "c")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    try:
        assert enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
