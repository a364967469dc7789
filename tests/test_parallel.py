"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

SURVEY.md §4: results must be bitwise-invariant to the mesh shape.
"""

import jax
import numpy as np
import pytest

from opticalflowclustering_tpu.features.grid import GridParams
from opticalflowclustering_tpu.parallel.mesh import make_mesh
from opticalflowclustering_tpu.parallel.temporal import (
    sharded_hue_pipeline,
    temporal_shard_flow,
)
from opticalflowclustering_tpu.pipeline.bounce import PipelineConfig, process_frames

pytestmark = pytest.mark.slow

RNG = np.random.default_rng(21)
# Small enough that the Farneback pyramid truncates to one level — the
# sharding semantics under test are identical, and CPU compiles stay fast.
FRAMES = RNG.integers(0, 256, size=(16, 40, 64, 3), dtype=np.uint8)


def test_make_mesh_shapes():
    m = make_mesh({"sp": 8})
    assert m.devices.shape == (8,)
    m2 = make_mesh({"dp": 2, "sp": -1})
    assert m2.devices.shape == (2, 4)
    assert m2.axis_names == ("dp", "sp")


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_pipeline_mesh_invariant(n_dev):
    mesh = make_mesh({"sp": n_dev}, devices=jax.devices()[:n_dev])
    hue, rgb_hue, mm = sharded_hue_pipeline(FRAMES, mesh)
    ref = process_frames(FRAMES, PipelineConfig(chunk=8))
    np.testing.assert_array_equal(np.asarray(hue)[:15], ref["hue_table"])
    np.testing.assert_array_equal(np.asarray(rgb_hue)[:15], ref["rgb_hue_table"])
    np.testing.assert_allclose(
        np.asarray(mm)[:15], ref["mean_magnitude"], rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("dp,sp", [(2, 4), (4, 2), (1, 8)])
def test_sharded_video_batch_pipeline_mesh_invariant(dp, sp):
    """dp×sp flagship pipeline over a video batch is bitwise equal to the
    unsharded emulation on every mesh shape."""
    from opticalflowclustering_tpu.parallel.temporal import (
        sharded_hue_pipeline_videos,
        unsharded_hue_pipeline_videos,
    )

    vids = RNG.integers(0, 256, size=(4, 8, 40, 64, 3), dtype=np.uint8)
    mesh = make_mesh({"dp": dp, "sp": sp})
    grid = GridParams(4, 6)
    sharded = sharded_hue_pipeline_videos(vids, mesh, grid=grid)
    # The library entry is a cached jit; the oracle must be jitted too —
    # an eager run dispatches op-by-op and XLA's whole-program fusion of
    # the float mean-magnitude telemetry differs at ~1e-7 (the hue
    # feature tables are integer math and bitwise either way).
    local = jax.jit(
        lambda v: unsharded_hue_pipeline_videos(v, grid=grid)
    )(vids)
    # Hue/centroid feature tables are integer math → bitwise on every mesh
    # shape. mean_magnitude is float telemetry: XLA fuses the hypot+mean
    # chain differently per local shard shape, so it is mesh-invariant
    # only to ~1 ulp.
    for s, l in zip(sharded[:3], local[:3]):
        np.testing.assert_array_equal(np.asarray(s), np.asarray(l))
    np.testing.assert_allclose(
        np.asarray(sharded[3]), np.asarray(local[3]), rtol=1e-6
    )


def test_temporal_shard_flow_matches_batched():
    from opticalflowclustering_tpu.flow.farneback import farneback_flow_batched
    from opticalflowclustering_tpu.ops.colorspace import bgr2gray

    mesh = make_mesh({"sp": 8})
    flow = np.asarray(temporal_shard_flow(FRAMES, mesh))[:15]
    gray = np.asarray(bgr2gray(FRAMES))
    want = np.asarray(farneback_flow_batched(gray))
    np.testing.assert_allclose(flow, want, atol=1e-5)


def test_fused_train_step_runs_and_learns():
    import optax

    from opticalflowclustering_tpu.flow.farneback import FarnebackParams
    from opticalflowclustering_tpu.models.bounce_classifier import init_classifier
    from opticalflowclustering_tpu.parallel.train import make_fused_train_step

    mesh = make_mesh({"dp": 2, "sp": 4})
    grid = GridParams(4, 6)
    model, params = init_classifier(jax.random.PRNGKey(0), grid.rows * grid.cols)
    tx = optax.adamw(1e-2)
    opt_state = tx.init(params)
    step = make_fused_train_step(
        mesh, model, tx, grid=grid, flow_params=FarnebackParams(levels=1)
    )
    videos = RNG.integers(0, 256, size=(4, 8, 64, 96, 3), dtype=np.uint8)
    labels = RNG.integers(0, 2, size=(4, 8)).astype(np.float32)
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, videos, labels)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


# --- multihost helpers: fast single-process unit coverage (the composed
# 2-process behavior runs in tests/test_multihost.py, marked slow) ---


def test_host_shard_explicit_args():
    from opticalflowclustering_tpu.parallel.multihost import host_shard

    items = ["a", "b", "c", "d", "e"]
    assert host_shard(items, process_id=0, num_processes=2) == ["a", "c", "e"]
    assert host_shard(items, process_id=1, num_processes=2) == ["b", "d"]
    # all shards partition the list exactly once
    n = 3
    shards = [host_shard(items, i, n) for i in range(n)]
    flat = [x for s in shards for x in s]
    assert sorted(flat) == sorted(items)
    # single process owns everything
    assert host_shard(items, 0, 1) == items


def test_global_mesh_and_local_submesh_single_process():
    from opticalflowclustering_tpu.parallel.multihost import (
        global_mesh,
        local_submesh,
    )

    mesh = global_mesh(sp=2)  # 8 CPU devices -> dp=4, sp=2
    assert mesh.shape == {"dp": 4, "sp": 2}
    # single-process: every dp row is local, so the submesh is the mesh
    sub = local_submesh(mesh)
    assert sub.shape == mesh.shape
    assert np.array_equal(
        np.vectorize(id)(sub.devices), np.vectorize(id)(mesh.devices)
    )
    with pytest.raises(ValueError, match="not divisible"):
        global_mesh(sp=3)


def test_initialize_env_fallbacks(monkeypatch):
    """initialize() forwards explicit args and falls back to the
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars
    (docs/ARCHITECTURE.md recipe) without touching a real cluster."""
    from opticalflowclustering_tpu.parallel import multihost

    seen = {}
    monkeypatch.setattr(
        multihost.jax.distributed,
        "initialize",
        lambda **kw: seen.update(kw),
    )
    multihost.initialize("host:1234", num_processes=2, process_id=1)
    assert seen == {
        "coordinator_address": "host:1234",
        "num_processes": 2,
        "process_id": 1,
    }

    seen.clear()
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "envhost:9")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    multihost.initialize()
    assert seen == {
        "coordinator_address": "envhost:9",
        "num_processes": 4,
        "process_id": 3,
    }

    seen.clear()
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    monkeypatch.delenv("JAX_NUM_PROCESSES")
    monkeypatch.delenv("JAX_PROCESS_ID")
    multihost.initialize()  # no args: JAX auto-detects the cluster
    assert seen == {}
