"""Start the flow→grid→hue pipeline on one NVIDIA GPU and check what it gives.

    python chip_smoke.py                # one GPU: phases A-D
    python chip_smoke.py --four-cards   # four GPUs: phase E only

Phases (one card):
  A  a 49-frame 1280×720 clip made from a seed runs through
     `pipeline.bounce.process_frames` (the library entry point the CLIs and
     the queue call), and its OutCSV table is written and read back;
  B  the same code on the CPU backend for the first 8 pairs is the plain
     reference: flow EPE, integer tables and the bounce match are compared;
  C  one 8-pair chunk at 1920×1080 and at 3840×2160: compile, run, memory;
  D  where a decoder exists, the committed MJPEG `demo_out/601_3.avi` runs
     through `process_video_stream` and is compared with the CPU path.
Phase E (`--four-cards`) runs the data-parallel queue
(`process_video_queue_dp`) on a dp=2 × sp=2 mesh and compares it with the
unsharded pipeline on one card.

Every check that fails ends the run with a non-zero exit code. The last line
of standard output is one JSON object, printed only when every phase passed.
With no GPU visible to JAX the script fails; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

CLIP = (49, 720, 1280)  # the canonical clip's geometry
LARGE = {"1080p": (1080, 1920), "2160p": (2160, 3840)}
CHUNK = 8
MAX_MEAN_EPE_PX = 1e-3
MIN_EQUAL_SHARE = 0.999
MAX_CENTROID_DIFF = 1
MAX_SIM_DIFF = 1e-6
DEMO_CLIP = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "demo_out", "601_3.avi")


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def make_clip(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """[n, h, w, 3] uint8 BGR frames with real motion: a smooth random
    texture panning 2 px right and 1 px down per frame, and a bright disc
    moving 12 px per frame on a sine track."""
    rng = np.random.default_rng(seed)
    s, k, pad = 8, 9, 2 * n + 16
    coarse = rng.random(((h + pad) // s + 2, (w + pad) // s + 2), np.float32)
    tex = np.kron(coarse, np.ones((s, s), np.float32))
    for axis in (0, 1):  # box-blur the blocks into a smooth texture
        c = np.cumsum(tex, axis=axis, dtype=np.float32)
        tex = (np.delete(c, np.s_[:k], axis) - np.delete(c, np.s_[-k:], axis)) / k
    tex = (tex - tex.min()) * (255.0 / (tex.max() - tex.min()))
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        g = tex[i : i + h, 2 * i : 2 * i + w]
        cy = h // 2 + int(h / 18 * np.sin(i / 4))
        cx = w // 5 + 12 * i
        g = np.where((yy - cy) ** 2 + (xx - cx) ** 2 < (h // 12) ** 2, 230.0, g)
        frames[i, ..., 0] = g
        frames[i, ..., 1] = 0.8 * g + 20
        frames[i, ..., 2] = 255 - g
    return frames


def flow_epe(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """(mean end-point error, max |Δ| over both components) of two flows."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.sqrt((d**2).sum(-1)).mean()), float(np.abs(d).max())


def equal_share(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a), np.asarray(b)
    check(a.shape == b.shape, f"shape {a.shape} vs {b.shape}")
    return float(np.mean(a == b))


def cosine_match_f64(signature, series) -> tuple[float, int]:
    """Sliding cosine match in float64 (`findCosineDifferentVectors.py`
    semantics: zero-norm windows score 0, the last window at the max wins)."""
    sig = np.asarray(signature, np.float64)
    ser = np.asarray(series, np.float64)
    best, frame = -np.inf, -1
    for i in range(len(ser) - len(sig) + 1):
        win = ser[i : i + len(sig)]
        den = np.linalg.norm(sig) * np.linalg.norm(win)
        sim = float(sig @ win / den) if den > 0 else 0.0
        if sim >= best:
            best, frame = sim, i
    return best, frame


def compare_tables(dev: dict, ref: dict, n: int, tag: str) -> str:
    """Integer tables of two runs over the same pairs: equal-cell shares
    and the largest centroid channel difference, checked against the
    bounds. Returns a one-line summary."""
    shares = {
        k: equal_share(dev[k][:n], ref[k][:n])
        for k in ("hue_table", "rgb_hue_table", "centroids")
    }
    cen_diff = int(np.abs(dev["centroids"][:n].astype(np.int64)
                          - ref["centroids"][:n].astype(np.int64)).max())
    for k, v in shares.items():
        check(v >= MIN_EQUAL_SHARE,
              f"{tag}: {k} only {v:.6f} equal to the CPU reference")
    check(cen_diff <= MAX_CENTROID_DIFF,
          f"{tag}: a centroid channel differs by {cen_diff}")
    return (f"equal cells hue {shares['hue_table']:.6f}, rgb_hue "
            f"{shares['rgb_hue_table']:.6f}, centroids "
            f"{shares['centroids']:.6f}; max centroid |Δ| {cen_diff}")


def check_tables(out: dict, n_pairs: int, cells: int, tag: str) -> None:
    check(out["hue_table"].shape == (n_pairs, cells),
          f"{tag}: hue_table shape {out['hue_table'].shape}")
    check(out["centroids"].shape == (n_pairs, cells, 4),
          f"{tag}: centroids shape {out['centroids'].shape}")
    check(int(out["hue_table"].max()) < 180, f"{tag}: hue out of range")
    check(float(out["rgb_hue_table"].max()) < 180, f"{tag}: rgb hue range")
    mm = out["mean_magnitude"]
    check(mm.shape == (n_pairs,) and bool(np.all(np.isfinite(mm))),
          f"{tag}: mean magnitude not finite")
    check(float(mm.max()) > 0.1, f"{tag}: no motion found ({mm.max()})")


def memory_line(compiled, device) -> str:
    ma = compiled.memory_analysis()
    stats = device.memory_stats() or {}
    return (f"argument {ma.argument_size_in_bytes} B, output "
            f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B, "
            f"code {ma.generated_code_size_in_bytes} B; peak_bytes_in_use "
            f"{stats.get('peak_bytes_in_use')}")


def phase_a(gpu, clip, cfg, card: str):
    """Main path at full size; returns (frames, tables)."""
    import jax

    from opticalflowclustering_tpu.compat.writers import write_hue_table_csv
    from opticalflowclustering_tpu.pipeline.bounce import (
        _stack_chunks,
        _video_step,
        process_frames,
    )

    frames = make_clip(*clip)
    n_pairs = frames.shape[0] - 1
    t = time.perf_counter()
    out = process_frames(frames, cfg)
    first = time.perf_counter() - t
    chunks, _ = _stack_chunks(frames, cfg.chunk)
    t = time.perf_counter()
    compiled = _video_step.lower(jax.device_put(chunks, gpu), cfg).compile()
    relower = time.perf_counter() - t
    times = []
    for _ in range(3):
        t = time.perf_counter()
        again = process_frames(frames, cfg)
        times.append(time.perf_counter() - t)
    cells = cfg.grid.rows * cfg.grid.cols
    check_tables(out, n_pairs, cells, "phase A")
    for k in out:
        check(np.array_equal(out[k], again[k]), f"phase A: {k} not repeatable")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "OutCSV", "clip.csv")
        write_hue_table_csv(path, out["hue_table"])
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
    check(rows[0] == [f"cell_{i}" for i in range(cells)], "phase A: header")
    check(np.array_equal(np.array(rows[1:], np.int64), out["hue_table"]),
          "phase A: OutCSV rows differ from the hue table")
    print(f"phase A: {frames.shape[0]} frames {clip[2]}x{clip[1]}, chunk "
          f"{cfg.chunk}: first call (compile + run) {first:.3f} s; "
          f"lower+compile again {relower:.3f} s")
    print(f"phase A: _video_step memory: {memory_line(compiled, gpu)}")
    print(f"phase A: first reading on {card}, not a benchmark: warm "
          f"process_frames {np.median(times):.4f} s for {n_pairs} pairs = "
          f"{n_pairs / np.median(times):.1f} pairs/s (3 runs: "
          f"{', '.join(f'{x:.4f}' for x in times)} s)")
    print(f"phase A ok: tables {out['hue_table'].shape}, mean |flow| "
          f"{float(out['mean_magnitude'].mean()):.3f} px, OutCSV "
          f"{len(rows) - 1} rows written and read back")
    return frames, out


def _flow_and_tables(chunk, cfg):
    from opticalflowclustering_tpu.flow.farneback import farneback_flow
    from opticalflowclustering_tpu.ops.colorspace import bgr2gray
    from opticalflowclustering_tpu.pipeline.bounce import chunk_step

    gray = bgr2gray(chunk)
    return farneback_flow(gray[:-1], gray[1:], cfg.flow), chunk_step(chunk, cfg)


def phase_b(gpu, cpu, frames, out, cfg) -> None:
    """The same `exact` code on the CPU backend for the first chunk."""
    import jax

    from opticalflowclustering_tpu.pipeline.bounce import classify_bounce

    fn = jax.jit(_flow_and_tables, static_argnames="cfg")
    chunk = frames[: cfg.chunk + 1]
    t = time.perf_counter()
    flow_cpu, ref = jax.device_get(fn(jax.device_put(chunk, cpu), cfg))
    t_cpu = time.perf_counter() - t
    flow_gpu, _ = jax.device_get(fn(jax.device_put(chunk, gpu), cfg))
    mean_epe, max_abs = flow_epe(flow_gpu, flow_cpu)
    check(mean_epe <= MAX_MEAN_EPE_PX,
          f"phase B: flow mean EPE {mean_epe} px vs CPU > {MAX_MEAN_EPE_PX}")
    print(f"phase B: flow GPU vs CPU over {cfg.chunk} pairs: mean EPE "
          f"{mean_epe:.3e} px, max |Δ| {max_abs:.3e} px (CPU run "
          f"{t_cpu:.1f} s incl. compile)")
    print("phase B: " + compare_tables(out, ref, cfg.chunk, "phase B"))

    # Bounce match: a per-frame hue series of the busiest cell against a
    # signature made from the seed, on the GPU vs float64 numpy.
    hue = out["hue_table"].astype(np.float64)
    series = hue[:, int(np.argmax(hue.std(axis=0)))]
    signature = np.random.default_rng(1).integers(
        0, 180, min(12, len(series) // 2))
    sim, frame = classify_bounce(signature, series)
    want_sim, want_frame = cosine_match_f64(signature, series)
    check(frame == want_frame,
          f"phase B: bounce frame {frame} vs float64 {want_frame}")
    check(abs(sim - want_sim) <= MAX_SIM_DIFF,
          f"phase B: bounce similarity {sim} vs float64 {want_sim}")
    print(f"phase B ok: bounce match frame {frame} (float64 {want_frame}), "
          f"similarity {sim:.9f} (float64 {want_sim:.9f})")


def phase_c(gpu, cfg, sizes) -> None:
    import jax

    from opticalflowclustering_tpu.pipeline.bounce import (
        _stack_chunks,
        _unpack_tables,
        _video_step,
    )

    cells = cfg.grid.rows * cfg.grid.cols
    for name, (h, w) in sizes.items():
        chunks, n_pairs = _stack_chunks(make_clip(cfg.chunk + 1, h, w, 1),
                                        cfg.chunk)
        x = jax.device_put(chunks, gpu)
        t = time.perf_counter()
        compiled = _video_step.lower(x, cfg).compile()
        t_compile = time.perf_counter() - t
        t = time.perf_counter()
        out = _unpack_tables(np.asarray(compiled(x)), n_pairs)
        t_run = time.perf_counter() - t
        check_tables(out, n_pairs, cells, f"phase C {name}")
        print(f"phase C ok: {name} {cfg.chunk}-pair chunk: compile "
              f"{t_compile:.1f} s, first run {t_run:.3f} s; "
              f"{memory_line(compiled, gpu)}")


def phase_d(cpu, cfg) -> None:
    """Decode the committed MJPEG clip; GPU stream path vs CPU path."""
    import importlib.util

    import jax

    from opticalflowclustering_tpu.io import fastio
    from opticalflowclustering_tpu.pipeline.bounce import (
        process_frames,
        process_video_stream,
    )

    have_cv2 = importlib.util.find_spec("cv2") is not None
    have_native = fastio.available()
    if not (have_cv2 or have_native):
        print("phase D: left out — no decoder here (cv2 absent, native "
              "decoder did not build)")
        return
    native = not have_cv2
    t = time.perf_counter()
    got = process_video_stream(DEMO_CLIP, cfg, native=native)
    t_stream = time.perf_counter() - t
    if native:
        frames = fastio.decode_mjpeg_avi(DEMO_CLIP)
    else:
        from opticalflowclustering_tpu.io.video import read_video_bgr

        frames = read_video_bgr(DEMO_CLIP)
    with jax.default_device(cpu):
        ref = process_frames(frames, cfg)
    n_pairs = frames.shape[0] - 1
    check_tables(got, n_pairs, cfg.grid.rows * cfg.grid.cols, "phase D")
    summary = compare_tables(got, ref, n_pairs, "phase D")
    print(f"phase D ok: {os.path.basename(DEMO_CLIP)} decoded by "
          f"{'the native decoder' if native else 'cv2'}, {frames.shape[0]} "
          f"frames {frames.shape[2]}x{frames.shape[1]}, stream path "
          f"{t_stream:.2f} s; vs CPU: {summary}")


def phase_e(devices, cfg, n_videos=2, clip=(16, 720, 1280)) -> None:
    """Data-parallel queue on a dp=2 × sp=2 mesh vs one card, unsharded."""
    import jax

    from opticalflowclustering_tpu.io.video import read_video_bgr, write_video_mjpg
    from opticalflowclustering_tpu.parallel.mesh import make_mesh
    from opticalflowclustering_tpu.parallel.temporal import (
        unsharded_hue_pipeline_videos,
    )
    from opticalflowclustering_tpu.pipeline import queue

    check(len(devices) >= 4, f"phase E needs 4 devices, found {len(devices)}")
    mesh = make_mesh({"dp": 2, "sp": 2}, devices=devices[:4])
    n = clip[0]
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for v in range(n_videos):
            paths.append(os.path.join(d, f"v{v}.avi"))
            write_video_mjpg(paths[-1], make_clip(*clip, seed=10 + v), 30.0)
        vids = np.stack([read_video_bgr(p) for p in paths])
        t = time.perf_counter()
        results = queue.process_video_queue_dp(
            paths, os.path.join(d, "features"), mesh, cfg
        )
        t_dp = time.perf_counter() - t
        check(all(r.ok for r in results), f"phase E: {results}")
        stats = dict(queue.LAST_DP_STATS)
        check(stats.get("batches") == 1 and stats.get("batch_failures") == 0,
              f"phase E: the mesh batch did not run: {stats}")
        got = [queue.load_features(r.path) for r in results]
    peaks = [(dev.memory_stats() or {}).get("peak_bytes_in_use")
             for dev in devices[:4]]
    want = jax.device_get(jax.jit(
        unsharded_hue_pipeline_videos, static_argnames=("grid", "params")
    )(jax.device_put(vids, devices[0]), grid=cfg.grid, params=cfg.flow))
    names = ("hue_table", "rgb_hue_table", "centroids")
    for i, g in enumerate(got):
        for name, w in zip(names, want[:3]):
            check(np.array_equal(g[name], w[i, : n - 1]),
                  f"phase E: video {i} {name} differs from one card")
        mm, wm = g["mean_magnitude"], want[3][i, : n - 1]
        check(np.allclose(mm, wm, rtol=1e-6, atol=0),
              f"phase E: video {i} mean magnitude differs beyond rtol 1e-6: "
              f"max rel {np.abs(mm - wm).max() / np.abs(wm).max():.2e}")
    if None not in peaks:  # the CPU backend keeps no memory statistics
        check(min(peaks[1:]) > 0.25 * peaks[0],
              f"phase E: work landed on device 0 only (peak bytes {peaks})")
    print(f"phase E ok: {n_videos} videos x {n} frames {clip[2]}x{clip[1]} "
          f"on a dp=2 x sp=2 mesh in {t_dp:.1f} s (decode + compile + run); "
          f"integer tables bitwise equal to one card, mean magnitude within "
          f"rtol 1e-6; peak bytes per device {peaks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase E")
    args = ap.parse_args(argv)

    # The device path runs on the GPU; the CPU backend is there for the
    # reference. Set before JAX is first imported.
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    import jax

    try:
        gpus = jax.devices("gpu")
    except RuntimeError as e:
        print(f"chip_smoke: no GPU visible to JAX: {e}", file=sys.stderr)
        return 1
    cpu = jax.devices("cpu")[0]
    from opticalflowclustering_tpu.pipeline.bounce import PipelineConfig
    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    card = smi.splitlines()[0] if smi else gpus[0].device_kind
    print(smi)
    print(f"device_kind {gpus[0].device_kind} x{len(gpus)}; jax "
          f"{jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
          f"compile cache {cache}")
    cfg = PipelineConfig(chunk=CHUNK, emit_flow_bgr=False)
    t0 = time.perf_counter()
    try:
        if args.four_cards:
            phase_e(gpus, cfg)
        else:
            frames, out = phase_a(gpus[0], CLIP, cfg, card)
            phase_b(gpus[0], cpu, frames, out, cfg)
            phase_c(gpus[0], cfg, LARGE)
            phase_d(cpu, cfg)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
