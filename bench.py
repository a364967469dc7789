"""End-to-end benchmark: flow→grid→cluster frames/sec on one GPU vs the
reference's OpenCV/sklearn CPU loop.

Prints ONE JSON line:
  {"metric": ..., "value": <device fps>, "unit": "frames/sec/device",
   "vs_baseline": <device fps / reference cpu fps>, "device": {...}}

Fails when JAX finds no GPU: a CPU number is never reported as a device
number.

The workload mirrors the canonical eval clip (49 frames of 1280×720,
`601_bad_bounce_3` — its mp4 is an LFS stub, so frames are synthesized
deterministically at the same geometry). The CPU baseline is a faithful
re-enactment of the reference's per-frame loop (`KmeanGrids.py:180-239` +
phase 2): cv2 Farneback → HSV render → 350 cell slices → per-cell
sklearn KMeans(k=1) → hue, timed over 10 frames and scaled.

Flow accuracy of the benched config is reported as the worst mean EPE vs cv2 over 27 real
high-motion frame pairs from the committed reference footage
(images/601_3_cropped_{3,4,6}_OF), falling back to the synthetic clip when
the reference tree is unavailable.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REF = "/root/reference/k-means-color-clustering"

H, W, N = 720, 1280, 49
GRID_ROWS, GRID_COLS = 14, 25


def synth_frames(n=N, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    import cv2

    bg = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    bg = cv2.GaussianBlur(bg, (0, 0), 3)
    frames = []
    for i in range(n):
        f = bg.copy()
        cv2.circle(f, (100 + 20 * i, 300 + int(8 * np.sin(i / 3))), 25,
                   (40, 200, 220), -1)
        frames.append(f)
    return np.stack(frames)


def noise_frames(n=N, h=H, w=W, seed=7):
    """Pathological-motion input: per-frame independent uniform noise —
    zero temporal correlation, so the warp's gathers scatter as widely as
    they can. Reported alongside the headline so the number can't be gamed
    by easy input."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)


def real_footage_frames(n=N, h=H, w=W):
    """Bench input with REAL motion statistics: the committed reference
    footage `images/601_3_cropped_3_OF` (75 frames, 232×220) tiled
    spatially to the bench geometry. Tiling preserves the per-pixel flow
    field exactly (every tile sees the same motion), so the warp's
    data-dependent gather pattern is measured at the real footage's
    statistics rather than bracketed between smooth-synthetic and
    pure-noise inputs."""
    import cv2

    fs = sorted(glob.glob(f"{REF}/images/601_3_cropped_3_OF/*.png"))
    if not fs:
        return None  # partial checkout — caller skips the datapoint
    # Decode (and tile) each unique file once; frames beyond the footage
    # length reuse the tiled arrays instead of re-reading the PNGs.
    uniq = [cv2.imread(f) for f in fs[: min(n, len(fs))]]
    if any(f is None for f in uniq):
        return None  # unreadable/corrupt PNG — skip rather than die mid-bench
    ty = -(-h // uniq[0].shape[0])
    tx = -(-w // uniq[0].shape[1])
    tiled = [np.tile(f, (ty, tx, 1))[:h, :w] for f in uniq]
    return np.stack([tiled[i % len(tiled)] for i in range(n)])


def pipeline_config():
    from opticalflowclustering_tpu.pipeline.bounce import PipelineConfig

    return PipelineConfig(chunk=8, emit_flow_bgr=False)


def real_pairs():
    """High-motion frame pairs from the committed reference footage
    (max |flow| up to ~50 px/frame — the regime that breaks separable
    warps)."""
    cases = [
        ("601_3_cropped_4_OF", 38, 50),
        ("601_3_cropped_3_OF", 48, 60),
        ("601_3_cropped_6_OF", 20, 26),
    ]
    import cv2

    pairs = []
    for d, lo, hi in cases:
        fs = sorted(glob.glob(f"{REF}/images/{d}/*.png"))[lo:hi]
        gray = [cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2GRAY) for f in fs]
        pairs.extend((gray[i], gray[i + 1]) for i in range(len(gray) - 1))
    return pairs


def bench_epe_vs_cv2(frames: np.ndarray) -> tuple[float, int]:
    """Worst mean EPE of the benchmarked flow configuration vs cv2."""
    import cv2
    import jax

    from opticalflowclustering_tpu.flow.farneback import farneback_flow

    cfg = pipeline_config()
    if os.path.isdir(REF):
        pairs = real_pairs()
    else:
        from opticalflowclustering_tpu.ops.colorspace import bgr2gray

        gray = np.asarray(jax.jit(bgr2gray)(frames[:13]))
        pairs = [(gray[i], gray[i + 1]) for i in range(len(gray) - 1)]
    worst = 0.0
    jits = {}
    for a, b in pairs:
        key = a.shape
        if key not in jits:
            jits[key] = jax.jit(
                lambda x, y: farneback_flow(x, y, cfg.flow)
            )
        want = cv2.calcOpticalFlowFarneback(
            a, b, None, 0.5, 3, 15, 3, 5, 1.2, 0
        )
        got = np.asarray(jits[key](a, b))
        worst = max(worst, float(np.sqrt(((got - want) ** 2).sum(-1)).mean()))
    return worst, len(pairs)


def bench_device(frames: np.ndarray, repeats: int = 3) -> float:
    """Whole-clip throughput: ONE device dispatch per run (lax.scan over
    chunks), completion measured by fetching the feature tables. Returns
    n_pairs / MEDIAN(repeat times): a min() would make each run a best-of;
    the median is robust in both directions."""
    import jax

    from opticalflowclustering_tpu.pipeline.bounce import (
        _stack_chunks,
        _video_step,
    )

    cfg = pipeline_config()
    chunks, n_pairs = _stack_chunks(frames, cfg.chunk)
    dev = jax.device_put(chunks)

    def run():
        # Completion barrier: the device→host fetch of the packed uint8
        # feature table (hue | rgb_hue | RGBA centroids | bitcast mean_mag).
        return np.asarray(_video_step(dev, cfg))

    run()  # compile + warm
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return n_pairs / float(np.median(times))


def bench_decode_inclusive(frames: np.ndarray) -> dict[str, float]:
    """End-to-end FROM AN MP4/AVI ON DISK: encode the
    canonical clip as MJPG (the reference's own writer fourcc), then time
    decode → flow → grid → cluster → OutCSV **bytes on disk**, twice per
    decode path:

      * `stream`: cv2 decode on a background thread overlapped with async
        device dispatch (pipeline.bounce.process_video_stream),
      * `native`: the C++ threaded MJPEG decoder (native/fastio.cpp), whole
        file in one FFI call, then the single-dispatch device path.

    Also times decode alone (both paths) so the host-decode roofline is
    explicit: on an M-core host the sustainable ceiling is
    min(device_fps, M × decode_fps_1core).
    """
    import cv2

    from opticalflowclustering_tpu.compat.writers import write_hue_table_csv
    from opticalflowclustering_tpu.io import fastio
    from opticalflowclustering_tpu.io.video import (
        read_video_bgr,
        write_video_mjpg,
    )
    from opticalflowclustering_tpu.pipeline.bounce import process_video_stream

    out: dict[str, float] = {}
    n_pairs = frames.shape[0] - 1
    cfg = pipeline_config()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "clip.avi")
        write_video_mjpg(path, frames, fps=30.0)
        out["clip_mb"] = round(os.path.getsize(path) / 1e6, 1)

        # decode-only rooflines (single pass each; decode is deterministic)
        t0 = time.perf_counter()
        read_video_bgr(path)
        out["decode_fps_cv2"] = frames.shape[0] / (time.perf_counter() - t0)
        if fastio.available():
            t0 = time.perf_counter()
            fastio.decode_mjpeg_avi(path)
            out["decode_fps_native"] = frames.shape[0] / (
                time.perf_counter() - t0
            )

        def timed(native: bool) -> float:
            csv_path = os.path.join(td, "out.csv")
            t0 = time.perf_counter()
            tables = process_video_stream(path, cfg, native=native)
            write_hue_table_csv(csv_path, tables["hue_table"])
            os.stat(csv_path)  # completion = CSV bytes on disk
            return n_pairs / (time.perf_counter() - t0)

        timed(False)  # compile warm-up (stream-path shapes differ from batch)
        runs = [timed(False), timed(False)]
        out["e2e_fps_stream"] = max(runs)
        out["e2e_fps_stream_spread_pct"] = (
            abs(runs[0] - runs[1]) / max(runs) * 100
        )
        if fastio.available():
            runs = [timed(True), timed(True)]
            out["e2e_fps_native"] = max(runs)
            out["e2e_fps_native_spread_pct"] = (
                abs(runs[0] - runs[1]) / max(runs) * 100
            )
    return out


def bench_h2d_roofline(frames: np.ndarray) -> dict[str, float]:
    """Measured host→device ingest bandwidth, the third roofline of the
    decode-inclusive path (besides host decode rate and device compute):
    put → tiny consuming program → scalar fetch, minus the resident-input
    cost of the same program."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda a: jnp.sum(a, dtype=jnp.int32))
    chunk = np.ascontiguousarray(frames[:8])
    int(f(jax.device_put(chunk)))  # compile + warm
    put = []
    for _ in range(3):
        t0 = time.perf_counter()
        int(f(jax.device_put(chunk)))
        put.append(time.perf_counter() - t0)
    resident = jax.device_put(chunk)
    int(f(resident))
    res = []
    for _ in range(3):
        t0 = time.perf_counter()
        int(f(resident))
        res.append(time.perf_counter() - t0)
    xfer = max(min(put) - min(res), 1e-6)
    mbps = chunk.nbytes / 1e6 / xfer
    frame_mb = frames[0].nbytes / 1e6
    return {
        "h2d_MBps": mbps,
        "h2d_bound_fps": mbps / frame_mb,
        "frame_mb": frame_mb,
    }


def bench_cpu_reference(frames: np.ndarray, n_frames: int = 10) -> float:
    """The reference's per-frame loop, verbatim semantics. Two timed passes,
    fastest wins — the CPU number feeds the denominator of vs_baseline, so
    host-load noise must err in the CPU's favor."""
    return max(
        _cpu_reference_pass(frames, n_frames) for _ in range(2)
    )


def _cpu_reference_pass(frames: np.ndarray, n_frames: int) -> float:
    import cv2
    from sklearn.cluster import KMeans

    ys, xs = H // GRID_ROWS, W // GRID_COLS
    prev_gray = cv2.cvtColor(frames[0], cv2.COLOR_BGR2GRAY)
    t0 = time.perf_counter()
    for i in range(1, n_frames + 1):
        gray = cv2.cvtColor(frames[i], cv2.COLOR_BGR2GRAY)
        flow = cv2.calcOpticalFlowFarneback(
            prev_gray, gray, None, 0.5, 3, 15, 3, 5, 1.2, 0
        )
        mag, ang = cv2.cartToPolar(flow[..., 0], flow[..., 1])
        mask = np.zeros_like(frames[i])
        mask[..., 0] = ang * 180 / np.pi / 2
        mask[..., 1] = 255
        mask[..., 2] = cv2.normalize(mag, None, 0, 255, cv2.NORM_MINMAX)
        bgr = cv2.cvtColor(mask, cv2.COLOR_HSV2BGR)
        prev_gray = gray
        hues = []
        for r in range(GRID_ROWS):
            for c in range(GRID_COLS):
                roi = bgr[r * ys : (r + 1) * ys, c * xs : (c + 1) * xs].copy()
                roi[0, :] = 255
                roi[:, 0] = 255
                rgb = cv2.cvtColor(roi, cv2.COLOR_BGR2RGB)
                rgb[rgb < 30] = 0
                g2 = cv2.cvtColor(rgb, cv2.COLOR_BGR2GRAY)
                _, alpha = cv2.threshold(g2, 0, 255, cv2.THRESH_BINARY)
                flat = np.dstack([rgb, alpha]).reshape(-1, 4)
                clt = KMeans(n_clusters=1, n_init=1)
                clt.fit(flat)
                cen = np.rint(clt.cluster_centers_[0])
                px = np.array([[[cen[0], cen[1], cen[2]]]], np.uint8)
                hues.append(cv2.cvtColor(px, cv2.COLOR_BGR2HSV)[0, 0, 0])
    dt = time.perf_counter() - t0
    return n_frames / dt


RESOLUTIONS = {"720p": (720, 1280), "1080p": (1080, 1920), "1440p": (1440, 2560)}


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--res",
        choices=sorted(RESOLUTIONS),
        default="720p",
        help="frame geometry; the headline is 720p (the flagship clip "
        "geometry)",
    )
    ap.add_argument(
        "--frames",
        type=int,
        default=None,
        help="clip length; default is the canonical 49 (the eval clip's "
        "frame count). Longer clips amortize the per-clip "
        "dispatch+fetch further — sustained throughput is slightly "
        "ABOVE the 49-frame number, not below",
    )
    args = ap.parse_args()
    global H, W, N
    H, W = RESOLUTIONS[args.res]
    if args.frames is not None:
        N = max(args.frames, 9)

    import jax

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        sys.exit(f"bench: no GPU visible to JAX (devices: {jax.devices()})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    device = {
        "platform": gpus[0].platform,
        "kind": gpus[0].device_kind,
        "count": len(gpus),
        "nvidia_smi": smi,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    print(f"bench: device {device}", file=sys.stderr)
    enable_compile_cache()
    frames = synth_frames(n=N, h=H, w=W)
    n_cpu = min(10, N - 1)
    cpu_fps = bench_cpu_reference(frames, n_frames=n_cpu)
    print(f"cpu reference ({n_cpu} frames): {cpu_fps:.3f} fps",
          file=sys.stderr)
    # Three independent runs, headline = MEDIAN (robust to one outlier in
    # either direction). All run values land in the JSON for inspection.
    runs = []
    for i in range(3):
        fps_i = bench_device(frames)
        runs.append(fps_i)
        print(f"device pipeline run {i + 1}/3: {fps_i:.1f} fps", file=sys.stderr)
    device_fps = float(np.median(runs))
    spread = (max(runs) - min(runs)) / device_fps * 100
    print(f"device pipeline median: {device_fps:.1f} fps "
          f"(spread {spread:.1f}%)", file=sys.stderr)
    noise_fps = bench_device(noise_frames(n=N, h=H, w=W), repeats=2)
    print(
        f"device pipeline on pure-noise frames: {noise_fps:.1f} fps",
        file=sys.stderr,
    )
    real_fps = None
    real_frames = real_footage_frames(n=N, h=H, w=W) if os.path.isdir(REF) else None
    if real_frames is not None:
        real_fps = bench_device(real_frames, repeats=2)
        print(
            f"device pipeline on real-footage motion statistics "
            f"(601_3_cropped_3_OF tiled to {args.res}): {real_fps:.1f} fps",
            file=sys.stderr,
        )
    sustained_fps = None
    fps_1440p = None
    if args.res == "720p" and args.frames is None:
        # Sustained: one 192-pair pass of the same program (longer scan
        # amortizes the per-clip dispatch+fetch), plus a 1440p datapoint.
        sustained_fps = bench_device(synth_frames(n=193, h=H, w=W), repeats=1)
        print(f"sustained (192-pair single pass): {sustained_fps:.1f} fps",
              file=sys.stderr)
        h14, w14 = RESOLUTIONS["1440p"]
        fps_1440p = bench_device(synth_frames(n=17, h=h14, w=w14), repeats=2)
        print(f"1440p short-clip datapoint (16 pairs): {fps_1440p:.1f} fps "
              f"(4x the 720p pixels)", file=sys.stderr)
    dec = bench_decode_inclusive(frames)
    print(
        "decode-inclusive (mp4 on disk -> OutCSV bytes, "
        f"{dec['clip_mb']} MB MJPG clip): "
        f"stream {dec['e2e_fps_stream']:.1f} fps "
        f"(spread {dec['e2e_fps_stream_spread_pct']:.1f}%), "
        f"native {dec.get('e2e_fps_native', float('nan')):.1f} fps "
        f"(spread {dec.get('e2e_fps_native_spread_pct', float('nan')):.1f}%)",
        file=sys.stderr,
    )
    ncpu = os.cpu_count() or 1
    print(
        f"decode-only roofline ({ncpu}-core host): "
        f"cv2 {dec['decode_fps_cv2']:.1f} fps, "
        f"native {dec.get('decode_fps_native', float('nan')):.1f} fps "
        f"-> multi-core projection min(device, cores x decode)",
        file=sys.stderr,
    )
    h2d = bench_h2d_roofline(frames)
    print(
        f"host->device ingest roofline: {h2d['h2d_MBps']:.0f} MB/s measured "
        f"({h2d['frame_mb']:.2f} MB/{args.res} frame -> "
        f"{h2d['h2d_bound_fps']:.1f} fps cap). The decode-inclusive "
        "numbers above are bound by min(device, cores x decode, h2d).",
        file=sys.stderr,
    )
    epe, n_pairs = bench_epe_vs_cv2(frames)
    print(f"flow worst mean EPE vs cv2 over {n_pairs} "
          f"{'real' if os.path.isdir(REF) else 'synthetic'} pairs: "
          f"{epe:.6f} px (target < 0.1)", file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": (
                    "e2e flow+grid+cluster throughput "
                    f"({args.res}, {N}-frame clip)"
                ),
                "value": round(device_fps, 1),
                "unit": "frames/sec/device",
                "vs_baseline": round(device_fps / cpu_fps, 1),
                "device": device,
                # the denominator, so the ratio is auditable: a loaded
                # 1-core host can depress the cv2 baseline (measured
                # 0.47-1.54 fps across sessions), inflating vs_baseline
                "cpu_baseline_fps": round(cpu_fps, 3),
                "flow_epe_px_vs_cv2": round(epe, 6),
                # each run is the MEDIAN of its 3 repeats (not best-of)
                "runs_fps": [round(v, 1) for v in runs],
                "noise_frames_fps": round(noise_fps, 1),
                "real_footage_fps": (
                    round(real_fps, 1) if real_fps is not None else None
                ),
                "sustained_fps": (
                    round(sustained_fps, 1)
                    if sustained_fps is not None else None
                ),
                "fps_1440p": (
                    round(fps_1440p, 1) if fps_1440p is not None else None
                ),
                "decode_inclusive_fps_stream": round(
                    dec["e2e_fps_stream"], 1
                ),
                "decode_inclusive_fps_native": round(
                    dec.get("e2e_fps_native", 0.0), 1
                ),
                "decode_only_fps_cv2_1core": round(dec["decode_fps_cv2"], 1),
                "decode_only_fps_native_1core": round(
                    dec.get("decode_fps_native", 0.0), 1
                ),
                "h2d_MBps": round(h2d["h2d_MBps"], 1),
                "h2d_bound_fps": round(h2d["h2d_bound_fps"], 1),
                "host_cores": ncpu,
            }
        )
    )


if __name__ == "__main__":
    main()
