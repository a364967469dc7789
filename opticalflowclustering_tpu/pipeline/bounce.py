"""The fused end-to-end bounce pipeline.

One jitted program replaces the reference's three host hot loops
(SURVEY.md §3.1: per-frame flow, 350-cell grid slicing, 350 KMeans calls):

  frames [N,H,W,3]u8 ──► gray ──► Farneback flow (N-1 pairs, batched)
    ──► HSV render (per-frame min-max) ──► grid cells + white-line overlay
    ──► RGBA preprocess ──► exact k=1 dominant hue      → OutCSV table
    ──► per-cell mean hue                               → rgb_values table
    ──► per-frame mean |flow|                           → telemetry CSV

Everything between decode and the CSV emit stays HBM-resident. Frame pairs
are independent, so long videos stream through in fixed-size chunks (the
chunk is the jit unit; one compile serves any video length).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from opticalflowclustering_tpu.cluster.matcher import match_signature
from opticalflowclustering_tpu.features.dominant_color import (
    dominant_hue_k1,
    dominant_hue_k1_frames,
    preprocess_cells_rgba,
)
from opticalflowclustering_tpu.features.grid import (
    GridParams,
    grid_mean_hue,
)
from opticalflowclustering_tpu.flow.farneback import (
    FarnebackParams,
    farneback_flow,
)
from opticalflowclustering_tpu.flow.render import render_flow_hsv_bgr
from opticalflowclustering_tpu.ops.colorspace import bgr2gray
from opticalflowclustering_tpu.ops.polar import magnitude


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    grid: GridParams = GridParams()
    flow: FarnebackParams = FarnebackParams()
    # Reproduce the R/B-swapped disk-roundtrip path that generated the
    # golden OutCSV artifacts (SURVEY.md §2.5 #5).
    rb_swap: bool = True
    # Frame pairs per jitted chunk (memory/throughput trade-off).
    chunk: int = 16
    # Materialize the rendered flow video as an output. The feature tables
    # are ~3 KB/frame; the render is ~2.7 MB/frame — skip it when only CSVs
    # are needed, so the device→host copy stays small.
    emit_flow_bgr: bool = True


@dataclasses.dataclass(frozen=True)
class OverlaySpec:
    """YOLO-box / contour overlays (`KmeanGrids.py:201-211`). When present,
    the pipeline runs two-phase (flow render on device → host overlay edit →
    grid/cluster on device) because the per-frame boxes/polygons are ragged
    host data. The documented runs disable both (--noyolo --nocontour)."""

    yolo_file: str | None = None
    contour_dir: str | None = None
    video_name: str = ""


def chunk_step(frames_chunk, cfg: PipelineConfig):
    """Process one chunk of C+1 BGR frames → features for C pairs.
    Pure/jittable; `_chunk_step` is its jitted form, and `_video_step`
    scans it over a whole video as one program (gray conversion included).
    """
    gray = bgr2gray(frames_chunk)
    flow = farneback_flow(gray[:-1], gray[1:], cfg.flow)
    mag = magnitude(flow[..., 0], flow[..., 1])
    mean_mag = jnp.mean(mag, axis=(-2, -1))
    flow_bgr = render_flow_hsv_bgr(flow)

    # Frame-wise feature extraction: whiten/preprocess fuse as elementwise
    # masks and the cell sums are strided reductions — no cell-layout copy
    # of the rendered frames (element-equal to the cell-tensor path).
    centroids, hue = dominant_hue_k1_frames(
        flow_bgr, cfg.grid, rb_swap=cfg.rb_swap
    )
    rgb_hue = grid_mean_hue(flow_bgr, cfg.grid)
    out = {
        "hue_table": hue,
        "rgb_hue_table": rgb_hue,
        # Per-cell RGBA centroids: the `-f`/addnew per-cell rows the
        # reference's fused run appends (`KmeanGrids.py:320-339`).
        "centroids": centroids,
        "mean_magnitude": mean_mag,
    }
    if cfg.emit_flow_bgr:
        out["flow_bgr"] = flow_bgr
    return out


_chunk_step = functools.partial(jax.jit, static_argnames=("cfg",))(chunk_step)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _video_step(chunks, cfg: PipelineConfig):
    """Whole-video pipeline as ONE device program: lax.scan of chunk_step
    over stacked chunks [K, C+1, H, W, 3], so a video costs one dispatch
    instead of one per chunk.

    Feature-only runs (emit_flow_bgr=False) return ONE packed uint8 array
    [K, C, 6·cells + 4] = [hue | rgb_hue | RGBA centroids | mean_mag
    bitcast to 4 bytes] instead of a dict: one device→host copy of 1 byte
    per value (the 49-frame clip: 103 KB instead of 412 KB in f32). The
    packing is LOSSLESS: hue/rgb_hue are integers in [0, 180), centroid
    RGBA are integers in [0, 255] (both pinned by the golden-CSV tests),
    and the one true float — per-pair mean magnitude — travels as its raw
    f32 bytes. Whether the packing pays on a local PCIe link is not
    measured yet."""

    def step(carry, chunk):
        return carry, chunk_step(chunk, cfg)

    _, outs = jax.lax.scan(step, 0, chunks)
    if not cfg.emit_flow_bgr:
        cen = outs["centroids"]
        return jnp.concatenate(
            [
                outs["hue_table"].astype(jnp.uint8),
                outs["rgb_hue_table"].astype(jnp.uint8),
                cen.reshape(cen.shape[:2] + (-1,)).astype(jnp.uint8),
                jax.lax.bitcast_convert_type(
                    outs["mean_magnitude"], jnp.uint8
                ),
            ],
            axis=-1,
        )
    return outs


def _unpack_tables(packed: np.ndarray, n_pairs: int) -> dict[str, np.ndarray]:
    """Inverse of _video_step's packed uint8 layout → flat per-pair
    tables (same dtypes chunk_step emits)."""
    flat = packed.reshape(-1, packed.shape[-1])[:n_pairs]
    cells = (flat.shape[-1] - 4) // 6
    return {
        "hue_table": flat[:, :cells],
        "rgb_hue_table": flat[:, cells : 2 * cells].astype(np.float32),
        "centroids": flat[:, 2 * cells : 6 * cells]
        .reshape(-1, cells, 4)
        .astype(np.int32),
        "mean_magnitude": np.ascontiguousarray(flat[:, -4:])
        .view(np.float32)
        .ravel(),
    }


def _stack_chunks(frames_bgr: np.ndarray, chunk: int) -> tuple[np.ndarray, int]:
    """[N,H,W,3] → overlapping chunk stack [K, chunk+1, H, W, 3] (each
    chunk shares its first frame with the previous chunk's last; the tail
    pads by repeating the final frame)."""
    n_pairs = frames_bgr.shape[0] - 1
    k = -(-n_pairs // chunk)
    chunks = np.empty(
        (k, chunk + 1) + frames_bgr.shape[1:], frames_bgr.dtype
    )
    for j in range(k):
        start = j * chunk
        stop = min(start + chunk, n_pairs)
        c = frames_bgr[start : stop + 1]
        chunks[j, : c.shape[0]] = c
        chunks[j, c.shape[0] :] = c[-1:]
    return chunks, n_pairs


@functools.partial(jax.jit, static_argnames=("grid", "rb_swap"))
def grid_cluster_stage(flow_bgr, grid: GridParams, rb_swap: bool):
    """Grid pooling + dominant hue/centroids for pre-rendered (possibly
    host-edited) flow frames — the device half of the two-phase overlay
    path. Returns (centroids, hue_table, rgb_hue_table)."""
    centroids, hue = dominant_hue_k1_frames(flow_bgr, grid, rb_swap=rb_swap)
    rgb_hue = grid_mean_hue(flow_bgr, grid)
    return centroids, hue, rgb_hue


def process_frames(
    frames_bgr: np.ndarray,
    cfg: PipelineConfig = PipelineConfig(),
    overlays: OverlaySpec | None = None,
) -> dict[str, np.ndarray]:
    """Full pipeline over decoded [N,H,W,3] uint8 BGR frames.

    Returns per-pair arrays (N-1 rows): flow_bgr render, OutCSV hue table,
    rgb_values hue table, mean flow magnitude. Streams in cfg.chunk-pair
    chunks so arbitrary-length videos reuse one compiled program. With
    `overlays`, YOLO boxes / contour masks are drawn onto each rendered
    frame (host edit) before the grid stage, matching
    `KmeanGrids.py:201-231`'s ordering (overlays before overlayGrid).
    """
    frames_bgr = np.asarray(frames_bgr)
    n = frames_bgr.shape[0]
    if n < 2:
        raise ValueError("need at least 2 frames")
    if overlays is not None and not cfg.emit_flow_bgr:
        # The overlay path edits the rendered frames on host, so the render
        # must be materialized; silently missing it would KeyError mid-loop.
        cfg = dataclasses.replace(cfg, emit_flow_bgr=True)

    if overlays is None:
        # Single-dispatch path: scan over chunks on device.
        chunks, n_pairs = _stack_chunks(frames_bgr, cfg.chunk)
        out = _video_step(jax.device_put(chunks), cfg)
        if not cfg.emit_flow_bgr:
            return _unpack_tables(np.asarray(out), n_pairs)
        return {
            k: np.asarray(v).reshape((-1,) + v.shape[2:])[:n_pairs]
            for k, v in out.items()
        }

    outs: list[dict[str, np.ndarray]] = []
    c = cfg.chunk
    for start in range(0, n - 1, c):
        stop = min(start + c, n - 1)
        chunk = frames_bgr[start : stop + 1]  # C+1 frames → C pairs
        pad = (c + 1) - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        out = _chunk_step(chunk, cfg)
        out = {k: np.asarray(v)[: stop - start] for k, v in out.items()}
        if overlays is not None:
            flow_bgr = out["flow_bgr"].copy()
            # frameNum: the reference counts the first decoded frame as 1
            # and pairs start at frame 2 (`KmeanGrids.py:169,189`).
            _apply_overlays(flow_bgr, start + 2, overlays)
            cen, hue, rgb_hue = grid_cluster_stage(
                flow_bgr, cfg.grid, cfg.rb_swap
            )
            out["flow_bgr"] = flow_bgr
            out["hue_table"] = np.asarray(hue)
            out["rgb_hue_table"] = np.asarray(rgb_hue)
            out["centroids"] = np.asarray(cen)
        outs.append(out)
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def _apply_overlays(
    flow_bgr: np.ndarray, first_frame_num: int, spec: OverlaySpec
) -> None:
    from opticalflowclustering_tpu.io.overlays import (
        apply_contour_mask,
        draw_rect_outline,
        load_contour_polys,
        load_yolo_boxes,
        yolo_rects_for_frame,
    )

    yolo = load_yolo_boxes(spec.yolo_file) if spec.yolo_file else None
    for i in range(flow_bgr.shape[0]):
        frame_num = first_frame_num + i
        if yolo is not None:
            for x, y, w, h in yolo_rects_for_frame(yolo, frame_num):
                draw_rect_outline(flow_bgr[i], x, y, w, h)
        if spec.contour_dir:
            polys = load_contour_polys(
                spec.contour_dir, spec.video_name, frame_num
            )
            apply_contour_mask(flow_bgr[i], polys)


def process_video_file(
    path: str, cfg: PipelineConfig = PipelineConfig(), max_frames=None
) -> dict[str, np.ndarray]:
    from opticalflowclustering_tpu.io.video import read_video_bgr

    return process_frames(read_video_bgr(path, max_frames), cfg)


def process_video_stream(
    path: str,
    cfg: PipelineConfig = PipelineConfig(),
    max_frames: int | None = None,
    native: bool = False,
) -> dict[str, np.ndarray]:
    """Decode-inclusive pipeline from an mp4/avi ON DISK: host decode
    overlaps device compute, unlike the reference's loop which pays decode
    inline every frame (`KmeanGrids.py:156,180-185`).

    Two overlap mechanisms stack:
      * a background thread demuxes/decodes the NEXT chunk while the device
        crunches the current one (io/video.py stream_video_chunks), and
      * the device dispatch is asynchronous — the host fetches chunk k's
        packed feature table only after dispatching chunk k+1, so the
        device does not wait on the device→host copy.

    `native=True` routes MJPEG-AVI files through the threaded C++ decoder
    (native/fastio.cpp): frames stream out of the done-flag prefix
    (io/fastio.py stream_mjpeg_avi) as the decoder fills the buffer — the
    same overlap structure. Its JPEG rounding differs from cv2 by ≤5 codes, so
    golden-parity paths use the default.

    Feature-only by construction (the stream never materializes the
    rendered video); results are bit-identical to
    `process_frames(read_video_bgr(path), cfg)` — chunks share the overlap
    frame and all normalization is per-frame, pinned by
    tests/test_pipeline_stream.py.
    """
    probe = None
    if native:
        from opticalflowclustering_tpu.io import fastio

        # Gate order matters: 12-byte RIFF sniff first (rejects mp4/mkv
        # without touching the native runtime or the file body), then the
        # full probe (container + MJPEG codec) — an xvid/h264 AVI passes
        # the magic check but fails jpeg decode and must fall back to the
        # cv2 stream, not raise mid-stream.
        probe = (
            fastio.probe_mjpeg_avi(path)
            if fastio.is_mjpeg_avi(path) and fastio.available()
            else None
        )
        if probe is None:
            native = False  # cv2 stream handles every other container

    if native:
        from opticalflowclustering_tpu.io.fastio import stream_mjpeg_avi

        def gen():
            return stream_mjpeg_avi(
                path, cfg.chunk, overlap=1, max_frames=max_frames,
                probe=probe,
            )
    else:
        from opticalflowclustering_tpu.io.video import stream_video_chunks

        def gen():
            return stream_video_chunks(
                path, cfg.chunk, overlap=1, max_frames=max_frames
            )

    cfg = dataclasses.replace(cfg, emit_flow_bgr=False)
    flats: list[np.ndarray] = []
    pending: tuple[jnp.ndarray, int] | None = None

    def drain(p):
        packed, n_valid = p
        flats.append(np.asarray(packed).reshape(-1, packed.shape[-1])[:n_valid])

    for batch, n_valid in gen():
        out = _video_step(jax.device_put(batch)[None], cfg)  # async dispatch
        if pending is not None:
            drain(pending)
        pending = (out, n_valid)
    if pending is None:
        raise ValueError(f"need at least 2 frames in {path}")
    drain(pending)
    flat = np.concatenate(flats)
    return _unpack_tables(flat, flat.shape[0])


@functools.partial(jax.jit, static_argnames=("rb_swap",))
def dominant_hue_series(frames_bgr: jnp.ndarray, rb_swap: bool = True):
    """Whole-frame dominant hue per frame — the `color_kmeans.py` unit
    workload batched over a directory of crops (each frame = one "cell").
    [N,H,W,3]u8 → (centroids [N,4] int32, hues [N] uint8)."""
    return dominant_hue_k1(preprocess_cells_rgba(frames_bgr, rb_swap=rb_swap))


def classify_bounce(
    signature_hue: np.ndarray, series_hue: np.ndarray
) -> tuple[float, int]:
    """Sliding-window bounce match (`findCosineDifferentVectors.py:52-66`):
    returns (max cosine similarity, frame index, last tie wins)."""
    sim, frame = match_signature(
        jnp.asarray(signature_hue, jnp.float32),
        jnp.asarray(series_hue, jnp.float32),
    )
    return float(sim), int(frame)
