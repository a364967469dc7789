"""Fault-tolerant multi-video work queue with feature persistence.

SURVEY.md §5: the reference has no failure handling (loops just `break` on
a failed `cap.read()`, `KmeanGrids.py:185`) and nothing resumable. Here:
a host-side per-video queue that retries failed videos, checkpoints each
video's feature tensors (hue tables, telemetry) as .npz, and skips
already-completed work on resume — so a multi-video batch survives decode
errors and restarts without re-running flow.
"""

from __future__ import annotations

import dataclasses
import os
import traceback

import numpy as np

from opticalflowclustering_tpu.pipeline.bounce import PipelineConfig, process_frames
from opticalflowclustering_tpu.utils.logging import get_logger

log = get_logger("ofc_tpu.queue")

_SAVED_KEYS = ("hue_table", "rgb_hue_table", "centroids", "mean_magnitude")

#: Observability/test hook: filled in by the last `process_video_queue_dp`
#: call with {"peak_buffered_videos", "batches", "evictions",
#: "batch_failures"} so tests can assert the streaming-memory bound without
#: instrumenting internals. "batches" counts SUCCESSFUL mesh dispatches only
#: (failed dispatches land in "batch_failures" and fall back to the
#: sequential path) — the multi-host test's proof-of-dispatch relies on
#: that distinction.
LAST_DP_STATS: dict[str, int] = {}


@dataclasses.dataclass
class VideoResult:
    video: str
    ok: bool
    path: str | None = None
    error: str | None = None
    attempts: int = 0


def _artifact_path(out_dir: str, video_path: str) -> str:
    stem = os.path.splitext(os.path.basename(video_path))[0]
    return os.path.join(out_dir, f"{stem}.features.npz")


def process_video_queue(
    video_paths: list[str],
    out_dir: str,
    cfg: PipelineConfig = PipelineConfig(),
    max_retries: int = 2,
    resume: bool = True,
    max_frames: int | None = None,
) -> list[VideoResult]:
    """Run the fused pipeline over many videos with retry + resume.

    Persists {hue_table, rgb_hue_table, mean_magnitude} per video; on
    resume, videos whose artifact exists are skipped. Returns one
    VideoResult per input.
    """
    from opticalflowclustering_tpu.io.video import read_video_bgr

    os.makedirs(out_dir, exist_ok=True)
    results = []
    for path in video_paths:
        artifact = _artifact_path(out_dir, path)
        if resume and os.path.exists(artifact):
            log.info("skip %s (artifact exists)", path)
            results.append(VideoResult(path, True, artifact, attempts=0))
            continue
        last_err = None
        for attempt in range(1, max_retries + 2):
            try:
                frames = read_video_bgr(path, max_frames)
                # The queue persists feature tables only — never the
                # rendered flow video — so the feature-only pipeline
                # (packed fetch, no render materialization) is the right
                # configuration regardless of what the caller's cfg says.
                out = process_frames(
                    frames, dataclasses.replace(cfg, emit_flow_bgr=False)
                )
                np.savez_compressed(
                    artifact, **{k: out[k] for k in _SAVED_KEYS}
                )
                log.info("done %s (%d pairs, attempt %d)",
                         path, out["hue_table"].shape[0], attempt)
                results.append(VideoResult(path, True, artifact, attempts=attempt))
                break
            except Exception as e:  # noqa: BLE001 — queue must survive any video
                last_err = f"{type(e).__name__}: {e}"
                log.warning("attempt %d failed for %s: %s", attempt, path, last_err)
                log.debug("%s", traceback.format_exc())
        else:
            results.append(
                VideoResult(path, False, None, error=last_err,
                            attempts=max_retries + 1)
            )
    return results


def load_features(artifact_path: str) -> dict[str, np.ndarray]:
    with np.load(artifact_path) as z:
        return {k: z[k] for k in z.files}


def process_video_queue_dp(
    video_paths: list[str],
    out_dir: str,
    mesh,
    cfg: PipelineConfig = PipelineConfig(),
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    resume: bool = True,
    max_frames: int | None = None,
    shard_hosts: bool = True,
) -> list[VideoResult]:
    """Mesh fan-out of the queue (SURVEY §7 step 7): videos ride the dp
    axis, each video's frames the sp axis, so a dp×sp mesh crunches
    dp videos per dispatch through `sharded_hue_pipeline_videos`.

    Under `jax.distributed` (`shard_hosts=True`, the default) each host
    first takes its round-robin share of the list (`host_shard`) and then
    fans out over ITS OWN devices only: the global mesh is narrowed to
    this host's dp rows via `multihost.local_submesh`, so decoded frames
    (host-local numpy) feed an all-addressable-device jit — legal
    single-controller dispatch, no global-array assembly — and NOTHING
    crosses hosts during video processing (sp halos stay inside a host;
    hosts are independent by construction). Each process returns
    VideoResults for its own share only; artifacts land on the (shared)
    filesystem under `out_dir`, so resume works across runs regardless of
    which host previously owned a video. Executed under a real 2-process
    cluster in tests/test_multihost.py::test_two_process_dp_queue.

    Streaming dataflow with bounded host memory (contrast with the
    reference, which pays decode inline for every frame,
    `KmeanGrids.py:156,180-185`): a prefetch thread decodes ahead through a
    bounded queue while the consumer buckets videos by shape and dispatches
    each dp-sized same-shape group AS SOON as it fills — the decoder keeps
    decoding behind the device batch, so decode and compute genuinely
    overlap. Host-side buffering is capped at `max_buffered` decoded
    videos (default 2·dp): when odd-shaped stragglers would exceed it, the
    oldest buffered video is evicted to an immediate single-video device
    run instead of waiting for its bucket to fill. End-of-stream leftovers
    run the same way (frames are already in RAM — no re-decode). Peak host
    memory is therefore ≤ max_buffered + prefetch(2) + 1-being-decoded +
    dp-in-flight videos regardless of queue length; `LAST_DP_STATS`
    records the observed peak.

    Artifacts carry the full single-video contract — hue_table,
    rgb_hue_table, per-cell RGBA `centroids` (the reference's `-f`/addnew
    rows, `KmeanGrids.py:320-339`), mean_magnitude. The integer tables
    (hue/rgb_hue/centroids) are byte-identical to
    `process_video_queue`'s; the float mean_magnitude telemetry is
    ~1-ulp equal (XLA fuses its hypot+mean chain per local shard shape —
    parallel/temporal.py's contract; tests/test_queue_dp.py pins both).
    Retry/resume semantics match it too (a failed batch retries its
    videos individually)."""
    import collections
    import queue as _q
    import threading

    import jax

    from opticalflowclustering_tpu.io.video import read_video_bgr
    from opticalflowclustering_tpu.parallel.multihost import (
        host_shard,
        local_submesh,
    )
    from opticalflowclustering_tpu.parallel.temporal import (
        sharded_hue_pipeline_videos,
    )

    os.makedirs(out_dir, exist_ok=True)
    if shard_hosts and jax.process_count() > 1:
        paths = host_shard(video_paths)
        # Narrow to this host's dp rows: decoded numpy frames can only
        # feed a jit whose mesh is fully addressable from this process.
        mesh = local_submesh(mesh, dp_axis)
    else:
        paths = list(video_paths)
    dp = mesh.shape[dp_axis]
    sp = mesh.shape[sp_axis]
    max_buffered = 2 * dp

    results: list[VideoResult] = []
    todo = []
    for p in paths:
        artifact = _artifact_path(out_dir, p)
        if resume and os.path.exists(artifact):
            log.info("skip %s (artifact exists)", p)
            results.append(VideoResult(p, True, artifact, attempts=0))
        else:
            todo.append(p)

    # prefetch-decode thread: (path, frames|exception) stream. maxsize
    # bounds decode-ahead; the consumer dispatching device batches between
    # get()s is what lets the decoder run behind them.
    decoded: _q.Queue = _q.Queue(maxsize=2)

    def _decoder():
        for p in todo:
            try:
                decoded.put((p, read_video_bgr(p, max_frames)))
            except Exception as e:  # noqa: BLE001
                decoded.put((p, e))
        decoded.put(None)

    threading.Thread(target=_decoder, daemon=True).start()

    retry_paths: list[str] = []
    failed_decode: list[VideoResult] = []
    saved_ok: set[str] = set()

    def _save(p: str, tables: dict[str, np.ndarray]) -> None:
        artifact = _artifact_path(out_dir, p)
        np.savez_compressed(artifact, **{k: tables[k] for k in _SAVED_KEYS})
        results.append(VideoResult(p, True, artifact, attempts=1))
        saved_ok.add(p)

    def _run_batch(group):
        names = [p for p, _ in group]
        vids = np.stack([f for _, f in group])  # [dp, N, H, W, 3]
        n = vids.shape[1]
        n_pad = (-n) % sp
        if n_pad:  # repeat the last frame so sp divides N (extra pairs
            vids = np.concatenate(  # are junk and sliced off below)
                [vids, np.repeat(vids[:, -1:], n_pad, axis=1)], axis=1
            )
        hue, rgb_hue, cen, mag = sharded_hue_pipeline_videos(
            vids, mesh, dp_axis, sp_axis, grid=cfg.grid, params=cfg.flow,
            rb_swap=cfg.rb_swap,
        )
        hue = np.asarray(hue)[:, : n - 1]
        rgb_hue = np.asarray(rgb_hue)[:, : n - 1]
        cen = np.asarray(cen)[:, : n - 1]
        mag = np.asarray(mag)[:, : n - 1]
        for i, p in enumerate(names):
            _save(p, {
                "hue_table": hue[i],
                "rgb_hue_table": rgb_hue[i],
                "centroids": cen[i],
                "mean_magnitude": mag[i],
            })
        log.info("dp batch done: %s (%d pairs each)", names, n - 1)

    def _run_single(p: str, frames: np.ndarray) -> None:
        """Evicted/leftover video: frames are already decoded, so run the
        single-device pipeline directly (identical tables — pinned by
        tests) rather than re-decoding through the sequential queue."""
        feature_cfg = dataclasses.replace(cfg, emit_flow_bgr=False)
        _save(p, process_frames(frames, feature_cfg))

    buckets: dict[tuple, list] = collections.defaultdict(list)
    order: collections.deque = collections.deque()  # FIFO for eviction
    buffered = 0
    stats = {"peak_buffered_videos": 0, "batches": 0, "evictions": 0,
             "batch_failures": 0}

    def _dispatch(group) -> None:
        try:
            _run_batch(group)
            # Counted only on success so `batches >= 1 and
            # batch_failures == 0` PROVES mesh dispatch ran — the
            # sequential retry fallback below cannot fake it.
            stats["batches"] += 1
        except Exception as e:  # noqa: BLE001 — retry individually
            stats["batch_failures"] += 1
            log.warning("dp batch failed (%s); retrying sequentially", e)
            # A batch can fail partway through its per-video save loop
            # (e.g. disk full on video 2 of 4): retry only the videos
            # whose artifact+result didn't land, preserving the
            # one-VideoResult-per-input contract.
            retry_paths.extend(
                p for p, _ in group if p not in saved_ok
            )

    def _evict_oldest() -> None:
        nonlocal buffered
        while order:
            shape, p0 = order.popleft()
            bucket = buckets.get(shape)
            if bucket is None:
                continue
            idx = next((i for i, (p, _) in enumerate(bucket) if p == p0), None)
            if idx is None:
                continue
            p, frames = bucket.pop(idx)
            if not bucket:
                del buckets[shape]
            buffered -= 1
            stats["evictions"] += 1
            try:
                _run_single(p, frames)
            except Exception as e:  # noqa: BLE001
                log.warning("evicted single run failed for %s (%s); "
                            "queueing retry", p, e)
                retry_paths.append(p)
            return

    while True:
        item = decoded.get()
        if item is None:
            break
        p, frames = item
        if isinstance(frames, Exception):
            failed_decode.append(
                VideoResult(p, False, None,
                            error=f"{type(frames).__name__}: {frames}",
                            attempts=1)
            )
            continue
        buckets[frames.shape].append((p, frames))
        order.append((frames.shape, p))
        buffered += 1
        stats["peak_buffered_videos"] = max(
            stats["peak_buffered_videos"], buffered
        )
        if len(buckets[frames.shape]) == dp:
            group = buckets.pop(frames.shape)
            buffered -= dp
            _dispatch(group)  # decoder keeps filling behind this batch
        elif buffered > max_buffered:
            _evict_oldest()

    # end-of-stream leftovers: already decoded — single-video device runs
    for shape in list(buckets):
        for p, frames in buckets.pop(shape):
            buffered -= 1
            try:
                _run_single(p, frames)
            except Exception as e:  # noqa: BLE001
                log.warning("leftover single run failed for %s (%s); "
                            "queueing retry", p, e)
                retry_paths.append(p)

    if retry_paths:
        results.extend(
            process_video_queue(
                retry_paths, out_dir, cfg, resume=resume,
                max_frames=max_frames,
            )
        )
    results.extend(failed_decode)
    LAST_DP_STATS.clear()
    LAST_DP_STATS.update(stats)
    return results
