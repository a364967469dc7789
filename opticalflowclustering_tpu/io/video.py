"""Host media boundary: video decode/encode.

Decode happens once on the host (OpenCV's native demuxer), producing one
batched uint8 array that crosses to the device a single time — the
replacement for the reference's frame-at-a-time `cap.read()` loop
(`KmeanGrids.py:156,180-185`). Encode mirrors `cv2.VideoWriter` with the
reference's MJPG fourcc (`computeOpticalFlow.py:27-33`).
"""

from __future__ import annotations

import queue
import threading

import numpy as np


_LFS_POINTER_MAGIC = b"version https://git-lfs.github.com/spec/v1"


def is_lfs_pointer(path: str) -> bool:
    """True if `path` is a Git-LFS pointer stub rather than real media.

    Every `.mp4` in the reference tree is such a stub
    (`k-means-color-clustering/.gitattributes:1`); callers use this to fall
    back to the committed PNG artifacts explicitly instead of guessing from
    file size."""
    try:
        with open(path, "rb") as f:
            head = f.read(len(_LFS_POINTER_MAGIC))
    except OSError:
        return False
    return head == _LFS_POINTER_MAGIC


def read_video_bgr(
    path: str, max_frames: int | None = None, native: bool = False
) -> np.ndarray:
    """Decode a video file → [N, H, W, 3] uint8 BGR frames.

    native=True routes MJPEG-AVI files through the C++ threaded decoder
    (io/fastio.py) — faster batch decode, but JPEG chroma-upsample/IDCT
    rounding differs from cv2 by a couple of codes (|Δ|≤5, mean <1), so
    golden-parity paths keep the default cv2 decode."""
    if native:
        from opticalflowclustering_tpu.io import fastio

        # Same gate as the streaming path: cheap RIFF sniff, then the full
        # codec probe — a non-MJPEG AVI falls back to cv2 instead of
        # raising from the native decoder.
        if (
            fastio.is_mjpeg_avi(path)
            and fastio.available()
            and fastio.probe_mjpeg_avi(path)
        ):
            return fastio.decode_mjpeg_avi(path, max_frames)
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    frames = []
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(frame)
        if max_frames is not None and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


def video_fps(path: str) -> float:
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return float(fps) if fps and fps > 0 else 30.0


def assemble_chunks(frames_iter, chunk: int, overlap: int):
    """THE chunk/carry/pad contract, shared by every streaming decode path
    (cv2 here; native MJPEG in io/fastio.py): consume an iterator of
    [H, W, 3] uint8 frames and yield ([chunk+overlap, H, W, 3], n_valid)
    batches where consecutive batches share `overlap` trailing frames and
    the final batch is zero-padded to the fixed shape. One implementation
    so the two stream paths cannot drift from the bit-identity contract
    pinned in tests/test_pipeline_stream.py."""
    carry: list[np.ndarray] = []
    eof = False
    while not eof:
        frames = list(carry)
        while len(frames) < chunk + overlap:
            nxt = next(frames_iter, None)
            if nxt is None:
                eof = True
                break
            frames.append(nxt)
        n_valid = max(0, len(frames) - overlap)
        if n_valid == 0:
            break
        batch = np.zeros((chunk + overlap,) + frames[0].shape, np.uint8)
        batch[: len(frames)] = np.stack(frames)
        yield batch, n_valid
        carry = frames[chunk:]


def stream_video_chunks(
    path: str,
    chunk: int,
    overlap: int = 1,
    max_frames: int | None = None,
    prefetch: int = 2,
):
    """Yield [chunk+overlap, H, W, 3] uint8 batches decoded by a background
    thread, so host decode overlaps device compute (the reference decodes
    synchronously inside its hot loop, `KmeanGrids.py:180-185`; here the
    next chunk demuxes while the device crunches the current one).

    Consecutive chunks share `overlap` trailing frames (flow needs the
    previous frame). The final chunk is zero-padded to the fixed shape and
    yielded as (batch, n_valid); earlier chunks yield n_valid == chunk.
    A decode error surfaces on the consumer side as the raised exception.
    """
    import cv2

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        cap = cv2.VideoCapture(path)
        try:
            if not cap.isOpened():
                raise FileNotFoundError(f"cannot open video: {path}")

            def frames():
                decoded = 0
                while not stop.is_set():
                    if max_frames is not None and decoded >= max_frames:
                        return
                    ret, frame = cap.read()
                    if not ret:
                        return
                    decoded += 1
                    yield frame

            for item in assemble_chunks(frames(), chunk, overlap):
                q.put(item)
                if stop.is_set():
                    break
            q.put(None)
        except BaseException as e:  # surface on the consumer side
            q.put(e)
        finally:
            cap.release()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # drain so the worker can exit its q.put
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                break


class VideoStream:
    """Threaded frame source, the imutils.video.VideoStream analogue the
    real-time demo builds on (`real-time-object-detection-with-deep-learning
    -and-opencv/real_time_object_detection.py:29`): a daemon thread reads
    frames as fast as the source produces them and `read()` returns the
    latest one. `src` is a camera index or a video path (files are paced at
    their native fps so they behave like a live source)."""

    def __init__(self, src: int | str = 0, paced: bool | None = None):
        import cv2

        self._cap = cv2.VideoCapture(src)
        if not self._cap.isOpened():
            raise FileNotFoundError(f"cannot open stream source: {src}")
        self._paced = (
            paced if paced is not None else isinstance(src, str)
        )
        self._fps = self._cap.get(cv2.CAP_PROP_FPS) or 30.0
        self._frame: np.ndarray | None = None
        self._stopped = threading.Event()
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> "VideoStream":
        self._thread.start()
        return self

    def _loop(self):
        import time

        interval = 1.0 / max(self._fps, 1e-3)
        while not self._stopped.is_set():
            t0 = time.time()
            ret, frame = self._cap.read()
            if not ret:
                self._stopped.set()
                break
            self._frame = frame
            self._ready.set()
            if self._paced:
                time.sleep(max(0.0, interval - (time.time() - t0)))
        self._cap.release()

    def read(self, timeout: float = 5.0) -> np.ndarray | None:
        """Latest frame, or None once the source is exhausted."""
        if self._frame is None and not self._stopped.is_set():
            self._ready.wait(timeout)
        return None if self._frame is None else self._frame

    def running(self) -> bool:
        return not self._stopped.is_set()

    def stop(self):
        self._stopped.set()


def write_video_mjpg(path: str, frames: np.ndarray, fps: float) -> None:
    """Encode [N, H, W, 3] uint8 BGR frames as MJPG-in-mp4, the reference's
    writer configuration (`computeOpticalFlow.py:27-33`, `KmeanGrids.py:163`)."""
    import cv2

    h, w = frames.shape[1], frames.shape[2]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    for f in np.asarray(frames):
        out.write(f)
    out.release()
