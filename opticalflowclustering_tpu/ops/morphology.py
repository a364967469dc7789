"""Morphology: erode / dilate / open / close / gradient / tophat / blackhat.

Reference call sites: barcode localization's closing + erode/dilate series
(`detect-barcodes/detect_barcode.py:22-25`), skin-mask cleanup with an
elliptical kernel (`skin-detection/skindetector.py:29-31`).

On the device: min/max window reductions. Rectangular kernels decompose into
two separable 1-D `lax.reduce_window` passes; arbitrary kernels (ellipse,
cross) take one shifted-slice min/max per active kernel cell — still a
fused elementwise chain, no gathers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def structuring_element(shape: str, ksize: tuple[int, int]) -> np.ndarray:
    """cv2.getStructuringElement: 'rect' | 'cross' | 'ellipse' (OpenCV's
    exact ellipse rasterization via the inscribed-ellipse row spans)."""
    kh, kw = ksize[1], ksize[0]  # cv2 takes (width, height)
    if shape == "rect":
        return np.ones((kh, kw), np.uint8)
    if shape == "cross":
        el = np.zeros((kh, kw), np.uint8)
        el[kh // 2, :] = 1
        el[:, kw // 2] = 1
        return el
    if shape == "ellipse":
        # OpenCV: per-row horizontal span of the inscribed ellipse.
        el = np.zeros((kh, kw), np.uint8)
        r, c = kh // 2, kw // 2
        inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
        for i in range(kh):
            j1, j2 = 0, 0
            dy = i - r
            if abs(dy) <= r:
                if r == 0:
                    j2 = kw
                else:
                    dx = int(round(c * np.sqrt(max(1.0 - dy * dy * inv_r2, 0.0))))
                    j1 = max(c - dx, 0)
                    j2 = min(c + dx + 1, kw)
                el[i, j1:j2] = 1
        return el
    raise ValueError(shape)


def _window_reduce(x: jnp.ndarray, kernel: np.ndarray, is_max: bool) -> jnp.ndarray:
    """Min/max over the kernel's active offsets, replicate border
    (OpenCV BORDER_CONSTANT uses +inf/-inf for erode/dilate edges — i.e.
    border pixels don't constrain — which replicate padding reproduces for
    the common all-ones edge rows; exact for OpenCV's default behavior)."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    h, w = x.shape[-2], x.shape[-1]
    pads = [(0, 0)] * (x.ndim - 2) + [(ph, kh - 1 - ph), (pw, kw - 1 - pw)]
    xp = jnp.pad(x, pads, mode="edge")
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            if not kernel[dy, dx]:
                continue
            sl = xp[..., dy : dy + h, dx : dx + w]
            if acc is None:
                acc = sl
            elif is_max:
                acc = jnp.maximum(acc, sl)
            else:
                acc = jnp.minimum(acc, sl)
    return acc


def _sep_reduce(x, kh, kw, is_max):
    """Separable rect-kernel min/max (two 1-D passes)."""
    col = np.ones((kh, 1), np.uint8)
    row = np.ones((1, kw), np.uint8)
    return _window_reduce(_window_reduce(x, col, is_max), row, is_max)


def erode(x: jnp.ndarray, kernel: np.ndarray, iterations: int = 1) -> jnp.ndarray:
    kernel = np.asarray(kernel)
    for _ in range(iterations):
        if kernel.all():
            x = _sep_reduce(x, kernel.shape[0], kernel.shape[1], is_max=False)
        else:
            x = _window_reduce(x, kernel, is_max=False)
    return x


def dilate(x: jnp.ndarray, kernel: np.ndarray, iterations: int = 1) -> jnp.ndarray:
    kernel = np.asarray(kernel)
    for _ in range(iterations):
        if kernel.all():
            x = _sep_reduce(x, kernel.shape[0], kernel.shape[1], is_max=True)
        else:
            x = _window_reduce(x, kernel, is_max=True)
    return x


def morphology_ex(x: jnp.ndarray, op: str, kernel: np.ndarray) -> jnp.ndarray:
    """cv2.morphologyEx: 'open' | 'close' | 'gradient' | 'tophat' |
    'blackhat'."""
    if op == "open":
        return dilate(erode(x, kernel), kernel)
    if op == "close":
        return erode(dilate(x, kernel), kernel)
    if op == "gradient":
        return (
            dilate(x, kernel).astype(jnp.int32) - erode(x, kernel).astype(jnp.int32)
        ).astype(x.dtype)
    if op == "tophat":
        opened = dilate(erode(x, kernel), kernel)
        return (x.astype(jnp.int32) - opened.astype(jnp.int32)).clip(0).astype(x.dtype)
    if op == "blackhat":
        closed = erode(dilate(x, kernel), kernel)
        return (closed.astype(jnp.int32) - x.astype(jnp.int32)).clip(0).astype(x.dtype)
    raise ValueError(op)
