"""Histogram primitives: cv2.calcHist / cv2.compareHist / normalize.

Behind the reference's histogram workloads: per-channel and joint color
histograms (`ColorHistograms/ColorHistograms.py:32-36`,
`2D-ColorHistograms.py:17-35`), the CBIR feature extractor
(`FirstImageSearchEngine/rgbhistogram.py:8-13`), and the histogram-distance
survey (`compare-histograms/comphis.py:27-40`).

Design: a d-dimensional histogram maps pixels to flat bin ids and counts
them — via a one-hot reduction (matmul-shaped, scatter-free) when
n_pixels × n_bins is small, or a device scatter-add for large images where
the one-hot intermediate would blow past the device memory budget.
Both orders produce bitwise-identical counts (integer-valued f32 sums).
Masked variants zero the contribution of masked pixels.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def calc_hist(
    image: jnp.ndarray,
    channels: list[int],
    bins: list[int],
    ranges: list[tuple[float, float]],
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """cv2.calcHist for one image: [..., H, W, C] uint8 → float32 histogram
    of shape `bins`. Bin mapping matches OpenCV: bin = floor((v - lo) *
    nbins / (hi - lo)), values at/above hi excluded."""
    x = image.astype(jnp.float32)
    flat_bins = int(np.prod(bins))
    ids = jnp.zeros(x.shape[:-1], jnp.int32)
    valid = jnp.ones(x.shape[:-1], bool)
    stride = flat_bins
    for ch, nb, (lo, hi) in zip(channels, bins, ranges):
        v = x[..., ch]
        b = jnp.floor((v - lo) * (nb / (hi - lo))).astype(jnp.int32)
        inr = (b >= 0) & (b < nb)
        valid &= inr
        stride //= nb
        ids = ids + jnp.clip(b, 0, nb - 1) * stride
    if mask is not None:
        valid &= mask.astype(bool)
    # Two bitwise-identical accumulators (counts are integer-valued and
    # < 2^24, exact in f32 in any order):
    #   * one-hot matmul-style reduction — scatter-free, but materializes
    #     [n_pixels, flat_bins] f32 if XLA fails to fuse it (a 720p 3-D
    #     hist would be >1 GB; measured 17 GB of kernel-time page churn
    #     on the 25-image CBIR index before the gate existed);
    #   * scatter-add into the bin table (invalid pixels land in an
    #     overflow bin that is dropped), linear memory.
    if ids.size * flat_bins <= 2**24:
        onehot = jax.nn.one_hot(ids, flat_bins, dtype=jnp.float32)
        onehot = jnp.where(valid[..., None], onehot, 0.0)
        hist = jnp.sum(onehot.reshape(-1, flat_bins), axis=0)
    else:
        flat_ids = jnp.where(valid, ids, flat_bins).ravel()
        hist = (
            jnp.zeros(flat_bins + 1, jnp.float32)
            .at[flat_ids]
            .add(1.0)[:flat_bins]
        )
    return hist.reshape(bins)


def normalize_l2(hist: jnp.ndarray) -> jnp.ndarray:
    """cv2.normalize(hist, hist) default = L2 norm to 1."""
    n = jnp.linalg.norm(hist.ravel())
    return jnp.where(n > 0, hist / n, hist)


def compare_hist(h1: jnp.ndarray, h2: jnp.ndarray, method: str) -> jnp.ndarray:
    """cv2.compareHist: methods 'correl' | 'chisqr' | 'intersect' |
    'bhattacharyya' with OpenCV's exact formulas."""
    a = h1.ravel().astype(jnp.float32)
    b = h2.ravel().astype(jnp.float32)
    if method == "correl":
        am = a - jnp.mean(a)
        bm = b - jnp.mean(b)
        denom = jnp.sqrt(jnp.sum(am * am) * jnp.sum(bm * bm))
        return jnp.where(jnp.abs(denom) > 0, jnp.sum(am * bm) / denom, 1.0)
    if method == "chisqr":
        return jnp.sum(jnp.where(a > 0, (a - b) ** 2 / a, 0.0))
    if method == "intersect":
        return jnp.sum(jnp.minimum(a, b))
    if method == "bhattacharyya":
        sa, sb = jnp.sum(a), jnp.sum(b)
        num = jnp.sum(jnp.sqrt(a * b))
        denom = jnp.sqrt(sa * sb)
        s = jnp.where(denom > 0, num / denom, 0.0)
        return jnp.sqrt(jnp.maximum(1.0 - s, 0.0))
    raise ValueError(method)


def chi2_distance(a: jnp.ndarray, b: jnp.ndarray, eps: float = 1e-10) -> jnp.ndarray:
    """The hand-rolled chi² the search engines use
    (`FirstImageSearchEngine/searcher.py:18-21`):
    0.5 · Σ (a-b)²/(a+b+eps)."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    return 0.5 * jnp.sum((a - b) ** 2 / (a + b + eps), axis=-1)


def rgb_histogram_feature(image: jnp.ndarray, bins=(8, 8, 8)) -> jnp.ndarray:
    """`RGBHistogram.describe` (`rgbhistogram.py:8-13`): 3-D RGB histogram,
    L2-normalized, flattened — the CBIR index feature."""
    h = calc_hist(image, [0, 1, 2], list(bins), [(0, 256)] * 3)
    return normalize_l2(h).ravel()
