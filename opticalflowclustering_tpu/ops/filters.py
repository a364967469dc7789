"""Separable filtering primitives (GaussianBlur, box filter) as fused
shifted-slice sums.

OpenCV's `GaussianBlur` smooths every Farneback pyramid level
(optflowgf: sigma = (1/scale - 1)*0.5) and `blur`-style box sums drive the
flow refinement (winsize×winsize). Kernels here are tiny (3–19 taps), so
instead of conv layouts each tap is a shifted slice of the padded array and
the accumulation is k fused multiply-adds — XLA fuses the whole
chain into one HBM pass.

Summation order matches OpenCV's symmetric filters
(center + Σ_k w[k]·(left_k + right_k)) so float32 results track the
reference bit-closely.
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np

# OpenCV getGaussianKernel: fixed kernels for small ksize when sigma<=0.
_SMALL_GAUSSIAN_TAB = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}


@functools.lru_cache(maxsize=64)
def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma) in float64.

    sigma<=0 uses OpenCV's fixed small-kernel table (ksize<=7) or the
    derived sigma 0.3*((ksize-1)*0.5 - 1) + 0.8.
    """
    if sigma <= 0 and ksize <= 7:
        return _SMALL_GAUSSIAN_TAB[ksize].copy()
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x**2) / (2.0 * sigma * sigma))
    return k / k.sum()


def _pad_axis(x: jnp.ndarray, axis: int, before: int, after: int, mode: str):
    pads = [(0, 0)] * x.ndim
    pads[axis] = (before, after)
    if mode == "reflect101":
        return jnp.pad(x, pads, mode="reflect")  # numpy reflect == REFLECT_101
    if mode == "replicate":
        return jnp.pad(x, pads, mode="edge")
    raise ValueError(mode)


def sep_filter_axis(
    x: jnp.ndarray, kernel: np.ndarray, axis: int, border: str = "reflect101"
) -> jnp.ndarray:
    """Correlate one axis with a 1-D kernel, symmetric-pair summation order."""
    k = len(kernel)
    r = k // 2
    xp = _pad_axis(x.astype(jnp.float32), axis, r, r, border)
    n = x.shape[axis]

    def sl(off):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(off, off + n)
        return xp[tuple(idx)]

    symmetric = k % 2 == 1 and all(
        math.isclose(kernel[r - i], kernel[r + i]) for i in range(1, r + 1)
    )
    if symmetric:
        acc = jnp.float32(kernel[r]) * sl(r)
        for i in range(1, r + 1):
            acc = acc + jnp.float32(kernel[r - i]) * (sl(r - i) + sl(r + i))
        return acc
    acc = jnp.float32(kernel[0]) * sl(0)
    for i in range(1, k):
        acc = acc + jnp.float32(kernel[i]) * sl(i)
    return acc


def gaussian_blur(
    x: jnp.ndarray,
    ksize: int,
    sigma: float,
    border: str = "reflect101",
    axes: tuple[int, int] = (-2, -1),
) -> jnp.ndarray:
    """cv2.GaussianBlur(x, (ksize,ksize), sigma) over the two spatial axes.

    Default border REFLECT_101 matches OpenCV's BORDER_DEFAULT; the Farneback
    pyramid smoothing uses exactly this path (optflowgf.cpp calls
    GaussianBlur before each level's resize).
    """
    k = gaussian_kernel(ksize, sigma)
    x = sep_filter_axis(x, k, axes[0], border)
    x = sep_filter_axis(x, k, axes[1], border)
    return x


def box_sum(
    x: jnp.ndarray,
    ksize: int,
    border: str = "replicate",
    axes: tuple[int, int] = (-2, -1),
) -> jnp.ndarray:
    """Un-normalized ksize×ksize box sum with replicate border.

    This is the windowed accumulation inside Farneback's flow refinement
    (optflowgf FarnebackUpdateFlow_Blur: winsize box sums of the 5-channel
    M tensor, replicate-clamped at the borders, divided by winsize² at
    solve time).
    """
    ones = np.ones(ksize, dtype=np.float64)
    x = sep_filter_axis(x, ones, axes[0], border)
    x = sep_filter_axis(x, ones, axes[1], border)
    return x
