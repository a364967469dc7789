"""MSE + SSIM image comparison (`CompareTwoImages/compare.py:7-28`).

SSIM follows scikit-image's `structural_similarity` defaults for uint8
inputs (the reference's `ssim(imageA, imageB)` call): 7×7 uniform window,
sample-covariance normalization N/(N-1), data_range 255, K1=0.01, K2=0.03,
border-cropped mean. Windowed means are separable box filters — one fused
elementwise pass per statistic.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from opticalflowclustering_tpu.ops.filters import sep_filter_axis


def mse(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """`compare.py mse:7-10`: mean squared error in float."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    return jnp.mean((a - b) ** 2)


def _uniform(x: jnp.ndarray, win: int) -> jnp.ndarray:
    k = np.full(win, 1.0 / win)
    x = sep_filter_axis(x, k, axis=-2, border="reflect101")
    return sep_filter_axis(x, k, axis=-1, border="reflect101")


def ssim(
    a: jnp.ndarray,
    b: jnp.ndarray,
    win_size: int = 7,
    data_range: float = 255.0,
    k1: float = 0.01,
    k2: float = 0.03,
) -> jnp.ndarray:
    """Mean SSIM over the valid (border-cropped) region, skimage-default
    semantics. a, b: [..., H, W] grayscale."""
    f32 = jnp.float32
    x = a.astype(f32)
    y = b.astype(f32)
    np_win = win_size * win_size
    cov_norm = np_win / (np_win - 1.0)

    ux = _uniform(x, win_size)
    uy = _uniform(y, win_size)
    uxx = _uniform(x * x, win_size)
    uyy = _uniform(y * y, win_size)
    uxy = _uniform(x * y, win_size)
    vx = f32(cov_norm) * (uxx - ux * ux)
    vy = f32(cov_norm) * (uyy - uy * uy)
    vxy = f32(cov_norm) * (uxy - ux * uy)

    c1 = f32((k1 * data_range) ** 2)
    c2 = f32((k2 * data_range) ** 2)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2)
    )
    pad = (win_size - 1) // 2
    return jnp.mean(s[..., pad:-pad, pad:-pad])
