"""cv2-exact bilinear resize as separable matmuls.

`cv2.resize(..., INTER_LINEAR)` drives the Farneback pyramid (each level is
resampled from the full-resolution image, OpenCV optflowgf) and the coarse→
fine flow upsampling. Instead of translating OpenCV's per-row filter loops,
each axis's interpolation is materialized as a banded [dst, src] weight
matrix built at trace time (shapes are static), so a resize is two dense
matmuls that batch over frames/channels for free. Integer-ratio axes (the
pyramid's 2^k steps) take exact slice-based taps instead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=256)
def _linear_weight_matrix(dst_size: int, src_size: int) -> np.ndarray:
    """[dst, src] bilinear weights with OpenCV's coordinate convention:
    src_x = (dst_x + 0.5) * (src/dst) - 0.5, clamped at borders exactly the
    way OpenCV clamps (sx<0 → pixel 0 with weight 1; sx≥src-1 → last pixel
    with weight 1)."""
    scale = src_size / dst_size
    fx = (np.arange(dst_size, dtype=np.float64) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    fx[sx < 0] = 0.0
    sx[sx < 0] = 0
    fx[sx >= src_size - 1] = 0.0
    sx[sx >= src_size - 1] = src_size - 1
    w = np.zeros((dst_size, src_size), dtype=np.float32)
    w[np.arange(dst_size), sx] = (1.0 - fx).astype(np.float32)
    # fx>0 ⟹ sx+1 is in range by the clamping above.
    nz = fx > 0
    w[np.arange(dst_size)[nz], sx[nz] + 1] = fx[nz].astype(np.float32)
    return w


def _resize_axis_int_down(x: jnp.ndarray, dst: int, axis: int) -> jnp.ndarray:
    """Integer-factor downsample along `axis` as strided two-tap slices.

    With scale k = src/dst integer, every sample lands at fx = k/2 - 0.5:
    k even → taps (0.5, 0.5) at rows (k·j + k/2 − 1, k·j + k/2) — both
    multiplies exact, one rounding, so the result is bit-identical to the
    banded-matmul form but independent of GEMM blocking (this is what lets
    parallel/spatial.py's shard-local resizes match the global resize
    bitwise); k odd → a single tap (weight 1.0) at row k·j + (k−1)/2."""
    k = x.shape[axis] // dst

    def take(start):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(start, start + k * dst, k)
        return x[tuple(sl)]

    if k % 2:
        return take((k - 1) // 2)
    a = take(k // 2 - 1)
    b = take(k // 2)
    return jnp.float32(0.5) * a + jnp.float32(0.5) * b


def _resize_axis_up2(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Exact-2× upsample along `axis` as interleaved (0.25, 0.75) taps with
    OpenCV's border clamp (first/last dst row = weight 1.0 on the boundary
    source row). One fixed multiply/add order, so shard-local and global
    invocations agree bitwise (parallel/spatial.py)."""
    f32 = jnp.float32
    n = x.shape[axis]

    def sl(lo, hi):
        s = [slice(None)] * x.ndim
        s[axis] = slice(lo, hi)
        return x[tuple(s)]

    up = jnp.concatenate([sl(0, 1), sl(0, n - 1)], axis=axis)  # src[t-1]|edge
    dn = jnp.concatenate([sl(1, n), sl(n - 1, n)], axis=axis)  # src[t+1]|edge
    even = f32(0.25) * up + f32(0.75) * x  # dst row 2t
    odd = f32(0.75) * x + f32(0.25) * dn  # dst row 2t+1
    out = jnp.stack([even, odd], axis=axis + 1 if axis >= 0 else x.ndim + axis + 1)
    shp = list(x.shape)
    shp[axis] = 2 * n
    out = out.reshape(shp)
    # border clamp: dst 0 and dst 2n-1 take the boundary row with weight 1
    first = [slice(None)] * x.ndim
    first[axis] = slice(0, 1)
    last = [slice(None)] * x.ndim
    last[axis] = slice(2 * n - 1, 2 * n)
    out = out.at[tuple(first)].set(sl(0, 1))
    out = out.at[tuple(last)].set(sl(n - 1, n))
    return out


def resize_linear(
    img: jnp.ndarray, dst_hw: tuple[int, int]
) -> jnp.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) for float inputs.

    `img`: [..., H, W] (trailing spatial dims; channels go in leading batch
    dims — use `jnp.moveaxis` for HWC data or `resize_linear_hwc`).

    Integer-ratio axes (the Farneback pyramid's 2^k down / 2× up) take
    exact slice-based taps (bitwise stable across shard-local and global
    shapes — parallel/spatial.py relies on this); everything else is the
    banded [dst, src] matmul, unchanged.
    """
    dst_h, dst_w = dst_hw
    src_h, src_w = img.shape[-2], img.shape[-1]
    x = img.astype(jnp.float32)
    if dst_h != src_h:
        if src_h % dst_h == 0:
            x = _resize_axis_int_down(x, dst_h, x.ndim - 2)
        elif dst_h == 2 * src_h:
            x = _resize_axis_up2(x, x.ndim - 2)
        else:
            wy = jnp.asarray(_linear_weight_matrix(dst_h, src_h))
            x = jnp.einsum(
                "hs,...sw->...hw", wy, x, precision=jax.lax.Precision.HIGHEST
            )
    if dst_w != src_w:
        if src_w % dst_w == 0:
            x = _resize_axis_int_down(x, dst_w, x.ndim - 1)
        elif dst_w == 2 * src_w:
            x = _resize_axis_up2(x, x.ndim - 1)
        else:
            wx = jnp.asarray(_linear_weight_matrix(dst_w, src_w))
            x = jnp.einsum(
                "ws,...hs->...hw", wx, x, precision=jax.lax.Precision.HIGHEST
            )
    return x


def resize_linear_hwc(img: jnp.ndarray, dst_hw: tuple[int, int]) -> jnp.ndarray:
    """resize_linear for [..., H, W, C] channel-last data."""
    x = jnp.moveaxis(img, -1, -3)
    out = resize_linear(x, dst_hw)
    return jnp.moveaxis(out, -3, -1)
