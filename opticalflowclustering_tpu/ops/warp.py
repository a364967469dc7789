"""Geometric warps: warpAffine, warpPerspective, perspective solves, and the
four-point document rectification.

Reference call sites: `DocumentScanner/pyimagesearch/transform.py:5-64`
(order_points / four_point_transform), `imutils.py:5-58`
(translate/rotate/resize), `getperspectivetransform/transform.py`,
`Pokedex/find_screen.py:66-69`.

Implementation: inverse-mapping bilinear sampling. The sample gather is the
one irreducibly gather-shaped op in the library; rows/cols are gathered
separately as two 1-D gathers.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def get_rotation_matrix_2d(center, angle_deg, scale) -> np.ndarray:
    """cv2.getRotationMatrix2D."""
    a = np.deg2rad(angle_deg)
    alpha, beta = scale * np.cos(a), scale * np.sin(a)
    cx, cy = center
    return np.array(
        [
            [alpha, beta, (1 - alpha) * cx - beta * cy],
            [-beta, alpha, beta * cx + (1 - alpha) * cy],
        ],
        dtype=np.float64,
    )


def get_perspective_transform(src_pts, dst_pts) -> np.ndarray:
    """cv2.getPerspectiveTransform: 3×3 homography from 4 point pairs
    (8×8 linear solve, like OpenCV)."""
    src = np.asarray(src_pts, np.float64)
    dst = np.asarray(dst_pts, np.float64)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        a[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[i] = u
        b[i + 4] = v
    h = np.linalg.solve(a, b)
    return np.append(h, 1.0).reshape(3, 3)


def _sample_bilinear(img: jnp.ndarray, xs: jnp.ndarray, ys: jnp.ndarray):
    """Bilinear sample of [H, W, C] at float coords; constant-0 border
    (cv2 BORDER_CONSTANT default)."""
    h, w = img.shape[0], img.shape[1]
    x0 = jnp.floor(xs)
    y0 = jnp.floor(ys)
    fx = (xs - x0)[..., None]
    fy = (ys - y0)[..., None]
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    def at(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = img[jnp.clip(yy, 0, h - 1), jnp.clip(xx, 0, w - 1)]
        return jnp.where(inside[..., None], v.astype(jnp.float32), 0.0)

    p00 = at(y0i, x0i)
    p01 = at(y0i, x0i + 1)
    p10 = at(y0i + 1, x0i)
    p11 = at(y0i + 1, x0i + 1)
    return (
        p00 * (1 - fx) * (1 - fy)
        + p01 * fx * (1 - fy)
        + p10 * (1 - fx) * fy
        + p11 * fx * fy
    )


def _finish(out: jnp.ndarray, dtype, squeeze: bool):
    if dtype == jnp.uint8 or dtype == np.uint8:
        out = jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)
    else:
        out = out.astype(dtype)
    return out[..., 0] if squeeze else out


def warp_affine(img: jnp.ndarray, m: np.ndarray, dsize: tuple[int, int]):
    """cv2.warpAffine(img, M, (w, h)): inverse-map bilinear, constant
    border. img: [H, W] or [H, W, C]."""
    squeeze = img.ndim == 2
    src = img[..., None] if squeeze else img
    w_out, h_out = dsize
    minv = np.linalg.inv(np.vstack([np.asarray(m, np.float64), [0, 0, 1]]))[:2]
    gx, gy = jnp.meshgrid(
        jnp.arange(w_out, dtype=jnp.float32),
        jnp.arange(h_out, dtype=jnp.float32),
    )
    xs = jnp.float32(minv[0, 0]) * gx + jnp.float32(minv[0, 1]) * gy + jnp.float32(minv[0, 2])
    ys = jnp.float32(minv[1, 0]) * gx + jnp.float32(minv[1, 1]) * gy + jnp.float32(minv[1, 2])
    return _finish(_sample_bilinear(src, xs, ys), img.dtype, squeeze)


def warp_perspective(img: jnp.ndarray, m: np.ndarray, dsize: tuple[int, int]):
    """cv2.warpPerspective(img, M, (w, h))."""
    squeeze = img.ndim == 2
    src = img[..., None] if squeeze else img
    w_out, h_out = dsize
    minv = np.linalg.inv(np.asarray(m, np.float64))
    gx, gy = jnp.meshgrid(
        jnp.arange(w_out, dtype=jnp.float32),
        jnp.arange(h_out, dtype=jnp.float32),
    )
    denom = (
        jnp.float32(minv[2, 0]) * gx + jnp.float32(minv[2, 1]) * gy + jnp.float32(minv[2, 2])
    )
    xs = (
        jnp.float32(minv[0, 0]) * gx + jnp.float32(minv[0, 1]) * gy + jnp.float32(minv[0, 2])
    ) / denom
    ys = (
        jnp.float32(minv[1, 0]) * gx + jnp.float32(minv[1, 1]) * gy + jnp.float32(minv[1, 2])
    ) / denom
    return _finish(_sample_bilinear(src, xs, ys), img.dtype, squeeze)


def order_points(pts: np.ndarray) -> np.ndarray:
    """`transform.py order_points:5-26`: tl, tr, br, bl by coordinate
    sum/diff."""
    pts = np.asarray(pts, np.float32)
    rect = np.zeros((4, 2), np.float32)
    s = pts.sum(axis=1)
    rect[0] = pts[np.argmin(s)]
    rect[2] = pts[np.argmax(s)]
    d = np.diff(pts, axis=1)
    rect[1] = pts[np.argmin(d)]
    rect[3] = pts[np.argmax(d)]
    return rect


def four_point_transform(img: jnp.ndarray, pts) -> jnp.ndarray:
    """`transform.py four_point_transform:28-64`: rectify the quad to a
    top-down view sized by the max edge lengths."""
    rect = order_points(np.asarray(pts))
    tl, tr, br, bl = rect
    width_a = np.hypot(*(br - bl))
    width_b = np.hypot(*(tr - tl))
    max_w = max(int(width_a), int(width_b))
    height_a = np.hypot(*(tr - br))
    height_b = np.hypot(*(tl - bl))
    max_h = max(int(height_a), int(height_b))
    dst = np.array(
        [[0, 0], [max_w - 1, 0], [max_w - 1, max_h - 1], [0, max_h - 1]],
        np.float32,
    )
    m = get_perspective_transform(rect, dst)
    return warp_perspective(img, m, (max_w, max_h))


def translate(img: jnp.ndarray, x: float, y: float) -> jnp.ndarray:
    """imutils.translate (`pyimagesearch/imutils.py:5-11`)."""
    m = np.float64([[1, 0, x], [0, 1, y]])
    return warp_affine(img, m, (img.shape[1], img.shape[0]))


def rotate(img: jnp.ndarray, angle: float, center=None, scale: float = 1.0):
    """imutils.rotate (`imutils.py:13-27`)."""
    h, w = img.shape[:2]
    if center is None:
        center = (w // 2, h // 2)
    m = get_rotation_matrix_2d(center, angle, scale)
    return warp_affine(img, m, (w, h))


def resize_aspect(img: jnp.ndarray, width=None, height=None):
    """imutils.resize (`imutils.py:29-58`): aspect-preserving bilinear."""
    from opticalflowclustering_tpu.ops.resize import resize_linear_hwc

    h, w = img.shape[:2]
    if width is None and height is None:
        return img
    if width is None:
        r = height / float(h)
        dim = (height, int(w * r))
    else:
        r = width / float(w)
        dim = (int(h * r), width)
    squeeze = img.ndim == 2
    src = img[..., None] if squeeze else img
    out = resize_linear_hwc(src, dim)
    if img.dtype == np.uint8 or img.dtype == jnp.uint8:
        out = jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)
    return out[..., 0] if squeeze else out
