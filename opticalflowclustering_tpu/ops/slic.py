"""SLIC superpixels (`SLIC-Superpixel/slic.py:14-15`, skimage
`slic(image, n_segments, sigma)` + `mark_boundaries`).

Data-parallel formulation of SLIC (Achanta et al. 2012 — localized k-means in
LABXY space): cluster centers start on a √K×√K grid; each pixel considers
only the 3×3 neighborhood of grid clusters (the 2S-window locality rule),
so the assignment is a static 9-way gather + argmin, and the center update
is one one-hot matmul. Everything is static-shape and jittable;
iterations unroll via `lax.fori_loop`.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from opticalflowclustering_tpu.ops.filters import gaussian_blur
from opticalflowclustering_tpu.ops.lab import bgr2lab


@functools.partial(
    jax.jit, static_argnames=("n_segments", "compactness", "n_iter", "sigma")
)
def slic(
    image_bgr: jnp.ndarray,
    n_segments: int = 100,
    compactness: float = 10.0,
    n_iter: int = 10,
    sigma: float = 5.0,
) -> jnp.ndarray:
    """[H,W,3] uint8 BGR → [H,W] int32 superpixel labels.

    skimage-equivalent parameters: n_segments (approximate), compactness
    (space/color trade-off), sigma (pre-smoothing). Labels are indices into
    the (gy×gx) cluster grid actually allocated.
    """
    f32 = jnp.float32
    h, w = image_bgr.shape[0], image_bgr.shape[1]
    lab = bgr2lab(image_bgr).astype(f32)
    if sigma > 0:
        ks = int(2 * round(3 * sigma) + 1)
        lab = gaussian_blur(lab, ks, sigma, axes=(-3, -2))

    # grid geometry (static)
    step = math.sqrt(h * w / n_segments)
    gy = max(int(round(h / step)), 1)
    gx = max(int(round(w / step)), 1)
    k = gy * gx
    sy, sx = h / gy, w / gx

    ys = jnp.arange(h, dtype=f32)[:, None]
    xs = jnp.arange(w, dtype=f32)[None, :]
    feats = jnp.concatenate(
        [lab, jnp.broadcast_to(xs, (h, w))[..., None],
         jnp.broadcast_to(ys, (h, w))[..., None]],
        axis=-1,
    )  # [H, W, 5] = (L, a, b, x, y)

    # initial centers at grid cell midpoints
    cyv = (np.arange(gy) + 0.5) * sy
    cxv = (np.arange(gx) + 0.5) * sx
    cy0, cx0 = np.meshgrid(cyv, cxv, indexing="ij")
    init_xy = jnp.asarray(
        np.stack([cx0.ravel(), cy0.ravel()], axis=-1), f32
    )
    cyi = jnp.clip(init_xy[:, 1].astype(jnp.int32), 0, h - 1)
    cxi = jnp.clip(init_xy[:, 0].astype(jnp.int32), 0, w - 1)
    centers = feats[cyi, cxi]  # [K, 5]

    # Each pixel's 9 candidate clusters: the 3×3 neighborhood of its grid
    # cell — static index arrays.
    cell_y = np.clip((np.arange(h) / sy).astype(np.int64), 0, gy - 1)
    cell_x = np.clip((np.arange(w) / sx).astype(np.int64), 0, gx - 1)
    cand = np.empty((h, w, 9), np.int32)
    i = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ny = np.clip(cell_y[:, None] + dy, 0, gy - 1)
            nx = np.clip(cell_x[None, :] + dx, 0, gx - 1)
            cand[:, :, i] = ny * gx + nx
            i += 1
    cand = jnp.asarray(cand)

    # SLIC distance: d² = d_lab² + (compactness/step)²·d_xy²
    ratio = f32((compactness / step) ** 2)
    weights = jnp.asarray([1.0, 1.0, 1.0, 0.0, 0.0], f32) + jnp.asarray(
        [0.0, 0.0, 0.0, 1.0, 1.0], f32
    ) * ratio

    def assign(centers):
        cfeat = centers[cand]  # [H, W, 9, 5]
        d = feats[:, :, None, :] - cfeat
        d2 = jnp.sum(d * d * weights, axis=-1)
        best = jnp.argmin(d2, axis=-1)  # [H, W] ∈ [0, 9)
        return jnp.take_along_axis(cand, best[..., None], axis=-1)[..., 0]

    def update(labels):
        onehot = jax.nn.one_hot(labels.ravel(), k, dtype=f32)  # [HW, K]
        counts = jnp.sum(onehot, axis=0)
        sums = jnp.dot(
            onehot.T, feats.reshape(-1, 5), preferred_element_type=f32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return sums / jnp.maximum(counts[:, None], 1.0)

    def body(_, centers):
        return update(assign(centers))

    centers = jax.lax.fori_loop(0, n_iter, body, centers)
    return assign(centers)


def mark_boundaries(image_bgr: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """skimage mark_boundaries-style overlay: pixels adjacent to a label
    change painted yellow-ish, returned as float in [0,1] like skimage."""
    h, w = labels.shape
    diff = jnp.zeros((h, w), bool)
    diff = diff.at[:, 1:].set(labels[:, 1:] != labels[:, :-1])
    diff = diff.at[1:, :].set(diff[1:, :] | (labels[1:, :] != labels[:-1, :]))
    img = image_bgr.astype(jnp.float32) / 255.0
    color = jnp.asarray([0.0, 1.0, 1.0], jnp.float32)  # BGR yellow
    return jnp.where(diff[..., None], color, img)
