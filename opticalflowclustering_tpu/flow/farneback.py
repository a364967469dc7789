"""Farneback dense optical flow in JAX.

Re-implementation of the algorithm behind `cv2.calcOpticalFlowFarneback`
(the dominant cost of the reference pipeline —
`k-means-color-clustering/computeOpticalFlowModule.py:20-22` calls it per
frame with params (0.5, 3, 15, 3, 5, 1.2, 0)), built from Farnebäck 2003
("Two-frame motion estimation based on polynomial expansion") and the
functional semantics of OpenCV's optflowgf implementation:

  per pyramid level k = levels..0 (scale = pyr_scale^k, resampled from the
  FULL-resolution image each level, Gaussian-presmoothed with
  sigma = (1/scale-1)/2):
    R_i   = polynomial expansion of each image (separable Gaussian-weighted
            least squares, poly_n taps, poly_sigma)
    M     = local-system tensor from R_0, R_1 warped by current flow
    iter: flow = solve2x2(box_winsize(M));  M = rebuild(flow)   ×iterations

Everything is static-shape, batched, and expressed as fused elementwise
chains + two banded-matmul resizes per level, so XLA keeps the whole
pyramid HBM-resident. The per-level Python loop unrolls at trace time
(level shapes are static for a given input resolution).

Matches OpenCV to sub-0.1px EPE (tests/test_farneback.py), including its
border tapering, warp clamping and min-size pyramid truncation.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from opticalflowclustering_tpu.ops.filters import box_sum, gaussian_blur, gaussian_kernel
from opticalflowclustering_tpu.ops.resize import resize_linear

_MIN_SIZE = 32  # OpenCV: pyramid levels stop below 32 px on either side
_BORDER = 5
# OpenCV FarnebackUpdateMatrices edge taper.
_BORDER_SCALE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class FarnebackParams:
    """Mirror of cv2.calcOpticalFlowFarneback's signature; defaults are the
    reference's exact call (`computeOpticalFlowModule.py:20-22`).

    warp_mode selects the flow-warp implementation inside the local-system
    rebuild:
      'exact'  — per-pixel bilinear gather, bit-faithful to OpenCV.
      'select' — legacy gather-free select-warp (shifted-copy where-chains):
                 exact for displacements within ±warp_radius whose integer
                 part is locally smooth; the where-chains don't fuse, so it
                 is bound by memory traffic.
    """

    pyr_scale: float = 0.5
    levels: int = 3
    winsize: int = 15
    iterations: int = 3
    poly_n: int = 5
    poly_sigma: float = 1.2
    gaussian_win: bool = False  # OPTFLOW_FARNEBACK_GAUSSIAN
    warp_mode: str = "exact"
    warp_radius: int = 32  # 'select' mode only


def _cvround(x: float) -> int:
    return int(np.rint(x))


@functools.lru_cache(maxsize=32)
def _poly_exp_consts(n: int, sigma: float):
    """Per-tap weights (g, xg, xxg) and the 4 inverse-Gram coefficients of
    the 6×6 Gaussian-weighted monomial Gram matrix, as OpenCV builds them."""
    if sigma < 1e-7:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2 * sigma * sigma))
    g /= g.sum()
    # float32 quantization happens in OpenCV before the products; replicate.
    g = g.astype(np.float32).astype(np.float64)
    xg = (x * g).astype(np.float32).astype(np.float64)
    xxg = (x * x * g).astype(np.float32).astype(np.float64)

    G = np.zeros((6, 6), dtype=np.float64)
    for yy in x:
        for xx in x:
            w = g[int(yy) + n] * g[int(xx) + n]
            G[0, 0] += w
            G[1, 1] += w * xx * xx
            G[3, 3] += w * xx**4
            G[5, 5] += w * xx * xx * yy * yy
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    invG = np.linalg.inv(G)
    return (
        g.astype(np.float32),
        xg.astype(np.float32),
        xxg.astype(np.float32),
        float(invG[1, 1]),
        float(invG[0, 3]),
        float(invG[3, 3]),
        float(invG[5, 5]),
    )


def poly_expansion(img: jnp.ndarray, n: int, sigma: float) -> jnp.ndarray:
    """Quadratic polynomial expansion of [..., H, W] → [..., H, W, 5].

    Channels (OpenCV layout): 0: y-linear, 1: x-linear, 2: y², 3: x², 4: xy
    coefficients of the local signal model f(x) ≈ xᵀAx + bᵀx + c.
    Separable Gaussian-weighted least squares: a replicate-padded vertical
    pass producing (Σg·I, Σxg·I, Σxxg·I), then a horizontal pass combining
    them through the inverse Gram coefficients.
    """
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_consts(n, sigma)
    f32 = jnp.float32
    x = img.astype(f32)
    h = x.shape[-2]
    w = x.shape[-1]

    def pad(a, axis):
        pads = [(0, 0)] * a.ndim
        pads[axis] = (n, n)
        return jnp.pad(a, pads, mode="edge")

    # Vertical pass (replicate border, OpenCV's clamped row indexing).
    xp = pad(x, x.ndim - 2)

    def vsl(off):
        return jax.lax.slice_in_dim(xp, off, off + h, axis=x.ndim - 2)

    t0 = f32(g[n]) * vsl(n)
    t1 = jnp.zeros_like(t0)
    t2 = jnp.zeros_like(t0)
    for k in range(1, n + 1):
        up, down = vsl(n - k), vsl(n + k)
        t0 = t0 + f32(g[n + k]) * (up + down)
        t1 = t1 + f32(xg[n + k]) * (down - up)
        t2 = t2 + f32(xxg[n + k]) * (up + down)

    # Horizontal pass (replicate border).
    t0p = pad(t0, x.ndim - 1)
    t1p = pad(t1, x.ndim - 1)
    t2p = pad(t2, x.ndim - 1)

    def hsl(a, off):
        return jax.lax.slice_in_dim(a, off, off + w, axis=x.ndim - 1)

    b1 = f32(g[n]) * hsl(t0p, n)
    b3 = f32(g[n]) * hsl(t1p, n)
    b5 = f32(g[n]) * hsl(t2p, n)
    b2 = jnp.zeros_like(b1)
    b4 = jnp.zeros_like(b1)
    b6 = jnp.zeros_like(b1)
    for k in range(1, n + 1):
        l0, r0 = hsl(t0p, n - k), hsl(t0p, n + k)
        l1, r1 = hsl(t1p, n - k), hsl(t1p, n + k)
        l2, r2 = hsl(t2p, n - k), hsl(t2p, n + k)
        b1 = b1 + f32(g[n + k]) * (l0 + r0)
        b4 = b4 + f32(xxg[n + k]) * (l0 + r0)
        b2 = b2 + f32(xg[n + k]) * (r0 - l0)
        b6 = b6 + f32(xg[n + k]) * (r1 - l1)
        b3 = b3 + f32(g[n + k]) * (l1 + r1)
        b5 = b5 + f32(g[n + k]) * (l2 + r2)

    return jnp.stack(
        [
            b3 * f32(ig11),
            b2 * f32(ig11),
            b5 * f32(ig33) + b1 * f32(ig03),
            b4 * f32(ig33) + b1 * f32(ig03),
            b6 * f32(ig55),
        ],
        axis=-1,
    )


@functools.lru_cache(maxsize=64)
def _border_taper(h: int, w: int) -> np.ndarray:
    """OpenCV's per-pixel edge taper: product of per-side ramps
    {0.14, 0.14, 0.4472, 0.4472, 0.4472} within 5 px of each border."""
    ramp_x = np.ones(w, dtype=np.float32)
    ramp_y = np.ones(h, dtype=np.float32)
    for i in range(min(_BORDER, w)):
        ramp_x[i] *= _BORDER_SCALE[i]
        ramp_x[w - 1 - i] *= _BORDER_SCALE[i]
    for i in range(min(_BORDER, h)):
        ramp_y[i] *= _BORDER_SCALE[i]
        ramp_y[h - 1 - i] *= _BORDER_SCALE[i]
    return ramp_y[:, None] * ramp_x[None, :]


def _warp_gather(r1: jnp.ndarray, y1c, x1c, fx, fy) -> jnp.ndarray:
    """Exact bilinear warp (OpenCV-faithful): one take per corner from the
    flattened [B·Hs·W, C] coefficients. r1: [..., Hs, W, C] source;
    y1c/x1c/fx/fy: [..., H, W] output grid, with y1c ≤ Hs-2 and x1c ≤ W-2
    so the +1 corners stay inside the source."""
    hs, w, c = r1.shape[-3], r1.shape[-2], r1.shape[-1]
    h = y1c.shape[-2]
    lead = r1.shape[:-3]
    b = int(np.prod(lead)) if lead else 1
    flat = r1.reshape(b * hs * w, c)
    boff = (jnp.arange(b, dtype=jnp.int32) * (hs * w)).reshape((b, 1, 1))
    base = ((y1c * w + x1c).reshape(b, h, w) + boff).reshape(-1)

    def corner(off):
        return jnp.take(flat, base + off, axis=0).reshape(lead + (h, w, c))

    p00, p01, p10, p11 = corner(0), corner(1), corner(w), corner(w + 1)
    fxe = fx[..., None]
    fye = fy[..., None]
    return (
        p00 * (1 - fxe) * (1 - fye)
        + p01 * fxe * (1 - fye)
        + p10 * (1 - fxe) * fye
        + p11 * fxe * fye
    )


def _warp_select(r1: jnp.ndarray, y1i, x1i, fx, fy, radius: int) -> jnp.ndarray:
    """Gather-free separable select-warp (warp_mode='select'): the integer
    displacement picks from shifted array copies via per-pixel masks —
    pure elementwise traffic. See FarnebackParams.warp_mode for the accuracy
    contract. Out-of-range displacements clamp; callers discard those
    pixels through the out-of-bounds fallback mask anyway.
    r1: [..., H, W, C]."""
    h, w = r1.shape[-3], r1.shape[-2]
    nb = r1.ndim - 3
    ys = jnp.arange(h, dtype=jnp.int32)[:, None]
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]
    oy = jnp.clip(y1i - ys, -radius, radius - 1)
    ox = jnp.clip(x1i - xs, -radius, radius - 1)
    pad = radius + 1
    zero = [(0, 0)] * nb
    rp = jnp.pad(r1, zero + [(pad, pad), (0, 0), (0, 0)], mode="edge")
    a0 = jnp.zeros_like(r1)
    a1 = jnp.zeros_like(r1)
    for o in range(-radius, radius):
        sel = (oy == o)[..., None]
        a0 = jnp.where(sel, rp[..., pad + o : pad + o + h, :, :], a0)
        a1 = jnp.where(sel, rp[..., pad + o + 1 : pad + o + 1 + h, :, :], a1)
    fye = fy[..., None]
    av = a0 * (1 - fye) + a1 * fye
    avp = jnp.pad(av, zero + [(0, 0), (pad, pad), (0, 0)], mode="edge")
    b0 = jnp.zeros_like(r1)
    b1 = jnp.zeros_like(r1)
    for o in range(-radius, radius):
        sel = (ox == o)[..., None]
        b0 = jnp.where(sel, avp[..., pad + o : pad + o + w, :], b0)
        b1 = jnp.where(sel, avp[..., pad + o + 1 : pad + o + 1 + w, :], b1)
    fxe = fx[..., None]
    return b0 * (1 - fxe) + b1 * fxe


def _m_build(r0c, r1wc, dx, dy, inb, taper):
    """Normal-equation products from warped coefficients, shared by both
    warp modes so each produces M through the identical op sequence.

    r0c, r1wc: 5-tuples of per-channel arrays; returns the 5 M channels
    (G11, G12, G22, h1, h2). In-bounds pixels average the quadratic terms;
    out-of-bounds keep r0's with the halved cross term (OpenCV's
    constant-motion fallback), then the 5-px border taper applies."""
    f32 = jnp.float32
    r4 = jnp.where(inb, (r0c[2] + r1wc[2]) * f32(0.5), r0c[2])
    r5 = jnp.where(inb, (r0c[3] + r1wc[3]) * f32(0.5), r0c[3])
    r6 = jnp.where(inb, (r0c[4] + r1wc[4]) * f32(0.25), r0c[4] * f32(0.5))
    r2 = (r0c[0] - jnp.where(inb, r1wc[0], f32(0.0))) * f32(0.5)
    r3 = (r0c[1] - jnp.where(inb, r1wc[1], f32(0.0))) * f32(0.5)
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    r2 = r2 * taper
    r3 = r3 * taper
    r4 = r4 * taper
    r5 = r5 * taper
    r6 = r6 * taper

    return (
        r4 * r4 + r6 * r6,
        (r4 + r5) * r6,
        r5 * r5 + r6 * r6,
        r4 * r2 + r6 * r3,
        r6 * r2 + r5 * r3,
    )


def update_matrices(
    r0: jnp.ndarray,
    r1: jnp.ndarray,
    flow: jnp.ndarray,
    warp_mode: str = "exact",
    warp_radius: int = 32,
) -> jnp.ndarray:
    """Build the 5-channel local-system tensor M = [G11,G12,G22,h1,h2].

    Warps R1 by the current flow (bilinear, with OpenCV's out-of-bounds
    fallback: constant-motion assumption and halved cross term), averages
    the quadratic coefficients, forms the normal equations of
    A·d = Δb, and tapers the 5-px border.
    r0, r1: [..., H, W, 5]; flow: [..., H, W, 2] (x,y) → [..., H, W, 5].
    """
    f32 = jnp.float32
    h, w = flow.shape[-3], flow.shape[-2]
    dx = flow[..., 0]
    dy = flow[..., 1]
    gx = jnp.arange(w, dtype=jnp.float32)[None, :] + dx
    gy = jnp.arange(h, dtype=jnp.float32)[:, None] + dy
    x1 = jnp.floor(gx)
    y1 = jnp.floor(gy)
    fx = gx - x1
    fy = gy - y1
    x1i = x1.astype(jnp.int32)
    y1i = y1.astype(jnp.int32)
    inb = (x1i >= 0) & (x1i <= w - 2) & (y1i >= 0) & (y1i <= h - 2)
    if warp_mode == "select":
        # Displacements beyond the select-chain's exactness window take the
        # same constant-motion fallback OpenCV applies to out-of-image
        # samples — intermediate solver spikes (near-singular windows at the
        # tapered border) routinely exceed any static radius and must not
        # feed clamped garbage back into the iteration.
        ys_i = jnp.arange(h, dtype=jnp.int32)[:, None]
        xs_i = jnp.arange(w, dtype=jnp.int32)[None, :]
        inb = (
            inb
            & (jnp.abs(y1i - ys_i) <= warp_radius - 1)
            & (jnp.abs(x1i - xs_i) <= 126)
        )
        r1w = _warp_select(r1, y1i, x1i, fx, fy, warp_radius)
    else:
        x1c = jnp.clip(x1i, 0, w - 2)
        y1c = jnp.clip(y1i, 0, h - 2)
        r1w = _warp_gather(r1, y1c, x1c, fx, fy)

    taper = jnp.asarray(_border_taper(h, w))
    r0c = tuple(r0[..., c] for c in range(5))
    r1wc = tuple(r1w[..., c] for c in range(5))
    return jnp.stack(_m_build(r0c, r1wc, dx, dy, inb, taper), axis=-1)


def _update_flow(m: jnp.ndarray, winsize: int, gaussian: bool) -> jnp.ndarray:
    """Solve the windowed 2×2 system: flow = G⁻¹h with G,h box- (or
    Gaussian-) accumulated over winsize×winsize, det regularized by 1e-3."""
    f32 = jnp.float32
    if gaussian:
        mhalf = winsize // 2
        sigma = mhalf * 0.3
        x = np.arange(-mhalf, mhalf + 1, dtype=np.float64)
        kern = np.exp(-(x**2) / (2 * sigma * sigma))
        kern = kern / kern.sum()
        from opticalflowclustering_tpu.ops.filters import sep_filter_axis

        s = sep_filter_axis(m, kern, axis=-3, border="replicate")
        s = sep_filter_axis(s, kern, axis=-2, border="replicate")
    else:
        s = box_sum(m, winsize, border="replicate", axes=(-3, -2)) * f32(
            1.0 / (winsize * winsize)
        )
    g11 = s[..., 0]
    g12 = s[..., 1]
    g22 = s[..., 2]
    h1 = s[..., 3]
    h2 = s[..., 4]
    idet = f32(1.0) / (g11 * g22 - g12 * g12 + f32(1e-3))
    fx = (g11 * h2 - g12 * h1) * idet
    fy = (g22 * h1 - g12 * h2) * idet
    return jnp.stack([fx, fy], axis=-1)


def pyramid_plan(
    height: int, width: int, params: FarnebackParams
) -> list[tuple[int, int, int, float]]:
    """Static per-level plan [(k, h_k, w_k, sigma_k)] from coarsest to
    finest, with OpenCV's min-size truncation (stop when either side×scale
    drops below 32)."""
    levels = 0
    scale = 1.0
    for k in range(params.levels):
        scale *= params.pyr_scale
        if width * scale < _MIN_SIZE or height * scale < _MIN_SIZE:
            break
        levels = k + 1
    plan = []
    for k in range(levels, -1, -1):
        scale = params.pyr_scale**k
        sigma = (1.0 / scale - 1.0) * 0.5
        h_k = _cvround(height * scale)
        w_k = _cvround(width * scale)
        plan.append((k, h_k, w_k, sigma))
    return plan


def farneback_flow(
    prev_img: jnp.ndarray,
    next_img: jnp.ndarray,
    params: FarnebackParams = FarnebackParams(),
) -> jnp.ndarray:
    """Dense flow for grayscale pairs: [..., H, W] (uint8 or float) →
    [..., H, W, 2]. Natively batched over any leading dims.

    Functionally equivalent to
    cv2.calcOpticalFlowFarneback(prev, next, None, pyr_scale, levels,
    winsize, iterations, poly_n, poly_sigma, flags) — the reference's exact
    usage at `computeOpticalFlowModule.py:20-22`.
    """
    h, w = prev_img.shape[-2], prev_img.shape[-1]
    lead = tuple(prev_img.shape[:-2])
    plan = pyramid_plan(h, w, params)
    prev_f = prev_img.astype(jnp.float32)
    next_f = next_img.astype(jnp.float32)

    flow = None
    for k, h_k, w_k, sigma in plan:
        smooth_sz = max(_cvround(sigma * 5) | 1, 3)
        levels_imgs = []
        with jax.named_scope("pyramid"):
            for img in (prev_f, next_f):
                sm = gaussian_blur(img, smooth_sz, sigma, border="reflect101")
                levels_imgs.append(resize_linear(sm, (h_k, w_k)))
        with jax.named_scope("poly_expansion"):
            r0 = poly_expansion(levels_imgs[0], params.poly_n, params.poly_sigma)
            r1 = poly_expansion(levels_imgs[1], params.poly_n, params.poly_sigma)

        if flow is None:
            flow = jnp.zeros(lead + (h_k, w_k, 2), jnp.float32)
        else:
            flow = resize_linear_flow(flow, (h_k, w_k)) * jnp.float32(
                1.0 / params.pyr_scale
            )

        # Flow values at level k are in level-k pixels (≈ motion / 2^k),
        # so the bounded select-warp needs proportionally less vertical
        # reach at coarse levels — halve the radius per level, floor 8.
        radius_k = max(8, params.warp_radius >> k)

        for i in range(params.iterations):
            with jax.named_scope("update_matrices"):
                m = update_matrices(r0, r1, flow, params.warp_mode, radius_k)
            with jax.named_scope("update_flow"):
                flow = _update_flow(m, params.winsize, params.gaussian_win)
    return flow


def resize_linear_flow(flow: jnp.ndarray, dst_hw: tuple[int, int]) -> jnp.ndarray:
    """Bilinear-resize a [..., H, W, 2] flow field (channel-last)."""
    return jnp.moveaxis(
        resize_linear(jnp.moveaxis(flow, -1, -3), dst_hw), -3, -1
    )


def farneback_flow_batched(
    gray_frames: jnp.ndarray, params: FarnebackParams = FarnebackParams()
) -> jnp.ndarray:
    """Flow for every consecutive pair of [N, H, W] frames → [N-1, H, W, 2].

    Replaces the reference's sequential per-frame loop
    (`KmeanGrids.py:180-187`): all N-1 pairs are independent and
    farneback_flow is natively batched, so this is one call."""
    return farneback_flow(gray_frames[:-1], gray_frames[1:], params)
