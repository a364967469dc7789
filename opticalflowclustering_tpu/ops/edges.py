"""Gradient / edge primitives: Sobel, Scharr, Laplacian, Canny, bilateral.

Reference call sites: barcode gradients (`detect-barcodes/detect_barcode.py:
12-13`, Scharr via ksize=-1), document edges (`DocumentScanner/scan.py:20`
Canny 75/200), Game Boy screen finding (`Pokedex/find_screen.py:18-19`
bilateralFilter(11,17,17) + Canny 30/200).

Sobel/Scharr are separable shifted-slice correlations (REFLECT_101 border,
like OpenCV). Canny is the full pipeline — Sobel gradients, 4-direction
non-maximum suppression, double threshold, and hysteresis as an iterative
8-neighbor dilation over the strong-edge mask (a bounded `lax.while_loop`
fixpoint — the data-parallel formulation of OpenCV's BFS stack).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from opticalflowclustering_tpu.ops.filters import sep_filter_axis


def _deriv_kernels(order: int, ksize: int) -> np.ndarray:
    """cv2.getDerivKernels column for one axis (smoothing if order=0)."""
    if ksize == -1:  # Scharr
        return np.array([3.0, 10.0, 3.0]) if order == 0 else np.array([-1.0, 0.0, 1.0])
    if ksize == 1:
        return np.array([1.0]) if order == 0 else np.array([-1.0, 0.0, 1.0])
    # Pascal's-triangle construction (OpenCV getDerivKernels).
    k = np.array([1.0])
    for _ in range(ksize - 1 - order):
        k = np.convolve(k, [1.0, 1.0])
    for _ in range(order):
        k = np.convolve(k, [1.0, -1.0])
    return k[::-1]


def sobel(
    img: jnp.ndarray, dx: int, dy: int, ksize: int = 3,
    border: str = "reflect101",
) -> jnp.ndarray:
    """cv2.Sobel(img, CV_32F, dx, dy, ksize) / cv2.Scharr when ksize=-1.
    [..., H, W] → float32. `border` matches cv2.Sobel's default
    (BORDER_REFLECT_101); cv2.Canny's internal Sobel uses 'replicate'."""
    kx = _deriv_kernels(dx, ksize)
    ky = _deriv_kernels(dy, ksize)
    x = img.astype(jnp.float32)
    x = sep_filter_axis(x, ky, axis=-2, border=border)
    x = sep_filter_axis(x, kx, axis=-1, border=border)
    return x


def laplacian(img: jnp.ndarray, ksize: int = 1) -> jnp.ndarray:
    """cv2.Laplacian(img, CV_32F): sum of second derivatives."""
    if ksize == 1:
        k = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)
        x = img.astype(jnp.float32)
        h, w = x.shape[-2], x.shape[-1]
        pads = [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)]
        xp = jnp.pad(x, pads, mode="reflect")
        acc = jnp.zeros_like(x)
        for i in range(3):
            for j in range(3):
                if k[i, j]:
                    acc = acc + jnp.float32(k[i, j]) * xp[..., i : i + h, j : j + w]
        return acc
    return sobel(img, 2, 0, ksize) + sobel(img, 0, 2, ksize)


def canny(
    img: jnp.ndarray,
    threshold1: float,
    threshold2: float,
    l2gradient: bool = False,
    hysteresis_iters: int = 64,
) -> jnp.ndarray:
    """cv2.Canny for a uint8 [..., H, W] image → uint8 edge map {0, 255}.

    BIT-EXACT re-derivation of OpenCV's aperture-3 path (validated
    pixel-for-pixel on the reference demo images at 50/100 and 75/200):

    * gradients via Sobel-3 with BORDER_REPLICATE — cv2.Canny's internal
      Sobel border, NOT cv2.Sobel's reflect-101 default (the mismatch
      shows up as phantom/missing edges exactly on image border rows);
    * INTEGER L1 magnitude (|gx|+|gy| on the int16 Sobel values) with
      integer thresholds, or int32 squared magnitude for l2gradient
      (exact: values and squared thresholds both fit below 2^31), with
      cv2's threshold conversion order (square-the-double-then-floor,
      negatives never squared);
    * cv2's fixed-point sector NMS: |gy|·2^15 compared against
      |gx|·TG22 (TG22 = 13573 ≈ tan22.5°·2^15) and |gx|·TG22 + |gx|·2^16
      (tan67.5° = tan22.5° + 2), sign via the int XOR of gx, gy, with
      cv2's tie rules — (>, ≥) for the horizontal/vertical sectors and
      STRICT > on both diagonal neighbors;
    * hysteresis to fixpoint via iterative strong-edge propagation over
      the weak mask (a bounded `lax.while_loop` — the data-parallel form of
      OpenCV's BFS stack), zero magnitude outside the image.
    """
    import math

    i32 = jnp.int32
    # cv2's exact threshold conversion order: swap so low <= high, then for
    # L2 clip each to 2^15-1 and square ONLY positive values (a negative
    # threshold stays as-is), then cvFloor to int — squaring the double
    # BEFORE flooring (floor(50.5^2)=2550, not int(50.5)^2=2500).
    lo_f, hi_f = min(threshold1, threshold2), max(threshold1, threshold2)
    if l2gradient:
        lo_f = min(32767.0, lo_f)
        hi_f = min(32767.0, hi_f)
        if lo_f > 0:
            lo_f *= lo_f
        if hi_f > 0:
            hi_f *= hi_f
    low, high = math.floor(lo_f), math.floor(hi_f)
    gx = sobel(img, 1, 0, 3, border="replicate").astype(i32)
    gy = sobel(img, 0, 1, 3, border="replicate").astype(i32)
    if l2gradient:
        # int32 is exact here: |g| <= 4*255 for uint8 input, so the squared
        # magnitude <= ~2.1e6 and the squared thresholds <= 32767^2 < 2^31.
        mag = gx * gx + gy * gy
    else:
        mag = jnp.abs(gx) + jnp.abs(gy)

    h, w = mag.shape[-2], mag.shape[-1]
    pads = [(0, 0)] * (mag.ndim - 2) + [(1, 1), (1, 1)]
    mp = jnp.pad(mag, pads, mode="constant")

    def nb(dy, dx):
        return mp[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    # cv2's integer sector selection (CANNY_SHIFT = 15).
    ax, ay = jnp.abs(gx), jnp.abs(gy) << 15
    tg22x = ax * 13573
    tg67x = tg22x + (ax << 16)
    horiz = ay < tg22x  # gradient mostly horizontal → compare l/r
    vert = ay > tg67x  # mostly vertical → compare up/down
    diag1 = ((gx ^ gy) >= 0) & ~horiz & ~vert
    keep = jnp.where(
        horiz,
        (mag > nb(0, -1)) & (mag >= nb(0, 1)),
        jnp.where(
            vert,
            (mag > nb(-1, 0)) & (mag >= nb(1, 0)),
            jnp.where(
                diag1,
                (mag > nb(-1, -1)) & (mag > nb(1, 1)),
                (mag > nb(-1, 1)) & (mag > nb(1, -1)),
            ),
        ),
    )
    strong = keep & (mag > high)
    weak = keep & (mag > low)

    def dilate8(m):
        mpad = jnp.pad(m, pads, mode="constant")
        out = m
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy == 0 and dx == 0:
                    continue
                out = out | mpad[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        return out

    def body(state):
        cur, _ = state
        grown = dilate8(cur) & weak
        return grown, jnp.any(grown != cur)

    def cond(state):
        return state[1]

    final, _ = jax.lax.while_loop(
        cond, body, (strong, jnp.asarray(True))
    )
    return jnp.where(final, jnp.uint8(255), jnp.uint8(0))


def bilateral_filter(
    img: jnp.ndarray, d: int, sigma_color: float, sigma_space: float
) -> jnp.ndarray:
    """cv2.bilateralFilter for uint8/float [..., H, W] (grayscale) or
    [..., H, W, C]: windowed Gaussian in space × Gaussian in intensity,
    replicate border. OpenCV uses radius d//2 and exp tables; same math."""
    chan = img.ndim >= 3 and img.shape[-1] in (1, 3)
    x = img.astype(jnp.float32)
    if not chan:
        x = x[..., None]
    r = d // 2
    gauss_color = -0.5 / (sigma_color * sigma_color)
    h, w = x.shape[-3], x.shape[-2]
    pads = [(0, 0)] * (x.ndim - 3) + [(r, r), (r, r), (0, 0)]
    xp = jnp.pad(x, pads, mode="reflect")  # BORDER_DEFAULT = REFLECT_101
    num = jnp.zeros_like(x)
    den = jnp.zeros(x.shape[:-1] + (1,), jnp.float32)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy * dy + dx * dx > r * r:
                continue
            sw = np.exp((dy * dy + dx * dx) * -0.5 / (sigma_space * sigma_space))
            nbr = xp[..., r + dy : r + dy + h, r + dx : r + dx + w, :]
            diff = jnp.sum(jnp.abs(nbr - x), axis=-1, keepdims=True)
            cw = jnp.exp(diff * diff * jnp.float32(gauss_color))
            wgt = jnp.float32(sw) * cw
            num = num + wgt * nbr
            den = den + wgt
    out = num / den
    if not chan:
        out = out[..., 0]
    if img.dtype == jnp.uint8:
        out = jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)
    return out
