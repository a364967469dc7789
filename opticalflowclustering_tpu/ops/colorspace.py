"""OpenCV-exact color-space conversions as pure-JAX ops.

The reference leans on `cv2.cvtColor` everywhere (e.g.
`k-means-color-clustering/computeOpticalFlowModule.py:16,19,33`,
`k-means-color-clustering/KmeanGrids.py:86,92,336`). OpenCV's uint8 paths are
fixed-point integer algorithms, so matching the reference's golden CSV outputs
(hue values!) requires replicating that integer arithmetic bit-exactly — a
float approximation is off by one in the last bit often enough to break
golden-file parity. All functions take channel-last uint8 arrays with
arbitrary leading batch dims and are jit/vmap/shard_map friendly.

Bit-exactness is enforced by tests/test_colorspace.py against cv2 itself,
exhaustively over the full input domain where feasible.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

# OpenCV fixed-point constants (modules/imgproc color conversions).
# OpenCV 5.x gray uses a 15-bit fixed-point BT.601 kernel whose coefficients
# sum exactly to 1<<15 (verified bit-exact against cv2 5.0 over all 256³
# inputs in tests/test_colorspace.py):
_YUV_SHIFT = 15
_R2Y, _G2Y, _B2Y = 9798, 19235, 3735
_HSV_SHIFT = 12


def _cvround(x: np.ndarray) -> np.ndarray:
    """OpenCV cvRound = round half to even (numpy's default rounding)."""
    return np.rint(x)


@functools.lru_cache(maxsize=1)
def _hsv_div_tables() -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's sdiv/hdiv tables: saturate_cast<int>((255<<12)/i) and
    ((180<<12)/(6*i)), with entry 0 = 0."""
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = _cvround((255 << _HSV_SHIFT) / i)
        hdiv = _cvround((180 << _HSV_SHIFT) / (6.0 * i))
    sdiv[0] = 0
    hdiv[0] = 0
    return sdiv.astype(np.int32), hdiv.astype(np.int32)


def bgr2gray(bgr: jnp.ndarray) -> jnp.ndarray:
    """cv2.cvtColor(x, COLOR_BGR2GRAY) for uint8, bit-exact.

    OpenCV 5.x: y = (B*3735 + G*19235 + R*9798 + (1<<14)) >> 15.
    Used per frame in the reference (`computeOpticalFlowModule.py:16,19`).
    """
    x = bgr.astype(jnp.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = (b * _B2Y + g * _G2Y + r * _R2Y + (1 << (_YUV_SHIFT - 1))) >> _YUV_SHIFT
    return y.astype(jnp.uint8)


def rgb2gray(rgb: jnp.ndarray) -> jnp.ndarray:
    """cv2.cvtColor(x, COLOR_RGB2GRAY) for uint8, bit-exact."""
    return bgr2gray(rgb[..., ::-1])


def bgr2rgb(x: jnp.ndarray) -> jnp.ndarray:
    """cv2.cvtColor(x, COLOR_BGR2RGB) — channel flip (`KmeanGrids.py:267`)."""
    return x[..., ::-1]


def bgr2hsv(bgr: jnp.ndarray) -> jnp.ndarray:
    """cv2.cvtColor(x, COLOR_BGR2HSV) for uint8, bit-exact.

    OpenCV's fixed-point algorithm (hsv_shift=12 with division tables):
        v = max(b,g,r); diff = v - min(b,g,r)
        s = (diff * sdiv[v] + (1<<11)) >> 12
        h = g-b            if v==r
            b-r + 2*diff   elif v==g
            r-g + 4*diff   else
        h = (h * hdiv[diff] + (1<<11)) >> 12;  h += 180 if h < 0
    H ∈ [0,180), S,V ∈ [0,255]. This is the op behind every hue the golden
    CSVs contain (`KmeanGrids.py:336`, `color_kmeans.py:121`,
    `drawGridsAndOutputCSV.py:87`).
    """
    sdiv_np, hdiv_np = _hsv_div_tables()
    sdiv = jnp.asarray(sdiv_np)
    hdiv = jnp.asarray(hdiv_np)

    x = bgr.astype(jnp.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = jnp.maximum(jnp.maximum(b, g), r)
    vmin = jnp.minimum(jnp.minimum(b, g), r)
    diff = v - vmin

    s = (diff * sdiv[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = jnp.where(
        v == r,
        g - b,
        jnp.where(v == g, b - r + 2 * diff, r - g + 4 * diff),
    )
    # Arithmetic right shift on negative int32 == floor division by 4096,
    # matching C's behavior on gcc (jnp.right_shift is arithmetic for ints).
    h = (h * hdiv[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = jnp.where(h < 0, h + 180, h)
    return jnp.stack([h, s, v], axis=-1).astype(jnp.uint8)


# OpenCV HSV2RGB sector table: b,g,r = tab[sector_data[sector][0..2]]
# (for BGR output order; blueIdx=0).
_SECTOR_DATA = np.array(
    [[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]],
    dtype=np.int32,
)


def hsv2bgr(hsv: jnp.ndarray) -> jnp.ndarray:
    """cv2.cvtColor(x, COLOR_HSV2BGR) for uint8 (float32 internal path).

    OpenCV converts s,v to [0,1], scales h by 6/180, folds into a sector in
    [0,6), interpolates {v, v(1-s), v(1-s·f), v(1-s(1-f))} by sector, and
    rounds back to uint8 (round half to even). Used to render flow HSV to BGR
    (`computeOpticalFlowModule.py:33`).

    Note: OpenCV builds with Intel IPP dispatch large images to an IPP kernel
    that truncates where OpenCV's own scalar path rounds (±1 disagreement on
    ~1/3 of inputs). We replicate the canonical scalar
    algorithm (what cv2 computes for small images / non-IPP builds); tests
    pin bit-exactness against the scalar path and ±1 against the IPP path.
    """
    f32 = jnp.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)

    # fmod into [0,6) exactly like C fmodf for non-negative input.
    h = h - f32(6.0) * jnp.trunc(h * f32(1.0 / 6.0))
    # Guard against h==6.0 after float fmod.
    sector = jnp.clip(jnp.floor(h).astype(jnp.int32), 0, 5)
    f = h - sector.astype(f32)

    tab = (v, v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f)))
    # Sector-table lookup as elementwise selects: 6 sectors × 3 channels
    # of jnp.where fuse into one elementwise pass, with no gather.
    channels = []
    for ch in range(3):
        val = tab[_SECTOR_DATA[0][ch]]
        for sec in range(1, 6):
            val = jnp.where(sector == sec, tab[_SECTOR_DATA[sec][ch]], val)
        channels.append(val)
    bgr = jnp.stack(channels, axis=-1)
    return jnp.clip(jnp.round(bgr * f32(255.0)), 0, 255).astype(jnp.uint8)
