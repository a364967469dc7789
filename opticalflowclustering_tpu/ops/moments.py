"""Shape descriptors: image moments, Hu invariants, Zernike moments.

Reference call sites: Hu moments demo
(`opencv-shape-descriptors/humoments.py:7`) and the Pokédex shape index
(`Pokedex/pyimagesearch/zernikemoments.py:10-12`, mahotas
`zernike_moments(image, radius, degree=8)`).

On the device, raw moments are weighted reductions against precomputed
coordinate-power grids; Zernike is a single [P, K] basis matmul where the
basis (radial polynomials × angular phases over the disk) is built once at
trace time — the whole descriptor is one matmul per image.
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np


def moments(img: jnp.ndarray) -> dict[str, jnp.ndarray]:
    """cv2.moments for a (grayscale) image: raw m*, central mu*,
    normalized nu* — same keys as OpenCV's dict."""
    f = img.astype(jnp.float64) if img.dtype == jnp.float64 else img.astype(jnp.float32)
    h, w = f.shape[-2], f.shape[-1]
    ys = jnp.arange(h, dtype=f.dtype)[:, None]
    xs = jnp.arange(w, dtype=f.dtype)[None, :]

    def m(p, q):
        return jnp.sum(f * (xs**p) * (ys**q), axis=(-2, -1))

    out = {"m00": m(0, 0), "m10": m(1, 0), "m01": m(0, 1)}
    m00 = out["m00"]
    cx = out["m10"] / m00
    cy = out["m01"] / m00

    # Central moments computed directly around the centroid — the
    # translation identities (m11 - cx·m01, …) cancel catastrophically in
    # float32, losing ~3 digits; centered powers don't.
    dx = xs - cx[..., None, None] if cx.ndim else xs - cx
    dy = ys - cy[..., None, None] if cy.ndim else ys - cy

    def mu(p, q):
        return jnp.sum(f * (dx**p) * (dy**q), axis=(-2, -1))

    for p in range(4):
        for q in range(4):
            if 2 <= p + q <= 3:
                out[f"mu{p}{q}"] = mu(p, q)
    # Raw higher moments reconstructed additively (cancellation-free
    # direction) so the dict carries cv2.moments' full key set.
    out["m20"] = out["mu20"] + cx * out["m10"]
    out["m11"] = out["mu11"] + cx * out["m01"]
    out["m02"] = out["mu02"] + cy * out["m01"]
    out["m30"] = out["mu30"] + 3 * cx * out["m20"] - 2 * cx * cx * out["m10"]
    out["m21"] = (
        out["mu21"] + 2 * cx * out["m11"] + cy * out["m20"] - 2 * cx * cx * out["m01"]
    )
    out["m12"] = (
        out["mu12"] + 2 * cy * out["m11"] + cx * out["m02"] - 2 * cy * cy * out["m10"]
    )
    out["m03"] = out["mu03"] + 3 * cy * out["m02"] - 2 * cy * cy * out["m01"]
    # nu_pq = mu_pq / m00^(1 + (p+q)/2): m00² for order 2, m00^2.5 for 3.
    s2 = m00 * m00
    s3 = s2 * jnp.sqrt(m00)
    for p in range(4):
        for q in range(4):
            if 2 <= p + q <= 3:
                s = s2 if p + q == 2 else s3
                out[f"nu{p}{q}"] = out[f"mu{p}{q}"] / s
    return out


def hu_moments(img: jnp.ndarray) -> jnp.ndarray:
    """cv2.HuMoments(cv2.moments(img)): the 7 rotation invariants."""
    mo = moments(img)
    n20, n02, n11 = mo["nu20"], mo["nu02"], mo["nu11"]
    n30, n12, n21, n03 = mo["nu30"], mo["nu12"], mo["nu21"], mo["nu03"]
    t0 = n30 + n12
    t1 = n21 + n03
    q0 = t0 * t0
    q1 = t1 * t1
    h = [
        n20 + n02,
        (n20 - n02) ** 2 + 4 * n11 * n11,
        (n30 - 3 * n12) ** 2 + (3 * n21 - n03) ** 2,
        q0 + q1,
        (n30 - 3 * n12) * t0 * (q0 - 3 * q1) + (3 * n21 - n03) * t1 * (3 * q0 - q1),
        (n20 - n02) * (q0 - q1) + 4 * n11 * t0 * t1,
        (3 * n21 - n03) * t0 * (q0 - 3 * q1) - (n30 - 3 * n12) * t1 * (3 * q0 - q1),
    ]
    return jnp.stack(h, axis=-1)


@functools.lru_cache(maxsize=16)
def _zernike_basis(size_h: int, size_w: int, radius: float, degree: int):
    """Flattened complex Zernike basis V*_{nl} over the disk of `radius`
    centered at the image center-of-mass... mahotas centers per-image, so
    the basis here is parameterized by (cx, cy) at call time; this cache
    holds the coordinate grids and (n, l) index list + radial coefficients.
    """
    nl = []
    coeffs = []
    for n in range(degree + 1):
        for l in range(n + 1):
            if (n - l) % 2 == 0:
                cs = []
                for m in range((n - l) // 2 + 1):
                    c = (
                        (-1) ** m
                        * math.factorial(n - m)
                        / (
                            math.factorial(m)
                            * math.factorial((n - 2 * m + l) // 2)
                            * math.factorial((n - 2 * m - l) // 2)
                        )
                    )
                    cs.append((c, n - 2 * m))
                nl.append((n, l))
                coeffs.append(cs)
    return nl, coeffs


def zernike_moments(
    img: jnp.ndarray, radius: float, degree: int = 8
) -> jnp.ndarray:
    """mahotas-compatible Zernike moment magnitudes of a binary/gray image.

    mahotas semantics (`zernike_moments`): pixel coordinates normalized by
    `radius` around the intensity centroid, pixels outside the unit disk
    dropped, moments A_nl = (n+1)/π · Σ f(x)·V*_nl(x) / Σ f(x)·(disk mask),
    returned as |A_nl| for n ≤ degree, (n−l) even, l ≥ 0. One basis matmul.
    """
    f32 = jnp.float32
    f = img.astype(f32)
    h, w = f.shape[-2], f.shape[-1]
    ys = jnp.arange(h, dtype=f32)[:, None]
    xs = jnp.arange(w, dtype=f32)[None, :]
    total = jnp.sum(f, axis=(-2, -1), keepdims=True)
    cx = jnp.sum(f * xs, axis=(-2, -1), keepdims=True) / total
    cy = jnp.sum(f * ys, axis=(-2, -1), keepdims=True) / total
    yn = (ys - cy) / f32(radius)
    xn = (xs - cx) / f32(radius)
    r = jnp.sqrt(xn * xn + yn * yn)
    theta = jnp.arctan2(yn, xn)
    inside = r <= 1.0
    fm = jnp.where(inside, f, 0.0)
    norm = jnp.sum(fm, axis=(-2, -1))

    nl, coeffs = _zernike_basis(h, w, float(radius), degree)
    out = []
    for (n, l), cs in zip(nl, coeffs):
        rad = jnp.zeros_like(r)
        for c, p in cs:
            rad = rad + f32(c) * (r**p)
        re = jnp.sum(fm * rad * jnp.cos(l * theta), axis=(-2, -1))
        im = jnp.sum(fm * rad * jnp.sin(l * theta), axis=(-2, -1))
        scale = (n + 1) / jnp.pi
        out.append(jnp.sqrt(re * re + im * im) * scale / norm)
    return jnp.stack(out, axis=-1)
