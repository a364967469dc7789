"""Spatial tensor parallelism for Farneback flow: shard the ROW axis of a
frame across a `tp` mesh axis (SURVEY.md §2.4 row "Tensor parallel": halo
exchange via `ppermute` for >HD inputs).

Unlike temporal sharding (parallel/temporal.py — independent frame pairs),
spatial sharding cuts *inside* one frame, so every stage whose output row
depends on neighboring input rows needs its exact halo from the adjacent
shard. The design makes every owned output row see bit-identical inputs to
the unsharded `flow.farneback.farneback_flow` (warp_mode='exact'):

  per pyramid level k (scale 2^-k, resampled from full resolution exactly
  like the unsharded path / OpenCV optflowgf):
    1. ONE full-resolution ring exchange of F_k rows per side, where F_k
       covers the Gaussian presmooth radius + the bilinear downsample
       support + 2^k * (poly_n halo + winsize/2 + warp reach). Global
       image borders are emulated at the edge shards (reflect101 for the
       blur, replicate for everything downstream) so the shard-local ops
       reproduce the unsharded border handling bit-for-bit.
    2. blur + downsample + polynomial expansion run shard-locally on the
       extended block; results are valid on owned rows ± the level margin.
    3. each solver iteration needs only a winsize/2-row flow halo, traded
       with neighbors via one small `ppermute` per iteration; the border
       taper is built from *global* row indices so interior shards apply
       no vertical taper.
    4. the coarse→fine flow upsample exchanges a 4-row halo and fixes up
       the two globally-clamped boundary rows on the edge shards.

Exactness contract (two layers) provided the vertical displacement at
pyramid level k stays within `reach_k = max(8, warp_radius >> k)` rows
(beyond the exchanged halo the warp applies OpenCV's out-of-image
constant-motion fallback, which the unsharded path would only apply at
the true image border; real-footage flow is far inside this envelope):

* the halo/taper/margin MATH is exact — with op-by-op execution the
  sharded output is BITWISE equal to the unsharded flow
  (tests/test_spatial_tp.py::test_spatial_tp_bitwise_eager);
* the production entry point compiles the body as one cached jitted
  program, and XLA's whole-program fusion rounds float chains per
  program structure, so jitted-sharded vs unsharded agreement is
  fusion-noise level (≤5e-5 px asserted at the 1536-row and 720p
  flagship geometries).

Constraint: H must be divisible by n_shards * 2^levels so every pyramid
level splits evenly and the bilinear sample grids of shard-local resizes
align with the global grid (integer scale ⇒ identical interpolation
weights; see ops/resize.py for the weight convention). For arbitrary
heights use `spatial_farneback_flow_padded`, which replicate-pads the row
axis to the next multiple and crops the result.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from opticalflowclustering_tpu.flow.farneback import (
    _BORDER,
    _BORDER_SCALE,
    FarnebackParams,
    _m_build,
    _warp_gather,
    poly_expansion,
    pyramid_plan,
)
from opticalflowclustering_tpu.ops.filters import box_sum, gaussian_blur
from opticalflowclustering_tpu.ops.resize import resize_linear


def _cvround(x: float) -> int:
    return int(np.rint(x))


# ---------------------------------------------------------------------------
# halo exchange helpers (row axis = -2 for [..., H, W] data)
# ---------------------------------------------------------------------------


def _ring_halo(x: jnp.ndarray, n: int, axis_name: str, row_axis: int):
    """Return (from_above, from_below): the lower n rows of the shard above
    and the upper n rows of the shard below (zeros at the global edges)."""
    n_dev = jax.lax.axis_size(axis_name)
    size = x.shape[row_axis]
    bottom = jax.lax.slice_in_dim(x, size - n, size, axis=row_axis)
    top = jax.lax.slice_in_dim(x, 0, n, axis=row_axis)
    # from_above on shard i is shard (i-1)'s bottom rows: pairs (src, dst)
    down = [(i, i + 1) for i in range(n_dev - 1)]
    up = [(i, i - 1) for i in range(1, n_dev)]
    from_above = jax.lax.ppermute(bottom, axis_name, down)
    from_below = jax.lax.ppermute(top, axis_name, up)
    return from_above, from_below


def _edge_fill(x: jnp.ndarray, n: int, mode: str, side: str, row_axis: int):
    """What jnp.pad would put beyond the global border: the border emulation
    the edge shards substitute for their missing neighbor."""
    size = x.shape[row_axis]
    if mode == "reflect101":
        if side == "top":
            sl = jax.lax.slice_in_dim(x, 1, n + 1, axis=row_axis)
        else:
            sl = jax.lax.slice_in_dim(x, size - n - 1, size - 1, axis=row_axis)
        return jnp.flip(sl, axis=row_axis)
    if mode == "replicate":
        if side == "top":
            row = jax.lax.slice_in_dim(x, 0, 1, axis=row_axis)
        else:
            row = jax.lax.slice_in_dim(x, size - 1, size, axis=row_axis)
        reps = [1] * x.ndim
        reps[row_axis] = n
        return jnp.tile(row, reps)
    if mode == "zero":
        shp = list(x.shape)
        shp[row_axis] = n
        return jnp.zeros(shp, x.dtype)
    raise ValueError(mode)


def _extend_rows(
    x: jnp.ndarray, n: int, axis_name: str, mode: str, row_axis: int = -2
) -> jnp.ndarray:
    """Concatenate n exchanged halo rows above and below the local block;
    the global top/bottom shards get the `mode` border emulation instead."""
    if n == 0:
        return x
    row_axis = row_axis % x.ndim
    idx = jax.lax.axis_index(axis_name)
    n_dev = jax.lax.axis_size(axis_name)
    from_above, from_below = _ring_halo(x, n, axis_name, row_axis)
    top_fill = _edge_fill(x, n, mode, "top", row_axis)
    bot_fill = _edge_fill(x, n, mode, "bottom", row_axis)
    from_above = jnp.where(idx == 0, top_fill, from_above)
    from_below = jnp.where(idx == n_dev - 1, bot_fill, from_below)
    return jnp.concatenate([from_above, x, from_below], axis=row_axis)


def _slice_rows(x: jnp.ndarray, lo: int, hi: int, row_axis: int = -2):
    row_axis = row_axis % x.ndim
    return jax.lax.slice_in_dim(x, lo, x.shape[row_axis] - hi, axis=row_axis)


# ---------------------------------------------------------------------------
# shard-aware building blocks
# ---------------------------------------------------------------------------


def _taper_rows(
    gidx: jnp.ndarray, total: int
) -> jnp.ndarray:
    """OpenCV's 5-px border ramp evaluated at *global* row indices (float32,
    same multiply order as flow.farneback._border_taper)."""
    ramp = jnp.ones_like(gidx, dtype=jnp.float32)
    for i in range(min(_BORDER, total)):
        s = jnp.float32(_BORDER_SCALE[i])
        ramp = ramp * jnp.where(gidx == i, s, jnp.float32(1.0))
        ramp = ramp * jnp.where(gidx == total - 1 - i, s, jnp.float32(1.0))
    return ramp


def _taper_cols(w: int) -> np.ndarray:
    ramp = np.ones(w, dtype=np.float32)
    for i in range(min(_BORDER, w)):
        ramp[i] *= _BORDER_SCALE[i]
        ramp[w - 1 - i] *= _BORDER_SCALE[i]
    return ramp


def _update_matrices_ext(
    r0_m: jnp.ndarray,
    r1_ext: jnp.ndarray,
    flow_m: jnp.ndarray,
    ext_top: int,
    row0: jnp.ndarray,
    h_glob: int,
    w: int,
    taper_m: jnp.ndarray,
) -> jnp.ndarray:
    """M on the owned±winsize/2 region from shard-local tensors.

    r0_m/flow_m/taper_m cover the M region ([..., Hm, W]); r1_ext carries
    `ext_top` extra rows above the M region (and the warp reach below).
    `row0` is the global row index of the M region's first row; bounds use
    global coordinates so out-of-image fallback matches the unsharded path.
    """
    f32 = jnp.float32
    hm = flow_m.shape[-3]
    dx = flow_m[..., 0]
    dy = flow_m[..., 1]
    gx = jnp.arange(w, dtype=jnp.float32)[None, :] + dx
    gy = (
        (row0 + jnp.arange(hm, dtype=jnp.int32)).astype(jnp.float32)[:, None]
        + dy
    )
    x1 = jnp.floor(gx)
    y1 = jnp.floor(gy)
    fx = gx - x1
    fy = gy - y1
    x1i = x1.astype(jnp.int32)
    y1i = y1.astype(jnp.int32)
    inb = (x1i >= 0) & (x1i <= w - 2) & (y1i >= 0) & (y1i <= h_glob - 2)
    x1c = jnp.clip(x1i, 0, w - 2)
    # global row -> extended-block row; clamp into the exchanged halo.
    y1_loc = jnp.clip(y1i - row0 + ext_top, 0, r1_ext.shape[-3] - 2)
    r1w = _warp_gather(r1_ext, y1_loc, x1c, fx, fy)
    r0c = tuple(r0_m[..., c] for c in range(5))
    r1wc = tuple(r1w[..., c] for c in range(5))
    return jnp.stack(_m_build(r0c, r1wc, dx, dy, inb, taper_m), axis=-1)


def _solve_ext(m_ext: jnp.ndarray, winsize: int) -> jnp.ndarray:
    """Windowed 2×2 solve on the M region; valid on the center rows.
    Mirrors flow.farneback._update_flow (box path)."""
    f32 = jnp.float32
    s = box_sum(m_ext, winsize, border="replicate", axes=(-3, -2)) * f32(
        1.0 / (winsize * winsize)
    )
    g11, g12, g22 = s[..., 0], s[..., 1], s[..., 2]
    h1, h2 = s[..., 3], s[..., 4]
    idet = f32(1.0) / (g11 * g22 - g12 * g12 + f32(1e-3))
    fx = (g11 * h2 - g12 * h1) * idet
    fy = (g22 * h1 - g12 * h2) * idet
    return jnp.stack([fx, fy], axis=-1)


def _upsample_flow_rows(
    flow: jnp.ndarray,
    axis_name: str,
    w_dst: int,
    halo: int = 4,
) -> jnp.ndarray:
    """2× coarse→fine flow upsample across the sharded row axis.

    Exchanges `halo` coarse rows, bilinear-resizes the extended block
    (identical interpolation weights to the global resize: the grid offset
    is a multiple of the scale), slices the owned rows, and rewrites the
    two globally-clamped boundary rows on the edge shards (the global
    resize gives them weight 1.0 on the boundary source row)."""
    idx = jax.lax.axis_index(axis_name)
    n_dev = jax.lax.axis_size(axis_name)
    ext = _extend_rows(flow, halo, axis_name, "zero", row_axis=-3)
    x = jnp.moveaxis(ext, -1, -3)  # [..., 2, He, W]
    up = resize_linear(x, (x.shape[-2] * 2, w_dst))
    up = jnp.moveaxis(up, -3, -1)
    out = _slice_rows(up, 2 * halo, 2 * halo, row_axis=-3)
    # global first/last dst rows clamp to source row 0 / -1 (weight 1.0);
    # resize the W axis of those source rows alone for the fix-up.
    first = resize_linear(
        jnp.moveaxis(flow[..., :1, :, :], -1, -3), (1, w_dst)
    )
    first = jnp.moveaxis(first, -3, -1)
    last = resize_linear(
        jnp.moveaxis(flow[..., -1:, :, :], -1, -3), (1, w_dst)
    )
    last = jnp.moveaxis(last, -3, -1)
    h_loc = out.shape[-3]
    rows = jnp.arange(h_loc, dtype=jnp.int32).reshape(
        (1,) * (out.ndim - 3) + (h_loc, 1, 1)
    )
    out = jnp.where((idx == 0) & (rows == 0), first, out)
    out = jnp.where((idx == n_dev - 1) & (rows == h_loc - 1), last, out)
    return out


# ---------------------------------------------------------------------------
# the sharded flow
# ---------------------------------------------------------------------------


def _level_margins(params: FarnebackParams):
    """Static per-level (reach, level_margin, fullres_halo) plan."""
    out = {}
    mhalf = params.winsize // 2
    for k in range(params.levels + 1):
        reach = max(8, params.warp_radius >> k)
        marg = mhalf + params.poly_n // 2 + reach + 1  # r1 rows the warp reads
        scale = params.pyr_scale**k
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_sz = max(_cvround(sigma * 5) | 1, 3)
        rb = smooth_sz // 2
        step = 2**k
        full = step * marg + rb + step // 2
        full = ((full + step - 1) // step) * step  # align to the sample grid
        out[k] = (reach, marg, full)
    return out


def spatial_farneback_flow(
    prev_img: jnp.ndarray,
    next_img: jnp.ndarray,
    mesh: Mesh,
    axis_name: str = "tp",
    params: FarnebackParams = FarnebackParams(),
) -> jnp.ndarray:
    """farneback_flow with the row axis sharded over `axis_name`.

    prev_img/next_img: [..., H, W] grayscale; H % (n_shards * 2^levels) == 0.
    Returns [..., H, W, 2] flow, row-sharded, equal to the unsharded
    exact-mode flow within the reach contract (module docstring: bitwise
    op-by-op; ≤5e-5 px under whole-program jit fusion)."""
    h, w = prev_img.shape[-2], prev_img.shape[-1]
    _check_shard_geometry(h, w, mesh.shape[axis_name], params)
    return _spatial_farneback_fn(mesh, axis_name, params, prev_img.ndim, h, w)(
        prev_img, next_img
    )


def _check_shard_geometry(
    h: int, w: int, n_dev: int, params: FarnebackParams
) -> None:
    """Shared entry-point validation (spatial_farneback_flow AND
    spatial_hue_pipeline): the row count must split evenly across shards
    at every pyramid level, and a shard must be taller than the largest
    full-resolution halo — an undersized shard would otherwise fail deep
    inside shard_map tracing with an opaque negative-start lax.slice
    error."""
    if h % (n_dev * 2**params.levels):
        raise ValueError(
            f"H={h} must divide by n_shards*2^levels={n_dev * 2**params.levels}"
        )
    margins = _level_margins(params)
    max_full = max(margins[k][2] for k, *_ in pyramid_plan(h, w, params))
    if h // n_dev <= max_full:
        raise ValueError(
            f"shard of {h // n_dev} rows too small for the {max_full}-row "
            f"halo (use fewer shards or a smaller warp_radius)"
        )


def _build_shard_flow(
    axis_name: str,
    params: FarnebackParams,
    ndim: int,
    h: int,
    w: int,
    n_dev: int,
):
    """The per-shard flow body (runs INSIDE shard_map): local rows in,
    local flow rows out. Shared by the flow-only entry point and the
    end-to-end spatial hue pipeline below."""
    plan = pyramid_plan(h, w, params)
    margins = _level_margins(params)
    mhalf = params.winsize // 2
    col_ramp = {}

    def shard_fn(prev_loc, nxt_loc):
        idx = jax.lax.axis_index(axis_name)
        prev_f = prev_loc.astype(jnp.float32)
        next_f = nxt_loc.astype(jnp.float32)
        h_loc = prev_f.shape[-2]

        flow = None
        for k, h_k, w_k, sigma in plan:
            step = 2**k
            reach, marg, full = margins[k]
            smooth_sz = max(_cvround(sigma * 5) | 1, 3)
            hk_loc = h_loc // step
            row0_lvl = idx * hk_loc  # global level-row of first owned row

            # 1. full-res halo exchange + blur + downsample + poly expansion
            lvl = []
            for img in (prev_f, next_f):
                ext = _extend_rows(img, full, axis_name, "reflect101")
                sm = gaussian_blur(ext, smooth_sz, sigma, border="reflect101")
                if step > 1:
                    src_rows = step * (hk_loc + 2 * marg)
                    off = full - step * marg
                    sm = _slice_rows(sm, off, off)
                    assert sm.shape[-2] == src_rows
                    ds = resize_linear(sm, (hk_loc + 2 * marg, w_k))
                else:
                    off = full - marg
                    ds = _slice_rows(sm, off, off)
                    if w_k != w:
                        ds = resize_linear(ds, (ds.shape[-2], w_k))
                # beyond the global border: replicate the true edge row
                # (what poly/box replicate-padding sees in the unsharded run)
                rows = jnp.arange(ds.shape[-2], dtype=jnp.int32).reshape(
                    (1,) * (ds.ndim - 2) + (-1, 1)
                )
                top_row = jax.lax.slice_in_dim(
                    ds, marg, marg + 1, axis=ds.ndim - 2
                )
                bot_row = jax.lax.slice_in_dim(
                    ds, marg + hk_loc - 1, marg + hk_loc, axis=ds.ndim - 2
                )
                ds = jnp.where((idx == 0) & (rows < marg), top_row, ds)
                ds = jnp.where(
                    (idx == n_dev - 1) & (rows >= marg + hk_loc), bot_row, ds
                )
                lvl.append(ds)

            r0_ext = poly_expansion(lvl[0], params.poly_n, params.poly_sigma)
            r1_ext = poly_expansion(lvl[1], params.poly_n, params.poly_sigma)
            # poly rows within poly_n//2 of the extension edge are invalid;
            # marg keeps them outside the reach+solve region.

            # M region: owned ± mhalf level rows
            pad_m = marg - mhalf  # rows to drop from each side of the ext
            r0_m = jax.lax.slice_in_dim(
                r0_ext, pad_m, pad_m + hk_loc + 2 * mhalf, axis=r0_ext.ndim - 3
            )
            gidx_m = row0_lvl - mhalf + jnp.arange(
                hk_loc + 2 * mhalf, dtype=jnp.int32
            )
            if (h_k, w_k) not in col_ramp:
                # Host-side numpy constant — NEVER a traced/placed array:
                # shard_fn runs both eagerly (disable_jit) and traced, and
                # a value created under one execution context must not
                # leak into the next via this cache.
                col_ramp[(h_k, w_k)] = _taper_cols(w_k)
            taper_m = (
                _taper_rows(gidx_m, h_k)[:, None] * col_ramp[(h_k, w_k)][None, :]
            )
            row0_m = row0_lvl - mhalf

            # 2. initial flow on the M region
            if flow is None:
                flow_m = jnp.zeros(
                    prev_f.shape[:-2] + (hk_loc + 2 * mhalf, w_k, 2),
                    jnp.float32,
                )
            else:
                up = _upsample_flow_rows(flow, axis_name, w_k) * jnp.float32(
                    1.0 / params.pyr_scale
                )
                ext_f = _extend_rows(up, mhalf, axis_name, "zero", row_axis=-3)
                flow_m = ext_f

            # 3. iterate: M on the region, box solve, re-exchange halo
            glob_m = gidx_m.reshape((1,) * (prev_f.ndim - 2) + (-1, 1, 1))
            for i in range(params.iterations):
                m = _update_matrices_ext(
                    r0_m, r1_ext, flow_m, pad_m, row0_m, h_k, w_k, taper_m
                )
                # rows beyond the global border replicate the edge M row,
                # exactly like the unsharded box_sum's replicate padding
                m_top = jax.lax.slice_in_dim(
                    m, mhalf, mhalf + 1, axis=m.ndim - 3
                )
                m_bot = jax.lax.slice_in_dim(
                    m, mhalf + hk_loc - 1, mhalf + hk_loc, axis=m.ndim - 3
                )
                m = jnp.where((glob_m[..., 0] < 0)[..., None], m_top, m)
                m = jnp.where(
                    (glob_m[..., 0] > h_k - 1)[..., None], m_bot, m
                )
                sol = _solve_ext(m, params.winsize)
                flow_own = _slice_rows(sol, mhalf, mhalf, row_axis=-3)
                if i < params.iterations - 1:
                    flow_m = _extend_rows(
                        flow_own, mhalf, axis_name, "zero", row_axis=-3
                    )
            flow = flow_own
        return flow

    return shard_fn


@functools.lru_cache(maxsize=64)
def _spatial_farneback_fn(
    mesh: Mesh,
    axis_name: str,
    params: FarnebackParams,
    ndim: int,
    h: int,
    w: int,
):
    """Jitted executable for spatial_farneback_flow, memoized on the static
    configuration. A bare shard_map call outside jit executes EAGERLY —
    every traced op in the levels×iterations body dispatches as its own
    XLA program (measured ~16× slower end to end at 720p×4 shards on CPU:
    ~240 s eager vs ~15 s as one jitted program)."""
    n_dev = mesh.shape[axis_name]
    nb = ndim - 2
    spec = P(*([None] * nb), axis_name, None)
    flow_spec = P(*([None] * nb), axis_name, None, None)
    shard_fn = _build_shard_flow(axis_name, params, ndim, h, w, n_dev)

    sharded = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=flow_spec,
    )
    return jax.jit(sharded)


def spatial_farneback_flow_padded(
    prev_img: jnp.ndarray,
    next_img: jnp.ndarray,
    mesh: Mesh,
    axis_name: str = "tp",
    params: FarnebackParams = FarnebackParams(),
) -> jnp.ndarray:
    """Arbitrary-H spatial TP: replicate-pad the row axis up to the next
    multiple of `n_shards * 2^levels`, run the sharded flow, crop back —
    so non-divisible flagship geometries (720p, 1081p) shard without
    manual padding (VERDICT r2 #7).

    Semantics: equal (same two-layer contract as the module docstring)
    to the unsharded exact-mode flow *of the padded frame*, cropped to H
    (the TP-correctness property; pinned in
    tests/test_spatial_tp.py). Replicate-padding necessarily moves the
    bottom image border (taper position, blur reflection, box-solve
    windows), so rows near the bottom differ from the unsharded flow of
    the original frame; the 2×-integer pyramid resizes are row-local, so
    rows away from the bottom border are unaffected (also pinned).
    """
    n_dev = mesh.shape[axis_name]
    mult = n_dev * 2**params.levels
    h = prev_img.shape[-2]
    pad = (-h) % mult
    if pad == 0:
        return spatial_farneback_flow(
            prev_img, next_img, mesh, axis_name, params
        )

    def _pad(img):
        last = jax.lax.slice_in_dim(
            img, h - 1, h, axis=img.ndim - 2
        )
        reps = [1] * img.ndim
        reps[img.ndim - 2] = pad
        return jnp.concatenate([img, jnp.tile(last, reps)], axis=img.ndim - 2)

    flow = spatial_farneback_flow(
        _pad(prev_img), _pad(next_img), mesh, axis_name, params
    )
    return jax.lax.slice_in_dim(flow, 0, h, axis=flow.ndim - 3)


# ---------------------------------------------------------------------------
# end-to-end spatial-TP hue pipeline (VERDICT r4 #7)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _spatial_hue_fn(
    mesh: Mesh,
    axis_name: str,
    grid,
    params: FarnebackParams,
    rb_swap: bool,
    ndim: int,
    h: int,
    w: int,
):
    from opticalflowclustering_tpu.features.dominant_color import (
        dominant_hue_k1_frames,
    )
    from opticalflowclustering_tpu.features.grid import grid_mean_hue
    from opticalflowclustering_tpu.flow.render import (
        render_flow_hsv_bgr_given_range,
    )
    from opticalflowclustering_tpu.ops.polar import cart_to_polar

    n_dev = mesh.shape[axis_name]
    nb = ndim - 2
    spec = P(*([None] * nb), axis_name, None)
    shard_flow = _build_shard_flow(axis_name, params, ndim, h, w, n_dev)

    def step(prev_loc, nxt_loc):
        flow_loc = shard_flow(prev_loc, nxt_loc)  # [..., h_loc, W, 2]
        mag, _ = cart_to_polar(flow_loc[..., 0], flow_loc[..., 1])
        # Per-frame GLOBAL min-max (the reference's NORM_MINMAX,
        # `computeOpticalFlowModule.py:31`) as shard-local reductions +
        # pmin/pmax collectives — SURVEY §5's "cross-shard reduction in the
        # middle of an otherwise local kernel chain". min/max are exactly
        # associative, so the range is bitwise the unsharded one.
        smin = jax.lax.pmin(
            jnp.min(mag, axis=(-2, -1), keepdims=True), axis_name
        )
        smax = jax.lax.pmax(
            jnp.max(mag, axis=(-2, -1), keepdims=True), axis_name
        )
        bgr_loc = render_flow_hsv_bgr_given_range(flow_loc, smin, smax)
        # Grid cells don't align with shard boundaries (720 rows / 14 grid
        # rows = 51-row cells vs 180-row shards), so the grid stage runs
        # on the gathered frame: ONE uint8 all_gather (H·W·3 bytes — 2.7
        # MB at 720p, trivial next to the flow) and every later op is
        # bit-identical to the unsharded pipeline by construction.
        bgr = jax.lax.all_gather(
            bgr_loc, axis_name, axis=bgr_loc.ndim - 3, tiled=True
        )
        centroids, hue = dominant_hue_k1_frames(bgr, grid, rb_swap=rb_swap)
        rgb_hue = grid_mean_hue(bgr, grid)
        mean_mag = jax.lax.psum(
            jnp.sum(mag, axis=(-2, -1)), axis_name
        ) * jnp.float32(1.0 / (h * w))
        return hue, rgb_hue, centroids, mean_mag

    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(P(), P(), P(), P()),  # replicated post-gather outputs
        # The replication check cannot infer that values computed from the
        # all_gather'd frame are replicated.
        check_vma=False,
    )
    return jax.jit(sharded)


def spatial_hue_pipeline(
    prev_img: jnp.ndarray,
    next_img: jnp.ndarray,
    mesh: Mesh,
    axis_name: str = "tp",
    grid=None,
    params: FarnebackParams = FarnebackParams(),
    rb_swap: bool = True,
):
    """END-TO-END spatial tensor parallelism: the flagship features of one
    frame pair with the frame's ROW axis sharded across `axis_name`
    (SURVEY §2.4 TP row + §5 long-context row, VERDICT r4 #7).

    prev_img/next_img: [..., H, W] uint8 grayscale, H divisible by
    n_shards·2^levels (use the padded wrapper geometry otherwise).
    Returns (hue [..., cells] u8, rgb_hue [..., cells] f32,
    centroids [..., cells, 4] i32, mean_mag [...] f32), replicated on
    every shard. Stage layout:

      flow        — row-sharded (parallel/spatial.py halo machinery; the
                    ~all of the FLOPs),
      normalize   — per-frame global min-max via pmin/pmax collectives,
                    applied shard-locally (render_flow_hsv_bgr_given_range),
      grid/hue    — one uint8 all_gather of the rendered frame, then the
                    exact unsharded feature ops.

    Feature tables are BITWISE equal to the unsharded pipeline under
    op-by-op execution (the flow decomposition is exact and min/max are
    associative; tests/test_spatial_tp.py::test_spatial_hue_pipeline_*);
    under whole-program jit the uint8 quantization absorbs the ≤5e-5 px
    fusion noise (equality asserted at the test geometry). mean_mag sums
    shard-locally then psums (~1-ulp vs the unsharded mean, same
    contract as parallel/temporal.py)."""
    from opticalflowclustering_tpu.features.grid import GridParams

    if grid is None:
        grid = GridParams()
    h, w = prev_img.shape[-2], prev_img.shape[-1]
    _check_shard_geometry(h, w, mesh.shape[axis_name], params)
    return _spatial_hue_fn(
        mesh, axis_name, grid, params, rb_swap, prev_img.ndim, h, w
    )(prev_img, next_img)
