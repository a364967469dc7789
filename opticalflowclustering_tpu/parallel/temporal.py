"""Temporal (frame-axis) sharding of the flow pipeline.

Optical flow couples only adjacent frames (t-1, t) — the reference carries
one `prev_gray` frame of state (`computeOpticalFlowModule.py:34`). Sharding
a video's N frames into contiguous blocks across chips therefore needs a
single-frame halo: each chip ships its *first* grayscale frame to its left
neighbor (`jax.lax.ppermute`), computes its local frame pairs, and
every later stage (render, grid pooling, clustering) is purely local. This
is the sequence-parallel analogue for this workload (SURVEY.md §5
'long-context').

The ring wraps, so the last chip produces one junk pair (its last frame
against frame 0); callers drop the final row — `sharded_hue_pipeline`
returns [N, cells] of which the first N-1 rows are valid.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from opticalflowclustering_tpu.features.dominant_color import (
    dominant_hue_k1_frames,
)
from opticalflowclustering_tpu.features.grid import (
    GridParams,
    grid_mean_hue,
)
from opticalflowclustering_tpu.flow.farneback import FarnebackParams, farneback_flow
from opticalflowclustering_tpu.flow.render import render_flow_hsv_bgr
from opticalflowclustering_tpu.ops.colorspace import bgr2gray
from opticalflowclustering_tpu.ops.polar import magnitude


def _halo_pairs(gray_local: jnp.ndarray, axis_name: str):
    """[n_loc, H, W] local frames → (prev, next) [n_loc, H, W] pairs using a
    1-frame halo from the right neighbor (ring ppermute)."""
    n_dev = jax.lax.axis_size(axis_name)
    first = gray_local[:1]
    # send my first frame to my LEFT neighbor (i → i-1)
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    recv = jax.lax.ppermute(first, axis_name, perm)
    gray_ext = jnp.concatenate([gray_local, recv], axis=0)
    return gray_ext[:-1], gray_ext[1:]


@functools.lru_cache(maxsize=64)
def _temporal_shard_flow_fn(mesh: Mesh, axis_name: str, params: FarnebackParams):
    """Jitted executable for temporal_shard_flow, memoized on the static
    configuration. A bare shard_map call outside jit executes EAGERLY —
    every traced op dispatches individually and nothing is cached across
    calls — so all public entry points here route through cached jits."""

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=P(axis_name),
    )
    def step(frames_local):
        gray = bgr2gray(frames_local)
        prev, nxt = _halo_pairs(gray, axis_name)
        return farneback_flow(prev, nxt, params)

    return step


def temporal_shard_flow(
    frames: jnp.ndarray,
    mesh: Mesh,
    axis_name: str = "sp",
    params: FarnebackParams = FarnebackParams(),
) -> jnp.ndarray:
    """Flow over a frame-sharded video: [N,H,W,3]u8 → [N,H,W,2] (row N-1 is
    the wrapped junk pair; drop it). N must divide by the axis size."""
    return _temporal_shard_flow_fn(mesh, axis_name, params)(frames)


@functools.lru_cache(maxsize=64)
def _sharded_hue_pipeline_fn(
    mesh: Mesh,
    axis_name: str,
    grid: GridParams,
    params: FarnebackParams,
    rb_swap: bool,
):
    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=(P(axis_name), P(axis_name), P(axis_name)),
    )
    def step(frames_local):
        gray = bgr2gray(frames_local)
        prev, nxt = _halo_pairs(gray, axis_name)
        flow = farneback_flow(prev, nxt, params)
        mag = magnitude(flow[..., 0], flow[..., 1])
        mean_mag = jnp.mean(mag, axis=(-2, -1))
        flow_bgr = render_flow_hsv_bgr(flow)
        _, hue = dominant_hue_k1_frames(flow_bgr, grid, rb_swap=rb_swap)
        rgb_hue = grid_mean_hue(flow_bgr, grid)
        return hue, rgb_hue, mean_mag

    return step


def sharded_hue_pipeline(
    frames: jnp.ndarray,
    mesh: Mesh,
    axis_name: str = "sp",
    grid: GridParams = GridParams(),
    params: FarnebackParams = FarnebackParams(),
    rb_swap: bool = True,
):
    """Full flow→render→grid→cluster pipeline with the frame axis sharded
    across `axis_name`. Returns (hue_table [N, cells], rgb_hue [N, cells],
    mean_mag [N]); the last row of each is the wrapped junk pair — valid
    data is [:N-1]. All stages after the single halo exchange are local to
    each chip; no other communication occurs.
    """
    return _sharded_hue_pipeline_fn(mesh, axis_name, grid, params, rb_swap)(
        frames
    )


@functools.lru_cache(maxsize=64)
def _sharded_hue_pipeline_videos_fn(
    mesh: Mesh,
    dp_axis: str,
    sp_axis: str,
    grid: GridParams,
    params: FarnebackParams,
    rb_swap: bool,
):
    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(dp_axis, sp_axis),
        out_specs=(
            P(dp_axis, sp_axis),
            P(dp_axis, sp_axis),
            P(dp_axis, sp_axis),
            P(dp_axis, sp_axis),
        ),
    )
    def step(videos_local):  # [b_loc, n_loc, H, W, 3]
        gray = bgr2gray(videos_local)
        n_dev = jax.lax.axis_size(sp_axis)
        perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
        recv = jax.lax.ppermute(gray[:, :1], sp_axis, perm)
        gray_ext = jnp.concatenate([gray, recv], axis=1)
        flow = farneback_flow(gray_ext[:, :-1], gray_ext[:, 1:], params)
        mag = magnitude(flow[..., 0], flow[..., 1])
        mean_mag = jnp.mean(mag, axis=(-2, -1))
        flow_bgr = render_flow_hsv_bgr(flow)
        centroids, hue = dominant_hue_k1_frames(
            flow_bgr, grid, rb_swap=rb_swap
        )
        rgb_hue = grid_mean_hue(flow_bgr, grid)
        return hue, rgb_hue, centroids, mean_mag

    return step


def sharded_hue_pipeline_videos(
    videos: jnp.ndarray,
    mesh: Mesh,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    grid: GridParams = GridParams(),
    params: FarnebackParams = FarnebackParams(),
    rb_swap: bool = True,
):
    """dp×sp-sharded flagship pipeline over a BATCH of videos
    [B, N, H, W, 3]u8: videos sharded across `dp_axis`, each video's frame
    axis across `sp_axis` (1-frame ring halo). Returns
    (hue [B, N, cells], rgb_hue [B, N, cells],
    centroids [B, N, cells, 4] int32 RGBA — the per-cell `-f`/addnew rows
    the reference's fused run appends, `KmeanGrids.py:320-339`,
    mean_mag [B, N]); row N-1 of each video is the wrapped junk pair (last
    frame against frame 0) — valid data is [:, :N-1]. Beyond the halo
    exchange everything is chip-local; the hue/centroid feature tables are
    bitwise equal to the unsharded pipeline on any mesh shape, the float
    mean-magnitude telemetry to ~1 ulp (XLA fuses its hypot+mean chain per
    local shard shape) (tests/test_parallel.py,
    __graft_entry__.dryrun_multichip)."""
    return _sharded_hue_pipeline_videos_fn(
        mesh, dp_axis, sp_axis, grid, params, rb_swap
    )(videos)


def unsharded_hue_pipeline_videos(
    videos: jnp.ndarray,
    grid: GridParams = GridParams(),
    params: FarnebackParams = FarnebackParams(),
    rb_swap: bool = True,
):
    """Single-device emulation of sharded_hue_pipeline_videos (same ops,
    same ring wrap, same 4-tuple) — the bitwise oracle for mesh-invariance
    checks."""
    gray = bgr2gray(videos)
    gray_ext = jnp.concatenate([gray, gray[:, :1]], axis=1)
    flow = farneback_flow(gray_ext[:, :-1], gray_ext[:, 1:], params)
    mag = magnitude(flow[..., 0], flow[..., 1])
    mean_mag = jnp.mean(mag, axis=(-2, -1))
    flow_bgr = render_flow_hsv_bgr(flow)
    centroids, hue = dominant_hue_k1_frames(flow_bgr, grid, rb_swap=rb_swap)
    rgb_hue = grid_mean_hue(flow_bgr, grid)
    return hue, rgb_hue, centroids, mean_mag
