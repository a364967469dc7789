"""Learned bounce classifier (flax) — the trainable upgrade of the
reference's cosine-template matcher.

The reference classifies bounces by sliding-window cosine similarity
against one labeled hue signature (`findCosineDifferentVectors.py:52-66`),
with labeled data committed in-tree (`bounce.csv` 15 rows, `nobounce.csv`
334, `no_bounce2.csv` 925 — format `<frame>.png,<hue>`). This module trains
a small MLP/Conv head on those hue features instead: inputs are either
scalar-hue windows (the signature-matching workload) or full 350-dim
grid-hue rows from the fused pipeline.

The train step is the framework's flagship *training* program: pure
(params, opt_state, batch) → (params, opt_state, loss), jit/shard_map
friendly, gradients reduced across the device mesh with `psum` when run
data-parallel (see parallel/ and __graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import optax
from flax import linen as nn


class BounceClassifier(nn.Module):
    """MLP over hue feature vectors (scalar-hue windows or grid-hue rows).

    Hues are circular (uint8 degrees/2 in [0,180)); the input embedding maps
    each hue to (sin, cos) of its angle so 179≈0 — a fix for
    the discontinuity the reference's raw cosine matching inherits.
    """

    hidden: int = 64

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:  # [B, D] hue values
        theta = x.astype(jnp.float32) * jnp.float32(2.0 * jnp.pi / 180.0)
        feats = jnp.concatenate([jnp.sin(theta), jnp.cos(theta)], axis=-1)
        h = nn.Dense(self.hidden)(feats)
        h = nn.relu(h)
        h = nn.Dense(self.hidden)(h)
        h = nn.relu(h)
        return nn.Dense(1)(h)[..., 0]  # logits [B]


def init_classifier(key: jax.Array, feature_dim: int, hidden: int = 64):
    model = BounceClassifier(hidden=hidden)
    params = model.init(key, jnp.zeros((1, feature_dim), jnp.float32))
    return model, params


def make_train_step(
    model: BounceClassifier,
    tx: optax.GradientTransformation,
    mesh_axis_names: tuple[str, ...] = (),
):
    """Build a pure train step. When called inside shard_map, gradients are
    psum-averaged over `mesh_axis_names` (dp/sp axes) before the update, so
    every shard applies the identical step."""

    def loss_fn(params, x, y):
        logits = model.apply(params, x)
        return optax.sigmoid_binary_cross_entropy(logits, y).mean()

    def train_step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, y)
        for ax in mesh_axis_names:
            grads = jax.lax.pmean(grads, ax)
            loss = jax.lax.pmean(loss, ax)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return train_step


def train_on_hue_windows(
    windows: jnp.ndarray,
    labels: jnp.ndarray,
    hidden: int = 64,
    steps: int = 200,
    lr: float = 1e-3,
    seed: int = 0,
) -> tuple[Any, float]:
    """Single-process convenience trainer: hue windows [B, D] + binary
    labels [B] → (trained params, final loss). Used by the CLI and as the
    single-chip reference for the sharded path."""
    model, params = init_classifier(jax.random.PRNGKey(seed), windows.shape[-1], hidden)
    tx = optax.adamw(lr)
    opt_state = tx.init(params)
    step = jax.jit(make_train_step(model, tx))
    x = jnp.asarray(windows, jnp.float32)
    y = jnp.asarray(labels, jnp.float32)
    loss = None
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, x, y)
    return params, float(loss)


def hue_windows_from_series(series, window: int):
    """[N] hue series → [N-window+1, window] sliding windows (feature rows
    for training; mirrors the matcher's windowing)."""
    import numpy as np

    series = np.asarray(series, dtype=np.float32)
    n = len(series) - window + 1
    idx = np.arange(n)[:, None] + np.arange(window)[None, :]
    return series[idx]
