"""Sliding-window signature matching — the bounce classifier.

`findCosineDifferentVectors.py:52-61` slides a labeled hue signature over a
video's hue series one Python window at a time. Here every window's dot
product against the signature is one [W, L] @ [L] matmul (windows are a
strided gather built at trace time), the window norms are a parallel
reduction, and the max/argmax matches the reference's last-tie-wins
bookkeeping (`:57-61`: max_frame updates whenever similarity equals the
running max).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sliding_cosine_similarity(
    signature: jnp.ndarray, series: jnp.ndarray
) -> jnp.ndarray:
    """Cosine similarity of `signature` [L] against every length-L window of
    `series` [N] → [N-L+1]. Zero-norm windows (or signature) score 0,
    matching `calculate_cosine_similarity`'s guard
    (`findCosineDifferentVectors.py:20-21`)."""
    sig = signature.astype(jnp.float32)
    ser = series.astype(jnp.float32)
    n = ser.shape[0]
    l = sig.shape[0]
    num_windows = n - l + 1
    idx = jnp.arange(num_windows)[:, None] + jnp.arange(l)[None, :]
    windows = ser[idx]  # [W, L]
    # Full f32: in TF32 a near tie between windows can flip the chosen frame.
    dots = jnp.dot(
        windows, sig, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    sig_norm = jnp.sqrt(jnp.sum(sig * sig))
    win_norm = jnp.sqrt(jnp.sum(windows * windows, axis=-1))
    denom = sig_norm * win_norm
    return jnp.where(denom > 0, dots / denom, 0.0)


def match_signature(
    signature: jnp.ndarray, series: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(max_similarity, max_frame) with the reference's tie behavior: the
    *last* window attaining the maximum wins (`findCosineDifferentVectors.py:
    57-61` re-assigns max_frame on equality)."""
    sims = sliding_cosine_similarity(signature, series)
    max_sim = jnp.max(sims)
    # last index attaining the max
    w = sims.shape[0]
    last = (w - 1) - jnp.argmax(sims[::-1] == max_sim)
    return max_sim, last


def cosine_similarity_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """sklearn.metrics.pairwise.cosine_similarity for [n,d]×[m,d] → [n,m]
    (`computeVectorDistance.py:3,26`)."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    an = a / jnp.maximum(jnp.linalg.norm(a, axis=-1, keepdims=True), 1e-30)
    bn = b / jnp.maximum(jnp.linalg.norm(b, axis=-1, keepdims=True), 1e-30)
    return jnp.dot(
        an, bn.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def rowwise_euclidean_sum(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Σ_i ‖a_i − b_i‖ over the common prefix of rows
    (`computeVectorDistance.py:32-38`)."""
    m = min(a.shape[0], b.shape[0])
    d = a[:m].astype(jnp.float32) - b[:m].astype(jnp.float32)
    return jnp.sum(jnp.sqrt(jnp.sum(d * d, axis=-1)))
