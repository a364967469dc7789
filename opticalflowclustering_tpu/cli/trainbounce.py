"""Train the learned bounce classifier on the reference's labeled hue CSVs.

  python -m opticalflowclustering_tpu.cli.trainbounce \
      --bounce bounce.csv --nobounce nobounce.csv no_bounce2.csv \
      --window 9 --steps 300 --out bounce_params.npz

Windows from the bounce signature train as positives, windows from the
no-bounce series as negatives — the supervised upgrade of the reference's
single-template cosine matching (`findCosineDifferentVectors.py`).
"""

from __future__ import annotations

import argparse

import numpy as np


def load_hue_series(csv_path: str) -> np.ndarray:
    import pandas as pd

    return (
        pd.read_csv(csv_path, header=None).iloc[:, 1].values.astype(np.float32)
    )


def build_dataset(
    bounce_csvs: list[str], nobounce_csvs: list[str], window: int
):
    from opticalflowclustering_tpu.models.bounce_classifier import (
        hue_windows_from_series,
    )

    xs, ys = [], []
    for p in bounce_csvs:
        w = hue_windows_from_series(load_hue_series(p), window)
        xs.append(w)
        ys.append(np.ones(len(w), np.float32))
    for p in nobounce_csvs:
        w = hue_windows_from_series(load_hue_series(p), window)
        xs.append(w)
        ys.append(np.zeros(len(w), np.float32))
    return np.concatenate(xs), np.concatenate(ys)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bounce", nargs="+", required=True)
    ap.add_argument("--nobounce", nargs="+", required=True)
    ap.add_argument("--window", type=int, default=9)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="bounce_params.npz")
    args = ap.parse_args(argv)

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from opticalflowclustering_tpu.models.bounce_classifier import (
        BounceClassifier,
        train_on_hue_windows,
    )

    x, y = build_dataset(args.bounce, args.nobounce, args.window)
    print(f"dataset: {len(x)} windows ({int(y.sum())} positive)")
    params, loss = train_on_hue_windows(
        x, y, steps=args.steps, lr=args.lr
    )
    model = BounceClassifier()
    logits = model.apply(params, jnp.asarray(x))
    acc = float(((np.asarray(logits) > 0) == (y > 0.5)).mean())
    print(f"final loss {loss:.4f}, train accuracy {acc:.3f}")

    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    np.savez(
        args.out,
        **{jax.tree_util.keystr(k): np.asarray(v) for k, v in flat},
    )
    print(f"saved params to {args.out}")


if __name__ == "__main__":
    main()
