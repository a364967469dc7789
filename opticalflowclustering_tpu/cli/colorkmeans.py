"""Single-image dominant-color CLI, mirroring
`k-means-color-clustering/color_kmeans.py` (`-i image -c clusters -f csv`):
RGBA preprocess, k-means dominant color, appended CSV row, printed summary.
Directory mode (`-d`) covers `color_kmeansChange.py`'s tree walk in one
batched call."""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("-i", "--image", help="Path to one image")
    g.add_argument("-d", "--dir", help="Directory of images (batched)")
    ap.add_argument("-c", "--clusters", required=True, type=int)
    ap.add_argument("-f", "--csv", required=True, type=str)
    args = ap.parse_args(argv)

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import cv2

    from opticalflowclustering_tpu.compat.writers import (
        append_cluster_centers_rows,
    )
    from opticalflowclustering_tpu.pipeline.bounce import dominant_hue_series

    if args.image:
        paths = [args.image]
    else:
        from opticalflowclustering_tpu.io.images import numeric_key

        paths = [
            os.path.join(args.dir, n)
            for n in sorted(os.listdir(args.dir), key=numeric_key)
            if n.lower().endswith((".png", ".jpg"))
        ]

    frames = np.stack([cv2.imread(p) for p in paths])
    if args.clusters == 1:
        centroids, hues = dominant_hue_series(frames, rb_swap=True)
    else:
        from opticalflowclustering_tpu.cluster.kmeans import kmeans_batched
        from opticalflowclustering_tpu.features.dominant_color import (
            preprocess_cells_rgba,
        )
        from opticalflowclustering_tpu.ops.colorspace import bgr2hsv
        import jax.numpy as jnp

        rgba = preprocess_cells_rgba(frames, rb_swap=True)
        pts = np.asarray(rgba).reshape(len(paths), -1, 4).astype(np.float32)
        centers, labels = kmeans_batched(pts, args.clusters)
        # dominant = most-populated cluster (color_kmeans.py:78-96)
        counts = np.stack(
            [np.bincount(np.asarray(l), minlength=args.clusters) for l in labels]
        )
        top = counts.argmax(-1)
        centroids = np.rint(np.asarray(centers)[np.arange(len(paths)), top])
        bgr = centroids[:, :3].astype(np.uint8).reshape(-1, 1, 1, 3)
        hues = np.asarray(bgr2hsv(jnp.asarray(bgr)))[:, 0, 0, 0]

    # Row name: basename for the single-image entry (`color_kmeans.py:133`);
    # the directory variant writes the image PATH as traversed
    # (`color_kmeansChange.py:135`).
    names = (
        [os.path.basename(p) for p in paths] if args.image else list(paths)
    )
    # Both color_kmeans variants write the header when the (reference:
    # hard-coded; here: actual target) CSV is new/empty
    # (`color_kmeans.py:107-110`, `color_kmeansChange.py:108-110`); the
    # fused KmeanGrids path has it commented out (`KmeanGrids.py:321-323`)
    # so addnew.csv stays headerless.
    append_cluster_centers_rows(
        args.csv, names, np.asarray(centroids), hues, header=True
    )
    for name, cen, hue in zip(names, np.asarray(centroids), np.asarray(hues)):
        print(name, np.asarray(cen, np.float64), int(hue))


if __name__ == "__main__":
    main()
