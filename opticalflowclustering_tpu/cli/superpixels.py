"""SLIC CLI (`SLIC-Superpixel/slic.py`): segment at 100/200/300 segments
and write boundary overlays.

  python -m ...cli.superpixels -i image.jpg [-o out_prefix]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", required=True)
    ap.add_argument("-o", "--out", default="superpixels")
    ap.add_argument("--segments", type=int, nargs="+", default=[100, 200, 300])
    args = ap.parse_args(argv)

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import cv2

    from opticalflowclustering_tpu.ops.slic import mark_boundaries, slic

    img = cv2.imread(args.image)
    for n in args.segments:
        labels = slic(img, n_segments=n, sigma=5.0)
        overlay = np.asarray(mark_boundaries(img, labels))
        path = f"{args.out}_{n}.png"
        cv2.imwrite(path, (overlay * 255).astype(np.uint8))
        print(f"{path}: {len(np.unique(np.asarray(labels)))} segments")


if __name__ == "__main__":
    main()
