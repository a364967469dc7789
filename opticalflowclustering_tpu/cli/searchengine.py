"""CBIR CLI mirroring `FirstImageSearchEngine/indexdataset.py` and
`image-search-engine.py` / `external-query.py`: index a directory of images
as RGB-histogram features (npz instead of cPickle), then rank the index
against a query image with chi² distance.

  python -m ...cli.searchengine index -d photos/ -i index.npz
  python -m ...cli.searchengine search -i index.npz -q query.png [-k 10]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    ixp = sub.add_parser("index")
    ixp.add_argument("-d", "--dataset", required=True)
    ixp.add_argument("-i", "--index", required=True)
    sp = sub.add_parser("search")
    sp.add_argument("-i", "--index", required=True)
    sp.add_argument("-q", "--query", required=True)
    sp.add_argument("-k", type=int, default=10)
    args = ap.parse_args(argv)

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import cv2

    from opticalflowclustering_tpu.extras.search_engine import (
        RGBHistogram,
        Searcher,
        index_images,
    )

    if args.cmd == "index":
        names = sorted(
            n for n in os.listdir(args.dataset)
            if n.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        imgs = []
        kept = []
        for n in names:
            im = cv2.imread(os.path.join(args.dataset, n))
            if im is not None:
                imgs.append(cv2.resize(im, (166, 100)))
                kept.append(n)
        feats = index_images(np.stack(imgs))
        np.savez(args.index, names=np.array(kept), features=feats)
        print(f"indexed {len(kept)} images -> {args.index}")
    else:
        z = np.load(args.index, allow_pickle=False)
        index = {str(n): f for n, f in zip(z["names"], z["features"])}
        q = cv2.resize(cv2.imread(args.query), (166, 100))
        results = Searcher(index).search(RGBHistogram().describe(q))
        for dist, name in results[: args.k]:
            print(f"{dist:.4f}\t{name}")


if __name__ == "__main__":
    main()
