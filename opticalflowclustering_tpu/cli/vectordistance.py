"""Whole-matrix vector distance CLI, mirroring
`computeVectorDistance.py` / `exampleVectorDistances.py` (identical
duplicate files): cosine similarity of two hue CSVs plus summed per-row
Euclidean distance over the common prefix, with the same
length-mismatch warning."""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("file1", nargs="?", default="file1.csv")
    ap.add_argument("file2", nargs="?", default="file2.csv")
    args = ap.parse_args(argv)

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import numpy as np

    from opticalflowclustering_tpu.cluster.matcher import (
        cosine_similarity_matrix,
        rowwise_euclidean_sum,
    )

    def load(path):
        rows = []
        with open(path) as f:
            import csv

            for row in csv.reader(f):
                rows.append([float(v) for v in row[1:]])
        return np.asarray(rows, dtype=float)

    hsv1, hsv2 = load(args.file1), load(args.file2)
    m = min(len(hsv1), len(hsv2))
    sim = np.asarray(
        cosine_similarity_matrix(
            hsv1[:m].reshape(1, -1), hsv2[:m].reshape(1, -1)
        )
    )[0, 0]
    dist = float(rowwise_euclidean_sum(hsv1, hsv2))

    if len(hsv1) != len(hsv2):
        print(
            "Warning: The vectors have different lengths, only the Euclidean "
            "distance of the common subvectors has been computed."
        )
    print("Cosine similarity:", sim)
    print("Euclidean distance:", dist)


if __name__ == "__main__":
    main()
