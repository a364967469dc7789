"""Bounce-classification CLI, mirroring
`k-means-color-clustering/findCosineDifferentVectors.py` (same argv, same
printed lines: vector sizes, max cosine similarity, the vestigial
'Minimum sum of squared differences: 0', max frame)."""

from __future__ import annotations

import csv
import sys

import numpy as np


def _second_column(path: str) -> np.ndarray:
    """Column 1 of a header-less CSV (the reference reads it with
    `pd.read_csv(path, header=None).iloc[:, 1]`)."""
    with open(path, newline="") as f:
        return np.array([float(row[1]) for row in csv.reader(f) if row])


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    file1_name, nobounce_name = argv[0], argv[1]

    from opticalflowclustering_tpu.pipeline.bounce import classify_bounce

    file1_hue = _second_column(file1_name)
    nobounce_hue = _second_column(nobounce_name)

    print("Vector sizes are: ", len(file1_hue), len(nobounce_hue))
    sim, frame = classify_bounce(file1_hue, nobounce_hue)
    print("Maximum cosine similarity:", sim)
    # The reference declares-but-never-computes this value (:50,:65).
    print("Minimum sum of squared differences:", 0)
    print("Max frame:", frame)


if __name__ == "__main__":
    main()
