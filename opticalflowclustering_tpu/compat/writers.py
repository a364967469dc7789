"""Byte-compatible output-contract writers.

The reference's downstream consumers read its CSV artifacts, so formats are
preserved down to the reference's pandas `to_csv` layout and numpy
stringification (SURVEY.md §2.1 'data artifacts'), written here with the
standard library alone:

- `OutCSV/<video>.csv` (`KmeanGrids.py:394-399`): header `cell_0..cell_N-1`
  once, integer hue rows appended per frame.
- `<video>_rgb_values.csv` (`drawGridsAndOutputCSVChange.py:135-141`):
  same header, float hue strings ("12.0").
- `cluster_centers.csv` / `addnew.csv` (`color_kmeans.py:105-133`): rows
  `name,[ 12.  34.  56.   0.],[[[h s v]]],hue` — stringified numpy arrays,
  exactly as `csv.writer` renders `str(np.rint(centroid))` /
  `str(cv2.cvtColor(...))`.
- `<video>_opticalFlow.csv` (`computeOpticalFlow.py:146-149`): pandas
  default-index frame/mean-magnitude telemetry.

Floats are written as pandas writes float64 columns: the shortest repr that
round-trips (`repr(float)`), NaN as an empty field.
"""

from __future__ import annotations

import csv
import os

import numpy as np


def _float_field(v: float) -> str:
    return "" if v != v else repr(float(v))


def _write_rows(path: str, header: list[str], rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def write_hue_table_csv(path: str, hue_table: np.ndarray) -> None:
    """OutCSV contract: [frames, cells] integer hues; header written with
    the first frame, appended rows afterwards (`KmeanGrids.py:394-399`)."""
    hue_table = np.asarray(hue_table)
    cols = [f"cell_{i}" for i in range(hue_table.shape[1])]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _write_rows(path, cols, hue_table.astype(np.int64).tolist())


def write_rgb_values_csv(path: str, hue_table: np.ndarray) -> None:
    """`*_rgb_values.csv` contract: float hue strings, header once."""
    hue_table = np.asarray(hue_table, dtype=np.float64)
    cols = [f"cell_{i}" for i in range(hue_table.shape[1])]
    _write_rows(
        path, cols, ([_float_field(v) for v in row] for row in hue_table.tolist())
    )


def append_cluster_centers_rows(
    path: str,
    names: list[str],
    centroids: np.ndarray,
    hues: np.ndarray,
    header: bool = False,
) -> None:
    """cluster_centers.csv / addnew.csv contract: one appended row per image:
    `name, str(rint(centroid_rgba)), str(hsv_1x1x3), hue`
    (`color_kmeans.py:105-133`).

    header=True writes `File name,Cluster 1,HSV Cluster 1,Hue 0` when the
    target is new/empty — the reference guards this on the HARD-CODED
    `cluster_centers.csv` (`color_kmeans.py:107`, quirk §2.5 #4: crashes
    when that file is absent and headers addnew.csv only by accident of
    its existence). Here the guard checks the actual target, so the
    committed artifacts reproduce deterministically: cluster_centers.csv
    has the header (color_kmeans path, header=True), addnew.csv does not
    (fused KmeanGrids path, header=False)."""
    centroids = np.asarray(centroids)
    hues = np.asarray(hues)
    fresh = not os.path.exists(path) or os.stat(path).st_size == 0
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if header and fresh:
            w.writerow(["File name", "Cluster 1", "HSV Cluster 1", "Hue 0"])
        for name, cen, hue in zip(names, centroids, hues):
            cen_f = np.asarray(cen, dtype=np.float64)
            c0, c1, c2 = int(cen_f[0]), int(cen_f[1]), int(cen_f[2])
            hsv_arr = _hsv_1x1(np.array([c0, c1, c2], np.uint8), int(hue))
            w.writerow([name, str(cen_f), str(hsv_arr), int(hue)])


def _hsv_1x1(bgr: np.ndarray, hue: int) -> np.ndarray:
    """Rebuild the [[[h s v]]] uint8 array the reference stringifies."""
    from opticalflowclustering_tpu.ops.colorspace import bgr2hsv

    return np.asarray(bgr2hsv(bgr.reshape(1, 1, 3)))


def write_optical_flow_csv(path: str, mean_magnitudes: np.ndarray) -> None:
    """`<input>_opticalFlow.csv`: pandas frame with default index,
    columns Frame / Average Magnitude (`computeOpticalFlow.py:146-149`)."""
    mags = np.asarray(mean_magnitudes, dtype=np.float64)
    _write_rows(
        path,
        ["", "Frame", "Average Magnitude"],
        ([i, i, _float_field(m)] for i, m in enumerate(mags.tolist())),
    )
