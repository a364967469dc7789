"""Byte-level format parity of the compat CSV writers against the
reference's committed artifacts (stringified-numpy quirks included)."""

import os

import cv2
import numpy as np
import pytest

REF = "/root/reference/k-means-color-clustering"


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference data unavailable")
def test_cluster_centers_row_bytes_match_addnew(tmp_path):
    """Recompute the committed addnew.csv row for cell 50/176.png from the
    stored OutImgs cell and compare the full serialized row byte-for-byte
    (`name,[R. G. B. A.],[[[h s v]]],hue`)."""
    from opticalflowclustering_tpu.compat.writers import (
        append_cluster_centers_rows,
    )
    from opticalflowclustering_tpu.features.dominant_color import (
        dominant_hue_k1,
        preprocess_cells_rgba,
    )

    want_rows = {}
    with open(f"{REF}/addnew.csv") as f:
        for line in f:
            name = line.split(",", 1)[0]
            if name in ("50/176.png", "50/348.png"):
                want_rows[name] = line.rstrip("\n")

    out = tmp_path / "rows.csv"
    for name in want_rows:
        frame, cell = name.split("/")
        img = cv2.imread(f"{REF}/OutImgs/601_bad_bounce_3/{frame}/{cell}")
        rgba = preprocess_cells_rgba(img[None], rb_swap=True)
        centroid, hue = dominant_hue_k1(rgba)
        append_cluster_centers_rows(
            str(out), [name], np.asarray(centroid), np.asarray(hue)
        )
    got = out.read_text().strip().splitlines()
    for line in got:
        name = line.split(",", 1)[0]
        # csv.writer quotes fields containing commas; the reference's rows
        # use spaces inside the arrays, so no quoting either way
        assert line == want_rows[name], (line, want_rows[name])


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference data unavailable")
def test_cluster_centers_header_semantics(tmp_path):
    """header=True writes the committed cluster_centers.csv header line
    byte-for-byte on a fresh target only; header=False (the fused
    KmeanGrids path) stays headerless like the committed addnew.csv."""
    from opticalflowclustering_tpu.compat.writers import (
        append_cluster_centers_rows,
    )

    want_header = open(f"{REF}/cluster_centers.csv").readline().rstrip("\n")
    cen = np.array([[0.0, 0.0, 0.0, 0.0]])
    hue = np.array([0])

    with_h = tmp_path / "cluster_centers.csv"
    append_cluster_centers_rows(str(with_h), ["a.png"], cen, hue, header=True)
    append_cluster_centers_rows(str(with_h), ["b.png"], cen, hue, header=True)
    lines = with_h.read_text().strip().splitlines()
    assert lines[0] == want_header  # exactly once, only when fresh
    assert len(lines) == 3

    no_h = tmp_path / "addnew.csv"
    append_cluster_centers_rows(str(no_h), ["c.png"], cen, hue)
    first = no_h.read_text().splitlines()[0]
    assert first.startswith("c.png,")


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference data unavailable")
def test_outcsv_serialization_bytes():
    """write_hue_table_csv output bytes match the committed OutCSV header
    and first row exactly."""
    import pandas as pd

    from opticalflowclustering_tpu.compat.writers import write_hue_table_csv

    want = open(f"{REF}/OutCSV/601_bad_bounce_3.csv").read().splitlines()
    table = pd.read_csv(f"{REF}/OutCSV/601_bad_bounce_3.csv").values
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.csv")
        write_hue_table_csv(p, table)
        got = open(p).read().splitlines()
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert len(got) == len(want)


def _pandas_bytes(tmp_path, name, frame_fn):
    pd = pytest.importorskip("pandas")
    path = tmp_path / name
    frame_fn(pd, path)
    return path.read_bytes()


@pytest.mark.parametrize("writer", ["hue", "rgb_values", "optical_flow"])
def test_writers_match_pandas_to_csv_bytes(tmp_path, writer):
    """The standard-library writers reproduce pandas' `to_csv` bytes,
    float repr and NaN-as-empty included."""
    from opticalflowclustering_tpu.compat import writers

    rng = np.random.default_rng(0)
    cols = [f"cell_{i}" for i in range(7)]
    if writer == "hue":
        table = rng.integers(0, 180, (5, 7))
        writers.write_hue_table_csv(str(tmp_path / "a.csv"), table)
        want = _pandas_bytes(tmp_path, "b.csv", lambda pd, p: pd.DataFrame(
            table.astype(np.int64), columns=cols).to_csv(p, index=False))
    elif writer == "rgb_values":
        table = np.concatenate([
            rng.random((3, 7)) * 180,
            [[0.0, 12.0, 1e-7, 1e17, np.nan, 179.5, 3.0]],
        ])
        writers.write_rgb_values_csv(str(tmp_path / "a.csv"), table)
        want = _pandas_bytes(tmp_path, "b.csv", lambda pd, p: pd.DataFrame(
            table, columns=cols).to_csv(p, index=False))
    else:
        mags = np.concatenate([rng.random(6) * 3, [0.0, 1e-9]])
        mags = np.concatenate([mags, np.float32([0.1])])
        writers.write_optical_flow_csv(str(tmp_path / "a.csv"), mags)
        want = _pandas_bytes(tmp_path, "b.csv", lambda pd, p: pd.DataFrame({
            "Frame": np.arange(len(mags)),
            "Average Magnitude": mags.astype(np.float64),
        }).to_csv(p))
    assert (tmp_path / "a.csv").read_bytes() == want


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("artifact", ["OutCSV/601_3.csv", "601_3.avi_opticalFlow.csv"])
def test_writers_reproduce_committed_demo_artifacts(tmp_path, artifact):
    """Re-reading a committed demo_out table and writing it again gives the
    committed bytes back."""
    import csv

    from opticalflowclustering_tpu.compat import writers

    src = os.path.join(REPO, "demo_out", artifact)
    with open(src, newline="") as f:
        rows = list(csv.reader(f))
    out = tmp_path / "x.csv"
    if artifact.startswith("OutCSV"):
        writers.write_hue_table_csv(str(out), np.array(rows[1:], np.int64))
    else:
        mags = np.array([float(r[2]) for r in rows[1:]])
        writers.write_optical_flow_csv(str(out), mags)
    assert out.read_bytes() == open(src, "rb").read()


def test_findcosine_cli_reads_csv_without_pandas(tmp_path, capsys):
    from opticalflowclustering_tpu.cli import findcosine

    rng = np.random.default_rng(2)
    series = rng.integers(0, 180, 40)
    sig = series[25:31]
    for name, vals in (("sig.csv", sig), ("ser.csv", series)):
        (tmp_path / name).write_text(
            "".join(f"{i},{v}\n" for i, v in enumerate(vals)) + "\n"
        )
    findcosine.main([str(tmp_path / "sig.csv"), str(tmp_path / "ser.csv")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split(":")[1].split() == ["6", "40"]
    assert float(lines[1].split(":")[1]) == pytest.approx(1.0, abs=1e-6)
    assert int(lines[3].split(":")[1]) == 25
