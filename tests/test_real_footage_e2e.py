"""Real-footage end-to-end parity: full decode→flow→render→grid→cluster
path on committed reference frames vs a faithful cv2/numpy re-enactment of
the reference pipeline (`KmeanGrids.py:180-239` + phase 2), in both warp
modes. The committed `601_bad_bounce_3.mp4_rgb_values.csv` cannot be
matched bit-for-bit because its source RGB video exists only as an LFS
pointer stub — so the oracle here is the reference ALGORITHM re-run on the
same real decoded frames (the committed `images/601_3_cropped_*_OF`
sequences re-encoded as a clip), which pins the full video path against
real footage end to end."""

import os

import cv2
import numpy as np
import pytest

REF = "/root/reference/k-means-color-clustering"
GRID_ROWS, GRID_COLS = 14, 25

pytestmark = [
    pytest.mark.oracle,
    pytest.mark.skipif(
        not os.path.isdir(REF), reason="reference data unavailable"
    ),
]


@pytest.fixture(scope="module")
def real_clip(tmp_path_factory):
    """Encode 13 high-motion committed frames as MJPG video, then decode —
    both pipelines consume the SAME decoded (lossy) frames."""
    from opticalflowclustering_tpu.io.video import (
        read_video_bgr,
        write_video_mjpg,
    )

    d = f"{REF}/images/601_3_cropped_3_OF"
    names = sorted(n for n in os.listdir(d) if n.endswith(".png"))[46:59]
    frames = np.stack([cv2.imread(os.path.join(d, n)) for n in names])
    path = str(tmp_path_factory.mktemp("clip") / "real.mp4")
    write_video_mjpg(path, frames, 30.0)
    return path, read_video_bgr(path)


def reference_reenactment(frames: np.ndarray):
    """The reference pipeline verbatim on decoded frames: per-pair cv2
    Farneback → HSV render → 14×25 grid with white-line leakage → RGBA
    preprocess (with the R/B disk-roundtrip quirk) → KMeans(k=1) dominant
    hue (OutCSV semantics) and grid-mean hue (rgb_values semantics)."""
    h, w = frames.shape[1:3]
    ys, xs = h // GRID_ROWS, w // GRID_COLS
    prev_gray = cv2.cvtColor(frames[0], cv2.COLOR_BGR2GRAY)
    out_hue, rgb_hue, out_sat, rgb_sat = [], [], [], []
    for i in range(1, frames.shape[0]):
        gray = cv2.cvtColor(frames[i], cv2.COLOR_BGR2GRAY)
        flow = cv2.calcOpticalFlowFarneback(
            prev_gray, gray, None, 0.5, 3, 15, 3, 5, 1.2, 0
        )
        prev_gray = gray
        mag, ang = cv2.cartToPolar(flow[..., 0], flow[..., 1])
        mask = np.zeros_like(frames[i])
        mask[..., 0] = ang * 180 / np.pi / 2
        mask[..., 1] = 255
        mask[..., 2] = cv2.normalize(mag, None, 0, 255, cv2.NORM_MINMAX)
        bgr = cv2.cvtColor(mask, cv2.COLOR_HSV2BGR)
        hues, mhues, sats, msats = [], [], [], []
        for r in range(GRID_ROWS):
            for c in range(GRID_COLS):
                # rgb_values semantics: mean before own rectangle, after
                # the scan-order neighbors' — cv2.rectangle edges land on
                # this cell's top row (from the cell above) and left
                # column (from the cell to the left).
                roi = bgr[
                    r * ys : (r + 1) * ys, c * xs : (c + 1) * xs
                ].copy()
                if r > 0:
                    roi[0, :] = 255
                if c > 0:
                    roi[:, 0] = 255
                mean = np.mean(roi, axis=(0, 1)).astype(np.uint8)
                mhues.append(
                    cv2.cvtColor(mean[None, None], cv2.COLOR_BGR2HSV)[0, 0, 0]
                )
                msats.append(int(mean.max()) - int(mean.min()))
                # OutCSV semantics: own rectangle drawn first, then the
                # RGBA preprocess of color_kmeans.py (BGR→RGB swap
                # retained through the HSV convert — SURVEY §2.5 #5).
                roi[0, :] = 255
                roi[:, 0] = 255
                rgb = cv2.cvtColor(roi, cv2.COLOR_BGR2RGB)
                rgb[rgb < 30] = 0
                g2 = cv2.cvtColor(rgb, cv2.COLOR_BGR2GRAY)
                _, alpha = cv2.threshold(g2, 0, 255, cv2.THRESH_BINARY)
                flat = np.dstack([rgb, alpha]).reshape(-1, 4).astype(np.float64)
                cen = np.rint(flat.mean(axis=0))  # KMeans k=1 == mean
                px = np.array([[[cen[0], cen[1], cen[2]]]], np.uint8)
                hues.append(cv2.cvtColor(px, cv2.COLOR_BGR2HSV)[0, 0, 0])
                sats.append(cen[:3].max() - cen[:3].min())
        out_hue.append(hues)
        rgb_hue.append(mhues)
        out_sat.append(sats)
        rgb_sat.append(msats)
    f32 = np.float32
    return (
        np.array(out_hue, f32),
        np.array(rgb_hue, f32),
        np.array(out_sat, f32),
        np.array(rgb_sat, f32),
    )


def _check_hues(got, want, saturation, tag, min_exact=0.97):
    """≥97% of cells hue-exact; every disagreement beyond ±2 circular hue
    steps must be a low-saturation cell (channel spread ≤ 16 — hue there
    is ill-conditioned: ±1 render noise at uint8 truncation boundaries
    swings it by 30/spread per unit, flipping sectors on near-gray cells,
    in cv2 itself as much as here). The bounded-noise claim itself is
    asserted separately on the render means."""
    got = np.asarray(got, np.float32)
    exact = (got == want).mean()
    d = np.abs(got - want)
    d = np.minimum(d, 180 - d)  # hue is circular with period 180
    assert exact > min_exact, (tag, exact)
    bad = d > 2.0
    assert saturation[bad].max(initial=0.0) <= 16, (
        tag, exact, d.max(), saturation[bad].max(initial=0.0),
    )


def test_full_video_path_matches_reference_on_real_footage(real_clip):
    from opticalflowclustering_tpu.pipeline.bounce import (
        PipelineConfig,
        process_frames,
    )

    path, frames = real_clip
    want_hue, want_rgb, out_sat, rgb_sat = reference_reenactment(frames)

    cfg = PipelineConfig(chunk=4, emit_flow_bgr=True)
    out = process_frames(frames, cfg)

    # Bounded-noise invariant: per-cell means of our flow render vs the
    # cv2 render stay within ±2 units on every cell — the divergence of
    # the whole decode→flow→render front-end is uint8 truncation noise,
    # not drift. (Isolated ±1 pixel flips come from flows differing by
    # ~1e-6 px EPE at rounding boundaries.)
    h, w = frames.shape[1:3]
    ys, xs = h // GRID_ROWS, w // GRID_COLS
    cv2_means, our_means = [], []
    prev_gray = cv2.cvtColor(frames[0], cv2.COLOR_BGR2GRAY)
    for i in range(1, frames.shape[0]):
        gray = cv2.cvtColor(frames[i], cv2.COLOR_BGR2GRAY)
        flow = cv2.calcOpticalFlowFarneback(
            prev_gray, gray, None, 0.5, 3, 15, 3, 5, 1.2, 0
        )
        prev_gray = gray
        mag, ang = cv2.cartToPolar(flow[..., 0], flow[..., 1])
        mask = np.zeros_like(frames[i])
        mask[..., 0] = ang * 180 / np.pi / 2
        mask[..., 1] = 255
        mask[..., 2] = cv2.normalize(mag, None, 0, 255, cv2.NORM_MINMAX)
        bgr = cv2.cvtColor(mask, cv2.COLOR_HSV2BGR)
        for img, dst in ((bgr, cv2_means), (out["flow_bgr"][i - 1], our_means)):
            crop = img[: GRID_ROWS * ys, : GRID_COLS * xs].astype(np.float64)
            cells = crop.reshape(GRID_ROWS, ys, GRID_COLS, xs, 3)
            dst.append(cells.mean(axis=(1, 3)).reshape(-1, 3))
    mean_diff = np.abs(np.array(cv2_means) - np.array(our_means)).max()
    assert mean_diff <= 2.0, mean_diff

    # Hue tables: exact except isolated low-saturation sector flips. The
    # rgb_values path truncates the mean to uint8 BEFORE the hue convert,
    # so boundary flips are slightly more frequent there.
    _check_hues(out["hue_table"], want_hue, out_sat, "OutCSV")
    _check_hues(
        out["rgb_hue_table"], want_rgb, rgb_sat, "rgb_values",
        min_exact=0.94,
    )


def test_kmeangrids_cli_writes_csv_from_real_clip(real_clip, tmp_path):
    """The CLI decode→CSV path on the real clip: OutCSV rows equal the
    library path's hue table byte-for-byte (same writer)."""
    import subprocess
    import sys

    path, frames = real_clip
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run(
        [
            sys.executable, "-m",
            "opticalflowclustering_tpu.cli.kmeangrids",
            "-d", "OutImgs/real", "-c", "1", "-f", "addnew.csv",
            "--noyolo", "--nocontour", "--path", path,
        ],
        cwd=tmp_path,
        env=env,
        check=True,
        capture_output=True,
    )
    csv = tmp_path / "OutCSV" / "real.csv"
    assert csv.exists()
    rows = csv.read_text().strip().splitlines()
    assert len(rows) == frames.shape[0] - 1 + 1  # header + one per pair
    want_hue, _, out_sat, _ = reference_reenactment(frames)
    got = np.loadtxt(rows[1:], delimiter=",", dtype=np.float32)
    _check_hues(got, want_hue, out_sat, "CLI OutCSV")
