"""Grid-overlay CLI, mirroring `drawGridsAndOutputCSV[Change].py`:
`--path video` → `<video>_rgb_values.csv` (per-frame grid-mean hues over the
inline flow render), `<video>_output.mp4` (flow frames with grid overlay),
and optionally the OutImgs cell dump (`--dump-cells`). `--tenbyten` selects
the 10×10 grid of the non-Change variant (`drawGridsAndOutputCSV.py:168`)."""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", required=True)
    ap.add_argument(
        "--optical",
        default=None,
        help="pre-rendered flow video to grid instead of computing flow "
        "inline (the dual-VideoCapture variant, "
        "drawGridsAndOutputCSV.py:147-148)",
    )
    ap.add_argument(
        "--use-rgb",
        action="store_true",
        help="grid the RGB frames instead of the flow render (the showRGB "
        "toggle, drawGridsAndOutputCSV.py:180-183)",
    )
    ap.add_argument("--noyolo", action="store_false")
    ap.add_argument("--nocontour", action="store_false")
    ap.add_argument("--tenbyten", action="store_true")
    ap.add_argument("--dump-cells", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    args = ap.parse_args(argv)

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from opticalflowclustering_tpu.compat.writers import write_rgb_values_csv
    from opticalflowclustering_tpu.features.grid import GridParams
    from opticalflowclustering_tpu.io.video import (
        read_video_bgr,
        video_fps,
        write_video_mjpg,
    )
    from opticalflowclustering_tpu.pipeline.bounce import (
        PipelineConfig,
        process_frames,
    )

    grid = GridParams(10, 10) if args.tenbyten else GridParams(14, 25)
    cfg = PipelineConfig(grid=grid)
    frames = read_video_bgr(args.path, args.max_frames)

    if args.optical or args.use_rgb:
        # Grid pre-rendered flow frames (or the RGB frames themselves)
        # without recomputing flow — the non-Change variant's data flow.
        from opticalflowclustering_tpu.features.grid import grid_mean_hue
        from opticalflowclustering_tpu.pipeline.bounce import grid_cluster_stage

        src = (
            frames[1:]
            if args.use_rgb
            else read_video_bgr(args.optical, args.max_frames)
        )
        _, hue, rgb_hue = grid_cluster_stage(src, grid, cfg.rb_swap)
        out = {
            "flow_bgr": np.asarray(src),
            "hue_table": np.asarray(hue),
            "rgb_hue_table": np.asarray(rgb_hue),
        }
    else:
        out = process_frames(frames, cfg)

    write_rgb_values_csv(args.path + "_rgb_values.csv", out["rgb_hue_table"])

    # Overlay the grid lines on the flow render for the output video.
    flow_bgr = out["flow_bgr"].copy()
    h, w = flow_bgr.shape[1:3]
    ys, xs = grid.steps(h, w)
    for r in range(grid.rows + 1):
        y = min(r * ys, h - 1)
        flow_bgr[:, y, : grid.cols * xs] = 255
    for c in range(grid.cols + 1):
        x = min(c * xs, w - 1)
        flow_bgr[:, : grid.rows * ys, x] = 255

    # Per-cell mean-value text labels, centered in each cell — the
    # reference's annotation pass (`drawGridsAndOutputCSV.py:106-122`:
    # FONT_HERSHEY_SIMPLEX 0.3, white, thickness 1, LINE_AA, drawn after all
    # rectangles; the mean itself is taken before the cell's own rectangle).
    import cv2

    from opticalflowclustering_tpu.features.grid import grid_mean_bgr

    means = np.asarray(grid_mean_bgr(out["flow_bgr"], grid))
    font, font_scale, thickness = cv2.FONT_HERSHEY_SIMPLEX, 0.3, 1
    for f in range(flow_bgr.shape[0]):
        for i in range(grid.rows * grid.cols):
            x = (i % grid.cols) * xs
            y = (i // grid.cols) * ys + 10
            b, g, r = (int(v) for v in means[f, i])
            text = f"({b}, {g}, {r})"
            (tw, th), _ = cv2.getTextSize(text, font, font_scale, thickness)
            cv2.putText(
                flow_bgr[f],
                text,
                (x + (xs - tw) // 2, y + (ys - th) // 2 + th),
                font,
                font_scale,
                (255, 255, 255),
                thickness,
                cv2.LINE_AA,
            )
    write_video_mjpg(args.path + "_output.mp4", flow_bgr, video_fps(args.path))

    if args.dump_cells:
        import cv2

        from opticalflowclustering_tpu.features.grid import (
            extract_cells,
            whiten_grid_lines,
        )

        name = os.path.basename(args.path).split(".")[0]
        cells = np.asarray(
            whiten_grid_lines(
                extract_cells(out["flow_bgr"], grid), grid, own_rectangle=True
            )
        )
        for f in range(cells.shape[0]):
            d = f"OutImgs/{name}/{f + 2}"
            os.makedirs(d, exist_ok=True)
            for c in range(cells.shape[1]):
                cv2.imwrite(f"{d}/{c + 1}.png", cells[f, c])

    print(f"{args.path}_rgb_values.csv:", out["rgb_hue_table"].shape)


if __name__ == "__main__":
    main()
