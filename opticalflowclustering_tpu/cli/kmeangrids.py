"""Fused flow→grid→cluster CLI, mirroring
`k-means-color-clustering/KmeanGrids.py` (usage `KmeanGrids.py:406`):

  -d OutImgs/<video> -c 1 -f addnew.csv --noyolo --nocontour --path <video>

Phase 1+2 fuse on device; outputs `OutCSV/<video>.csv` (hue table) and
appends per-cell rows to the -f CSV in the addnew.csv format. When --path
is missing/undecodable but -d points at an existing OutImgs cell tree, the
cluster phase runs directly from the committed cells (the reference's
phase-2-only behavior) — this is also how golden parity is checked without
the LFS-stubbed mp4s.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_arguments(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-d", "--dir", required=True, help="Path to the image")
    ap.add_argument("-c", "--clusters", required=True, type=int)
    ap.add_argument("-f", "--csv", required=True, type=str)
    ap.add_argument("--noyolo", action="store_false")
    ap.add_argument("--nocontour", action="store_false")
    ap.add_argument("--path", required=True, help="Path to the input video")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument(
        "--no-rb-swap",
        action="store_true",
        help="use the in-memory channel order instead of the golden-artifact "
        "disk-roundtrip order (SURVEY.md §2.5 #5)",
    )
    ap.add_argument(
        "--stream",
        action="store_true",
        help="decode-overlapped streaming pipeline (pipeline.bounce."
        "process_video_stream): background-thread decode + async device "
        "dispatch, constant host memory for arbitrarily long videos; "
        "bit-identical tables, but incompatible with overlays (pass "
        "--noyolo --nocontour)",
    )
    ap.add_argument(
        "--warp-mode",
        choices=("exact", "select"),
        default="exact",
        help="flow-warp implementation (flow.farneback.FarnebackParams): "
        "'exact' the bit-faithful bilinear gather (default); 'select' the "
        "legacy gather-free warp — INEXACT at motion discontinuities "
        "(0.1-1 px EPE), kept for comparison only",
    )
    return vars(ap.parse_args(argv))


def main(argv=None):
    args = parse_arguments(argv)

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    rb_swap = not args["no_rb_swap"]

    from opticalflowclustering_tpu.compat.writers import (
        append_cluster_centers_rows,
        write_hue_table_csv,
    )
    from opticalflowclustering_tpu.features.dominant_color import (
        dominant_hue_k1,
        preprocess_cells_rgba,
    )

    video_name = os.path.basename(args["dir"].rstrip("/\\"))

    from opticalflowclustering_tpu.io.video import is_lfs_pointer

    use_video = os.path.isfile(args["path"])
    if use_video and is_lfs_pointer(args["path"]):
        # The reference commits every .mp4 as a Git-LFS pointer stub; fall
        # back to the committed OutImgs cell tree (phase-2-only) explicitly.
        print(f"{args['path']} is a Git-LFS pointer stub, not video data; "
              f"clustering the committed cell tree at {args['dir']} instead")
        use_video = False

    if use_video:
        from opticalflowclustering_tpu.pipeline.bounce import (
            OverlaySpec,
            PipelineConfig,
            process_frames,
        )
        from opticalflowclustering_tpu.io.video import read_video_bgr

        # argparse store_false: flags default True, passing --noyolo /
        # --nocontour turns them off (`KmeanGrids.py:255-257,353-354`).
        overlays = None
        if args["noyolo"] or args["nocontour"]:
            overlays = OverlaySpec(
                yolo_file="yolo_labels.txt" if args["noyolo"] else None,
                contour_dir="Contours" if args["nocontour"] else None,
                video_name=os.path.basename(args["path"]),
            )
        from opticalflowclustering_tpu.flow.farneback import FarnebackParams

        cfg = PipelineConfig(
            rb_swap=rb_swap,
            emit_flow_bgr=overlays is not None,
            flow=FarnebackParams(warp_mode=args["warp_mode"]),
        )
        if args["stream"]:
            if overlays is not None:
                raise SystemExit(
                    "--stream is feature-only; pass --noyolo --nocontour"
                )
            from opticalflowclustering_tpu.pipeline.bounce import (
                process_video_stream,
            )

            out = process_video_stream(args["path"], cfg, args["max_frames"])
        else:
            frames = read_video_bgr(args["path"], args["max_frames"])
            # This CLI writes CSVs only (the reference's video write is
            # commented out, `KmeanGrids.py:233-234`), so without overlays
            # it takes the feature-only path: no rendered-video
            # materialization, one packed device→host fetch.
            out = process_frames(frames, cfg, overlays=overlays)
        hue_table = out["hue_table"]
        # Per-cell RGBA centroids ride the packed fetch — the fused run's
        # `-f`/addnew rows (`KmeanGrids.py:320-339`) are written on the
        # video path too, not just the phase-2 cell-tree path.
        centroids = out["centroids"]
    else:
        # Phase-2-only: cluster the existing OutImgs cell tree.
        from opticalflowclustering_tpu.io.images import read_cell_tree

        cells = read_cell_tree(args["dir"], args["max_frames"])
        rgba = preprocess_cells_rgba(cells, rb_swap=rb_swap)
        centroids, hue = dominant_hue_k1(rgba)
        hue_table = np.asarray(hue)

    os.makedirs("OutCSV", exist_ok=True)
    write_hue_table_csv(f"OutCSV/{video_name}.csv", hue_table)
    print(f"OutCSV/{video_name}.csv: {hue_table.shape[0]} frames x "
          f"{hue_table.shape[1]} cells")

    if centroids is not None:
        names = [
            f"{f}/{c + 1}.png"
            for f in range(2, 2 + hue_table.shape[0])
            for c in range(hue_table.shape[1])
        ]
        append_cluster_centers_rows(
            args["csv"],
            names=names,
            centroids=np.asarray(centroids).reshape(-1, 4),
            hues=np.asarray(hue_table).reshape(-1),
        )


if __name__ == "__main__":
    main()
