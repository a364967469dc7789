"""Flow-video + magnitude telemetry CLI, mirroring
`k-means-color-clustering/computeOpticalFlow.py` (`-i video` → writes
`<input>onlyOpticalflow.mp4`, `<input>_opticalFlow.csv`,
`<input>_squares.png`)."""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="OpticalFlow", description="find optical flow of video"
    )
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument(
        "--warp-mode",
        choices=("exact", "select"),
        default="exact",
        help="flow-warp implementation: 'exact' = bit-faithful bilinear "
        "gather (default); 'select' = legacy gather-free warp, INEXACT at "
        "motion discontinuities (0.1-1 px EPE), kept for comparison only",
    )
    args = ap.parse_args(argv)

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from opticalflowclustering_tpu.compat.writers import write_optical_flow_csv
    from opticalflowclustering_tpu.flow.farneback import FarnebackParams
    from opticalflowclustering_tpu.io.video import (
        read_video_bgr,
        video_fps,
        write_video_mjpg,
    )
    from opticalflowclustering_tpu.pipeline.bounce import (
        PipelineConfig,
        process_frames,
    )

    frames = read_video_bgr(args.input, args.max_frames)
    out = process_frames(
        frames,
        PipelineConfig(flow=FarnebackParams(warp_mode=args.warp_mode)),
    )

    write_video_mjpg(
        args.input + "onlyOpticalflow.mp4", out["flow_bgr"], video_fps(args.input)
    )
    write_optical_flow_csv(args.input + "_opticalFlow.csv", out["mean_magnitude"])
    for i, m in enumerate(out["mean_magnitude"]):
        print("Average Magnitude of optical flow ", float(m))
        print("Number of VideoFrames processed", i + 1, "/", frames.shape[0])

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot(
            np.arange(len(out["mean_magnitude"])),
            out["mean_magnitude"],
            color="black",
        )
        plt.savefig(args.input + "_squares.png")
    except ImportError:
        print("matplotlib unavailable; skipped _squares.png")


if __name__ == "__main__":
    main()
