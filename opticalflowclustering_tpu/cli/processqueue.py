"""Multi-video fan-out CLI over the fault-tolerant queue
(pipeline/queue.py) — the serving entry point the reference drives with a
shell loop over single-video script invocations
(`color_kmeans_script.sh:17-20`; `KmeanGrids.py` runs one video per
process).

  python -m opticalflowclustering_tpu.cli.processqueue v1.mp4 v2.avi ... \
      -o features/ [--dp 4 --sp 2] [--no-resume]

Sequential by default (single device, retry + .npz resume). With
`--dp/--sp` a dp×sp `jax.sharding.Mesh` over the available devices runs
the streaming data-parallel queue: dp same-shape videos per dispatch,
frames sharded sp with the ring halo, decode overlapped behind device
batches, host buffering bounded (process_video_queue_dp). Artifacts carry
the full contract (hue/rgb_hue tables, per-cell RGBA centroids,
mean-magnitude telemetry); `--addnew FILE` also appends the reference's
per-cell rows (`KmeanGrids.py:320-339`) from each finished video.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("videos", nargs="+", help="video files to process")
    ap.add_argument("-o", "--out-dir", required=True)
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel width (0 = sequential queue)")
    ap.add_argument("--sp", type=int, default=1,
                    help="frame-axis shards per video (dp mode)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--addnew", default=None,
                    help="also append per-cell addnew rows to this CSV")
    args = ap.parse_args(argv)

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from opticalflowclustering_tpu.pipeline.bounce import PipelineConfig
    from opticalflowclustering_tpu.pipeline.queue import (
        load_features,
        process_video_queue,
        process_video_queue_dp,
    )

    cfg = PipelineConfig(emit_flow_bgr=False)
    resume = not args.no_resume
    if args.dp > 0:
        import jax
        import numpy as np
        from jax.sharding import Mesh

        need = args.dp * args.sp
        devs = jax.devices()
        if len(devs) < need:
            raise SystemExit(
                f"--dp {args.dp} --sp {args.sp} needs {need} devices; "
                f"{len(devs)} available"
            )
        mesh = Mesh(
            np.array(devs[:need]).reshape(args.dp, args.sp), ("dp", "sp")
        )
        results = process_video_queue_dp(
            args.videos, args.out_dir, mesh, cfg,
            resume=resume, max_frames=args.max_frames,
        )
    else:
        results = process_video_queue(
            args.videos, args.out_dir, cfg,
            resume=resume, max_frames=args.max_frames,
        )

    ok = [r for r in results if r.ok]
    bad = [r for r in results if not r.ok]
    for r in ok:
        print(f"ok   {r.video} -> {r.path} (attempts={r.attempts})")
    for r in bad:
        print(f"FAIL {r.video}: {r.error}", file=sys.stderr)

    if args.addnew:
        import numpy as np

        from opticalflowclustering_tpu.compat.writers import (
            append_cluster_centers_rows,
        )

        for r in ok:
            t = load_features(r.path)
            hue = np.asarray(t["hue_table"])
            names = [
                f"{os.path.basename(r.video)}:{f}/{c + 1}.png"
                for f in range(2, 2 + hue.shape[0])
                for c in range(hue.shape[1])
            ]
            append_cluster_centers_rows(
                args.addnew,
                names=names,
                centroids=np.asarray(t["centroids"]).reshape(-1, 4),
                hues=hue.reshape(-1),
            )
        print(f"addnew rows appended to {args.addnew}")

    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
