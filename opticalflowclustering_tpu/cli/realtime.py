"""Live-stream detection loop mirroring the real-time SSD demo
(`real-time-object-detection-with-deep-learning-and-opencv/
real_time_object_detection.py:29-71`): a threaded VideoStream feeds frames,
each frame is scored by the committed FlowCellNet detector in one batched
device forward, boxes are drawn, and an FPS meter reports elapsed time and
approx. throughput at the end — headless by design (annotated frames go to
an output video instead of cv2.imshow).

  python -m opticalflowclustering_tpu.cli.realtime -s video.mp4 \
      [-c 0.9] [--stride 25] [-o annotated.mp4] [--max-frames 100]

`-s` also accepts a camera index (e.g. `-s 0`) when a camera exists.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-s", "--source", required=True,
                    help="video path or camera index")
    ap.add_argument("-c", "--confidence", type=float, default=0.9)
    ap.add_argument("--stride", type=int, default=25)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    args = ap.parse_args(argv)

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import cv2
    import numpy as np

    from opticalflowclustering_tpu.io.video import VideoStream, write_video_mjpg
    from opticalflowclustering_tpu.models.flow_cnn import (
        detect_windows,
        load_params,
    )
    from opticalflowclustering_tpu.utils.profiling import ThroughputMeter

    src = int(args.source) if args.source.isdigit() else args.source
    params = load_params()
    # compile the detector before the stream starts ticking, like the
    # demo's model load happens before VideoStream(...).start()
    probe = cv2.VideoCapture(src)
    ok, first = probe.read()
    probe.release()
    if not ok:
        raise SystemExit(f"cannot read from {args.source}")
    detect_windows(params, np.zeros_like(first), stride=args.stride,
                   confidence=args.confidence)
    vs = VideoStream(src).start()  # `real_time_object_detection.py:29`
    fps = ThroughputMeter().start()  # `:31`
    annotated = []
    n = 0
    while vs.running() or n == 0:
        frame = vs.read()
        if frame is None:
            break
        dets = detect_windows(
            params, frame, stride=args.stride, confidence=args.confidence
        )
        for label, conf, (x1, y1, x2, y2) in dets:
            cv2.rectangle(frame, (x1, y1), (x2, y2), (0, 0, 255), 2)
            y = y1 - 15 if y1 - 15 > 15 else y1 + 15
            cv2.putText(frame, f"{label}: {conf * 100:.2f}%", (x1, y),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 255), 2)
        if args.output:
            annotated.append(frame.copy())
        fps.update()
        n += 1
        if args.max_frames is not None and n >= args.max_frames:
            break
    vs.stop()
    # `real_time_object_detection.py:67-71`
    print(f"[INFO] elapsed time: {fps.elapsed():.2f}")
    print(f"[INFO] approx. FPS: {fps.fps():.2f}")
    if args.output and annotated:
        write_video_mjpg(args.output, np.stack(annotated), 30.0)
    return n


if __name__ == "__main__":
    main()
