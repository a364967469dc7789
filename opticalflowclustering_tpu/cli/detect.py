"""Object-detection CLI mirroring the MobileNet-SSD demo
(`object-detection-with-deep-learning-and-opencv/
deep_learning_object_detection.py:12-38`): one image in, confidence-filtered
labeled boxes printed and drawn to an annotated copy.

Detection = the committed FlowCellNet scored over a strided window grid in
one batched device forward + the framework NMS (models/flow_cnn.py).

  python -m opticalflowclustering_tpu.cli.detect -i frame.png \
      [-c 0.9] [--stride 25] [-o annotated.png]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", required=True)
    ap.add_argument("-c", "--confidence", type=float, default=0.9)
    ap.add_argument("--stride", type=int, default=25)
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import cv2

    from opticalflowclustering_tpu.models.flow_cnn import (
        detect_windows,
        load_params,
    )

    image = cv2.imread(args.image)
    if image is None:
        raise SystemExit(f"cannot read {args.image}")
    params = load_params()
    dets = detect_windows(
        params, image, stride=args.stride, confidence=args.confidence
    )
    for label, conf, (x1, y1, x2, y2) in dets:
        # `deep_learning_object_detection.py:34-38` print + rectangle + text
        print(f"[INFO] {label}: {conf * 100:.2f}%")
        cv2.rectangle(image, (x1, y1), (x2, y2), (0, 0, 255), 2)
        y = y1 - 15 if y1 - 15 > 15 else y1 + 15
        cv2.putText(
            image,
            f"{label}: {conf * 100:.2f}%",
            (x1, y),
            cv2.FONT_HERSHEY_SIMPLEX,
            0.5,
            (0, 0, 255),
            2,
        )
    if args.output:
        cv2.imwrite(args.output, image)
    return dets


if __name__ == "__main__":
    main()
