"""Image-classification CLI mirroring the cv2.dnn GoogLeNet demo
(`deep-learning-with-opencv/deep_learning_with_opencv.py`): load an image,
run one forward pass, print the inference time and the top-k labels in the
demo's format.

The model is the committed FlowCellNet trained on the reference's real
labeled footage (models/flow_cnn.py explains why no Caffe weights exist to
port).

  python -m opticalflowclustering_tpu.cli.classify -i image.png [-k 2]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", required=True)
    ap.add_argument("-k", "--topk", type=int, default=2)
    args = ap.parse_args(argv)

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import cv2
    import numpy as np

    from opticalflowclustering_tpu.models.flow_cnn import (
        classify_cells,
        load_params,
        top_k_labels,
    )

    image = cv2.imread(args.image)
    if image is None:
        raise SystemExit(f"cannot read {args.image}")
    if image.shape[:2] != (50, 50):
        image = cv2.resize(image, (50, 50), interpolation=cv2.INTER_LINEAR)

    params = load_params()
    classify_cells(params, image[None])  # compile outside the timing
    start = time.time()
    probs = classify_cells(params, image[None])[0]
    end = time.time()
    # `deep_learning_with_opencv.py:25` timing line, `:29-33` top-k lines
    print(f"[INFO] classification took {end - start:.5f} seconds")
    for rank, label, p in top_k_labels(probs, args.topk):
        print(f"[INFO] {rank}. label: {label}, probability: {p:.5f}")
    return np.argmax(probs)


if __name__ == "__main__":
    main()
