"""Circle-detection CLI mirroring the reference demo
(`/root/reference/detect-circles/detect_circles.py:1-20`): load an image,
run Hough circles at the demo's parameters (HOUGH_GRADIENT, dp=1.2,
minDist=75, default param1=100/param2=100), draw each circle outline
(green, thickness 4) plus the orange center marker rectangle, and save
the reference's side-by-side [input | annotated] hstack (the reference
imshow's content; this framework is headless by design, SURVEY §2.5 #8).

`--mode coherent` (default) uses the gradient-coherence-gated detector —
no false positives on busy photographs; `--mode cv2-raw` reproduces
cv2.HoughCircles' raw semantics exactly (ops/hough.py docstring), the
reference demo's literal behavior on all three committed demo images.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-i", "--image", required=True, help="Path to the image")
    ap.add_argument(
        "-o",
        "--output",
        default=None,
        help="annotated hstack output path (default <image>_circles.png)",
    )
    ap.add_argument(
        "--mode",
        choices=("coherent", "cv2-raw"),
        default="coherent",
        help="'coherent' gates radius support on gradient direction (no "
        "accumulation-artifact circles); 'cv2-raw' matches "
        "cv2.HoughCircles exactly on the committed demo images",
    )
    ap.add_argument("--dp", type=float, default=1.2)
    ap.add_argument("--min-dist", type=float, default=75.0)
    ap.add_argument("--param1", type=float, default=100.0)
    ap.add_argument("--param2", type=float, default=100.0)
    ap.add_argument(
        "--max-circles",
        type=int,
        default=16,
        help="size of the fixed device output buffer (jittable core); "
        "cv2.HoughCircles has no such bound — raise this on circle-rich "
        "images (a warning is printed when the buffer fills)",
    )
    return ap


def main(argv: list[str] | None = None) -> int:
    import cv2

    from opticalflowclustering_tpu.ops.hough import hough_circles

    args = build_parser().parse_args(argv)

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    image = cv2.imread(args.image)
    if image is None:
        print(f"cannot read {args.image}")
        return 2
    output = image.copy()
    gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
    circles = hough_circles(
        gray,
        dp=args.dp,
        min_dist=args.min_dist,
        canny_high=args.param1,
        acc_threshold=args.param2,
        max_circles=args.max_circles,
        coherence_gate=args.mode == "coherent",
    )
    if len(circles) == args.max_circles:
        print(
            f"warning: output buffer full ({args.max_circles}); more "
            f"circles may exist — re-run with a larger --max-circles",
        )
    for x, y, r in np.round(circles).astype(int):
        cv2.circle(output, (x, y), r, (0, 255, 0), 4)
        cv2.rectangle(
            output, (x - 5, y - 5), (x + 5, y + 5), (0, 128, 255), -1
        )
        print(f"circle x={x} y={y} r={r}")
    print(f"{len(circles)} circle(s) [{args.mode}]")
    out_path = args.output or (
        os.path.splitext(args.image)[0] + "_circles.png"
    )
    cv2.imwrite(out_path, np.hstack([image, output]))
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
