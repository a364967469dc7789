"""Document scanner CLI (`DocumentScanner/scan.py` flags):
  python -m ...cli.scan -i doc.jpg [-o out_prefix]
Writes <prefix>_warped.png and <prefix>_binarized.png."""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", required=True)
    ap.add_argument("-o", "--out", default="scanned")
    args = ap.parse_args(argv)

    from opticalflowclustering_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import cv2

    from opticalflowclustering_tpu.extras.document_scanner import scan_document

    img = cv2.imread(args.image)
    warped, binarized = scan_document(img)
    if warped is None:
        print("no 4-point document contour found")
        return
    cv2.imwrite(args.out + "_warped.png", warped)
    cv2.imwrite(args.out + "_binarized.png", binarized)
    print(f"wrote {args.out}_warped.png {args.out}_binarized.png "
          f"({warped.shape[1]}x{warped.shape[0]})")


if __name__ == "__main__":
    main()
