"""End-to-end demo of the reference's full workflow on the committed
footage, one command:

    python scripts/demo_workflow.py [--workdir DIR] [--cpu]

Recreates the reference's documented pipeline
(`k-means-color-clustering/README.md`) against real frames committed in
the reference tree:

  1. build an MJPG clip from `images/601_3_cropped_3_OF` PNG frames
     (the mp4s in the reference are Git-LFS pointer stubs),
  2. `cli.computeopticalflow`  → flow video + `*_opticalFlow.csv` +
     `*_squares.png`            (reference: computeOpticalFlow.py),
  3. `cli.kmeangrids --stream` → `OutCSV/<clip>.csv` hue table +
     addnew per-cell rows       (reference: KmeanGrids.py fused run),
  4. `cli.findcosine`          → the README's verbatim bounce-match
     recipe on the committed labeled hue series (`bounce.csv` vs
     `601_3_3_cropped.csv`; reference: findCosineDifferentVectors.py,
     `README.md:7`).

Everything runs headless; artifacts land in --workdir. Works on the GPU
(default) or CPU (--cpu).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference/k-means-color-clustering"
sys.path.insert(0, REPO)  # runnable from any cwd


def run_cli(mod: str, *args: str, cwd: str, cpu: bool) -> None:
    env = dict(os.environ, PYTHONPATH=REPO)
    if cpu:
        env["JAX_PLATFORMS"] = "cpu"
    cmd = [sys.executable, "-m", f"opticalflowclustering_tpu.cli.{mod}", *args]
    print(f"\n$ {' '.join(cmd[2:])}")
    subprocess.run(cmd, cwd=cwd, env=env, check=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="demo_out")
    ap.add_argument("--cpu", action="store_true",
                    help="force the JAX CPU backend")
    args = ap.parse_args()

    if not os.path.isdir(REF):
        sys.exit("reference tree unavailable at /root/reference")
    os.makedirs(args.workdir, exist_ok=True)
    wd = os.path.abspath(args.workdir)

    # 1. clip from committed real frames
    import cv2

    from opticalflowclustering_tpu.io.video import write_video_mjpg

    d = f"{REF}/images/601_3_cropped_3_OF"
    names = sorted(n for n in os.listdir(d) if n.endswith(".png"))
    frames = np.stack([cv2.imread(os.path.join(d, n)) for n in names])
    clip = os.path.join(wd, "601_3.avi")
    write_video_mjpg(clip, frames, 30.0)
    print(f"clip: {frames.shape[0]} committed frames → {clip}")

    # 2. flow video + telemetry CSV + magnitude plot
    run_cli("computeopticalflow", "-i", clip, cwd=wd, cpu=args.cpu)

    # 3. fused flow→grid→cluster run (streaming decode), OutCSV + addnew
    run_cli(
        "kmeangrids", "-d", "OutImgs/601_3", "-c", "1", "-f", "addnew.csv",
        "--noyolo", "--nocontour", "--path", clip, "--stream",
        cwd=wd, cpu=args.cpu,
    )

    # 4. bounce classification — the README recipe on the committed
    # labeled per-frame hue series (findcosine consumes the 2-column
    # `name,hue` format those files use)
    run_cli(
        "findcosine", f"{REF}/bounce.csv",
        f"{REF}/601_3_3_cropped.csv",
        cwd=wd, cpu=args.cpu,
    )

    print("\nartifacts:")
    for root, _, files in os.walk(wd):
        for f in sorted(files):
            p = os.path.join(root, f)
            print(f"  {os.path.relpath(p, wd):40s} {os.path.getsize(p):>10d} B")


if __name__ == "__main__":
    main()
