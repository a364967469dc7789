"""opticalflowclustering_tpu — a JAX/XLA video-analytics framework for NVIDIA
GPUs with the capabilities of menmitsu/opticalFlowClustering.

The reference pipeline (see /root/reference, SURVEY.md) detects table-tennis
ball bounces from video: per-frame Farneback dense optical flow, HSV flow
rendering, grid-cell pooling, per-cell dominant color via k-means, and
sliding-window cosine matching of per-frame hue vectors against labeled
signatures. The reference runs one frame and one grid cell at a time through
Python/OpenCV/sklearn; here every stage is a batched, device-resident XLA
computation over whole videos, sharded across devices with `shard_map` over a
`jax.sharding.Mesh`.

Layout (mirrors SURVEY.md §7):
  ops/       cv2-exact image primitives (colorspace, resize, filters, polar, …)
  flow/      Farneback dense optical flow (pure XLA)
  features/  grid pooling + per-cell dominant color
  cluster/   batched k-means, distance kernels, sliding-window matcher
  pipeline/  fused end-to-end bounce pipeline
  parallel/  mesh construction, temporal/spatial sharding, halo exchange
  models/    flax model slot (learned bounce classifier, CNN inference slot)
  io/        host boundary: video/PNG decode, CSV/overlay emitters
  compat/    byte-compatible output-contract writers for the reference CSVs
  cli/       entry points mirroring the reference scripts
  extras/    library ports of the reference's auxiliary workloads
"""

__version__ = "0.1.0"
