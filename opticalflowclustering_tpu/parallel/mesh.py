"""Device-mesh construction.

The reference has no distributed layer at all (SURVEY.md §2.4 — a single
Python process); scale-out here is a `jax.sharding.Mesh` with XLA
collectives (NCCL between GPUs), axes named for the
parallelism they carry:

  dp — across videos (embarrassingly parallel)
  sp — across a video's frame axis (temporal sharding; flow needs a 1-frame
       halo exchanged via ppermute — the ring-attention analogue here)
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(
    axes: dict[str, int] | None = None, devices=None
) -> Mesh:
    """Build a Mesh. Default: all local devices on one 'sp' axis.

    make_mesh({'dp': 2, 'sp': 4}) → 2×4 mesh (8 chips). An axis size of -1
    absorbs the remaining devices.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if axes is None:
        axes = {"sp": len(devices)}
    names = list(axes.keys())
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    if total != len(devices):
        devices = devices[:total]
    return Mesh(devices.reshape(sizes), tuple(names))
