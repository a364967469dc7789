"""Content-based image retrieval (`FirstImageSearchEngine/` and its
`hobbit-lotr-image-search-engine/` duplicate).

- `RGBHistogram.describe` (`rgbhistogram.py:8-13`): 3-D RGB histogram,
  L2-normalized, flattened.
- `Searcher.search` (`searcher.py:7-16`): chi²-distance ranking.
- `index_images` (`indexdataset.py:14-26`): batched feature extraction —
  all images' histograms in one device call, persisted as .npz instead of
  cPickle.

On the device the whole index search is ONE [Q, D] × [N, D] chi² broadcast,
not a Python loop over the index.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from opticalflowclustering_tpu.ops.histogram import chi2_distance, rgb_histogram_feature


class RGBHistogram:
    """API-compatible descriptor (`rgbhistogram.py:4-13`)."""

    def __init__(self, bins=(8, 8, 8)):
        self.bins = tuple(bins)

    def describe(self, image) -> np.ndarray:
        return np.asarray(rgb_histogram_feature(jnp.asarray(image), self.bins))


def index_images(images: np.ndarray, bins=(8, 8, 8)) -> np.ndarray:
    """[N,H,W,3] uint8 → [N, prod(bins)] features in one batched call."""
    feats = jax.vmap(lambda im: rgb_histogram_feature(im, bins))(
        jnp.asarray(images)
    )
    return np.asarray(feats)


class Searcher:
    """`searcher.py:4-21` with a vectorized chi² ranking."""

    def __init__(self, index: dict[str, np.ndarray]):
        self.index = index
        self._names = list(index.keys())
        self._feats = jnp.asarray(np.stack([index[k] for k in self._names]))

    def search(self, query_features) -> list[tuple[float, str]]:
        q = jnp.asarray(query_features, jnp.float32)
        d = np.asarray(chi2_distance(self._feats, q[None, :]))
        results = sorted((float(dist), name) for name, dist in zip(self._names, d))
        return results

    @staticmethod
    def chi2_distance(a, b, eps=1e-10) -> float:
        return float(chi2_distance(jnp.asarray(a), jnp.asarray(b), eps))
