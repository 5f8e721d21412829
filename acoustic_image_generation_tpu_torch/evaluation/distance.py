"""Chunked squared-Euclidean nearest neighbours for the latent-space
evaluations (``knn.py``, ``retrieve.py``).

Counterpart of ``acoustic_image_generation_tpu/evaluation/distance.py``:
each block of ``chunk`` query rows gets its squared distances to the whole
gallery, ``|q|^2 - 2 q.g + |g|^2`` in f32 as JAX's numpy computes them:
the squared norms in numpy on the host (its pairwise sums, so they are
JAX's to the bit), the products and the sums as torch on ``device``
(``cuda`` unless the caller passes ``cpu``) with TF32 off. A stable sort of each row keeps JAX's tie-break (the lowest gallery
index first), and one copy per block brings the first ``k`` indices to the
host.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from acoustic_image_generation_tpu_torch import resolve_device
from acoustic_image_generation_tpu_torch.train.generation import no_tf32


def as_feature_matrix(x) -> np.ndarray:
    return np.reshape(np.asarray(x), (len(x), -1)).astype(np.float32)


def iter_nearest(queries: np.ndarray, gallery: np.ndarray, k: int, chunk: int,
                 device="cuda") -> Iterator[tuple[int, np.ndarray]]:
    """Yield ``(row_offset, idx)``: ``idx[i]`` the gallery indices of query
    ``row_offset + i`` in increasing squared distance (ties by index), the
    first ``k`` of them."""
    device = resolve_device(device)
    upload = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    gal = upload(gallery)
    gal_sq = upload(np.sum(gallery**2, 1))[None, :]
    for lo in range(0, len(queries), chunk):
        q = queries[lo:lo + chunk]
        q_sq, q = upload(np.sum(q**2, 1)), upload(q)
        with no_tf32():
            d = q_sq[:, None] - 2.0 * (q @ gal.T) + gal_sq
        yield lo, torch.sort(d, dim=1, stable=True).indices[:, :k].cpu().numpy()
