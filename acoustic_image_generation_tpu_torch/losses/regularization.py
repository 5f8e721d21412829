"""Weight decay as an explicit loss term.

Counterpart of ``acoustic_image_generation_tpu/losses/regularization.py``:
TF's ``l2_regularizer(scale)`` adds ``scale * sum(w^2) / 2`` per kernel
(biases and BN scales carry none), which ``tf.losses.get_total_loss()``
folds into the objective. The caller passes the kernels. A kernel split
over the model group (``parallel/mesh.py``) adds its block's squares, and
the peers' partial sums are added up (``mesh.model_sum``).
"""

from __future__ import annotations

from collections.abc import Iterable

import torch

from acoustic_image_generation_tpu_torch.parallel import mesh


def l2_regularization(kernels: Iterable[torch.Tensor], scale: float) -> torch.Tensor:
    """0.5 * scale * sum of squared kernel entries, in f32."""
    kernels = list(kernels)
    if scale == 0.0 or not kernels:
        return torch.zeros((), dtype=torch.float32)
    square = lambda k: torch.sum(torch.square(k.float()))
    total = sum(square(k) for k in kernels if mesh.tp_dim(k) is None)
    split = [square(k) for k in kernels if mesh.tp_dim(k) is not None]
    if split:
        total = total + mesh.model_sum(sum(split))
    return 0.5 * scale * total
