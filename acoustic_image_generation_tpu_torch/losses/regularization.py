"""Weight decay as an explicit loss term.

Counterpart of ``acoustic_image_generation_tpu/losses/regularization.py``:
TF's ``l2_regularizer(scale)`` adds ``scale * sum(w^2) / 2`` per kernel
(biases and BN scales carry none), which ``tf.losses.get_total_loss()``
folds into the objective. The caller passes the kernels.
"""

from __future__ import annotations

from collections.abc import Iterable

import torch


def l2_regularization(kernels: Iterable[torch.Tensor], scale: float) -> torch.Tensor:
    """0.5 * scale * sum of squared kernel entries, in f32."""
    kernels = list(kernels)
    if scale == 0.0 or not kernels:
        return torch.zeros((), dtype=torch.float32)
    total = sum(torch.sum(torch.square(k.float())) for k in kernels)
    return 0.5 * scale * total
