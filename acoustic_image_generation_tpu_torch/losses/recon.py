"""Reconstruction and latent losses with TF-1 reduction conventions, in f32.

Counterpart of ``acoustic_image_generation_tpu/losses/recon.py``: MSE and
Huber with mean reduction (``tf.losses``), sigmoid cross-entropy in logit
space, and the per-sample diagonal-Gaussian KL of the reference
(``0.5 * sum(mean^2 + std^2 - log(eps + std^2) - 1)``), which callers
reduce and weight themselves.
"""

from __future__ import annotations

import torch


def mse_tf(labels: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
    """``tf.losses.mean_squared_error``: mean over all elements."""
    return torch.mean(torch.square(predictions.float() - labels.float()))


def huber_tf(labels: torch.Tensor, predictions: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """``tf.losses.huber_loss`` with unit weights: elementwise Huber, mean."""
    abs_err = torch.abs(predictions.float() - labels.float())
    quadratic = torch.clamp_max(abs_err, delta)
    linear = abs_err - quadratic
    return torch.mean(0.5 * quadratic**2 + delta * linear)


def sigmoid_ce_logits(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``tf.nn.sigmoid_cross_entropy_with_logits``, mean reduction, computed
    stably in logit space: ``max(l, 0) - l*t + log1p(exp(-|l|))``."""
    l = logits.float()
    t = labels.float()
    return torch.mean(torch.clamp_min(l, 0.0) - l * t + torch.log1p(torch.exp(-torch.abs(l))))


def kl_diag_gaussian(mean: torch.Tensor, std: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-sample KL(N(mean, std) || N(0, 1)), shape (batch,)."""
    m = mean.float()
    s = std.float()
    return 0.5 * torch.sum(torch.square(m) + torch.square(s) - torch.log(eps + torch.square(s)) - 1.0, dim=1)
