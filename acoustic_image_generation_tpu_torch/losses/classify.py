"""Classification loss and accuracy, in f32: the counterparts of
``acoustic_image_generation_tpu/losses/classify.py``."""

from __future__ import annotations

import torch


def softmax_cross_entropy(labels_onehot: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``tf.nn.softmax_cross_entropy_with_logits``, averaged over the batch."""
    return per_example_cross_entropy(labels_onehot, logits).mean()


def per_example_cross_entropy(labels_onehot: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """-sum(labels * log_softmax(logits)) per row, f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(labels_onehot.float() * logp).sum(dim=-1)


def correct(logits: torch.Tensor, labels_onehot: torch.Tensor) -> torch.Tensor:
    """1.0 where the argmax of the logits is the label's, per row."""
    return (logits.argmax(dim=1) == labels_onehot.argmax(dim=1)).float()


def accuracy(logits: torch.Tensor, labels_onehot: torch.Tensor) -> torch.Tensor:
    """The fraction of rows whose argmax matches the label's."""
    return correct(logits, labels_onehot).mean()
