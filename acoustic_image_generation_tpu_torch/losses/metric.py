"""Cross-modal metric losses: batch-hard triplet, all-triplets, NCA, in f32.

Counterpart of ``acoustic_image_generation_tpu/losses/metric.py``, with
the reference's quirks kept, since the metric losses were trained with
them:

- ``pairwise_sq_distances`` broadcasts the squared norms against the
  unmatched axes of the cross product, so only the diagonal is a true pair
  distance;
- ``nca_loss`` shifts and scales the distance matrix by per-row min and max
  broadcast over rows, i.e. per column.

Maxima and minima are ``amax``/``amin`` and clamps at 0 ``torch.maximum``, so
that ties share the gradient as they do in JAX.
"""

from __future__ import annotations

import torch


def _relu_tied(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``: at x == 0 half the gradient passes."""
    return torch.maximum(x, torch.zeros_like(x))


def pairwise_sq_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``dist[i, j] = ||a_j||^2 - 2 a_i.b_j + ||b_i||^2``, clamped at 0."""
    a = a.float()
    b = b.float()
    sq_a = torch.sum(a * a, dim=1)
    sq_b = torch.sum(b * b, dim=1)
    d = sq_a[None, :] - 2.0 * (a @ b.T) + sq_b[:, None]
    return _relu_tied(d)


def positive_negative_masks(labels: torch.Tensor, scenario: torch.Tensor):
    """(positive, negative) boolean masks: positive = same label and same
    scenario (self-pairs included), negative = either differs."""
    labels_eq = labels[None, :] == labels[:, None]
    scen_eq = scenario[None, :] == scenario[:, None]
    pos = labels_eq & scen_eq
    return pos, ~pos


def _triplet_mask(labels, scenario) -> torch.Tensor:
    """mask[a, p, n]: (a, p) positive and (a, n) not."""
    same, _ = positive_negative_masks(labels, scenario)
    return same[:, :, None] & ~same[:, None, :]


def triplet_hard(z0, z1, labels, scenario, margin: float):
    """Batch-hard triplet loss: ``(loss, fraction of positive triplets)``."""
    dist = pairwise_sq_distances(z0, z1)
    pos, neg = positive_negative_masks(labels, scenario)
    pos_f, neg_f = pos.float(), neg.float()
    hardest_pos = torch.amax(pos_f * dist, dim=1, keepdim=True)
    max_dist = torch.amax(dist, dim=1, keepdim=True)
    hardest_neg = torch.amin(dist + max_dist * (1.0 - neg_f), dim=1, keepdim=True)
    tl = _relu_tied(hardest_pos - hardest_neg + margin)
    num_positive = torch.sum((tl > 1e-16).float())
    num_valid = torch.sum(_triplet_mask(labels, scenario).float())
    return torch.mean(tl), num_positive / (num_valid + 1e-16)


def triplet_all(z0, z1, labels, scenario, margin: float):
    """All-valid-triplets loss: ``(loss, fraction of positive triplets)``."""
    dist = pairwise_sq_distances(z0, z1)
    tl = dist[:, :, None] - dist[:, None, :] + margin
    mask = _triplet_mask(labels, scenario).float()
    tl = _relu_tied(mask * tl)
    num_positive = torch.sum((tl > 1e-16).float())
    frac = num_positive / (torch.sum(mask) + 1e-16)
    return torch.sum(tl) / (num_positive + 1e-16), frac


def nca_loss(z0, z1, labels, scenario) -> torch.Tensor:
    """NCA-style loss: the distance matrix min-max normalized (per column,
    the reference's broadcast), hardest positive + log(sum exp(-negative
    distances))."""
    dist = pairwise_sq_distances(z0, z1)
    dist = dist - torch.amin(dist, dim=1)
    dist = dist / torch.amax(dist, dim=1)
    pos, neg = positive_negative_masks(labels, scenario)
    hardest_pos = torch.amax(pos.float() * dist, dim=1, keepdim=True)
    sum_neg = torch.sum(torch.exp(-(neg.float() * dist)), dim=1, keepdim=True)
    return torch.mean(hardest_pos + torch.log(1e-15 + sum_neg))
