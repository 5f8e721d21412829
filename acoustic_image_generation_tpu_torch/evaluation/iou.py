"""Sound-source localization metrics: energy-mask IoU, the threshold
sweep, the AUC, and the weighted IoU against annotated boxes.

Counterpart of ``acoustic_image_generation_tpu/evaluation/iou.py``. The
generator runs once per image; every threshold of the sweep reads the same
IoU vector. A mask is the set of pixels of ``find_logen``'s energy map above
the map's mean (below it with ``invert``). ``box_weighted_iou`` upsamples
the (36, 48) mask to the video's (224, 298) bilinearly with half-pixel
centers, which is what ``jax.image.resize(..., "bilinear")`` does when it
enlarges (its antialiasing only acts when it shrinks).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.dsp.energy import find_logen

DEFAULT_THRESHOLDS = np.round(np.arange(0.0, 1.01, 0.1), 1)


def energy_mask(acoustic: torch.Tensor, *, invert: bool = False) -> torch.Tensor:
    """(N,36,48,12) acoustic or generated image -> boolean (N,36,48) mask of
    the above-mean energy. ``invert=True`` selects the below-mean region:
    ``find_logen``'s inversion peaks at the source for MFCC coefficients
    (real dualcam data), while the synthetic data store blob energy as
    channel amplitude, which the inversion turns into a minimum.
    Real-vs-generated IoU is the same either way; the box sweep is not."""
    emap = find_logen(acoustic)
    mean = torch.mean(emap, dim=(-2, -1), keepdim=True)
    return emap < mean if invert else emap > mean


def iou_real_vs_generated(real: torch.Tensor, generated: torch.Tensor) -> torch.Tensor:
    """Per-image IoU of the above-mean energy masks, (N,) float32."""
    m1, m2 = energy_mask(real), energy_mask(generated)
    inter = torch.sum(m1 & m2, dim=(-2, -1)).to(torch.float32)
    union = torch.sum(m1 | m2, dim=(-2, -1)).to(torch.float32)
    return inter / union


def threshold_fractions(ious, thresholds=DEFAULT_THRESHOLDS) -> dict[float, float]:
    """The fraction of images whose IoU is strictly above each threshold:
    the 11 numbers of the ``intersection_{t}_accuracy.txt`` files."""
    ious = np.asarray(ious)
    return {float(t): float(np.mean(ious > t)) for t in thresholds}


def localization_auc(fractions: dict[float, float]) -> float:
    """Trapezoidal area under the (threshold, fraction) curve, in float64
    (numpy's ``trapezoid``)."""
    ts = sorted(fractions)
    xs = np.asarray(ts, dtype=np.float64)
    ys = np.asarray([fractions[t] for t in ts], dtype=np.float64)
    return float((np.diff(xs) * (ys[1:] + ys[:-1]) / 2.0).sum())


def render_box_map(xmin, xmax, ymin, ymax, height: int = 224, width: int = 298) -> torch.Tensor:
    """(N,3) box coordinates -> (N,224,298) weighted map: each box present
    (``xmax != 0``) filled at 0.5 over the closed interval [min, max], the
    boxes summed and clipped at 1."""
    xmin, xmax, ymin, ymax = (torch.as_tensor(v)[:, :, None, None] for v in (xmin, xmax, ymin, ymax))
    ys = torch.arange(height, device=xmin.device)[:, None]
    xs = torch.arange(width, device=xmin.device)[None, :]
    inside = (xs >= xmin) & (xs <= xmax) & (ys >= ymin) & (ys <= ymax) & (xmax != 0)
    return torch.clamp(torch.sum(torch.where(inside, 0.5, 0.0), dim=1), max=1.0).to(torch.float32)


def box_weighted_iou(generated: torch.Tensor, box_map: torch.Tensor, *, invert: bool = False) -> torch.Tensor:
    """Per-image weighted IoU of the generated energy mask against the
    annotated boxes: ``box_map`` (N,224,298) in {0, .5, 1}; the mask
    upsampled bilinearly and held above 0.5; the intersection weighted by
    the box map, the union corrected by the boxes' sub-1 weights."""
    mask = energy_mask(generated, invert=invert).to(torch.float32)
    big = F.interpolate(mask[:, None], size=tuple(box_map.shape[-2:]), mode="bilinear",
                        align_corners=False, antialias=False)[:, 0]
    m2 = big > 0.5
    boxed = box_map > 0
    inter = (boxed & m2).to(torch.float32) * box_map
    union = (boxed | m2).to(torch.float32)
    union_weighted = union + (box_map - boxed.to(torch.float32))
    return torch.sum(inter, dim=(-2, -1)) / torch.sum(union_weighted, dim=(-2, -1))


def write_threshold_files(run_dir: str, fractions: dict[float, float]) -> None:
    """``intersection_{t}_accuracy.txt`` for each threshold and
    ``area.txt`` with the AUC, as the reference's sweep writes them."""
    os.makedirs(run_dir, exist_ok=True)
    for t, frac in fractions.items():
        with open(os.path.join(run_dir, f"intersection_{t}_accuracy.txt"), "w") as f:
            f.write(f"iou {frac:6f}")
    with open(os.path.join(run_dir, "area.txt"), "w") as f:
        f.write(f"{localization_auc(fractions):6f}")
