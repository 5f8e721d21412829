"""Localization evaluation: energy-mask IoU, the threshold sweep and its
AUC (``iou.py``), and the sweep over a loader (``localize.py``); the
real-vs-generated DualCamNet accuracy (``real_vs_generated.py``)."""

from acoustic_image_generation_tpu_torch.evaluation.iou import (
    box_weighted_iou,
    energy_mask,
    iou_real_vs_generated,
    localization_auc,
    threshold_fractions,
)

__all__ = ["box_weighted_iou", "energy_mask", "iou_real_vs_generated", "localization_auc", "threshold_fractions"]
