"""The localization sweep: one generator pass over a loader -> per-image
IoU vector -> the fractions above all 11 thresholds, the AUC and the
reference's files.

Counterpart of ``acoustic_image_generation_tpu/evaluation/localize.py``.
Batch ``i``'s VAE noise comes from ``step_generator(seed, i)``, a
``torch.Generator`` seeded from ``(seed, i)`` (JAX folds ``i`` into its
key), so the two packages draw different noise from one seed; with
``ae=True`` there is none.
"""

from __future__ import annotations

import numpy as np
import torch

from acoustic_image_generation_tpu_torch.evaluation import iou as iou_mod
from acoustic_image_generation_tpu_torch.train.trainer import as_raw, prepare, step_generator


def run_iou_sweep(task, loader, run_dir: str | None = None, *, seed: int = 0) -> dict:
    """Real-vs-generated localization IoU of ``task`` (a ``GenerationTask``,
    its weights as they stand) over one pass of ``loader``: ``{"iou": the
    per-image vector, trimmed to each batch's valid frames, "fractions":
    {threshold: fraction}, "auc": float}``; with ``run_dir``, the threshold
    files and ``area.txt`` too."""
    ious = []
    for i, raw_batch in enumerate(loader.batches(0)):
        raw = as_raw(raw_batch)
        with torch.no_grad():
            batch = prepare(raw, task.device)
            generated = task.generate(batch.mfcc, batch.video, generator=step_generator(seed, i, task.device))
            vec = iou_mod.iou_real_vs_generated(batch.acoustic, generated).cpu().numpy()
        clips, frames = raw["acoustic"].shape[:2]
        ious.append(vec[: int(raw.get("valid", clips)) * frames])
    ious = np.concatenate(ious) if ious else np.zeros((0,), np.float32)
    fractions = iou_mod.threshold_fractions(ious)
    auc = iou_mod.localization_auc(fractions)
    if run_dir is not None:
        iou_mod.write_threshold_files(run_dir, fractions)
    return {"iou": ious, "fractions": fractions, "auc": auc}
