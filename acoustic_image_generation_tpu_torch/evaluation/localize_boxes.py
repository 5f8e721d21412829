"""The Flickr-SoundNet box-localization sweep: one generator pass over a
box-annotated loader -> the weighted box map of each frame -> the weighted
IoU of each generated energy mask against it -> the fractions above all 11
thresholds, the AUC and the reference's files.

Counterpart of ``acoustic_image_generation_tpu/evaluation/localize_boxes.py``.
Batch ``i``'s VAE noise comes from ``step_generator(seed, i)``, as in
``evaluation/localize.py``; with ``ae=True`` there is none.
"""

from __future__ import annotations

import numpy as np
import torch

from acoustic_image_generation_tpu_torch.evaluation import iou as iou_mod
from acoustic_image_generation_tpu_torch.train.trainer import as_raw, prepare, step_generator

BOX_KEYS = ("xmin", "xmax", "ymin", "ymax")


def run_box_iou_sweep(task, loader, run_dir: str | None = None, *, seed: int = 0, invert: bool = False) -> dict:
    """Weighted box IoU of ``task`` (a ``GenerationTask``, its weights as
    they stand) over one pass of ``loader``, which must yield the boxes
    (``include_boxes=True``): ``{"iou": the per-frame vector, trimmed to
    each batch's valid frames, "fractions": {threshold: fraction}, "auc":
    float}``; with ``run_dir``, the threshold files and ``area.txt`` too.
    ``invert`` takes the below-mean energy as the source region (the
    synthetic benchmark's convention, ``evaluation.iou.energy_mask``)."""
    ious = []
    for i, raw_batch in enumerate(loader.batches(0)):
        if raw_batch.extras is None or "xmax" not in raw_batch.extras:
            raise ValueError("the box sweep needs a loader with include_boxes=True")
        raw = as_raw(raw_batch)
        with torch.no_grad():
            batch = prepare(raw, task.device)
            generated = task.generate(batch.mfcc, batch.video, generator=step_generator(seed, i, task.device))
            boxes = (torch.from_numpy(raw_batch.extras[k].reshape(-1, 3)).to(task.device) for k in BOX_KEYS)
            box_map = iou_mod.render_box_map(*boxes)
            vec = iou_mod.box_weighted_iou(generated, box_map, invert=invert).cpu().numpy()
        ious.append(vec[: raw_batch.valid * raw_batch.frames])
    ious = np.concatenate(ious) if ious else np.zeros((0,), np.float32)
    fractions = iou_mod.threshold_fractions(ious)
    auc = iou_mod.localization_auc(fractions)
    if run_dir is not None:
        iou_mod.write_threshold_files(run_dir, fractions)
    return {"iou": ious, "fractions": fractions, "auc": auc}
