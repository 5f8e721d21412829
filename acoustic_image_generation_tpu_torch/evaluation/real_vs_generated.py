"""Real-vs-generated DualCamNet accuracy in one pass.

Counterpart of ``acoustic_image_generation_tpu/evaluation/real_vs_generated.py``:
a trained DualCamNet classifies, for the same clips, the real acoustic
images and the images the frozen generator makes from their MFCC and
video. Generated images that carry the class information score close to
the real ones. Batch ``i``'s VAE noise comes from ``step_generator(seed,
i)``, a ``torch.Generator`` seeded from ``(seed, i)`` (JAX folds ``i`` into
its key), so the two packages draw different noise from one seed; the tests
hand in JAX's (``eps``).
"""

from __future__ import annotations

import torch

from acoustic_image_generation_tpu_torch.losses.classify import correct
from acoustic_image_generation_tpu_torch.train.trainer import as_raw, prepare, step_generator


def real_vs_generated_accuracy(generation_task, classify_task, loader, *, seed: int = 0, eps=None) -> dict:
    """``{"real_accuracy", "generated_accuracy", "n"}`` over one pass of
    ``loader`` (each batch's valid clips): ``generation_task`` (a
    ``GenerationTask``) makes the images, ``classify_task`` (a
    ``ClassificationTask`` on real images; its DualCamNet and clip length)
    scores both. ``eps``: per batch, the (frames, 150) VAE noise to use
    instead of the seeded draws."""
    real_sum = gen_sum = 0.0
    count = 0
    for i, raw_batch in enumerate(loader.batches(0)):
        raw = as_raw(raw_batch)
        noise = None if eps is None else torch.as_tensor(eps[i], dtype=torch.float32, device=generation_task.device)
        with torch.no_grad():
            batch = prepare(raw, generation_task.device)
            generated = generation_task.generate(
                batch.mfcc, batch.video, eps=noise,
                generator=None if noise is not None else step_generator(seed, i, generation_task.device))
            labels = classify_task.labels(batch)
            real_c = correct(classify_task.logits(batch.acoustic), labels)
            gen_c = correct(classify_task.logits(generated), labels)
        valid = int(raw.get("valid", raw["audio"].shape[0]))
        real_sum += float(real_c[:valid].sum())
        gen_sum += float(gen_c[:valid].sum())
        count += valid
    return {"real_accuracy": real_sum / max(count, 1), "generated_accuracy": gen_sum / max(count, 1), "n": count}
