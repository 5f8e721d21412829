"""The device steps of the qualitative renders, and the per-frame overlay
video.

Counterpart of ``acoustic_image_generation_tpu/evaluation/show_video.py``
(and of ``tools show``'s forward): the device work of a render is a
function of its own, apart from the matplotlib figure, so that it runs
where matplotlib is not installed.

- ``show_step``: preprocess a batch, run the generator in eval mode, and the
  above-mean energy masks of the real and the generated images.
- ``video_overlay_step``: the same forward, ``find_logen`` of the generated
  images and its bilinear resize to the 224x298 frame (half-pixel centers,
  as ``jax.image.resize`` enlarges).
- ``render_video_overlays``: every frame of a loader, the grayscale frame
  with the jet-coloured energy alpha-blended, saved as ``I_{n:06d}.png``.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.dsp.energy import find_logen
from acoustic_image_generation_tpu_torch.evaluation.iou import energy_mask
from acoustic_image_generation_tpu_torch.train.trainer import as_raw, prepare, step_generator


def _forward(task, raw: dict, eps, generator):
    """Preprocessed batch and generated images (N,36,48,12) f32; ``eps``
    (N,150) on any device, or ``generator``'s draw."""
    batch = prepare(raw, task.device)
    eps = None if eps is None else torch.as_tensor(eps, device=task.device)
    return batch, task.generate(batch.mfcc, batch.video, eps=eps, generator=generator)


def show_step(task, raw: dict, *, eps=None, generator=None) -> dict:
    """``tools show``'s device step on a raw batch (clips of frames): numpy
    ``real`` and ``generated`` (N,36,48,12), ``video`` (N,224,298,3) in [0,
    1], and the boolean ``real_mask`` and ``generated_mask`` (N,36,48)."""
    with torch.no_grad():
        batch, gen = _forward(task, raw, eps, generator)
        out = dict(real=batch.acoustic, generated=gen, video=batch.video, real_mask=energy_mask(batch.acoustic),
                   generated_mask=energy_mask(gen))
        return {k: v.cpu().numpy() for k, v in out.items()}


def video_overlay_step(task, raw: dict, *, eps=None, generator=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``render_video_overlays``'s device step on a raw batch: the frames
    (N,224,298,3) in [0, 1] and the generated energy maps resized to them,
    (N,224,298) f32, both on the task's device."""
    with torch.no_grad():
        batch, gen = _forward(task, raw, eps, generator)
        emap = find_logen(gen)
        h, w = batch.video.shape[1:3]
        emap = F.interpolate(emap[:, None], size=(h, w), mode="bilinear", align_corners=False, antialias=False)
        return batch.video, emap[:, 0]


def render_video_overlays(task, loader, out_dir: str, *, alpha: float = 0.7, seed: int = 0) -> list[str]:
    """Render every valid frame the loader yields, batch ``i`` with the noise
    of ``step_generator(seed, i)``; returns the written paths, numbered from
    ``I_000001.png``."""
    from acoustic_image_generation_tpu_torch.evaluation.overlay import _pyplot

    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, raw_batch in enumerate(loader.batches(0)):
        video, emap = video_overlay_step(task, as_raw(raw_batch), generator=step_generator(seed, i, task.device))
        n = raw_batch.valid * raw_batch.frames
        for frame, m in zip(video[:n].cpu().numpy(), emap[:n].cpu().numpy()):
            h, w = frame.shape[:2]
            fig, ax = plt.subplots(figsize=(w / 100, h / 100), dpi=100)
            ax.imshow(frame.mean(axis=-1), cmap="gray")
            ax.imshow(m, cmap="jet", alpha=alpha)
            ax.axis("off")
            fig.subplots_adjust(0, 0, 1, 1)
            path = os.path.join(out_dir, f"I_{len(paths) + 1:06d}.png")
            fig.savefig(path)
            plt.close(fig)
            paths.append(path)
    return paths
