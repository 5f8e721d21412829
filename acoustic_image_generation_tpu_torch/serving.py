"""The generation serving path: raw frames -> generated acoustic image and
its energy map.

Counterpart of the JAX CLI's ``tools generate`` step (``cmd_generate._serve``
in ``cli/tools.py``): device preprocessing (MFCC frontend, video
normalization), ``GenerationTask.generate`` and ``find_logen``, for one
batch of frames per call, on the task's device.

With ``trunk_quant="int8"`` the service runs the int8 trunk: a
``QuantTrunk`` given to it, or one it folds, quantizes and calibrates once,
from the normalized frames of its first request, as ``cmd_generate`` does
from its first batch.
"""

from __future__ import annotations

import numpy as np
import torch

from acoustic_image_generation_tpu_torch import NUM_SAMPLES_PER_FRAME, VIDEO_H, VIDEO_W
from acoustic_image_generation_tpu_torch.data.preprocess import preprocess_batch
from acoustic_image_generation_tpu_torch.dsp.energy import find_logen
from acoustic_image_generation_tpu_torch.models.quant import QuantTrunk
from acoustic_image_generation_tpu_torch.train.generation import GenerationTask, no_tf32


def _as_tensor(a, dtype: torch.dtype, shape_tail: tuple, what: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a numpy array or a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 + len(shape_tail) or tuple(t.shape[1:]) != shape_tail:
        raise ValueError(f"{what} must be (N, {', '.join(map(str, shape_tail))}), got {tuple(t.shape)}")
    return t.to(device, non_blocking=True)


class GenerationService:
    """Holds a ``GenerationTask`` and its weights on one device and answers
    raw requests. ``qtrunk``: a calibrated ``QuantTrunk`` for a task with
    ``trunk_quant="int8"``; without one, the first request calibrates it."""

    def __init__(self, task: GenerationTask, qtrunk: QuantTrunk | None = None):
        if qtrunk is not None and task.cfg.trunk_quant != "int8":
            raise ValueError('a QuantTrunk serves only a task with trunk_quant="int8"')
        self.task = task.eval()
        self.device = task.device
        self.qtrunk = qtrunk

    def __call__(self, audio, video, seed: int, *, eps=None):
        """``audio`` int32 (N,1024), ``video`` uint8 (N,224,298,3) BGR ->
        (generated (N,36,48,12) float32, energy (N,36,48) float32).

        The VAE noise is drawn from a generator on the task's device seeded
        with ``seed``, unless ``eps`` (N,150) is given. float32 work runs
        without TF32."""
        audio = _as_tensor(audio, torch.int32, (NUM_SAMPLES_PER_FRAME,), "audio", self.device)
        video = _as_tensor(video, torch.uint8, (VIDEO_H, VIDEO_W, 3), "video", self.device)
        if audio.shape[0] != video.shape[0]:
            raise ValueError(f"{audio.shape[0]} audio frames but {video.shape[0]} video frames")
        with torch.inference_mode(), no_tf32():
            batch = preprocess_batch(audio, video)
            if self.task.cfg.trunk_quant == "int8" and self.qtrunk is None:
                self.qtrunk = self.task.build_qtrunk(batch.video)
            generator = None
            if eps is None:
                generator = torch.Generator(device=self.device).manual_seed(seed)
            else:
                eps = torch.as_tensor(eps, device=self.device)
            gen = self.task.generate(batch.mfcc, batch.video, eps=eps, generator=generator,
                                     qtrunk=self.qtrunk)
            return gen, find_logen(gen)
