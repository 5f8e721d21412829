"""The serving paths.

``GenerationService``, the generation path: raw frames -> generated
acoustic image and its energy map.

Counterpart of the JAX CLI's ``tools generate`` step (``cmd_generate._serve``
in ``cli/tools.py``): device preprocessing (MFCC frontend, video
normalization), ``GenerationTask.generate`` and ``find_logen``, for one
batch of frames per call, on the task's device.

With ``trunk_quant="int8"`` the service runs the int8 trunk: a
``QuantTrunk`` given to it, or one it folds, quantizes and calibrates once,
from the normalized frames of its first request, as ``cmd_generate`` does
from its first batch.

``EmbeddingService``, the embedding path: model-ready acoustic frames,
audio samples and video frames -> three aligned per-second latents, the
counterpart of the ``serve`` function that ``core/serving.py::
export_embedding`` exports. It runs only the three encoders and VAE heads
(``EmbedTask.encode``): the decoders do not feed the latents, and XLA drops
them from JAX's jitted ``embeddings``, so the numbers are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from acoustic_image_generation_tpu_torch import (
    FRAMES_PER_SECOND,
    NUM_SAMPLES_PER_FRAME,
    SPATIAL_H,
    SPATIAL_W,
    VIDEO_H,
    VIDEO_W,
)
from acoustic_image_generation_tpu_torch.data.preprocess import Batch, preprocess_batch
from acoustic_image_generation_tpu_torch.dsp.energy import find_logen
from acoustic_image_generation_tpu_torch.models.quant import QuantTrunk
from acoustic_image_generation_tpu_torch.train.embed import EmbedTask
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


class EmbeddingService:
    """Holds an ``EmbedTask`` and its weights on one device and answers
    requests of whole seconds."""

    def __init__(self, task: EmbedTask):
        self.task = task.eval()
        self.device = task.device

    def __call__(self, acoustic, audio, video, seed: int, *, use_mean: bool = False, eps=None):
        """float32 ``acoustic`` (N,36,48,C) and ``video`` (N,224,298,3) in
        [0, 1], ``audio`` (N,1024) samples, N a multiple of 12 ->
        (z_acoustic, z_audio, z_video), each (N/12, latent_dim) float32.

        BN runs on its running averages. The latents are the means with
        ``use_mean``, else ``mean + std * eps`` with one ``eps`` (N/12,
        latent_dim) shared by the three: given, or drawn from a generator
        on the task's device seeded with ``seed``. float32 work runs without
        TF32."""
        c = self.task.cfg.num_channels
        f32 = torch.float32
        acoustic = _as_tensor(acoustic, f32, (SPATIAL_H, SPATIAL_W, c), "acoustic", self.device)
        audio = _as_tensor(audio, f32, (NUM_SAMPLES_PER_FRAME,), "audio", self.device)
        video = _as_tensor(video, f32, (VIDEO_H, VIDEO_W, 3), "video", self.device)
        n = acoustic.shape[0]
        if audio.shape[0] != n or video.shape[0] != n:
            raise ValueError(f"{n} acoustic, {audio.shape[0]} audio and {video.shape[0]} video frames")
        if n == 0 or n % FRAMES_PER_SECOND:
            raise ValueError(f"a request is whole seconds of {FRAMES_PER_SECOND} frames, got {n} frames")
        with torch.inference_mode(), no_tf32():
            batch = Batch(audio=audio.contiguous(), mfcc=None, video=video, acoustic=acoustic)
            generator = None
            if eps is not None:
                eps = torch.as_tensor(eps, dtype=f32, device=self.device)
            elif not use_mean:
                generator = torch.Generator(device=self.device).manual_seed(seed)
            z = self.task.embeddings(batch, use_mean=use_mean, eps=eps, generator=generator)
            return z["acoustic"], z["audio"], z["video"]
