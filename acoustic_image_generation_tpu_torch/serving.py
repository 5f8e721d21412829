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

With ``spatial_devices`` (a list of ``n`` devices, the first the task's;
one device may repeat) ``GenerationService`` splits a request's video rows
over them (``parallel/spatial.py``, JAX's ``spatial_sharding`` of a
generation artifact with ``spatial_shards = n``): the eval trunk (float or
unfused int8) and ``conv_map`` run on each shard's rows with their halos,
and only ``conv_map``'s output (N,12,16,12) is gathered onto the first
device, where the tiled MFCC map, the generator, the noise and
``find_logen`` run once, as without the split.

``GenerationService.generate``, ``ClassificationService``,
``EmbeddingService`` and ``ProjectionService`` (projection and joint
tasks) answer the model-ready requests of the serving artifacts
(``core/serving.py``), which are built on them.
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
from acoustic_image_generation_tpu_torch.data.preprocess import Batch, preprocess_batch, tile_mfccmap
from acoustic_image_generation_tpu_torch.dsp.energy import find_logen
from acoustic_image_generation_tpu_torch.models.quant import QuantTrunk, trunk_forward_rows
from acoustic_image_generation_tpu_torch.models.resnet import conv_map_rows, trunk_rows
from acoustic_image_generation_tpu_torch.parallel import spatial
from acoustic_image_generation_tpu_torch.train.classify import ClassificationTask
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
    ``trunk_quant="int8"``; without one, the first request calibrates it.
    ``spatial_devices``: split each request's video rows over these devices
    (the first the task's), each holding one copy of the ResNet (and of the
    ``QuantTrunk``); the int8 trunk is then the unfused one."""

    def __init__(self, task: GenerationTask, qtrunk: QuantTrunk | None = None, spatial_devices=None):
        if qtrunk is not None and task.cfg.trunk_quant != "int8":
            raise ValueError('a QuantTrunk serves only a task with trunk_quant="int8"')
        self.task = task.eval()
        self.device = task.device
        self.qtrunk = qtrunk
        self.spatial_devices = None
        if spatial_devices is not None:
            if task.cfg.fused_qgemm:
                raise ValueError("the spatially split int8 trunk is the unfused one: serve without fused_qgemm")
            spatial.check_shards(len(spatial_devices))
            self.spatial_devices = [spatial.as_device(d) for d in spatial_devices]
            if self.spatial_devices[0] != spatial.as_device(self.device):
                raise ValueError(f"the first spatial device must be the task's, {self.device}; got "
                                 f"{self.spatial_devices[0]}")
            self._resnets = spatial.replicas(task.resnet, self.spatial_devices)
            self._qtrunks = None

    def _spatial_feature(self, video: torch.Tensor) -> torch.Tensor:
        """``conv_map``'s output (N,12,16,12) on the task's device, from the
        video's rows split over the spatial devices."""
        rows = spatial.Rows.split(video, self.spatial_devices)
        if self.qtrunk is not None:
            if self._qtrunks is None:
                self._qtrunks = spatial.replicas(self.qtrunk, self.spatial_devices)
            feat = trunk_forward_rows(self._qtrunks, rows, out_dtype=self.task.dtype)
        else:
            feat = trunk_rows(self._resnets, rows)
        return conv_map_rows(self._resnets, feat).gather(self.device)

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
            return self.generate(batch.mfcc, batch.video, seed, eps=eps)

    def generate(self, mfcc, video, seed: int = 0, *, eps=None, generator=None, energy: bool = True):
        """Model-ready inputs, the serving artifact's (``core/serving.py``):
        float32 ``mfcc`` (N,12) and ``video`` (N,224,298,3) in [0, 1] ->
        (generated (N,36,48,12) float32, energy (N,36,48) float32, or None
        without ``energy``). The noise is ``eps``, else ``generator``'s,
        else a generator's on the task's device seeded with ``seed``."""
        f32 = torch.float32
        mfcc = _as_tensor(mfcc, f32, (12,), "mfcc", self.device)
        video = _as_tensor(video, f32, (VIDEO_H, VIDEO_W, 3), "video", self.device)
        if mfcc.shape[0] != video.shape[0]:
            raise ValueError(f"{mfcc.shape[0]} mfcc frames but {video.shape[0]} video frames")
        with torch.inference_mode(), no_tf32():
            if self.task.cfg.trunk_quant == "int8" and self.qtrunk is None:
                self.qtrunk = self.task.build_qtrunk(video)
            if eps is not None:
                eps, generator = torch.as_tensor(eps, device=self.device), None
            elif generator is None:
                generator = torch.Generator(device=self.device).manual_seed(seed)
            map_feat = None if self.spatial_devices is None else self._spatial_feature(video)
            gen = self.task.generate(mfcc, video, eps=eps, generator=generator, qtrunk=self.qtrunk,
                                     map_feat=map_feat)
            return gen, find_logen(gen) if energy else None


class ClassificationService:
    """Holds a classification task (DualCamNet) on one device and answers
    requests of whole clips: the ``serve`` function of ``core/serving.py::
    export_classification``."""

    def __init__(self, task: ClassificationTask):
        self.task = task.eval()
        self.device = task.device

    def __call__(self, inputs) -> torch.Tensor:
        """float32 per-frame acoustic images (N*F,36,48,C), or MFCC vectors
        (N*F,12) with ``mfccmap`` (tiled to the map here), F the task's
        frames a clip -> clip logits (N, K) float32."""
        c = self.task.cfg.num_channels
        tail = (12,) if self.task.cfg.mfccmap else (SPATIAL_H, SPATIAL_W, c)
        x = _as_tensor(inputs, torch.float32, tail, "inputs", self.device)
        frames = self.task.num_frames
        if x.shape[0] == 0 or x.shape[0] % frames:
            raise ValueError(f"a request is whole clips of {frames} frames, got {x.shape[0]} frames")
        with torch.inference_mode(), no_tf32():
            return self.task.logits(tile_mfccmap(x) if self.task.cfg.mfccmap else x)


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


class ProjectionService:
    """Holds a ``ProjectTask`` or a ``JointTask`` on one device and answers
    requests of whole seconds: acoustic images from audio and video alone,
    the ``serve`` functions of ``core/serving.py::export_projection`` and
    ``export_joint`` (the tasks' ``project``)."""

    def __init__(self, task):
        self.task = task.eval()
        self.device = task.device

    def __call__(self, audio, video, seed: int = 0, *, eps=None):
        """float32 ``audio`` (N,1024) samples and ``video`` (N,224,298,3) in
        [0, 1], N a multiple of 12 -> generated acoustic images (N/12,36,48,C)
        float32. The noise is ``eps`` (N/12, 150), else a generator's on the
        task's device seeded with ``seed``."""
        f32 = torch.float32
        audio = _as_tensor(audio, f32, (NUM_SAMPLES_PER_FRAME,), "audio", self.device)
        video = _as_tensor(video, f32, (VIDEO_H, VIDEO_W, 3), "video", self.device)
        n = audio.shape[0]
        if video.shape[0] != n:
            raise ValueError(f"{n} audio and {video.shape[0]} video frames")
        if n == 0 or n % FRAMES_PER_SECOND:
            raise ValueError(f"a request is whole seconds of {FRAMES_PER_SECOND} frames, got {n} frames")
        with torch.inference_mode(), no_tf32():
            batch = Batch(audio=audio.contiguous(), mfcc=None, video=video)
            generator = None
            if eps is not None:
                eps = torch.as_tensor(eps, dtype=f32, device=self.device)
            else:
                generator = torch.Generator(device=self.device).manual_seed(seed)
            return self.task.project(batch, eps=eps, generator=generator)
