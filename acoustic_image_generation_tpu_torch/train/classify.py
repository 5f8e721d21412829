"""The classification tasks: DualCamNet on real, tiled-MFCC or generated
acoustic images, and the audio-visual correspondence task.

Counterparts of ``acoustic_image_generation_tpu/train/classify.py``:

- ``ClassificationTask``: DualCamNet over the real acoustic images, or the
  tiled MFCC map with ``mfccmap``; softmax cross-entropy over the clip
  logits (each clip's frame logits averaged); clip labels from every
  ``num_frames``-th frame's action. The best epoch is the one of the
  highest validation ``accuracy`` (``eval_mode = "max"``).
- ``GeneratedClassificationTask``: DualCamNet on the images that a frozen
  generation task (ResNet50 trunk and UNetAcResNet, eval mode, under
  ``no_grad``) makes from the MFCC and the video. Only ``dualcamnet``
  trains: the generator's and the trunk's parameters require no grad and
  get no Adam slots (JAX: ``optax.multi_transform`` with ``set_to_zero``
  under ``param_labels``). JAX's trainer builds no int8 trunk for this task
  (it reads ``trunk_quant`` off the task, which has none), and neither does
  the port's: the trunk is the compute-dtype eval trunk.
- ``CorrespondenceTask``: DualCamNet with 2 classes over the batch that the
  trainer's correspondence augmentation doubled; the labels are the
  augmentation's.

The parameters are f32 masters on one device, computing in the compute
dtype; they come from ``init_params(seed)`` or ``bridge.load_flax``
(``{"dualcamnet": ...}``, plus ``"resnet"`` and ``"generator"`` for the
generated task).

On more than one rank (``parallel/mesh.py``) each rank holds its clips of
the global batch (doubled on the rank by the correspondence augmentation):
the cross-entropy and the accuracy are rank means over equal clips, which
the trainer averages, and ``evaluate`` sums the per-clip terms and counts
over the ranks. The generated task's VAE noise is drawn at the global frame
count and cut to the rank's rows (``global_noise``). Under tensor
parallelism the generated task's frozen trunk holds its wide convs' blocks
of output channels on each rank of a model group (``split_modules``); the
other two tasks split nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch import FRAMES_PER_SECOND, resolve_device
from acoustic_image_generation_tpu_torch.data.preprocess import Batch, tile_mfccmap
from acoustic_image_generation_tpu_torch.losses.classify import (
    accuracy,
    correct,
    per_example_cross_entropy,
    softmax_cross_entropy,
)
from acoustic_image_generation_tpu_torch.models.dualcamnet import DualCamNet, clip_logits
from acoustic_image_generation_tpu_torch.models.layers import init_modules
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ClassifyConfig:
    """The fields of the JAX ``ExperimentConfig`` that the classification
    tasks and their train step read: ``data.num_classes`` and
    ``data.num_channels`` (by ``data.datatype``), ``data.sample_length``,
    ``data.correspondence``, ``data.correspondence_video``,
    ``model.mfccmap``, ``parallel.compute_dtype``, ``optim.learning_rate``
    and ``run.seed``; ``generation`` is the frozen generation task's
    configuration (the generated task only)."""

    num_classes: int = 10
    num_channels: int = 12
    sample_length: int = 1  # seconds a clip: DualCamNet sees 12 * sample_length frames
    mfccmap: bool = False
    datatype: str = "outdoor"
    correspondence: bool = False
    correspondence_video: bool = False
    compute_dtype: str = "bfloat16"
    learning_rate: float = 1e-4
    seed: int = 0
    generation: GenerationConfig | None = None


class ClassificationTask(nn.Module):
    eval_metric = "accuracy"
    eval_mode = "max"
    reads_video = False  # no input of DualCamNet's: the trainer's batches skip it

    def __init__(self, config: ClassifyConfig = ClassifyConfig(), *, device=None):
        super().__init__()
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute dtype {config.compute_dtype!r}")
        self.cfg = config
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.compute_dtype]
        self.num_frames = FRAMES_PER_SECOND * config.sample_length
        self.dualcamnet = DualCamNet(self._num_outputs(), self.num_frames, config.num_channels,
                                     device=self.device, dtype=self.dtype)

    def _num_outputs(self) -> int:
        return self.cfg.num_classes

    @property
    def reads_mfcc(self) -> bool:
        """Only the tiled MFCC map reads the MFCC: without ``mfccmap`` the
        trainer's batches skip the frontend (JAX's jit drops it too)."""
        return self.cfg.mfccmap

    def init_params(self, seed: int) -> "ClassificationTask":
        """Random weights with the JAX initializers' distributions, drawn
        from a CPU generator seeded with ``seed``."""
        init_modules(self, seed)
        return self

    def trained_modules(self) -> tuple[nn.Module, ...]:
        """The modules whose parameters train (FSDP shards each):
        DualCamNet."""
        return (self.dualcamnet,)

    def split_modules(self) -> tuple[nn.Module, ...]:
        """Under tensor parallelism (``parallel/mesh.py``): none. JAX's
        ``tp_sharding`` splits no kernel of DualCamNet (12 to 128 channels,
        a 5-D temporal conv), so the grid only decides which ranks share
        rows."""
        return ()

    def global_noise(self, frames: int, generator: torch.Generator, *, train: bool = True) -> torch.Tensor | None:
        """None: DualCamNet on real or tiled-MFCC images draws nothing."""
        return None

    def inputs(self, batch: Batch) -> torch.Tensor:
        if self.cfg.mfccmap:
            return tile_mfccmap(batch.mfcc)
        return batch.acoustic

    def labels(self, batch: Batch) -> torch.Tensor:
        """(clips, num_classes) one-hot f32 from every ``num_frames``-th
        frame's action (the frames of a clip share it)."""
        return F.one_hot(batch.action[:: self.num_frames].long(), self.cfg.num_classes).float()

    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """(N*F, 36, 48, C) -> the (N, K) clip logits in f32."""
        return clip_logits(self.dualcamnet(images).float(), self.num_frames)

    def _images(self, batch: Batch, eps=None, generator=None) -> torch.Tensor:
        del eps, generator
        return self.inputs(batch)

    def loss(self, batch: Batch, *, eps=None, generator=None, **unused):
        """``(cross-entropy, {"loss", "cross_loss", "accuracy"})`` in f32.
        ``eps`` and ``generator`` are the generated task's VAE noise; the
        other keyword arguments (the generation task's) mean nothing here."""
        logits = self.logits(self._images(batch, eps, generator))
        labels = self.labels(batch)
        ce = softmax_cross_entropy(labels, logits)
        return ce, {"loss": ce, "cross_loss": ce, "accuracy": accuracy(logits, labels).detach()}

    def forward(self, batch: Batch, **kw):
        """``loss``: the train step's forward, through which
        ``DistributedDataParallel`` wraps the task on more than one rank."""
        return self.loss(batch, **kw)

    def eval_losses(self, batch: Batch, *, eps=None, generator=None, **unused):
        """Per-clip ``({"cross_loss": (N,), "accuracy": (N,) 0/1}, logits
        (N, K))``, f32."""
        logits = self.logits(self._images(batch, eps, generator))
        labels = self.labels(batch)
        return {"cross_loss": per_example_cross_entropy(labels, logits),
                "accuracy": correct(logits, labels)}, logits


class GeneratedClassificationTask(ClassificationTask):
    """DualCamNet trained on the output of a frozen generation task."""

    reads_mfcc = True
    reads_video = True

    def __init__(self, config: ClassifyConfig = ClassifyConfig(), *, device=None):
        super().__init__(config, device=device)
        if config.generation is None:
            raise ValueError("the generated task needs config.generation, its generator's configuration")
        generation = GenerationTask(config.generation, device=self.device)
        # the generation task's modules sit at the top of this task, under
        # JAX's keys ("resnet", "generator"); the task object itself is kept
        # out of the module tree so that nothing is registered twice
        self.__dict__["generation"] = generation
        self.resnet = generation.resnet
        self.generator = generation.generator
        for name, p in self.named_parameters():
            p.requires_grad_(name.split(".")[0] == "dualcamnet")

    def param_labels(self) -> dict[str, str]:
        """"train" for DualCamNet's parameters, "frozen" for the rest (JAX's
        ``param_labels``)."""
        return {name: "train" if name.split(".")[0] == "dualcamnet" else "frozen"
                for name, _ in self.named_parameters()}

    def split_modules(self) -> tuple[nn.Module, ...]:
        """The frozen generation task's trunk, under JAX's top-level key:
        its convs of 256 to 2048 outputs are split as the generation
        task's are, and run forward only, in eval mode."""
        return (self.resnet,)

    def global_noise(self, frames: int, generator: torch.Generator, *, train: bool = True) -> torch.Tensor | None:
        """The frozen generator's VAE noise for a global batch of ``frames``
        frames, as one device draws it."""
        return self.generation.global_noise(frames, generator)

    def _images(self, batch: Batch, eps=None, generator=None) -> torch.Tensor:
        """The generator's images (N*F, 36, 48, 12) f32: eval-mode trunk and
        generator under ``no_grad``, the VAE noise from ``eps`` or
        ``generator``."""
        with torch.no_grad():
            return self.generation.generate(batch.mfcc, batch.video, eps=eps, generator=generator)


class CorrespondenceTask(ClassificationTask):
    """DualCamNet with 2 classes over the correspondence-augmented batch:
    label 1 for the real (corresponding) half, 0 for the other. A padded
    eval batch's real rows are a prefix of each half; the trainer masks
    per half."""

    def __init__(self, config: ClassifyConfig = ClassifyConfig(), *, device=None):
        if not config.correspondence:
            raise ValueError("the correspondence task needs config.correspondence")
        super().__init__(config, device=device)

    def _num_outputs(self) -> int:
        return 2

    def labels(self, batch: Batch) -> torch.Tensor:
        if batch.correspondence is None:
            raise ValueError("the correspondence task needs the augmented batch's labels")
        return batch.correspondence[:: self.num_frames]
