"""The single-modality reconstruction task: one VAE on the modality that
``encoder_type`` names.

Counterpart of ``acoustic_image_generation_tpu/train/reconstruct.py::
ReconstructTask`` (``_inputs``, ``init_variables``, ``loss``,
``eval_losses``):

- ``Ac``: ``UNetAcoustic`` (no BN) on each (36,48,C) acoustic frame;
- ``Energy``: ``UNetEnergy`` (no BN) on each frame's channel 0, min-max
  normalized over the frame;
- ``Audio``: the small ``UNetSound`` (BN) on each second's 99x257 STFT
  magnitude (``ops.stft``), not resized;
- ``Video``: ``UNetVideo`` (BN) on each 224x298 video frame.

Loss = MSE + Huber + mean KL / 1e6 + L2 over the model's kernels with the
reference's weight decay per model (``WEIGHT_DECAY``). The BN models run
train-mode BN in a train step (running averages updated in place). The
VAE samples in the train step and in evaluation alike, as JAX's does
whenever its ``latent`` rng exists: ``eps`` (samples, latent) is given, or
drawn from the step's generator. ``eval_losses`` gives the per-sample MSE:
per frame for ``Ac``, ``Energy`` and ``Video``, per second for ``Audio``.
The parameter tree is JAX's ``{"model": ...}``; every parameter trains.

On more than one rank (``parallel/mesh.py``) each rank holds its samples
of the global batch: the BN models' train-mode statistics cover the
global batch (``models/layers.py``), and the VAE noise is the global
batch's draw (``global_noise``, drawn by the trainer), cut to the rank's
rows, as JAX's one program over its ``data`` mesh draws it. The loss terms
are rank means over equal rows, which the trainer averages. Under tensor
parallelism the rows are the data rank's (``split_modules``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from acoustic_image_generation_tpu_torch import FRAMES_PER_SECOND, resolve_device
from acoustic_image_generation_tpu_torch.data.preprocess import Batch, minmax_frame
from acoustic_image_generation_tpu_torch.dsp.spectrogram import SAMPLES_PER_SECOND
from acoustic_image_generation_tpu_torch.losses.recon import huber_tf, kl_diag_gaussian, mse_tf
from acoustic_image_generation_tpu_torch.losses.regularization import l2_regularization
from acoustic_image_generation_tpu_torch.models.blocks import LATENT_DIM
from acoustic_image_generation_tpu_torch.models.layers import init_modules
from acoustic_image_generation_tpu_torch.models.unet_ac import UNetAcoustic
from acoustic_image_generation_tpu_torch.models.unet_sound import UNetSound
from acoustic_image_generation_tpu_torch.models.unet_video import UNetEnergy, UNetVideo
from acoustic_image_generation_tpu_torch.ops.stft import stft
from acoustic_image_generation_tpu_torch.train.embed import _DTYPES, EmbedTask

WEIGHT_DECAY = {"Ac": 0.0, "Energy": 1e-6, "Audio": 6e-5, "Video": 7e-5}
LATENTS = {"Ac": LATENT_DIM, "Energy": UNetEnergy.LATENT, "Audio": UNetSound.SMALL_LATENT, "Video": 1024}


@dataclass(frozen=True)
class ReconstructConfig:
    """The fields of the JAX ``ExperimentConfig`` that ``ReconstructTask``
    and its train step read: ``model.encoder_type``, ``data.num_channels``
    (the ``Ac`` model's), ``parallel.compute_dtype``,
    ``optim.learning_rate`` and ``run.seed``, with JAX's defaults."""

    encoder_type: str = "Video"
    num_channels: int = 12
    compute_dtype: str = "bfloat16"
    learning_rate: float = 1e-4
    seed: int = 0


class ReconstructTask(nn.Module):
    reads_mfcc = False  # no model reads it: the trainer's batches skip the frontend
    eval_metric = "mse"
    eval_mode = "min"

    def __init__(self, config: ReconstructConfig = ReconstructConfig(), *, device=None):
        super().__init__()
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute dtype {config.compute_dtype!r}")
        if config.encoder_type not in WEIGHT_DECAY:
            raise ValueError(f"unknown encoder_type {config.encoder_type!r}")
        self.cfg = config
        self.encoder_type = config.encoder_type
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.compute_dtype]
        kw = dict(device=self.device, dtype=self.dtype)
        self.model = {
            "Ac": lambda: UNetAcoustic(config.num_channels, **kw),
            "Energy": lambda: UNetEnergy(**kw),
            "Audio": lambda: UNetSound("small", **kw),
            "Video": lambda: UNetVideo(**kw),
        }[config.encoder_type]()

    @property
    def reads_video(self) -> bool:
        """Only the video VAE reads the video: the other models' batches skip
        it (JAX's jit drops it too)."""
        return self.encoder_type == "Video"

    def init_params(self, seed: int) -> "ReconstructTask":
        """Random weights with the JAX initializers' distributions, drawn
        from a CPU generator seeded with ``seed``."""
        init_modules(self, seed)
        return self

    def trained_modules(self) -> tuple[nn.Module, ...]:
        """The modules whose parameters train (FSDP shards each): the VAE."""
        return (self.model,)

    def split_modules(self) -> tuple[nn.Module, ...]:
        """The module that holds every kernel JAX's ``tp_sharding`` splits
        under tensor parallelism (``parallel/mesh.py``): the VAE. Only
        ``Video``'s has such kernels (its wide convs and its head's
        1024-channel mean and std); ``Ac``, ``Energy`` and ``Audio`` keep
        every kernel whole, and the grid only sets which ranks share rows."""
        return (self.model,)

    def global_noise(self, frames: int, generator: torch.Generator, *, train: bool = True) -> torch.Tensor:
        """The VAE noise of a global batch of ``frames`` frames (a sample a
        second for ``Audio``, a frame otherwise), as one device's model draws
        it."""
        samples = frames // FRAMES_PER_SECOND if self.encoder_type == "Audio" else frames
        return torch.randn((samples, LATENTS[self.encoder_type]), generator=generator, device=self.device)

    def inputs(self, batch: Batch) -> torch.Tensor:
        """The model's input: (N,36,48,C) acoustic frames, (N,36,48,1)
        energy maps, (S,99,257,1) f32 magnitudes or (N,224,298,3) frames."""
        if self.encoder_type == "Ac":
            return batch.acoustic
        if self.encoder_type == "Energy":
            return minmax_frame(batch.acoustic[..., :1], dims=(-3, -2))
        if self.encoder_type == "Audio":
            return stft(batch.audio.reshape(-1, SAMPLES_PER_SECOND))[..., None]
        return batch.video

    def _forward(self, batch: Batch, *, train: bool, eps, generator):
        x = self.inputs(batch)
        if eps is None and generator is None:
            raise ValueError("the reconstruction VAE samples its latent: pass eps or generator")
        return x, self.model(x, eps=eps, generator=generator, train=train)

    def forward(self, batch: Batch, **kw):
        """``loss``: the train step's forward, through which
        ``DistributedDataParallel`` wraps the task on more than one rank."""
        return self.loss(batch, **kw)

    def loss(self, batch: Batch, *, train: bool = True, eps=None, generator=None, **unused):
        """Forward (train-mode BN in a train step) and objective, ``(total,
        {"loss", "mse", "huber", "latent_loss"})`` in f32. The other
        keyword arguments (the other tasks') mean nothing here."""
        x, out = self._forward(batch, train=train, eps=eps, generator=generator)
        recon = out.output.float()
        mse = mse_tf(x, recon)
        hub = huber_tf(x, recon)
        kl = torch.mean(kl_diag_gaussian(out.mean, out.std)) / 1e6
        reg = l2_regularization(EmbedTask.kernels(self.model), WEIGHT_DECAY[self.encoder_type])
        total = mse + hub + kl + reg
        return total, {"loss": total, "mse": mse, "huber": hub, "latent_loss": kl}

    def eval_losses(self, batch: Batch, *, eps=None, generator=None, **unused):
        """Eval-mode forward, sampled as JAX's is: ``({"mse": (samples,)
        f32}, reconstruction f32)``."""
        x, out = self._forward(batch, train=False, eps=eps, generator=generator)
        recon = out.output.float()
        err = torch.square(recon - x.float())
        return {"mse": torch.mean(err, dim=tuple(range(1, err.dim())))}, recon
