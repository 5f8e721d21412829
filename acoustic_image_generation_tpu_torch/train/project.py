"""The projection task: frozen per-modality VAE latents translated into the
acoustic latent space, and acoustic images decoded from them.

Counterpart of ``acoustic_image_generation_tpu/train/project.py::
ProjectTask`` (``_inputs``, ``init_variables``, ``param_labels``,
``_associate``, ``_forward``, ``loss``, ``embeddings``, ``eval_losses``).
Three wirings, as JAX picks them:

- ``Video`` (``encoder_type="Video"``): the video VAE's (mean, std) ->
  ``assoc_video`` (``LatentAssociator``, ``VIDEO_AC_HIDDEN``);
- ``Audio`` (any other ``encoder_type``): the spectrogram ->
  ``assoc_audio_enc`` (``AssociatorAudioEncoder``, train-mode BN in a train
  step);
- ``fusion``: ``assoc_video`` and ``assoc_audio`` (``AUDIO_AC_HIDDEN``, over
  the audio VAE's latent), their (mean, std) averaged.

The acoustic, video and audio VAEs (JAX's tree holds all three in every
wiring) are frozen and run in eval mode without sampling; only their
encoders and VAE heads run (JAX's jit drops the unread decoders). The
acoustic VAE then decodes from the translated latent
(``UNetAcoustic.forward(external_latent=...)``), and the loss reaches the
associators through its frozen decoder. Loss = acoustic MSE + Huber + mean
KL of the associators' latents / 1e6 + the alignment term: with ``l2`` the
MSE between the acoustic VAE's (mean, std) and the translated ones, else
all-triplets between the acoustic VAE's z and each associator's, all drawn
with one shared noise tensor; + L2 (8e-5) over ``assoc_audio_enc``'s
kernels.

Only the ``assoc*`` modules train (``param_labels``): every other
parameter requires no grad and gets no Adam slot. The noise is ``eps``, a
dict of ``"latent"`` (the decoder's reparameterization) and, without
``l2``, ``"triplet"``, each (seconds, 150); or drawn from the step's
generator in that order. Per second: the first acoustic and video frame
of each second, and the second's STFT magnitude bilinearly resized to
193x257 (the ``Video`` wiring reads no spectrogram and skips the ``stft``;
the ``Audio`` wiring reads no video).

On more than one rank (``parallel/mesh.py``) each rank holds its seconds
of the global batch, and what couples rows covers the global batch, as in
JAX's one program over its ``data`` mesh: the audio encoder associator's
train-mode BN statistics (``models/layers.py``); ``triplet_all`` over
``z_ac``, each associator's sample, the labels and the scenarios, gathered
by ``mesh.all_gather_rows``; the two noise draws, which the trainer draws
at the global shape (``global_noise``) and cuts to the rank's rows. The
reconstruction, KL and ``l2`` terms are rank means over equal rows, which
the trainer averages. Under tensor parallelism the frozen video VAE's wide
convs and the audio VAE's head hold their block of the output channels on
each rank of a model group (``split_modules``); the rows, the gathers of
the triplet and the statistics are the data group's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from acoustic_image_generation_tpu_torch import FRAMES_PER_SECOND, resolve_device
from acoustic_image_generation_tpu_torch.data.preprocess import Batch
from acoustic_image_generation_tpu_torch.dsp.spectrogram import SAMPLES_PER_SECOND, resize_frames
from acoustic_image_generation_tpu_torch.losses.metric import triplet_all
from acoustic_image_generation_tpu_torch.losses.recon import huber_tf, kl_diag_gaussian, mse_tf
from acoustic_image_generation_tpu_torch.losses.regularization import l2_regularization
from acoustic_image_generation_tpu_torch.models.associators import (
    AUDIO_AC_HIDDEN,
    VIDEO_AC_HIDDEN,
    AssociatorAudioEncoder,
    LatentAssociator,
)
from acoustic_image_generation_tpu_torch.models.blocks import LATENT_DIM
from acoustic_image_generation_tpu_torch.models.layers import init_modules
from acoustic_image_generation_tpu_torch.models.unet_ac import UNetAcoustic
from acoustic_image_generation_tpu_torch.models.unet_sound import UNetSound
from acoustic_image_generation_tpu_torch.models.unet_video import UNetVideo
from acoustic_image_generation_tpu_torch.ops.stft import stft
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train.embed import _DTYPES, EmbedTask

AUDIO_ENC_WEIGHT_DECAY = 8e-5
VIDEO_LATENT, AUDIO_LATENT = 1024, 256


@dataclass(frozen=True)
class ProjectConfig:
    """The fields of the JAX ``ExperimentConfig`` that ``ProjectTask`` and
    its train step read: ``model.encoder_type``, ``model.fusion``,
    ``model.l2``, ``optim.margin``, ``data.num_channels``,
    ``parallel.compute_dtype``, ``optim.learning_rate`` and ``run.seed``,
    with JAX's defaults."""

    encoder_type: str = "Video"
    fusion: bool = False
    l2: bool = False
    margin: float = 0.2
    num_channels: int = 12
    compute_dtype: str = "bfloat16"
    learning_rate: float = 1e-4
    seed: int = 0


def _frozen_head(model, x) -> tuple[torch.Tensor, torch.Tensor]:
    """A frozen VAE's eval-mode encoder and head: (mean, std) in f32."""
    with torch.no_grad():
        _, mean, std = model.vae(model.features(x, train=False))
    return mean.float(), std.float()


class ProjectTask(nn.Module):
    reads_mfcc = False
    eval_metric = "mse"
    eval_mode = "min"

    def __init__(self, config: ProjectConfig = ProjectConfig(), *, device=None):
        super().__init__()
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute dtype {config.compute_dtype!r}")
        self.cfg = config
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.compute_dtype]
        kw = dict(device=self.device, dtype=self.dtype)
        self.wiring = "fusion" if config.fusion else ("Video" if config.encoder_type == "Video" else "Audio")
        self.acoustic = UNetAcoustic(config.num_channels, LATENT_DIM, **kw)
        self.video = UNetVideo(VIDEO_LATENT, **kw)
        self.audio = UNetSound("large", AUDIO_LATENT, **kw)
        if self.wiring != "Audio":
            self.assoc_video = LatentAssociator(VIDEO_LATENT, VIDEO_AC_HIDDEN, **kw)
        if self.wiring == "fusion":
            self.assoc_audio = LatentAssociator(AUDIO_LATENT, AUDIO_AC_HIDDEN, **kw)
        if self.wiring == "Audio":
            self.assoc_audio_enc = AssociatorAudioEncoder(**kw)
        for name, p in self.named_parameters():
            p.requires_grad_(name.startswith("assoc"))

    @property
    def reads_video(self) -> bool:
        return self.wiring != "Audio"

    def param_labels(self) -> dict[str, str]:
        """"train" for the associators' parameters, "frozen" for the VAEs'
        (JAX's ``param_labels``)."""
        return {name: "train" if name.startswith("assoc") else "frozen" for name, _ in self.named_parameters()}

    def init_params(self, seed: int) -> "ProjectTask":
        """Random weights with the JAX initializers' distributions, drawn
        from a CPU generator seeded with ``seed``."""
        init_modules(self, seed)
        return self

    def trained_modules(self) -> tuple[nn.Module, ...]:
        """The modules whose parameters train (FSDP shards each): the
        wiring's associators."""
        return tuple(m for n, m in self.named_children() if n.startswith("assoc"))

    def split_modules(self) -> tuple[nn.Module, ...]:
        """The modules that hold every kernel JAX's ``tp_sharding`` splits
        under tensor parallelism (``parallel/mesh.py``), in every wiring
        (JAX's tree holds them even where the wiring never runs them): the
        frozen video VAE's 13 wide convs and the frozen audio VAE's head
        (its 256-channel mean and std). They run forward only. The acoustic
        VAE and the associators (at most 150 outputs) stay whole."""
        return self.video, self.audio

    def global_noise(self, frames: int, generator: torch.Generator, *, train: bool = True) -> dict:
        """The step's noise for a global batch of ``frames`` frames, as one
        device draws it: ``latent``, then (a train step without ``l2``)
        ``triplet``."""
        names = ("latent", "triplet") if train and not self.cfg.l2 else ("latent",)
        return self._noise(frames // FRAMES_PER_SECOND, None, generator, names)

    def inputs(self, batch: Batch):
        """Per second: the first acoustic frame (S,36,48,C; None without the
        batch's), the resized spectrogram (S,193,257,1) f32 (None for the
        ``Video`` wiring) and the first video frame (None for the ``Audio``
        wiring)."""
        f = FRAMES_PER_SECOND
        spec = None
        if self.wiring != "Video":
            spec = resize_frames(stft(batch.audio.reshape(-1, SAMPLES_PER_SECOND)))[..., None]
        ac = None if batch.acoustic is None else batch.acoustic[::f]
        return ac, spec, batch.video[::f] if self.reads_video else None

    def _associate(self, spec, video, *, train: bool):
        """The translated (mean, std) and each associator's, in the compute
        dtype."""
        results = []
        if self.wiring != "Audio":
            results.append(self.assoc_video(*_frozen_head(self.video, video)))
        if self.wiring == "fusion":
            results.append(self.assoc_audio(*_frozen_head(self.audio, spec)))
        if self.wiring == "Audio":
            results.append(self.assoc_audio_enc(spec, train=train))
        if len(results) == 2:
            (m1, s1), (m2, s2) = results
            return (m1 + m2) / 2, (s1 + s2) / 2, results
        return *results[0], results

    def _noise(self, seconds: int, eps, generator, names):
        if eps is not None:
            return {k: eps[k].to(self.device, torch.float32) for k in names}
        if generator is None:
            raise ValueError("the projection task samples its latents: pass eps or generator")
        return {k: torch.randn((seconds, LATENT_DIM), generator=generator, device=self.device) for k in names}

    def _forward(self, batch: Batch, *, train: bool, eps, generator, names=("latent",)):
        """The acoustic VAE decoding from the translated latent; ``names``
        are the noise tensors to take or draw."""
        ac, spec, video = self.inputs(batch)
        mean, std, per_assoc = self._associate(spec, video, train=train)
        noise = self._noise(ac.shape[0], eps, generator, names)
        out = self.acoustic(ac, external_latent=(mean, std), eps=noise["latent"])
        return ac, out, mean, std, per_assoc, noise

    def loss(self, batch: Batch, *, train: bool = True, eps=None, generator=None, **unused):
        """Forward and objective, ``(total, metrics)`` in f32: ``loss``,
        ``mse``, ``huber``, ``latent_loss`` and ``l2_latent`` or
        ``triplet``."""
        if not self.cfg.l2 and (batch.action is None or batch.location is None):
            raise ValueError("the projection triplet needs the batch's action and location labels")
        names = ("latent",) if self.cfg.l2 else ("latent", "triplet")
        ac, out, mean, std, per_assoc, noise = self._forward(batch, train=train, eps=eps, generator=generator,
                                                             names=names)
        recon = out.output.float()
        mse = mse_tf(ac, recon)
        hub = huber_tf(ac, recon)
        latent = torch.mean(sum(kl_diag_gaussian(m, s) for m, s in per_assoc)) / 1e6
        metrics = {"mse": mse, "huber": hub, "latent_loss": latent}
        if self.cfg.l2:
            metric_term = metrics["l2_latent"] = mse_tf(out.mean, mean) + mse_tf(out.std, std)
        else:
            # the triplet mining couples rows: its latents, labels and scenarios cover the global batch
            e = noise["triplet"]
            sample = lambda mean, std: mesh.all_gather_rows(mean.float() + std.float() * e)
            z_ac = sample(out.mean, out.std)
            labels = mesh.all_gather_rows(batch.action[::FRAMES_PER_SECOND])
            scenario = mesh.all_gather_rows(batch.location[::FRAMES_PER_SECOND])
            metric_term = sum(triplet_all(z_ac, sample(m, s), labels, scenario, self.cfg.margin)[0]
                              for m, s in per_assoc)
            metrics["triplet"] = metric_term
        reg = 0.0
        if self.wiring == "Audio":
            reg = l2_regularization(EmbedTask.kernels(self.assoc_audio_enc), AUDIO_ENC_WEIGHT_DECAY)
        total = mse + hub + latent + metric_term + reg
        metrics["loss"] = total
        return total, metrics

    def forward(self, batch: Batch, **kw):
        """``loss``: the train step's forward, through which
        ``DistributedDataParallel`` wraps the task on more than one rank."""
        return self.loss(batch, **kw)

    def embeddings(self, batch: Batch, *, use_mean: bool = False, eps=None, generator=None) -> dict:
        """Per-second latents (f32): ``acoustic``, the acoustic VAE's own,
        and ``video`` and/or ``audio``, translated by the wiring's
        associators; the means with ``use_mean``, else ``mean + std * eps``
        with one ``eps`` (seconds, 150), given or drawn from ``generator``,
        shared by all of them. Eval mode; no decoder runs."""
        ac, spec, video = self.inputs(batch)
        heads = [_frozen_head(self.acoustic, ac)]
        _, _, per_assoc = self._associate(spec, video, train=False)
        heads += per_assoc
        if not use_mean and eps is None:
            if generator is None:
                raise ValueError("sampled embeddings need eps or generator")
            eps = torch.randn((ac.shape[0], LATENT_DIM), generator=generator, device=self.device)
        names = ["acoustic"] + {"Video": ["video"], "Audio": ["audio"], "fusion": ["video", "audio"]}[self.wiring]
        return {n: m.float() if use_mean else m.float() + s.float() * eps.to(self.device)
                for n, (m, s) in zip(names, heads)}

    def project(self, batch: Batch, *, eps=None, generator=None) -> torch.Tensor:
        """Acoustic images (S,36,48,C) f32 from the batch's audio and video
        alone, eval mode: the translated latent sampled with ``eps`` (S,150)
        (or ``generator``'s draw) and decoded by the acoustic VAE, as
        ``_forward`` decodes it. JAX's exported projection feeds the acoustic
        VAE zeros, whose encoder does not reach the output."""
        _, spec, video = self.inputs(batch)
        mean, std, _ = self._associate(spec, video, train=False)
        noise = self._noise(mean.shape[0], None if eps is None else {"latent": eps}, generator, ("latent",))
        return self.acoustic.decode(mean + std * noise["latent"].to(std.dtype)).float()

    def eval_losses(self, batch: Batch, *, eps=None, generator=None, **unused):
        """Eval-mode forward, sampled as JAX's is: ``({"mse": (seconds,)
        f32}, reconstruction (S,36,48,C) f32)``."""
        ac, out, *_ = self._forward(batch, train=False, eps=eps, generator=generator)
        recon = out.output.float()
        return {"mse": torch.mean(torch.square(recon - ac.float()), dim=(1, 2, 3))}, recon
