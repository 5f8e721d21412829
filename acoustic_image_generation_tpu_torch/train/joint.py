"""The joint-MVAE task: bottleneck feature maps fused across modalities, and
every modality reconstructed from the fused code.

Counterpart of ``acoustic_image_generation_tpu/train/joint.py::JointTask``
(``_inputs``, ``init_variables``, ``param_labels``, ``_features``,
``_stage2``, ``loss``, ``embeddings``, ``eval_losses``), over the two-stage
split of the three VAEs (``features``, then ``from_features``). Modes, as
JAX picks them:

- default: ``associator`` (``JointMVAE`` over the acoustic, video and audio
  feature maps) emits one replacement map per modality; each VAE's stage 2
  reconstructs its modality from it;
- ``fusion``: the associator fuses the video and audio maps only, still
  emitting all three;
- ``onlyaudiovideo``: the (frozen) 3-input associator gives the target
  acoustic map, a 2-input ``associator1`` (head ``ac``) predicts it from
  video and audio; loss = feature MSE + the acoustic reconstruction terms;
- ``moddrop``: in a train step, one Bernoulli keep gate (``uniform <
  0.2``) multiplies the acoustic feature map before the fusion.

The three VAEs are frozen: their encoders run in eval mode (BN on running
averages), and each stage 2 samples (``eps``) with eval-mode BN; the loss
reaches the associator through the frozen decoders. Only ``associator``
(``associator1`` with ``onlyaudiovideo``) trains (``param_labels``): every
other parameter requires no grad and gets no Adam slot. Loss = 3 x (MSE +
Huber) + sum of the three KLs / 1e6 (the mean over seconds).

Noise: ``eps`` is a dict of ``"acoustic"`` (seconds, 150), ``"video"``
(seconds, 1024) and ``"audio"`` (seconds, 256), the stage-2 draws (the
acoustic one alone where only the acoustic stage 2 runs), and ``moddrop``
the keep flag; or the step's generator draws the moddrop uniform, then the
stage-2 noise in that order. Per second: the first acoustic and video frame
and the STFT magnitude resized to 193x257.

On more than one rank (``parallel/mesh.py``) each rank holds its seconds
of the global batch. The trainer draws the step's noise as one device
does (``global_noise``): the moddrop flag, one draw for the whole batch,
which every rank keeps whole (``shared_draws``), then the stage-2 noise at
the global shape, of which each rank keeps its rows. The loss terms are
rank means over equal rows, which the trainer averages; no trained layer
couples rows. Under tensor parallelism the frozen video VAE's wide convs
and the audio VAE's head hold their block of the output channels on each
rank of a model group (``split_modules``), and the peers, which hold the
same rows, keep the same moddrop flag and stage-2 draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from acoustic_image_generation_tpu_torch import FRAMES_PER_SECOND, resolve_device
from acoustic_image_generation_tpu_torch.data.preprocess import Batch
from acoustic_image_generation_tpu_torch.dsp.spectrogram import SAMPLES_PER_SECOND, resize_frames
from acoustic_image_generation_tpu_torch.losses.recon import huber_tf, kl_diag_gaussian, mse_tf
from acoustic_image_generation_tpu_torch.models.associators import JOINT_HEADS, JointMVAE
from acoustic_image_generation_tpu_torch.models.blocks import LATENT_DIM
from acoustic_image_generation_tpu_torch.models.layers import init_modules
from acoustic_image_generation_tpu_torch.models.unet_ac import UNetAcoustic
from acoustic_image_generation_tpu_torch.models.unet_sound import UNetSound
from acoustic_image_generation_tpu_torch.models.unet_video import UNetVideo
from acoustic_image_generation_tpu_torch.ops.stft import stft
from acoustic_image_generation_tpu_torch.train.embed import _DTYPES
from acoustic_image_generation_tpu_torch.train.project import AUDIO_LATENT, VIDEO_LATENT

MODDROP_KEEP = 0.2
LATENTS = {"acoustic": LATENT_DIM, "video": VIDEO_LATENT, "audio": AUDIO_LATENT}


@dataclass(frozen=True)
class JointConfig:
    """The fields of the JAX ``ExperimentConfig`` that ``JointTask`` and its
    train step read: ``model.fusion``, ``model.onlyaudiovideo``,
    ``model.moddrop``, ``data.num_channels``, ``parallel.compute_dtype``,
    ``optim.learning_rate`` and ``run.seed``, with JAX's defaults."""

    fusion: bool = False
    onlyaudiovideo: bool = False
    moddrop: bool = False
    num_channels: int = 12
    compute_dtype: str = "bfloat16"
    learning_rate: float = 1e-4
    seed: int = 0


class JointTask(nn.Module):
    reads_mfcc = False
    reads_video = True
    eval_metric = "mse"
    eval_mode = "min"
    shared_draws = ("moddrop",)  # global_noise's draws that are not per row

    def __init__(self, config: JointConfig = JointConfig(), *, device=None):
        super().__init__()
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute dtype {config.compute_dtype!r}")
        self.cfg = config
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.compute_dtype]
        kw = dict(device=self.device, dtype=self.dtype)
        self.acoustic = UNetAcoustic(config.num_channels, LATENT_DIM, **kw)
        self.audio = UNetSound("large", AUDIO_LATENT, **kw)
        self.video = UNetVideo(VIDEO_LATENT, **kw)
        pair = JOINT_HEADS["video"] + JOINT_HEADS["audio"]
        self.associator = JointMVAE(pair if config.fusion else JOINT_HEADS["ac"] + pair, device=self.device)
        if config.onlyaudiovideo:
            self.associator1 = JointMVAE(pair, heads=("ac",), device=self.device)
        self.trained = "associator1" if config.onlyaudiovideo else "associator"
        for name, p in self.named_parameters():
            p.requires_grad_(name.split(".")[0] == self.trained)

    def param_labels(self) -> dict[str, str]:
        """"train" for the trained associator's parameters, "frozen" for the
        rest (JAX's ``param_labels``)."""
        return {n: "train" if n.split(".")[0] == self.trained else "frozen" for n, _ in self.named_parameters()}

    def init_params(self, seed: int) -> "JointTask":
        """Random weights with the JAX initializers' distributions, drawn
        from a CPU generator seeded with ``seed``."""
        init_modules(self, seed)
        return self

    def trained_modules(self) -> tuple[nn.Module, ...]:
        """The modules whose parameters train (FSDP shards each): the trained
        associator."""
        return (getattr(self, self.trained),)

    def split_modules(self) -> tuple[nn.Module, ...]:
        """The modules that hold every kernel JAX's ``tp_sharding`` splits
        under tensor parallelism (``parallel/mesh.py``): the frozen video
        VAE's 13 wide convs and the frozen audio VAE's head (its
        256-channel mean and std). Their stage 2 runs on the fused maps, so
        in a train step the gradient goes back through the split heads and
        the video decoder to the associator: each split conv sums its
        input's gradient over the model group (``sum_input_grad``), with no
        weight gradient. The acoustic VAE and ``JointMVAE`` (dense) stay
        whole."""
        return self.video, self.audio

    def global_noise(self, frames: int, generator: torch.Generator, *, train: bool = True) -> dict:
        """The step's draws for a global batch of ``frames`` frames, in one
        device's order: ``moddrop``, the keep flag (a train step with
        ``moddrop``), then the stage-2 noise (the acoustic one alone where
        only the acoustic stage 2 runs: ``onlyaudiovideo``, or eval)."""
        out = {"moddrop": self._keep(None, generator)} if self.cfg.moddrop and train else {}
        names = tuple(LATENTS) if train and not self.cfg.onlyaudiovideo else ("acoustic",)
        return {**out, **self._noise(frames // FRAMES_PER_SECOND, names, None, generator)}

    def inputs(self, batch: Batch):
        """Per second: the first acoustic frame (S,36,48,C; None without the
        batch's), the resized spectrogram (S,193,257,1) f32 and the first
        video frame."""
        f = FRAMES_PER_SECOND
        spec = resize_frames(stft(batch.audio.reshape(-1, SAMPLES_PER_SECOND)))[..., None]
        return None if batch.acoustic is None else batch.acoustic[::f], spec, batch.video[::f]

    def _fuse(self, inputs, keep=None, acoustic_features=False):
        """The frozen encoders' feature maps (the acoustic one times
        ``keep``; with ``fusion`` only if ``acoustic_features`` asks for it,
        as nothing else reads it there), and the associator's (and
        ``associator1``'s) outputs."""
        ac, spec, video = inputs
        f_ac = None
        with torch.no_grad():
            if acoustic_features or not self.cfg.fusion:
                f_ac = self.acoustic.features(ac)
            f_vi = self.video.features(video, train=False)
            f_au = self.audio.features(spec, train=False)
        if keep is not None and f_ac is not None:
            f_ac = f_ac * keep.to(f_ac.dtype)
        maps = (f_vi, f_au) if self.cfg.fusion else (f_ac, f_vi, f_au)
        with torch.set_grad_enabled(torch.is_grad_enabled() and self.trained == "associator"):
            fused = self.associator(*maps)
        pred = self.associator1(f_vi, f_au) if self.cfg.onlyaudiovideo else None
        return (f_ac, f_vi, f_au), fused, pred

    def _keep(self, moddrop, generator):
        """The moddrop keep flag of a train step (1,) f32."""
        if moddrop is not None:
            return torch.as_tensor(moddrop, dtype=torch.float32, device=self.device).reshape(1)
        if generator is None:
            raise ValueError("moddrop draws its keep gate: pass moddrop or generator")
        return (torch.rand((1,), generator=generator, device=self.device) < MODDROP_KEEP).float()

    def _noise(self, seconds: int, names, eps, generator) -> dict:
        if eps is not None:
            return {k: eps[k].to(self.device, torch.float32) for k in names}
        if generator is None:
            raise ValueError("the joint task's stage 2 samples its latents: pass eps or generator")
        return {k: torch.randn((seconds, LATENTS[k]), generator=generator, device=self.device) for k in names}

    def _stage2(self, modality: str, fmap, eps):
        """A frozen VAE's head (sampled) and decoder over a fused map."""
        model = getattr(self, modality)
        if modality == "acoustic":
            return model.from_features(fmap, eps=eps)
        return model.from_features(fmap, eps=eps, train=False)

    def loss(self, batch: Batch, *, train: bool = True, eps=None, generator=None, moddrop=None, **unused):
        """Forward and objective, ``(total, metrics)`` in f32: ``loss``,
        ``mse``, ``huber``, ``latent_loss`` (and ``feature_l2`` with
        ``onlyaudiovideo``). ``moddrop`` (the keep flag, or ``eps``'s
        ``moddrop``) replaces the draw."""
        inputs = self.inputs(batch)
        ac, spec, video = inputs
        if moddrop is None and eps is not None:
            moddrop = eps.get("moddrop")
        keep = self._keep(moddrop, generator) if self.cfg.moddrop and train else None
        _, fused, pred = self._fuse(inputs, keep)
        seconds = ac.shape[0]
        if self.cfg.onlyaudiovideo:
            noise = self._noise(seconds, ("acoustic",), eps, generator)
            ac_out = self._stage2("acoustic", pred["ac"], noise["acoustic"])
            recon = ac_out.output.float()
            feat_l2 = mse_tf(fused["ac"], pred["ac"])
            mse, hub = mse_tf(ac, recon), huber_tf(ac, recon)
            latent = torch.mean(kl_diag_gaussian(ac_out.mean, ac_out.std)) / 1e6
            total = feat_l2 + mse + hub + latent
            return total, {"loss": total, "mse": mse, "huber": hub, "latent_loss": latent, "feature_l2": feat_l2}
        noise = self._noise(seconds, ("acoustic", "video", "audio"), eps, generator)
        outs = {m: self._stage2(m, fused[h], noise[m]) for m, h in (("acoustic", "ac"), ("video", "video"),
                                                                    ("audio", "audio"))}
        pairs = ((ac, outs["acoustic"]), (spec, outs["audio"]), (video, outs["video"]))
        mse = sum(mse_tf(x, o.output) for x, o in pairs)
        hub = sum(huber_tf(x, o.output) for x, o in pairs)
        latent = torch.mean(sum(kl_diag_gaussian(o.mean, o.std) for _, o in pairs)) / 1e6
        total = mse + hub + latent
        return total, {"loss": total, "mse": mse, "huber": hub, "latent_loss": latent}

    def forward(self, batch: Batch, **kw):
        """``loss``: the train step's forward, through which
        ``DistributedDataParallel`` wraps the task on more than one rank."""
        return self.loss(batch, **kw)

    def embeddings(self, batch: Batch, *, use_mean: bool = False, eps=None, generator=None) -> dict:
        """Per-second latents (f32) of the VAE heads, eval mode, no decoder:
        ``acoustic`` over the associator's acoustic map (``associator1``'s
        with ``onlyaudiovideo``), ``acoustic_true`` over the real acoustic
        features, and, except with ``onlyaudiovideo``, ``audio`` and
        ``video`` over the associator's translated maps. The means with
        ``use_mean``, else ``mean + std * eps``: ``eps`` a dict as the
        loss's (``acoustic`` shared by the two acoustic latents), given or
        drawn from ``generator``."""
        (f_ac, _, _), fused, pred = self._fuse(self.inputs(batch), acoustic_features=True)
        heads = {"acoustic": ("acoustic", (pred or fused)["ac"]), "acoustic_true": ("acoustic", f_ac)}
        if not self.cfg.onlyaudiovideo:
            heads.update(audio=("audio", fused["audio"]), video=("video", fused["video"]))
        if not use_mean:
            eps = self._noise(f_ac.shape[0], dict.fromkeys(m for m, _ in heads.values()), eps, generator)
        out = {}
        for name, (model, fmap) in heads.items():
            _, mean, std = getattr(self, model).vae(fmap)
            out[name] = mean.float() if use_mean else mean.float() + std.float() * eps[model]
        return out

    def project(self, batch: Batch, *, eps=None, generator=None) -> torch.Tensor:
        """Acoustic images (S,36,48,C) f32 from the batch's audio and video
        alone, eval mode: the frozen video and audio encoders' maps, the
        acoustic map of ``associator1`` (``onlyaudiovideo``) or of the
        ``fusion`` associator, and the acoustic stage 2 sampled with
        ``eps`` (S,150) (or ``generator``'s draw). The plain variant's
        associator reads real acoustic features: it has no such path."""
        if not (self.cfg.onlyaudiovideo or self.cfg.fusion):
            raise ValueError("acoustic images from audio and video need --onlyaudiovideo or --fusion (the plain "
                             "jointmvae associator consumes real acoustic features)")
        _, spec, video = self.inputs(batch)
        with torch.no_grad():
            f_vi = self.video.features(video, train=False)
            f_au = self.audio.features(spec, train=False)
        head = self.associator1 if self.cfg.onlyaudiovideo else self.associator
        noise = self._noise(f_vi.shape[0], ("acoustic",), None if eps is None else {"acoustic": eps}, generator)
        return self._stage2("acoustic", head(f_vi, f_au)["ac"], noise["acoustic"]).output.float()

    def eval_losses(self, batch: Batch, *, eps=None, generator=None, **unused):
        """Eval-mode forward through the acoustic stage 2 alone (JAX's reads
        nothing else), sampled as JAX's is: ``({"mse": (seconds,) f32},
        reconstruction (S,36,48,C) f32)``."""
        inputs = self.inputs(batch)
        _, fused, pred = self._fuse(inputs)
        noise = self._noise(inputs[0].shape[0], ("acoustic",), eps, generator)
        recon = self._stage2("acoustic", (pred or fused)["ac"], noise["acoustic"]).output.float()
        return {"mse": torch.mean(torch.square(recon - inputs[0].float()), dim=(1, 2, 3))}, recon
