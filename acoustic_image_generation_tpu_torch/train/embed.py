"""The cross-modal embedding task: three per-modality VAEs aligned in
latent space.

Counterpart of ``acoustic_image_generation_tpu/train/embed.py::EmbedTask``
(``_inputs``, ``init_variables``, ``_forward``, ``loss``, ``eval_losses``,
``embeddings``; ``_load_spec_stats``). The unit of embedding is one
second (12 frames): the acoustic VAE (``UNetAcoustic``, no BN) sees the
second's first acoustic frame, the video VAE (``UNetVideo``) its first video
frame and the audio VAE (``UNetSound``, large) the second's 99x257 STFT
magnitude (``ops.stft``: the CUDA kernel on the card, its plain version on
the CPU), z-normalized with the global statistics of ``stats_dir`` when
``normalize_spectrogram`` is set (``data/stats.py``), then bilinearly
resized to 193x257. The three latents share ``latent_dim``.

The loss, with the variant chosen as in JAX: 3 x (MSE + Huber), or the
sigmoid cross-entropy with ``bce``; + mean KL / 1e6; + L2 over the audio
(8e-5) and video (7e-5) VAEs' kernels; + the alignment term:

- default: batch-hard triplet of (acoustic, video) + (acoustic, audio);
- ``fusion``: all-triplets against the mean of the audio and video latents;
- ``moddrop``: all-triplets against the mean of the modalities kept by
  three Bernoulli draws (video .98, audio .98, acoustic .5; all kept in
  eval);
- ``l2``: MSE between the means and between the stds;
- ``proxy``: NCA of (acoustic, video) + (acoustic, audio).

One noise tensor ``eps`` (seconds, latent_dim) per step is shared by every
modality's reparameterization. It and the moddrop draws come from the
step's ``torch.Generator`` (eps first), or are given (the tests hand in
JAX's). The train-mode forward updates the BN running averages of the audio
and video VAEs in place (JAX returns them as new ``batch_stats``).

On more than one rank (``parallel/mesh.py``) each rank holds its seconds
of the global batch, and what couples rows covers the global batch, as in
JAX's one program over its ``data`` mesh: the audio and video VAEs'
train-mode BN statistics (``models/layers.py``); the triplet mining,
``triplet_all`` and NCA, over the latents, labels and scenarios gathered by
``mesh.all_gather_rows``; ``eps``, which the trainer draws at the global
shape (``global_noise``) and cuts to the rank's rows, so that the moddrop
draws after it come from the same generator state on every rank. The
reconstruction terms and the ``l2`` variant are rank means over equal
rows, which the trainer averages. Under tensor parallelism the rows are the
data rank's and the gathers run over the data group; the video VAE's wide
convs are split over the model group (``split_modules``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from acoustic_image_generation_tpu_torch import FRAMES_PER_SECOND, resolve_device
from acoustic_image_generation_tpu_torch.data.preprocess import Batch
from acoustic_image_generation_tpu_torch.data.stats import load_stats, normalize_spectrogram
from acoustic_image_generation_tpu_torch.dsp.spectrogram import SAMPLES_PER_SECOND, resize_frames
from acoustic_image_generation_tpu_torch.losses.metric import nca_loss, triplet_all, triplet_hard
from acoustic_image_generation_tpu_torch.losses.recon import huber_tf, kl_diag_gaussian, mse_tf, sigmoid_ce_logits
from acoustic_image_generation_tpu_torch.losses.regularization import l2_regularization
from acoustic_image_generation_tpu_torch.models.blocks import ChainConv
from acoustic_image_generation_tpu_torch.models.layers import Conv2d, ConvTransposeTF, Dense, init_modules
from acoustic_image_generation_tpu_torch.models.unet_ac import UNetAcoustic
from acoustic_image_generation_tpu_torch.models.unet_sound import UNetSound
from acoustic_image_generation_tpu_torch.models.unet_video import UNetVideo
from acoustic_image_generation_tpu_torch.ops.stft import stft
from acoustic_image_generation_tpu_torch.parallel import mesh

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
AUDIO_WEIGHT_DECAY = 8e-5
VIDEO_WEIGHT_DECAY = 7e-5
MODDROP_KEEP = (0.98, 0.98, 0.5)  # video, audio, acoustic
_KERNEL_MODULES = (Conv2d, ConvTransposeTF, Dense, ChainConv)


@dataclass(frozen=True)
class EmbedConfig:
    """The fields of the JAX ``ExperimentConfig`` that ``EmbedTask`` reads:
    ``data.num_channels``, ``model.num_class`` (``latent_dim``),
    ``optim.margin``, ``model.fusion``/``moddrop``/``l2``/``proxy``,
    ``optim.bce``, ``data.normalize_spectrogram``,
    ``parallel.compute_dtype``, ``optim.learning_rate`` and ``run.seed``,
    with JAX's defaults (bfloat16 is the CLI's default compute dtype).
    ``stats_dir`` is where ``normalize_spectrogram`` reads the statistics
    (``core.config.embed_config`` resolves JAX's default, ``stats2s``
    beside the training list)."""

    num_channels: int = 12
    latent_dim: int = 128
    margin: float = 0.2
    fusion: bool = False
    moddrop: bool = False
    l2: bool = False
    proxy: bool = False
    bce: bool = False
    normalize_spectrogram: bool = False
    stats_dir: str | None = None
    compute_dtype: str = "bfloat16"
    learning_rate: float = 1e-4
    seed: int = 0


def _load_spec_stats(config: EmbedConfig, device: torch.device):
    """The global spectrogram statistics as f32 tensors on ``device`` when
    ``normalize_spectrogram`` is set, else None."""
    if not config.normalize_spectrogram:
        return None
    if config.stats_dir is None:
        raise ValueError("normalize_spectrogram needs stats_dir (or a train_file beside its stats2s directory)")
    return tuple(torch.from_numpy(a).to(device, torch.float32) for a in load_stats(config.stats_dir))


class EmbedTask(nn.Module):
    reads_mfcc = False  # no VAE reads it: the trainer's batches skip the frontend
    eval_metric = "mse"
    eval_mode = "min"

    def __init__(self, config: EmbedConfig = EmbedConfig(), *, device=None):
        super().__init__()
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute dtype {config.compute_dtype!r}")
        self.cfg = config
        self.device = resolve_device(device)
        self.spec_stats = _load_spec_stats(config, self.device)
        self.dtype = _DTYPES[config.compute_dtype]
        kw = dict(device=self.device, dtype=self.dtype)
        latent = config.latent_dim
        self.acoustic = UNetAcoustic(config.num_channels, latent, **kw)
        self.audio = UNetSound("large", latent, **kw)
        self.video = UNetVideo(latent, **kw)

    def init_params(self, seed: int) -> "EmbedTask":
        """Random weights with the JAX initializers' distributions (glorot
        uniform, zero biases; BN scale 1, bias 0, running mean 0, variance
        1), drawn from a CPU generator seeded with ``seed``."""
        init_modules(self, seed)
        return self

    def trained_modules(self) -> tuple[nn.Module, ...]:
        """The modules whose parameters train (FSDP shards each): the three
        VAEs."""
        return self.acoustic, self.audio, self.video

    def split_modules(self) -> tuple[nn.Module, ...]:
        """The module that holds every kernel JAX's ``tp_sharding`` splits
        under tensor parallelism (``parallel/mesh.py``): the video VAE
        (``layer3``, ``layer5``, ``conv_dec``, ``upsample_6``, ``layer6``,
        ``layer7``), trained, so its split convs run both collectives. The
        acoustic and audio VAEs (at most 128 channels) stay whole."""
        return (self.video,)

    @staticmethod
    def kernels(module: nn.Module) -> list[torch.Tensor]:
        """The conv, transposed-conv and dense kernels of ``module``: the
        leaves JAX's L2 term covers (biases and BN scales carry none)."""
        return [m.weight for m in module.modules() if isinstance(m, _KERNEL_MODULES)]

    # --------------------------------------------------------------- inputs

    def inputs(self, batch: Batch):
        """Per second: the first acoustic frame (S,36,48,C), the
        (normalized) resized spectrogram (S,193,257,1) f32 and the first
        video frame (S,224,298,3)."""
        f = FRAMES_PER_SECOND
        ac = batch.acoustic[::f]
        video = batch.video[::f]
        spec = stft(batch.audio.reshape(-1, SAMPLES_PER_SECOND))
        if self.spec_stats is not None:
            spec = normalize_spectrogram(spec, *self.spec_stats)
        return ac, resize_frames(spec)[..., None], video

    # -------------------------------------------------------------- forward

    def _forward(self, batch: Batch, *, train: bool):
        ac, spec, video = self.inputs(batch)
        outs = (self.acoustic(ac), self.audio(spec, train=train), self.video(video, train=train))
        return (ac, spec, video), outs

    def draw_noise(self, seconds: int, generator: torch.Generator | None) -> torch.Tensor:
        if generator is None:
            raise ValueError("the embedding loss samples the latent noise: pass eps or generator")
        return torch.randn((seconds, self.cfg.latent_dim), generator=generator, device=self.device)

    def global_noise(self, frames: int, generator: torch.Generator, *, train: bool = True) -> torch.Tensor:
        """The step's ``eps`` for a global batch of ``frames`` frames, as one
        device draws it."""
        return self.draw_noise(frames // FRAMES_PER_SECOND, generator)

    # ----------------------------------------------------------------- loss

    def loss(self, batch: Batch, *, train: bool = True, eps=None, generator=None, moddrop=None, qtrunk=None):
        """Forward (train mode: BN on batch statistics, running averages
        updated in place) and objective, ``(total, metrics)`` in f32.
        ``eps`` (seconds, latent_dim) and ``moddrop`` (keep flags of video,
        audio, acoustic) replace the draws from ``generator``. ``qtrunk`` is
        the generation task's int8 trunk and means nothing here."""
        del qtrunk
        if batch.action is None or batch.location is None:
            raise ValueError("the embedding loss needs the batch's action and location labels")
        inputs, outs = self._forward(batch, train=train)
        return self.objective(inputs, outs, batch, train=train, eps=eps, generator=generator, moddrop=moddrop)

    def forward(self, batch: Batch, **kw):
        """``loss``: the train step's forward, through which
        ``DistributedDataParallel`` wraps the task on more than one rank."""
        return self.loss(batch, **kw)

    def objective(self, inputs, outs, batch: Batch, *, train: bool = True, eps=None, generator=None,
                  moddrop=None):
        """The loss of ``_forward``'s ``(inputs, outs)``: ``(total,
        metrics)`` in f32, as JAX's ``loss`` computes it after its forward."""
        cfg = self.cfg
        (ac, spec, video), (ac_out, au_out, vi_out) = inputs, outs

        mse = mse_tf(ac, ac_out.output) + mse_tf(spec, au_out.output) + mse_tf(video, vi_out.output)
        hub = huber_tf(ac, ac_out.output) + huber_tf(spec, au_out.output) + huber_tf(video, vi_out.output)
        kl = sum(kl_diag_gaussian(o.mean, o.std) for o in (ac_out, au_out, vi_out))
        latent_term = torch.mean(kl) / 1e6

        seconds = ac_out.mean.shape[0]
        eps = self.draw_noise(seconds, generator) if eps is None else eps.to(self.device, torch.float32)
        # the alignment terms couple rows: their latents, labels and scenarios cover the global batch
        sample = lambda mean, std: mesh.all_gather_rows(mean.float() + std.float() * eps)
        z_ac = sample(ac_out.mean, ac_out.std)
        labels = mesh.all_gather_rows(batch.action[::FRAMES_PER_SECOND])
        scenario = mesh.all_gather_rows(batch.location[::FRAMES_PER_SECOND])

        metrics = {"mse": mse, "huber": hub, "latent_loss": latent_term}
        if cfg.l2:
            l2m = mse_tf(vi_out.mean, ac_out.mean) + mse_tf(au_out.mean, ac_out.mean)
            l2s = mse_tf(vi_out.std, ac_out.std) + mse_tf(au_out.std, ac_out.std)
            metric_term = metrics["l2_latent"] = l2m + l2s
        elif cfg.fusion:
            z = sample((vi_out.mean + au_out.mean) / 2, (vi_out.std + au_out.std) / 2)
            tl, frac = triplet_all(z_ac, z, labels, scenario, cfg.margin)
            metrics["triplet"], metrics["fraction_positive"] = tl, frac
            metric_term = tl
        elif cfg.moddrop:
            if not train:
                on_v = on_a = on_ac = 1.0
            elif moddrop is None:
                if generator is None:
                    raise ValueError("moddrop samples its modality draws: pass moddrop or generator")
                draws = torch.rand((3,), generator=generator, device=self.device)
                keep = torch.tensor(MODDROP_KEEP, device=self.device)
                on_v, on_a, on_ac = (draws < keep).float().unbind()
            else:
                on_v, on_a, on_ac = (torch.as_tensor(v, dtype=torch.float32, device=self.device)
                                     for v in moddrop)
            n_on = torch.clamp_min(torch.as_tensor(on_v + on_a + on_ac, dtype=torch.float32), 1e-15)
            # in f32, as JAX promotes its bf16 latents against the f32 flags
            mean = (on_ac * ac_out.mean.float() + on_a * au_out.mean.float() + on_v * vi_out.mean.float()) / n_on
            std = (on_ac * ac_out.std.float() + on_a * au_out.std.float() + on_v * vi_out.std.float()) / n_on
            tl, _ = triplet_all(z_ac, sample(mean, std), labels, scenario, cfg.margin)
            metric_term = metrics["triplet"] = tl
        elif cfg.proxy:
            z_a, z_v = sample(au_out.mean, au_out.std), sample(vi_out.mean, vi_out.std)
            nca = nca_loss(z_ac, z_v, labels, scenario) + nca_loss(z_ac, z_a, labels, scenario)
            metric_term = metrics["nca"] = nca
        else:
            z_a, z_v = sample(au_out.mean, au_out.std), sample(vi_out.mean, vi_out.std)
            tl_v, _ = triplet_hard(z_ac, z_v, labels, scenario, cfg.margin)
            tl_a, _ = triplet_hard(z_ac, z_a, labels, scenario, cfg.margin)
            metric_term = metrics["triplet"] = tl_v + tl_a

        reg = (l2_regularization(self.kernels(self.audio), AUDIO_WEIGHT_DECAY)
               + l2_regularization(self.kernels(self.video), VIDEO_WEIGHT_DECAY))
        if cfg.bce:
            ce = (sigmoid_ce_logits(ac, ac_out.logits) + sigmoid_ce_logits(spec, au_out.logits)
                  + sigmoid_ce_logits(video, vi_out.logits))
            metrics["bce"] = ce
            total = ce + latent_term + metric_term + reg
        else:
            total = mse + hub + latent_term + metric_term + reg
        metrics["regularization"] = reg
        metrics["loss"] = total
        return total, metrics

    # ----------------------------------------------------------------- eval

    def eval_losses(self, batch: Batch, **unused):
        """Eval-mode forward: ``({"mse", "mse_acoustic", "mse_audio",
        "mse_video"}: (seconds,) f32, (ac_out, au_out, vi_out))``. It draws
        no noise (JAX's eval forward does not sample): the trainer's
        ``eps``, ``generator``, ``qtrunk`` and ``trunk_feat`` mean nothing
        here."""
        (ac, spec, video), outs = self._forward(batch, train=False)
        per = lambda x, y: torch.mean(torch.square(x.float() - y.float()), dim=tuple(range(1, x.dim())))
        mse_ac, mse_au, mse_vi = (per(x, o.output) for x, o in zip((ac, spec, video), outs))
        return {"mse": mse_ac + mse_au + mse_vi, "mse_acoustic": mse_ac, "mse_audio": mse_au,
                "mse_video": mse_vi}, outs

    def encode(self, batch: Batch):
        """Eval-mode encoders and VAE heads only: ``((mean, std) of the
        acoustic, audio and video VAEs)``, each (seconds, latent_dim) in the
        compute dtype. The decoders do not feed the latents."""
        ac, spec, video = self.inputs(batch)
        heads = []
        for model, x in ((self.acoustic, ac), (self.audio, spec), (self.video, video)):
            _, mean, std = model.vae(model.features(x, train=False))
            heads.append((mean, std))
        return tuple(heads)

    def embeddings(self, batch: Batch, *, use_mean: bool = False, eps=None, generator=None) -> dict:
        """Per-second latents ``{"acoustic", "audio", "video"}`` (f32): the
        means with ``use_mean``, else ``mean + std * eps`` with one ``eps``
        (given, or drawn from ``generator``) shared by the three."""
        heads = self.encode(batch)
        if not use_mean and eps is None:
            eps = self.draw_noise(heads[0][0].shape[0], generator)
        out = {}
        for name, (mean, std) in zip(("acoustic", "audio", "video"), heads):
            out[name] = mean.float() if use_mean else mean.float() + std.float() * eps.to(self.device)
        return out
