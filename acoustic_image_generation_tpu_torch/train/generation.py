"""The generation task: ResNet50 trunk -> ``conv_map`` feature + tiled MFCC
map -> ``UNetAcResNet``, with its loss for training.

Counterpart of ``acoustic_image_generation_tpu/train/generation.py::
GenerationTask`` (``__init__``, ``param_labels``, ``trunk_features``,
``_forward``, ``loss``, ``generate``). The parameters are f32 masters in the
task's modules, on one device; every layer computes in the compute dtype
(BN statistics stay f32). They come from ``init_params(seed)`` or from the
JAX package's variables through ``bridge.load_flax``.

As in JAX the trunk is frozen (``freeze_trunk``): only the generator and
``resnet.conv_map`` train, and their parameters alone require grad. With
``trunk_bn="train"`` (the default) the trunk's BN statistics still update
in every train forward.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.nn as nn

from acoustic_image_generation_tpu_torch import resolve_device
from acoustic_image_generation_tpu_torch.data.preprocess import Batch, tile_mfccmap
from acoustic_image_generation_tpu_torch.losses.recon import (
    huber_tf,
    kl_diag_gaussian,
    mse_tf,
    sigmoid_ce_logits,
)
from acoustic_image_generation_tpu_torch.losses.regularization import l2_regularization
from acoustic_image_generation_tpu_torch.models.resnet import ConvBN, ResNet50
from acoustic_image_generation_tpu_torch.models.unet_ac import UNetAcResNet, VaeOutput

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TRAINED_RESNET_HEADS = ("conv_map", "logits")  # the ResNet scopes that train


@contextlib.contextmanager
def no_tf32():
    """IEEE float32 in cuBLAS matmuls and cuDNN convolutions inside the
    block (cuDNN uses TF32 by default); the global flags are restored on
    exit."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclass(frozen=True)
class GenerationConfig:
    """The fields of the JAX ``ExperimentConfig`` that serving and the train
    step read: ``model.num_skip_conn``, ``model.ae``, ``model.resnet_units``,
    ``model.trunk_bn``, ``parallel.compute_dtype``, ``optim.learning_rate``,
    ``optim.latent_loss``, ``optim.mse``, ``optim.huber``, ``optim.bce``,
    ``optim.resnet_weight_decay`` and ``run.seed``, with JAX's defaults
    (bfloat16 is the CLI's default compute dtype). float32 work runs
    without TF32, so float32 is IEEE float32 on CUDA too."""

    num_skip_conn: int = 1
    ae: bool = False
    resnet_units: tuple[int, int, int, int] = (3, 4, 6, 3)
    trunk_bn: str = "train"  # train | frozen: trunk BN on batch or running statistics
    compute_dtype: str = "bfloat16"
    learning_rate: float = 1e-4
    latent_loss: float = 1e-6
    mse: bool = True
    huber: bool = True
    bce: bool = False
    resnet_weight_decay: float = 5e-4
    seed: int = 0


class GenerationTask(nn.Module):
    def __init__(self, config: GenerationConfig = GenerationConfig(), *, device=None):
        super().__init__()
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute dtype {config.compute_dtype!r}")
        if config.trunk_bn not in ("train", "frozen"):
            raise ValueError(f"trunk_bn must be 'train' or 'frozen', got {config.trunk_bn!r}")
        self.cfg = config
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.compute_dtype]
        u = config.resnet_units
        blocks = ((64, u[0], 1), (128, u[1], 2), (256, u[2], 2), (512, u[3], 1))
        kw = dict(device=self.device, dtype=self.dtype)
        self.resnet = ResNet50(
            blocks, freeze_trunk=True, trunk_bn_frozen=config.trunk_bn == "frozen", **kw
        )
        self.generator = UNetAcResNet(skips=config.num_skip_conn, embedding=config.ae, **kw)
        labels = self.param_labels()
        for name, p in self.named_parameters():
            p.requires_grad_(labels[name] == "train")

    def param_labels(self) -> dict[str, str]:
        """"train" or "frozen" for every parameter, as JAX's ``param_labels``:
        the generator and the ResNet's ``conv_map`` (and ``logits``) heads
        train; the backbone is frozen and gets no Adam slots."""
        out = {}
        for name, _ in self.named_parameters():
            top, sub = name.split(".")[:2]
            train = top == "generator" or sub in TRAINED_RESNET_HEADS
            out[name] = "train" if train else "frozen"
        return out

    def init_params(self, seed: int) -> "GenerationTask":
        """Random weights with the JAX initializers' distributions, drawn
        from a CPU generator seeded with ``seed``: glorot-uniform with zero
        biases for the generator, He truncated-normal for the trunk, BN
        scale 1, bias 0, running mean 0, running variance 1."""
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(g)
        return self

    def resnet_kernels(self) -> list[torch.Tensor]:
        """The ResNet's conv kernels (trunk and ``conv_map``), the leaves the
        L2 term covers."""
        return [m.weight for m in self.resnet.modules() if isinstance(m, ConvBN)]

    def trunk_features(self, video: torch.Tensor) -> torch.Tensor:
        """Block4 output (N,14,19,2048) in the compute dtype, eval-mode BN."""
        with no_tf32():
            return self.resnet(video, mode="trunk")

    def _forward(self, mfcc, video, *, train: bool = False, eps=None, generator=None,
                 trunk_feat=None) -> VaeOutput:
        """The forward pass. ``train``: BN on batch statistics, the running
        averages of every train-mode BN updated in place (JAX returns them as
        new ``batch_stats``); the VAE noise must then come from ``eps`` or
        ``generator``."""
        if train and not self.cfg.ae and eps is None and generator is None:
            raise ValueError("a train forward samples the VAE noise: pass eps or generator")
        if trunk_feat is None:
            feat = self.resnet(video, mode="full", train=train)
        else:
            feat = self.resnet(trunk_feat, mode="head", train=train)
        mfccmap = tile_mfccmap(mfcc).to(self.dtype)
        return self.generator(mfccmap, feat, eps=eps, generator=generator)

    def objective(self, out: VaeOutput, batch: Batch) -> tuple[torch.Tensor, dict]:
        """Total loss and its terms, in f32, as JAX's ``loss``: [MSE] +
        [Huber] + [BCE] + latent_loss * mean(KL) (VAE only) + L2 over the
        ResNet's kernels."""
        cfg = self.cfg
        recon = out.output.float()
        target = batch.acoustic
        mse = mse_tf(target, recon)
        metrics = {"mse": mse}
        total = torch.zeros((), dtype=torch.float32, device=recon.device)
        if cfg.mse:
            total = total + mse
        if cfg.huber:
            metrics["huber"] = huber_tf(target, recon)
            total = total + metrics["huber"]
        if cfg.bce:
            metrics["bce"] = sigmoid_ce_logits(target, out.logits)
            total = total + metrics["bce"]
        if not cfg.ae:
            metrics["latent_loss"] = cfg.latent_loss * torch.mean(kl_diag_gaussian(out.mean, out.std))
            total = total + metrics["latent_loss"]
        metrics["regularization"] = l2_regularization(
            self.resnet_kernels(), cfg.resnet_weight_decay
        ).to(total.device)
        total = total + metrics["regularization"]
        metrics["loss"] = total
        return total, metrics

    def loss(self, batch: Batch, *, eps=None, generator=None, trunk_feat=None):
        """Train-mode forward and objective: ``(total, metrics)``. The BN
        running averages are updated in place."""
        out = self._forward(batch.mfcc, batch.video, train=True, eps=eps, generator=generator,
                            trunk_feat=trunk_feat)
        return self.objective(out, batch)

    def generate(self, mfcc, video, *, eps=None, generator=None) -> torch.Tensor:
        """(mfcc (N,12), video (N,224,298,3) in [0,1]) -> generated acoustic
        images (N,36,48,12) float32. The VAE noise is ``eps`` when given,
        else drawn from ``generator``."""
        with no_tf32():
            out = self._forward(mfcc, video, eps=eps, generator=generator)
        return out.output.to(torch.float32)
