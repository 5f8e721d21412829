"""The generation task: ResNet50 trunk -> ``conv_map`` feature + tiled MFCC
map -> ``UNetAcResNet``, with its loss for training.

Counterpart of ``acoustic_image_generation_tpu/train/generation.py::
GenerationTask`` (``__init__``, ``param_labels``, ``trunk_features``,
``_forward``, ``loss``, ``eval_losses``, ``generate``, ``build_qtrunk``). The
parameters are f32 masters in the task's modules, on one device; every
layer computes in the compute dtype (BN statistics stay f32). They come from
``init_params(seed)`` or from the JAX package's variables through
``bridge.load_flax``.

As in JAX the trunk is frozen (``freeze_trunk``): only the generator and
``resnet.conv_map`` train, and their parameters alone require grad. With
``trunk_bn="train"`` (the default) the trunk's BN statistics still update
in every train forward.

``trunk_quant="int8"`` (with ``trunk_bn="frozen"``, which the BN folding
needs) runs the frozen trunk as the BN-folded W8A8 program of
``models/quant.py``. Its ``QuantTrunk`` is built once (``build_qtrunk``,
calibrated on normalized frames) and passed to ``loss``, ``eval_losses`` and
``generate`` as ``qtrunk``; the features then take the head-only path, so
``conv_map``'s BN statistics and gradients are those of the f32 trunk's
path. ``fused_qgemm`` puts every 1x1 trunk conv on the ``qgemm_s8`` kernel.
The L2 term still covers the f32 trunk kernels, as in JAX.

Under tensor parallelism (``split_modules``) the trunk's wide convs hold
their block of the output channels on each rank of a model group; the
int8 trunk is built whole from them (``models/quant.py``).
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
from acoustic_image_generation_tpu_torch.models.layers import init_modules
from acoustic_image_generation_tpu_torch.models.quant import QuantTrunk, calibrate, quantize_trunk, trunk_forward
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
    ``model.trunk_bn``, ``model.trunk_quant``, ``model.fused_qgemm``,
    ``data.correspondence``, ``data.correspondence_video``,
    ``data.datatype``, ``parallel.compute_dtype``, ``optim.learning_rate``,
    ``optim.latent_loss``, ``optim.mse``, ``optim.huber``, ``optim.bce``,
    ``optim.resnet_weight_decay``, ``run.seed`` and the feature cache's
    ``model.cache_*`` fields, with JAX's defaults
    (bfloat16 is the CLI's default compute dtype). float32 work runs
    without TF32, so float32 is IEEE float32 on CUDA too."""

    num_skip_conn: int = 1
    ae: bool = False
    resnet_units: tuple[int, int, int, int] = (3, 4, 6, 3)
    trunk_bn: str = "train"  # train | frozen: trunk BN on batch or running statistics
    trunk_quant: str = "none"  # none | int8: the frozen trunk as a BN-folded W8A8 program
    fused_qgemm: bool = False  # int8: every 1x1 trunk conv on the qgemm_s8 kernel
    correspondence: bool = False  # the trainer doubles each batch (data/preprocess.py)
    correspondence_video: bool = False  # ... zeroing the second half's video, not the silence map
    datatype: str = "outdoor"  # music: the shuffled-pair correspondence
    compute_dtype: str = "bfloat16"
    learning_rate: float = 1e-4
    latent_loss: float = 1e-6
    mse: bool = True
    huber: bool = True
    bce: bool = False
    resnet_weight_decay: float = 5e-4
    seed: int = 0
    # the frozen-trunk feature cache (train/feature_cache.py); on only with
    # trunk_bn="frozen" and no correspondence augmentation
    cache_trunk_features: bool = False
    cache_device_bytes: int = 4 << 30  # the device pool's budget; 0: no pool
    cache_eval_bytes: int = 8 << 30  # each eval loader's host cache; 0: none
    cache_disk_dir: str | None = None  # the cross-run disk tier's root
    cache_disk_bytes: int = 256 << 30  # byte cap of one disk store
    cache_features_dtype: str = "bf16"  # bf16: what the trunk produces | f8_e4m3


class GenerationTask(nn.Module):
    reads_mfcc = True  # the generator's input: the trainer's batches compute it
    eval_metric = "mse"  # the eval loss that gates the best epoch

    def __init__(self, config: GenerationConfig = GenerationConfig(), *, device=None):
        super().__init__()
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute dtype {config.compute_dtype!r}")
        if config.trunk_bn not in ("train", "frozen"):
            raise ValueError(f"trunk_bn must be 'train' or 'frozen', got {config.trunk_bn!r}")
        if config.trunk_quant not in ("none", "int8"):
            raise ValueError(f"unknown trunk_quant {config.trunk_quant!r}")
        if config.trunk_quant == "int8" and config.trunk_bn != "frozen":
            raise ValueError('trunk_quant="int8" requires trunk_bn="frozen"')
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

    def trained_modules(self) -> tuple[nn.Module, ...]:
        """The modules whose parameters train (FSDP shards each): ``conv_map``
        and the generator."""
        return self.resnet.conv_map, self.generator

    def split_modules(self) -> tuple[nn.Module, ...]:
        """The modules that hold every kernel JAX's ``tp_sharding`` splits
        under tensor parallelism (``parallel/mesh.py``): the trunk's convs of
        256 to 2048 outputs. They are frozen, so the split runs forward
        collectives only; ``conv_map`` (12 outputs) and the generator (at
        most 133) stay whole."""
        return (self.resnet,)

    def global_noise(self, frames: int, generator: torch.Generator, *, train: bool = True) -> torch.Tensor | None:
        """The VAE noise of a global batch of ``frames`` frames (the doubled
        batch's with the correspondence augmentation), as one device draws
        it, in a train step and in eval alike; None for the deterministic AE,
        which draws nothing."""
        if self.cfg.ae:
            return None
        return torch.randn((frames, self.generator.vae.latent_dim), generator=generator, device=self.device)

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
        init_modules(self, seed)
        return self

    def resnet_kernels(self) -> list[torch.Tensor]:
        """The ResNet's conv kernels (trunk and ``conv_map``), the leaves the
        L2 term covers."""
        return [m.weight for m in self.resnet.modules() if isinstance(m, ConvBN)]

    def trunk_features(self, video: torch.Tensor, qtrunk: QuantTrunk | None = None) -> torch.Tensor:
        """Block4 output (N,14,19,2048) in the compute dtype, eval-mode BN;
        with ``qtrunk`` (a calibrated ``QuantTrunk``) through the int8
        program, which quantizes the f32 ``video`` itself."""
        if qtrunk is not None:
            with torch.no_grad():
                feat, _ = trunk_forward(qtrunk, video, out_dtype=self.dtype,
                                        fused_gemm=self.cfg.fused_qgemm)
            return feat
        with no_tf32():
            return self.resnet(video, mode="trunk")

    def trunk_state(self) -> dict[str, torch.Tensor]:
        """Everything ``trunk_features`` depends on without an int8 trunk:
        the frozen backbone's parameters and BN statistics, without the
        trained heads. The disk feature tier fingerprints it."""
        return {name: t for name, t in [*self.resnet.named_parameters(), *self.resnet.named_buffers()]
                if name.split(".")[0] not in TRAINED_RESNET_HEADS}

    def build_qtrunk(self, video: torch.Tensor) -> QuantTrunk:
        """Fold, quantize and calibrate the int8 trunk from the ResNet's
        current (frozen) weights, on ``video``: normalized frames
        (N,224,298,3) f32."""
        return calibrate(quantize_trunk(self.resnet), video)

    def _forward(self, mfcc, video, *, train: bool = False, eps=None, generator=None,
                 trunk_feat=None, qtrunk=None, map_feat=None) -> VaeOutput:
        """The forward pass. ``train``: BN on batch statistics, the running
        averages of every train-mode BN updated in place (JAX returns them as
        new ``batch_stats``); the VAE noise must then come from ``eps`` or
        ``generator``. ``qtrunk``: the trunk runs as the int8 program and its
        features take the head-only path. ``map_feat``: ``conv_map``'s
        output (N,12,16,12), computed elsewhere (the spatially split trunk of
        ``serving.py``); the ResNet does not run."""
        if train and not self.cfg.ae and eps is None and generator is None:
            raise ValueError("a train forward samples the VAE noise: pass eps or generator")
        if trunk_feat is None and qtrunk is not None and map_feat is None:
            trunk_feat = self.trunk_features(video, qtrunk)
        if map_feat is not None:
            feat = map_feat
        elif trunk_feat is None:
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

    def loss(self, batch: Batch, *, eps=None, generator=None, trunk_feat=None, qtrunk=None, moddrop=None):
        """Train-mode forward and objective: ``(total, metrics)``. The BN
        running averages are updated in place. ``moddrop`` is the embedding
        task's and means nothing here."""
        del moddrop
        out = self._forward(batch.mfcc, batch.video, train=True, eps=eps, generator=generator,
                            trunk_feat=trunk_feat, qtrunk=qtrunk)
        return self.objective(out, batch)

    def forward(self, batch: Batch, **kw):
        """``loss``: the train step's forward, through which
        ``DistributedDataParallel`` wraps the task on more than one rank."""
        return self.loss(batch, **kw)

    def eval_losses(self, batch: Batch, *, eps=None, generator=None, qtrunk=None, trunk_feat=None):
        """Per-frame eval losses, eval-mode forward: ``({"mse": (N,),
        "mse0".."mse3": (N,)}, recon (N,36,48,12) f32)``, the MSE over each
        frame and over each group of three channels (JAX's ``eval_losses``).
        ``trunk_feat`` (cached trunk features) bypasses the trunk."""
        with no_tf32():
            out = self._forward(batch.mfcc, batch.video, eps=eps, generator=generator, qtrunk=qtrunk,
                                trunk_feat=trunk_feat)
        recon = out.output.float()
        err = torch.square(recon - batch.acoustic)
        losses = {"mse": err.mean(dim=(1, 2, 3))}
        for i in range(4):
            losses[f"mse{i}"] = err[..., 3 * i: 3 * i + 3].mean(dim=(1, 2, 3))
        return losses, recon

    def generate(self, mfcc, video, *, eps=None, generator=None, qtrunk=None, map_feat=None) -> torch.Tensor:
        """(mfcc (N,12), video (N,224,298,3) in [0,1]) -> generated acoustic
        images (N,36,48,12) float32. The VAE noise is ``eps`` when given,
        else drawn from ``generator``; ``qtrunk`` runs the int8 trunk;
        ``map_feat``, ``conv_map``'s output computed elsewhere, replaces the
        ResNet (``video`` is then not read)."""
        with no_tf32():
            out = self._forward(mfcc, video, eps=eps, generator=generator, qtrunk=qtrunk, map_feat=map_feat)
        return out.output.to(torch.float32)
