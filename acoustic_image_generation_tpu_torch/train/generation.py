"""The inference half of the generation task: ResNet50 trunk (eval-mode BN)
-> ``conv_map`` feature + tiled MFCC map -> ``UNetAcResNet``.

Counterpart of ``acoustic_image_generation_tpu/train/generation.py::
GenerationTask`` (``__init__``, ``trunk_features``, ``_forward`` with
``train=False``, ``generate``). The weights live in the task's modules, on
one device, in the compute dtype (BN statistics in f32). They come from
``init_params(seed)`` or from the JAX package's variables through
``bridge.load_flax``. Losses, the optimizer and the train step belong to the
training slice.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.nn as nn

from acoustic_image_generation_tpu_torch import resolve_device
from acoustic_image_generation_tpu_torch.data.preprocess import tile_mfccmap
from acoustic_image_generation_tpu_torch.models.resnet import ResNet50
from acoustic_image_generation_tpu_torch.models.unet_ac import UNetAcResNet, VaeOutput

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    """The fields of the JAX ``ExperimentConfig`` that the serving path
    reads (``model.num_skip_conn``, ``model.ae``, ``model.resnet_units``,
    ``parallel.compute_dtype``). The CLI's default compute dtype is
    bfloat16. ``generate`` turns TF32 off for its cuBLAS and cuDNN calls, so
    float32 is IEEE float32 on CUDA too."""

    num_skip_conn: int = 1
    ae: bool = False
    resnet_units: tuple[int, int, int, int] = (3, 4, 6, 3)
    compute_dtype: str = "bfloat16"


class GenerationTask(nn.Module):
    def __init__(self, config: GenerationConfig = GenerationConfig(), *, device=None):
        super().__init__()
        if config.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute dtype {config.compute_dtype!r}")
        self.cfg = config
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.compute_dtype]
        u = config.resnet_units
        blocks = ((64, u[0], 1), (128, u[1], 2), (256, u[2], 2), (512, u[3], 1))
        kw = dict(device=self.device, dtype=self.dtype)
        self.resnet = ResNet50(blocks, **kw)
        self.generator = UNetAcResNet(skips=config.num_skip_conn, embedding=config.ae, **kw)
        # inference only: nothing here is differentiated
        self.requires_grad_(False)

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

    def trunk_features(self, video: torch.Tensor) -> torch.Tensor:
        """Block4 output (N,14,19,2048) in the compute dtype."""
        with no_tf32():
            return self.resnet(video, mode="trunk")

    def _forward(self, mfcc, video, *, eps=None, generator=None, trunk_feat=None) -> VaeOutput:
        if trunk_feat is None:
            feat = self.resnet(video, mode="full")
        else:
            feat = self.resnet(trunk_feat, mode="head")
        mfccmap = tile_mfccmap(mfcc).to(self.dtype)
        return self.generator(mfccmap, feat, eps=eps, generator=generator)

    def generate(self, mfcc, video, *, eps=None, generator=None) -> torch.Tensor:
        """(mfcc (N,12), video (N,224,298,3) in [0,1]) -> generated acoustic
        images (N,36,48,12) float32. The VAE noise is ``eps`` when given,
        else drawn from ``generator``."""
        with no_tf32():
            out = self._forward(mfcc, video, eps=eps, generator=generator)
        return out.output.to(torch.float32)
