"""Latent -> modality decoders and ``MeanStd``, on NHWC.

Counterpart of ``acoustic_image_generation_tpu/models/decoders.py``, which
no task builds (nor did the reference's trainers): standalone decoders
that render a latent straight into a video frame, an energy map or a
waveform, and the batch norm with a learned offset and no scale. Every
decoder is two ReLU dense layers (glorot, zero bias), a reshape to
(H, W, 1) and a stack of stride-1 SAME convs (glorot), ReLU unless noted:

- ``DecoderVideo``: dense 36*48, 224*298 -> (224, 298, 1) -> 3x3 convs 8,
  64, 512, 128, 64, 32, 16 -> 8 (linear) -> 3 (sigmoid);
- ``DecoderEnergy``: dense 12*16, 36*48 -> (36, 48, 1) -> 5x5 convs 64,
  32, 16, then 3x3 convs 8, 4, 2, 1;
- ``DecoderAudio``: dense 1024, 12288 -> (12288, 1, 1) -> tall convs 128
  (1024x1), 64 (512x1), 32 (128x1), 16 (32x1), 8 (16x1), 4 (3x1), 1 (1x1).

The port's modules are built with their input width (JAX infers it at
init): ``in_features``, the latent's size flattened. Module names mirror
the flax scopes (``fc_0``, ``fc_1``, ``conv_0``...; ``MeanStd``'s
``BatchNorm_0``), so ``bridge.load_flax`` and ``to_flax`` carry the trees.

``MeanStd`` is flax's ``BatchNorm(momentum=0.999, epsilon=1e-3,
use_scale=False)``: statistics over every axis but the last, in f32, the
fast variance ``max(E[x^2] - E[x]^2, 0)`` and the biased batch variance in
the running average in train mode, the running averages in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.models.layers import Conv2d, Dense

MEAN_STD_MOMENTUM = 0.999
MEAN_STD_EPS = 1e-3


class FCConvDecoder(nn.Module):
    """Two ReLU dense layers of ``fc_sizes`` -> reshape to ``grid`` x 1 ->
    SAME convs, each ``(features, kernel, activation)`` with activation
    "relu", "linear" or "sigmoid"."""

    def __init__(self, in_features: int, fc_sizes, grid, convs, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.grid = tuple(grid)
        self.acts = [act for _, _, act in convs]
        widths = (in_features, *fc_sizes)
        for i in range(len(fc_sizes)):
            self.add_module(f"fc_{i}", Dense(widths[i], widths[i + 1], **kw))
        in_ch = 1
        for i, (features, kernel, _) in enumerate(convs):
            self.add_module(f"conv_{i}", Conv2d(in_ch, features, tuple(kernel), **kw))
            in_ch = features

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        net = z.reshape(z.shape[0], -1)
        i = 0
        while hasattr(self, f"fc_{i}"):
            net = F.relu(getattr(self, f"fc_{i}")(net))
            i += 1
        net = net.reshape(-1, *self.grid, 1)
        for i, act in enumerate(self.acts):
            net = getattr(self, f"conv_{i}")(net)
            if act == "relu":
                net = F.relu(net)
            elif act == "sigmoid":
                net = torch.sigmoid(net)
        return net


def DecoderVideo(in_features: int, *, device=None, dtype=torch.float32) -> FCConvDecoder:
    """Latent -> 224x298x3 sigmoid frame."""
    convs = [(c, (3, 3), "relu") for c in (8, 64, 512, 128, 64, 32, 16)] + [(8, (3, 3), "linear"),
                                                                          (3, (3, 3), "sigmoid")]
    return FCConvDecoder(in_features, (36 * 48, 224 * 298), (224, 298), convs, device=device, dtype=dtype)


def DecoderEnergy(in_features: int, *, device=None, dtype=torch.float32) -> FCConvDecoder:
    """Latent -> 36x48x1 energy map (final ReLU)."""
    convs = [(c, (5, 5), "relu") for c in (64, 32, 16)] + [(c, (3, 3), "relu") for c in (8, 4, 2, 1)]
    return FCConvDecoder(in_features, (12 * 16, 36 * 48), (36, 48), convs, device=device, dtype=dtype)


def DecoderAudio(in_features: int, *, device=None, dtype=torch.float32) -> FCConvDecoder:
    """Latent -> 12288x1x1 waveform (one second at 12288 Hz)."""
    convs = [(c, (k, 1), "relu") for c, k in ((128, 1024), (64, 512), (32, 128), (16, 32), (8, 16), (4, 3), (1, 1))]
    return FCConvDecoder(in_features, (1024, 12288), (12288, 1), convs, device=device, dtype=dtype)


class CenterBatchNorm(nn.Module):
    """flax ``BatchNorm`` with ``use_scale=False``: a learned ``bias`` and
    the running ``running_mean``/``running_var`` (flax: params ``bias``,
    batch_stats ``mean``, ``var``), over the last axis."""

    def __init__(self, channels: int, eps: float, momentum: float, *, device=None):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        f32 = dict(device=device, dtype=torch.float32)
        self.bias = nn.Parameter(torch.zeros((channels,), **f32))
        self.register_buffer("running_mean", torch.zeros((channels,), **f32))
        self.register_buffer("running_var", torch.ones((channels,), **f32))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        xf = x.float()
        if train:
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=dims)
            var = torch.clamp_min(xf.square().mean(dim=dims) - mean.square(), 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return ((xf - mean) * torch.rsqrt(var + self.eps) + self.bias).to(x.dtype)


class MeanStd(nn.Module):
    """``meanvariance.mean_std``: batch norm with a learned offset and no
    scale, decay 0.999, eps 1e-3, over the last axis of ``channels``."""

    def __init__(self, channels: int, *, device=None):
        super().__init__()
        self.BatchNorm_0 = CenterBatchNorm(channels, MEAN_STD_EPS, MEAN_STD_MOMENTUM, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``train``: batch statistics, the running averages updated in
        place (JAX's ``use_running_average=False``)."""
        return self.BatchNorm_0(x, train)
