"""Stride-16 ResNet-50 v1 trunk with the 12-channel ``conv_map`` head, in
eval mode (BN on running averages) or train mode (BN on batch statistics,
running averages updated in place).

Counterpart of ``acoustic_image_generation_tpu/models/resnet.py``:

- block1 and block4 have stride 1 (overall stride 16);
- the root 7x7/2 conv and each stride-2 3x3 conv use tf-slim's fixed
  padding (``conv2d_same_fixed_pad``); the other convs XLA "SAME";
- every conv has no bias and is followed by BN (eps 1e-5) and, unless
  disabled, ReLU; ``conv_map`` is a (3,4) VALID conv -> BN -> ReLU;
- identity shortcuts of a stride-2 unit are a 1x1 stride-2 max-pool, a
  plain subsample; projection shortcuts a 1x1 stride-2 conv without pad.

Input (N,224,298,3) -> 112x149 -> max-pool 3/2 VALID 55x74 -> 28x37 ->
14x19 -> conv_map 12x16x12. Module names mirror the flax scopes
(``block2_unit_4``, ``shortcut``, ``conv_map``).

Train mode follows flax's BatchNorm: statistics in f32 over (N, H, W) with
the fast variance ``max(E[x^2] - E[x]^2, 0)``, the biased batch variance in
the running average, ``running = 0.997*running + 0.003*batch``, eps 1e-5.
``F.batch_norm(training=True)`` would put the unbiased variance in the
running average, so it is not used. Options, as in JAX:

- ``freeze_trunk``: the trunk runs under ``torch.no_grad()`` (JAX's
  ``stop_gradient`` before ``conv_map``): no trunk activations are kept,
  and its BN statistics still update in train mode;
- ``trunk_bn_frozen``: the trunk's BNs use their running averages even in
  train mode; ``conv_map``'s BN follows ``train``;
- ``fused_bn_stats``: each train-mode 1x1 stride-1 conv (not fixed-pad)
  runs through ``ops.conv_stats`` (the ``matmul_stats`` kernel on the card)
  and applies BN with the statistics it returns, in the compute dtype
  (JAX's ``_Conv1x1Stats`` + ``_TrainBN``). The parameters are the same.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.models.layers import he_truncated_normal
from acoustic_image_generation_tpu_torch.ops.conv_stats import conv1x1_batch_stats
from acoustic_image_generation_tpu_torch.ops.tf_compat import conv2d_same_fixed_pad, conv2d_xla

# (base_depth, num_units, stride) per block.
RESNET50_BLOCKS = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 1))
BN_EPS = 1e-5
BN_MOMENTUM = 0.997


class BatchNorm(nn.Module):
    """BN over the last (channel) axis of NHWC, params and statistics in
    f32 (see the module docstring for train mode)."""

    def __init__(self, channels, eps, *, device=None):
        super().__init__()
        self.eps = eps
        f32 = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.empty((channels,), **f32))
        self.bias = nn.Parameter(torch.empty((channels,), **f32))
        self.register_buffer("running_mean", torch.empty((channels,), **f32))
        self.register_buffer("running_var", torch.empty((channels,), **f32))

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Running averages <- 0.997 * running + 0.003 * batch."""
        with torch.no_grad():
            m = BN_MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            y = F.batch_norm(
                x.permute(0, 3, 1, 2), self.running_mean, self.running_var,
                self.weight, self.bias, training=False, eps=self.eps,
            )
            return y.permute(0, 2, 3, 1)
        xf = x.float()
        mean = xf.mean(dim=(0, 1, 2))
        var = torch.clamp_min(xf.square().mean(dim=(0, 1, 2)) - mean.square(), 0.0)
        self.update(mean.detach(), var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)

    def forward_stats(self, y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
        """Train mode with statistics computed elsewhere, in ``y``'s dtype
        (JAX's ``_TrainBN``)."""
        self.update(mean.detach(), var.detach())
        dt = y.dtype
        inv = (self.weight * torch.rsqrt(var + self.eps)).to(dt)
        return (y - mean.to(dt)) * inv + self.bias.to(dt)


class ConvBN(nn.Module):
    """slim ``conv2d`` under ``resnet_arg_scope``: conv (no bias) -> BN
    [-> ReLU]. ``fixed_pad`` selects ``conv2d_same`` padding for stride 2."""

    def __init__(self, in_ch, out_ch, kernel=(1, 1), stride=1, *, relu=True, fixed_pad=False,
                 padding="SAME", fused_stats=False, device=None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.relu = relu
        self.fixed_pad = fixed_pad
        self.padding = padding
        self.fused_stats = fused_stats and not fixed_pad and tuple(kernel) == (1, 1) and stride == 1
        self.weight = nn.Parameter(
            torch.empty((out_ch, in_ch, *kernel), device=device, dtype=torch.float32)
            .contiguous(memory_format=torch.channels_last)
        )
        self.bn = BatchNorm(out_ch, BN_EPS, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _, i, kh, kw = self.weight.shape
        with torch.no_grad():
            self.weight.copy_(he_truncated_normal(self.weight.shape, i * kh * kw, generator))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        x = x.to(self.dtype)
        if train and self.fused_stats:
            y, mean, var = conv1x1_batch_stats(x.contiguous(), w.reshape(w.shape[0], -1).t())
            y = self.bn.forward_stats(y, mean, var)
        else:
            if self.fixed_pad:
                y = conv2d_same_fixed_pad(x, w, self.stride)
            else:
                y = conv2d_xla(x, w, None, self.stride, self.padding)
            y = self.bn(y, train)
        return F.relu(y) if self.relu else y


class BottleneckV1(nn.Module):
    """resnet_v1 bottleneck unit."""

    def __init__(self, in_ch, depth, depth_bottleneck, stride, *, fused_stats=False, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        fs = dict(kw, fused_stats=fused_stats)
        self.stride = stride
        if depth != in_ch:
            self.shortcut = ConvBN(in_ch, depth, (1, 1), stride, relu=False, **fs)
        else:
            self.shortcut = None
        self.conv1 = ConvBN(in_ch, depth_bottleneck, (1, 1), 1, **fs)
        self.conv2 = ConvBN(depth_bottleneck, depth_bottleneck, (3, 3), stride,
                            fixed_pad=stride > 1, **kw)
        self.conv3 = ConvBN(depth_bottleneck, depth, (1, 1), 1, relu=False, **fs)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.shortcut is not None:
            shortcut = self.shortcut(x, train)
        else:
            shortcut = x[:, :: self.stride, :: self.stride, :]
        residual = self.conv3(self.conv2(self.conv1(x, train), train), train)
        return F.relu(shortcut + residual)


class ResNet50(nn.Module):
    """Stride-16 ResNet-50 v1 with the 12-channel ``conv_map`` head."""

    def __init__(self, blocks=RESNET50_BLOCKS, *, freeze_trunk=False, trunk_bn_frozen=False,
                 fused_bn_stats=False, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dtype = dtype
        self.freeze_trunk = freeze_trunk
        self.trunk_bn_frozen = trunk_bn_frozen
        self.unit_names = []
        self.conv1 = ConvBN(3, 64, (7, 7), 2, fixed_pad=True, **kw)
        in_ch = 64
        for b, (base_depth, num_units, block_stride) in enumerate(blocks, start=1):
            for u in range(1, num_units + 1):
                stride = block_stride if u == num_units else 1
                name = f"block{b}_unit_{u}"
                self.add_module(name, BottleneckV1(in_ch, base_depth * 4, base_depth, stride,
                                                   fused_stats=fused_bn_stats, **kw))
                self.unit_names.append(name)
                in_ch = base_depth * 4
        self.conv_map = ConvBN(in_ch, 12, (3, 4), 1, padding="VALID", **kw)

    def forward(self, x: torch.Tensor, *, mode: str = "full", train: bool = False) -> torch.Tensor:
        """``mode``: "full" = trunk + conv_map; "trunk" = block4 output;
        "head" = ``x`` is a trunk feature, apply conv_map only. ``train``:
        BN on batch statistics, running averages updated in place."""
        if mode not in ("full", "trunk", "head"):
            raise ValueError(f"unknown mode {mode!r}")
        net = x.to(self.dtype)
        if mode != "head":
            with torch.no_grad() if self.freeze_trunk else contextlib.nullcontext():
                net = self._trunk(net, train and not self.trunk_bn_frozen)
            if mode == "trunk":
                return net
        return self.conv_map(net, train)

    def _trunk(self, net: torch.Tensor, train: bool) -> torch.Tensor:
        net = self.conv1(net, train)
        net = F.max_pool2d(net.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
        for name in self.unit_names:
            net = getattr(self, name)(net, train)
        return net
