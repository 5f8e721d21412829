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

Train mode follows flax's BatchNorm (``layers.BatchNorm``): statistics in
f32, the biased batch variance in the running average,
``running = 0.997*running + 0.003*batch``, eps 1e-5. Options, as in JAX:

- ``freeze_trunk``: the trunk runs under ``torch.no_grad()`` (JAX's
  ``stop_gradient`` before ``conv_map``): no trunk activations are kept,
  and its BN statistics still update in train mode;
- ``trunk_bn_frozen``: the trunk's BNs use their running averages even in
  train mode; ``conv_map``'s BN follows ``train``;
- ``fused_bn_stats``: each train-mode 1x1 stride-1 conv (not fixed-pad)
  runs through ``ops.conv_stats`` (the ``matmul_stats`` kernel on the card)
  and applies BN with the statistics it returns, in the compute dtype
  (JAX's ``_Conv1x1Stats`` + ``_TrainBN``). The parameters are the same.

Under tensor parallelism (``parallel/mesh.py``) a ``ConvBN`` whose kernel
is split holds its block of the output channels: the conv (or the
``matmul_stats`` product, on the local columns, with their column sums)
runs on them after ``sum_input_grad``, ``gather_channels`` makes the whole
map (and the whole mean and variance), and the BN runs on it, replicated.

Under spatial sharding (``parallel/spatial.py``) ``trunk_rows`` and
``conv_map_rows`` run the eval-mode trunk and ``conv_map`` on a request's
row blocks: every conv and the max-pool give each shard its own rows of
their output, from the input window those rows read (the halo from the
neighbouring shards, zero rows at the image border as the layer's padding);
the 1x1 convs read only their own rows, and a stride-2 shortcut reads the
even global rows. Each shard runs the layer's copy on its own device
(``spatial.replicas``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.models.layers import BatchNorm, he_truncated_normal
from acoustic_image_generation_tpu_torch.ops.conv_stats import conv1x1_batch_stats
from acoustic_image_generation_tpu_torch.ops.tf_compat import (
    conv2d_same_fixed_pad,
    conv2d_xla,
    conv_nhwc,
    fixed_pads,
    same_pads,
)
from acoustic_image_generation_tpu_torch.parallel import mesh, spatial

# (base_depth, num_units, stride) per block.
RESNET50_BLOCKS = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 1))
BN_EPS = 1e-5
BN_MOMENTUM = 0.997


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
        self.bn = BatchNorm(out_ch, BN_EPS, BN_MOMENTUM, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _, i, kh, kw = self.weight.shape
        with torch.no_grad():
            self.weight.copy_(he_truncated_normal(self.weight.shape, i * kh * kw, generator))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        x = x.to(self.dtype)
        split = mesh.tp_dim(self.weight) is not None
        if split:
            x = mesh.sum_input_grad(x)
        if train and self.fused_stats:
            y, mean, var = conv1x1_batch_stats(x.contiguous(), w.reshape(w.shape[0], -1).t())
            if split:
                y = mesh.gather_channels(y)
                mean, var = mesh.gather_channels(torch.stack([mean, var])).unbind()
            y = self.bn.forward_stats(y, mean, var)
        else:
            if self.fixed_pad:
                y = conv2d_same_fixed_pad(x, w, self.stride)
            else:
                y = conv2d_xla(x, w, None, self.stride, self.padding)
            y = self.bn(mesh.gather_channels(y) if split else y, train)
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
        self.blocks = tuple(blocks)
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


# ------------------------------------------------------ spatial sharding


def conv_bn_rows(x: spatial.Rows, convs: list, name: str) -> spatial.Rows:
    """``ConvBN.forward`` in eval mode on row blocks; ``convs[i]`` is the
    layer on shard ``i``'s device. The row padding is the whole image's
    (tf-slim's fixed pad, or XLA "SAME" over the whole height)."""
    c = convs[0]
    kh, kw = c.weight.shape[2:]
    if c.fixed_pad:
        hp, wp = fixed_pads(kh), fixed_pads(kw)
    elif c.padding == "VALID":
        hp = wp = (0, 0)
    else:
        hp, wp = same_pads(x.height, kh, c.stride), same_pads(x.width, kw, c.stride)

    def run(i, win):
        m = convs[i]
        y = m.bn(conv_nhwc(win.to(m.dtype), m.weight.to(m.dtype), None, m.stride, ((0, 0), wp)), False)
        return F.relu(y) if m.relu else y

    return spatial.layer(x, kh, c.stride, hp, run, name)


def _max_pool(i, win):
    return F.max_pool2d(win.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)


def trunk_rows(replicas: list, x: spatial.Rows) -> spatial.Rows:
    """``ResNet50(mode="trunk")`` in eval mode on row blocks: ``replicas[i]``
    is the ResNet50 on shard ``i``'s device, ``x`` the video's rows."""
    net = x.map(lambda i, b: b.to(replicas[i].dtype))
    net = conv_bn_rows(net, [r.conv1 for r in replicas], "conv1")
    net = spatial.layer(net, 3, 2, (0, 0), _max_pool, "pool1")
    for name in replicas[0].unit_names:
        units = [getattr(r, name) for r in replicas]
        stride = units[0].stride
        if units[0].shortcut is not None:
            shortcut = conv_bn_rows(net, [u.shortcut for u in units], f"{name}/shortcut")
        elif stride > 1:  # rows at even global indices: each window starts at one
            shortcut = spatial.layer(net, 1, stride, (0, 0), lambda i, w, s=stride: w[:, ::s, ::s], f"{name}/subsample")
        else:
            shortcut = net
        r = conv_bn_rows(net, [u.conv1 for u in units], f"{name}/conv1")
        r = conv_bn_rows(r, [u.conv2 for u in units], f"{name}/conv2")
        r = conv_bn_rows(r, [u.conv3 for u in units], f"{name}/conv3")
        net = shortcut.zip(r, lambda i, a, b: F.relu(a + b))
    return net


def conv_map_rows(replicas: list, feat: spatial.Rows) -> spatial.Rows:
    """``ResNet50(mode="head")`` in eval mode on row blocks of a trunk
    feature."""
    return conv_bn_rows(feat.map(lambda i, b: b.to(replicas[i].dtype)), [r.conv_map for r in replicas], "conv_map")
