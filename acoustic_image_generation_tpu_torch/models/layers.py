"""Layers with TF-1 initializers and shape rules, on NHWC tensors.

Counterpart of ``acoustic_image_generation_tpu/models/layers.py``. Every
module takes and returns NHWC (the JAX layout); convs run on the NCHW view
with channels-last memory. Parameters are f32 masters on the module's
device, as flax's ``param_dtype=float32``; each module computes in its
``dtype`` and casts the masters to it in ``forward``. In torch layout:

- ``Conv2d``: OIHW weight, bias (flax ``nn.Conv``: HWIO kernel);
- ``BatchNorm``: weight, bias, running_mean, running_var (flax: scale,
  bias; batch_stats mean, var);
- ``Dense``: ``nn.Linear``, weight (out, in) (flax: (in, out));
- ``ConvTransposeTF``: weight (in, out, kh, kw) (flax: HWIO, unflipped).

Under tensor parallelism (``parallel/mesh.py``) a ``Conv2d`` or
``ConvTransposeTF`` whose weight is split (``mesh.split_``: its block of
the output channels, dim 0 or dim 1) runs as a column-parallel layer:
``sum_input_grad`` on the input and on the bias, the conv on the local
channels with their slice of the bias (added before the output's one
rounding, as one device adds it), then ``gather_channels``. The bias stays
whole and replicated, as JAX keeps 1-D leaves: each peer's gradient of it
covers its slice, and ``sum_input_grad`` sums them into the whole one. A
frozen split layer (no gradient of its own) still sums its input's
gradient where the input requires one: the joint task's frozen video
decoder passes the trained associator its whole gradient.

``reset_parameters(generator)`` draws the JAX initializers' distributions
from a CPU ``torch.Generator``: glorot-uniform (``tf.layers`` and
``xavier_initializer``) with zero biases, or, for ``Conv2d`` and ``Dense``
built with ``init="trunc_normal_001"`` (DualCamNet's ``models/base.py``
layers), a normal of stddev 0.01 truncated at two stddevs, not rescaled.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.ops.tf_compat import conv2d_xla, conv_transpose_tf
from acoustic_image_generation_tpu_torch.parallel import mesh


def glorot_uniform(shape, fan_in: int, fan_out: int, generator: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


def he_truncated_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """``variance_scaling(2.0, "fan_in", "truncated_normal")``: a standard
    normal truncated to [-2, 2], scaled by sqrt(2/fan_in)/0.8796..."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * std


def trunc_normal_001(shape, generator: torch.Generator) -> torch.Tensor:
    """``tf.truncated_normal_initializer(0.0, 0.01)``: a standard normal
    truncated to [-2, 2], times 0.01 (JAX's ``truncated_normal(0.01)``)."""
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * 0.01


def _init_kernel(init: str, shape, fan_in: int, fan_out: int, generator: torch.Generator) -> torch.Tensor:
    if init == "glorot":
        return glorot_uniform(shape, fan_in, fan_out, generator)
    if init == "trunc_normal_001":
        return trunc_normal_001(shape, generator)
    raise ValueError(f"unknown init {init!r}")


def init_modules(root: nn.Module, seed: int) -> None:
    """``reset_parameters`` of every submodule of ``root`` that has one, in
    module order, from one CPU generator seeded with ``seed``: a task's
    random weights with the JAX initializers' distributions."""
    g = torch.Generator().manual_seed(seed)
    for m in root.modules():
        if m is not root and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)


def split_conv(conv, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A column-parallel conv: ``conv(x, b)`` on this rank's output
    channels, ``b`` its slice of the whole ``bias``, gathered whole over the
    model group."""
    c = bias.shape[0] // mesh.model_world()
    b = mesh.sum_input_grad(bias).narrow(0, mesh.model_rank() * c, c)
    return mesh.gather_channels(conv(mesh.sum_input_grad(x), b))


def minmax_norm(x: torch.Tensor, dims) -> torch.Tensor:
    """Per-sample min-max onto [0, 1] over ``dims``. No epsilon, as in the
    reference: a constant input gives NaN."""
    x = x - torch.amin(x, dim=dims, keepdim=True)
    return x / torch.amax(x, dim=dims, keepdim=True)


class Conv2d(nn.Module):
    """``tf.layers.conv2d``: XLA "SAME" or "VALID" padding, glorot init."""

    def __init__(self, in_ch, out_ch, kernel_size=(3, 3), stride=1, padding="SAME",
                 *, device=None, dtype=torch.float32, init="glorot"):
        super().__init__()
        kh, kw = kernel_size
        self.dtype = dtype
        self.init = init
        self.stride = stride
        self.padding = padding.upper()
        if self.padding not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        self.weight = nn.Parameter(
            torch.empty((out_ch, in_ch, kh, kw), device=device, dtype=torch.float32)
            .contiguous(memory_format=torch.channels_last)
        )
        self.bias = nn.Parameter(torch.empty((out_ch,), device=device, dtype=torch.float32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        o, i, kh, kw = self.weight.shape
        with torch.no_grad():
            self.weight.copy_(_init_kernel(self.init, self.weight.shape, i * kh * kw, o * kh * kw, generator))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if mesh.tp_dim(self.weight) is not None:
            w = self.weight.to(dt)
            return split_conv(lambda v, b: conv2d_xla(v, w, b, self.stride, self.padding), x.to(dt),
                              self.bias.to(dt))
        return conv2d_xla(
            x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride, self.padding
        )


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last (channel) axis of NHWC, params
    and statistics in f32. ``momentum`` is flax's, the weight of the running
    average (torch's ``momentum`` is one minus it): 0.997 with eps 1e-5 in
    the ResNet trunk, 0.99 with eps 1e-3 in the UNets
    (``tf.layers.batch_normalization``'s defaults).

    Train mode (``forward(x, train=True)``) follows flax: statistics in f32
    over (N, H, W) with the fast variance ``max(E[x^2] - E[x]^2, 0)``, the
    biased batch variance in the running average, updated in place, and the
    output in ``x``'s dtype. ``F.batch_norm(training=True)`` would put the
    unbiased variance in the running average, so it is not used.

    With more than one data rank (``parallel/mesh.py``) the statistics
    cover the global batch, as JAX's over its ``data`` mesh:
    ``mesh.global_moments`` of the per-channel sums, sums of squares and
    counts, so the running averages come out equal on every rank. Under
    tensor parallelism a BN after a split conv runs on the gathered whole
    map, replicated on the model group's peers."""

    def __init__(self, channels, eps: float, momentum: float, *, device=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
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
        """Running averages <- momentum * running + (1 - momentum) * batch."""
        with torch.no_grad():
            m = self.momentum
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
        if mesh.data_world() > 1:
            mean, var = mesh.global_moments(xf.sum(dim=(0, 1, 2)), xf.square().sum(dim=(0, 1, 2)),
                                            xf.numel() // xf.shape[-1])
        else:
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


class Dense(nn.Linear):
    """``tf.layers.dense``: glorot init, zero bias; f32 masters, computes in
    ``dtype``."""

    def __init__(self, in_features, out_features, *, device=None, dtype=torch.float32, init="glorot"):
        super().__init__(in_features, out_features, device=device, dtype=torch.float32)
        self.dtype = dtype
        self.init = init

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if generator is None:  # nn.Linear's constructor; init_params fills it
            return
        o, i = self.weight.shape
        with torch.no_grad():
            self.weight.copy_(_init_kernel(self.init, self.weight.shape, i, o, generator))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return torch.nn.functional.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class ConvTransposeTF(nn.Module):
    """``tf.layers.conv2d_transpose`` with VALID padding (see
    ``ops.tf_compat.conv_transpose_tf``)."""

    def __init__(self, in_ch, out_ch, kernel_size=(2, 2), strides=(2, 2),
                 *, device=None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.strides = tuple(strides)
        self.weight = nn.Parameter(
            torch.empty((in_ch, out_ch, *kernel_size), device=device, dtype=torch.float32)
            .contiguous(memory_format=torch.channels_last)
        )
        self.bias = nn.Parameter(torch.empty((out_ch,), device=device, dtype=torch.float32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        i, o, kh, kw = self.weight.shape
        with torch.no_grad():
            self.weight.copy_(glorot_uniform(self.weight.shape, i * kh * kw, o * kh * kw, generator))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if mesh.tp_dim(self.weight) is not None:
            w = self.weight.to(dt)
            return split_conv(lambda v, b: conv_transpose_tf(v, w, self.strides, bias=b), x.to(dt),
                              self.bias.to(dt))
        return conv_transpose_tf(x.to(dt), self.weight.to(dt), self.strides, bias=self.bias.to(dt))
