"""Layers with TF-1 initializers and shape rules, on NHWC tensors.

Counterpart of ``acoustic_image_generation_tpu/models/layers.py``. Every
module takes and returns NHWC (the JAX layout); convs run on the NCHW view
with channels-last memory. Weights live in the compute dtype on the
module's device, in torch layout:

- ``Conv2d``: OIHW weight, bias (flax ``nn.Conv``: HWIO kernel);
- ``Dense``: ``nn.Linear``, weight (out, in) (flax: (in, out));
- ``ConvTransposeTF``: weight (in, out, kh, kw) (flax: HWIO, unflipped).

``reset_parameters(generator)`` draws the JAX initializers' distributions
from a CPU ``torch.Generator``: glorot-uniform (``tf.layers`` and
``xavier_initializer``) with zero biases.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from acoustic_image_generation_tpu_torch.ops.tf_compat import conv2d_xla, conv_transpose_tf


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


def minmax_norm(x: torch.Tensor, dims) -> torch.Tensor:
    """Per-sample min-max onto [0, 1] over ``dims``. No epsilon, as in the
    reference: a constant input gives NaN."""
    x = x - torch.amin(x, dim=dims, keepdim=True)
    return x / torch.amax(x, dim=dims, keepdim=True)


class Conv2d(nn.Module):
    """``tf.layers.conv2d``: XLA "SAME" or "VALID" padding, glorot init."""

    def __init__(self, in_ch, out_ch, kernel_size=(3, 3), stride=1, padding="SAME",
                 *, device=None, dtype=torch.float32):
        super().__init__()
        kh, kw = kernel_size
        self.stride = stride
        self.padding = padding.upper()
        if self.padding not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        self.weight = nn.Parameter(
            torch.empty((out_ch, in_ch, kh, kw), device=device, dtype=dtype)
            .contiguous(memory_format=torch.channels_last)
        )
        self.bias = nn.Parameter(torch.empty((out_ch,), device=device, dtype=dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        o, i, kh, kw = self.weight.shape
        with torch.no_grad():
            self.weight.copy_(glorot_uniform(self.weight.shape, i * kh * kw, o * kh * kw, generator))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_xla(x.to(self.weight.dtype), self.weight, self.bias, self.stride, self.padding)


class Dense(nn.Linear):
    """``tf.layers.dense``: glorot init, zero bias."""

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if generator is None:  # nn.Linear's constructor; init_params fills it
            return
        o, i = self.weight.shape
        with torch.no_grad():
            self.weight.copy_(glorot_uniform(self.weight.shape, i, o, generator))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class ConvTransposeTF(nn.Module):
    """``tf.layers.conv2d_transpose`` with VALID padding (see
    ``ops.tf_compat.conv_transpose_tf``)."""

    def __init__(self, in_ch, out_ch, kernel_size=(2, 2), strides=(2, 2),
                 *, device=None, dtype=torch.float32):
        super().__init__()
        self.strides = tuple(strides)
        self.weight = nn.Parameter(
            torch.empty((in_ch, out_ch, *kernel_size), device=device, dtype=dtype)
            .contiguous(memory_format=torch.channels_last)
        )
        self.bias = nn.Parameter(torch.empty((out_ch,), device=device, dtype=dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        i, o, kh, kw = self.weight.shape
        with torch.no_grad():
            self.weight.copy_(glorot_uniform(self.weight.shape, i * kh * kw, o * kh * kw, generator))
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose_tf(x.to(self.weight.dtype), self.weight, self.strides, bias=self.bias)
