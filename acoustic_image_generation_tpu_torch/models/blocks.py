"""UNet building blocks: ``ConvConvPool`` (no-BN variant) and ``VaeHead``.

Counterpart of ``acoustic_image_generation_tpu/models/blocks.py``. The
stride-1 3x3 conv+ReLU pair of ``ConvConvPool`` always runs through
``ops.conv_chain`` (the CUDA kernels on the card, forward and backward,
their plain versions on the CPU); module names mirror the flax scopes
(``conv_1``, ``conv_2``, ``pool_2``, ``mean``, ``std``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.models.layers import Conv2d, glorot_uniform, minmax_norm
from acoustic_image_generation_tpu_torch.ops.conv_chain import conv_chain

POOL_KERNEL = (3, 3)  # the generator's one pool conv: 36x48 -> 12x16
POOL_STRIDE = 3
LATENT_DIM = 150
VAE_SPATIAL = (12, 16)  # the bottleneck the VALID mean/std convs cover


class ChainConv(nn.Module):
    """f32 master parameters of one 3x3 conv of a chain, packed once for
    the kernel: weight (9*Ci, Co), bias (Co,)."""

    def __init__(self, in_ch, out_ch, *, device=None):
        super().__init__()
        f32 = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.empty((9 * in_ch, out_ch), **f32))
        self.bias = nn.Parameter(torch.empty((out_ch,), **f32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        k, o = self.weight.shape
        with torch.no_grad():
            self.weight.copy_(glorot_uniform(self.weight.shape, k, 9 * o, generator))
            self.bias.zero_()


class ConvConvPool(nn.Module):
    """{Conv3x3 -> ReLU} x len(filters) -> optional 3x3 stride-3 "pool"
    conv (itself a conv + ReLU, XLA "SAME" padding)."""

    def __init__(self, in_ch, filters, *, pool=False, device=None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n = len(filters)
        chans = (in_ch, *filters)
        for i in range(self.n):
            self.add_module(f"conv_{i + 1}", ChainConv(chans[i], chans[i + 1], device=device))
        self.pool = pool
        if pool:
            self.add_module(
                f"pool_{self.n}",
                Conv2d(filters[-1], filters[-1], POOL_KERNEL, POOL_STRIDE, "SAME",
                       device=device, dtype=dtype),
            )

    def forward(self, x: torch.Tensor):
        convs = [getattr(self, f"conv_{i + 1}") for i in range(self.n)]
        # the f32 masters go in as they are: conv_chain casts them inside and
        # returns their grads in f32
        x = conv_chain(
            x.to(self.dtype).contiguous(),
            [c.weight for c in convs],
            [c.bias for c in convs],
            (True,) * self.n,
        )
        if not self.pool:
            return x
        return x, F.relu(getattr(self, f"pool_{self.n}")(x))


class VaeHead(nn.Module):
    """mean / softplus-std VALID convs over the (12,16) bottleneck to a
    ``LATENT_DIM`` latent, and the reparameterization ``z = mean + std * eps``. ``embedding=True`` is the
    deterministic AE: only the mean conv, min-max normalized per sample.

    The noise is ``eps`` when given, else drawn from ``generator``; with
    neither, ``z = mean``. A train step always passes one of them: JAX
    samples whenever its ``latent`` rng exists."""

    def __init__(self, in_ch, *, embedding=False, device=None, dtype=torch.float32):
        super().__init__()
        self.embedding = embedding
        kw = dict(padding="VALID", device=device, dtype=dtype)
        self.mean = Conv2d(in_ch, LATENT_DIM, VAE_SPATIAL, **kw)
        if not embedding:
            self.std = Conv2d(in_ch, LATENT_DIM, VAE_SPATIAL, **kw)

    def forward(self, x, *, eps=None, generator=None):
        mean = self.mean(x).reshape(-1, LATENT_DIM)
        if self.embedding:
            z = minmax_norm(mean, dims=1)
            return z, z, None
        std = F.softplus(self.std(x).reshape(-1, LATENT_DIM))
        if eps is None and generator is not None:
            eps = torch.randn(std.shape, generator=generator, device=std.device)
        z = mean if eps is None else mean + std * eps.to(std.dtype)
        return z, mean, std
