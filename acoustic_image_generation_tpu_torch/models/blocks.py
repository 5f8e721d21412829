"""UNet building blocks: ``ConvConvPool`` (with or without BN) and
``VaeHead``.

Counterpart of ``acoustic_image_generation_tpu/models/blocks.py``. Without
BN, the stride-1 3x3 conv+ReLU pair of ``ConvConvPool`` always runs through
``ops.conv_chain`` (the CUDA kernels on the card, forward and backward,
their plain versions on the CPU). With BN, each conv is followed by BN
before its ReLU, which the chain kernel does not fuse, so the convs run on
plain cuDNN convs as JAX's run on XLA's. Module names mirror the flax
scopes (``conv_1``, ``bn_1``, ``conv_2``, ``bn_2``, ``pool_2``,
``bn_pool_2``, ``mean``, ``std``). Under tensor parallelism a ``Conv2d``
whose kernel JAX's rule splits (the BN variant's convs of 256 channels or
more, a 1024-channel VAE head) runs column-parallel (``models/layers.py``)
and its BN on the gathered map.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.models.layers import BatchNorm, Conv2d, glorot_uniform, minmax_norm
from acoustic_image_generation_tpu_torch.ops.conv_chain import conv_chain

LATENT_DIM = 150  # the generator's latent
VAE_SPATIAL = (12, 16)  # the bottleneck the VALID mean/std convs cover
UNET_BN_EPS = 1e-3  # tf.layers.batch_normalization's defaults
UNET_BN_MOMENTUM = 0.99


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
    """{Conv3x3 -> (BN) -> ReLU} x len(filters) -> optional strided "pool"
    conv (itself a conv -> (BN) -> ReLU, XLA padding), as JAX's: pool
    kernel (3, 3), strides (2, 2) and "SAME" unless given. ``forward(x,
    train)`` returns the last conv's output, and with ``pool`` also the
    pool's; ``train`` selects BN on batch statistics (running averages
    updated in place) and means nothing without BN."""

    def __init__(self, in_ch, filters, *, pool=False, batch_norm=False, pool_kernel=(3, 3),
                 pool_strides=(2, 2), pool_padding="SAME", device=None, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n = len(filters)
        self.batch_norm = batch_norm
        chans = (in_ch, *filters)
        bn = dict(eps=UNET_BN_EPS, momentum=UNET_BN_MOMENTUM, device=device)
        for i in range(self.n):
            if batch_norm:
                self.add_module(f"conv_{i + 1}", Conv2d(chans[i], chans[i + 1], device=device, dtype=dtype))
                self.add_module(f"bn_{i + 1}", BatchNorm(chans[i + 1], **bn))
            else:
                self.add_module(f"conv_{i + 1}", ChainConv(chans[i], chans[i + 1], device=device))
        self.pool = pool
        if pool:
            self.add_module(f"pool_{self.n}", Conv2d(filters[-1], filters[-1], tuple(pool_kernel),
                                                     tuple(pool_strides), pool_padding,
                                                     device=device, dtype=dtype))
            if batch_norm:
                self.add_module(f"bn_pool_{self.n}", BatchNorm(filters[-1], **bn))

    def forward(self, x: torch.Tensor, train: bool = False):
        convs = [getattr(self, f"conv_{i + 1}") for i in range(self.n)]
        if self.batch_norm:
            for i, conv in enumerate(convs):
                x = F.relu(getattr(self, f"bn_{i + 1}")(conv(x), train))
        else:
            # the f32 masters go in as they are: conv_chain casts them inside
            # and returns their grads in f32
            x = conv_chain(
                x.to(self.dtype).contiguous(),
                [c.weight for c in convs],
                [c.bias for c in convs],
                (True,) * self.n,
            )
        if not self.pool:
            return x
        p = getattr(self, f"pool_{self.n}")(x)
        if self.batch_norm:
            p = getattr(self, f"bn_pool_{self.n}")(p, train)
        return x, F.relu(p)


class VaeHead(nn.Module):
    """mean / softplus-std VALID convs over the (12,16) bottleneck (every
    VAE of the port has that one) to a ``latent_dim`` latent, and the
    reparameterization ``z = mean + std * eps``. ``embedding=True`` is the
    deterministic AE: only the mean conv, min-max normalized per sample.

    The noise is ``eps`` when given, else drawn from ``generator``; with
    neither, ``z = mean``. A generation train step always passes one of
    them: JAX samples whenever its ``latent`` rng exists."""

    def __init__(self, in_ch, *, latent_dim=LATENT_DIM, embedding=False, device=None, dtype=torch.float32):
        super().__init__()
        self.embedding = embedding
        self.latent_dim = latent_dim
        kw = dict(padding="VALID", device=device, dtype=dtype)
        self.mean = Conv2d(in_ch, latent_dim, VAE_SPATIAL, **kw)
        if not embedding:
            self.std = Conv2d(in_ch, latent_dim, VAE_SPATIAL, **kw)

    def forward(self, x, *, eps=None, generator=None):
        mean = self.mean(x).reshape(-1, self.latent_dim)
        if self.embedding:
            z = minmax_norm(mean, dims=1)
            return z, z, None
        std = F.softplus(self.std(x).reshape(-1, self.latent_dim))
        if eps is None and generator is not None:
            eps = torch.randn(std.shape, generator=generator, device=std.device)
        z = mean if eps is None else mean + std * eps.to(std.dtype)
        return z, mean, std
