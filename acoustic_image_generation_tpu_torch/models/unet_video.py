"""``UNetVideo``, the video-frame VAE, and ``UNetEnergy``, the energy-map
UNet, on NHWC.

Counterpart of ``acoustic_image_generation_tpu/models/unet_video.py::
UNetVideo``: a (N,224,298,3) frame -> BN conv-pair stages with VALID
strided pool convs -> (12,16,512) -> VAE head -> TF-rule transposed convs
back to 224x298 -> 3-channel sigmoid. BN everywhere (momentum .99, eps
1e-3), no skip concats:

    layer1  3->32->32 @224x298, pool 3x3/3 VALID -> 74x99
    layer2  128 @74x99, pool 3x3/2 VALID -> 36x49
    layer3  256 @36x49, pool (2,3)/3 VALID -> 12x16
    layer5  512 @12x16 (the features)
    vae     (12,16) VALID mean/std -> (N, latent_dim)
    dense   z -> 9600 -> ReLU -> (N,12,16,50); conv_dec 3x3 -> 512
    upsample_6  (3,4)/3 -> 36x49, layer6, layer7 (256)
    upsample_8  (4,3)/2 -> 74x99, layer8, layer9 (128)
    upsample_10 (5,4)/3 -> 224x298, layer10, layer11 (32); final 1x1 -> 3

``UNetEnergy`` (scope ``UNetEnergy``, the reconstruction family's
``Energy`` model): a (N,36,48,1) map, no BN anywhere, so every conv pair
runs on ``conv_chain`` (JAX's on plain convs; identical in f32):

    layer1  1->16->16 @36x48, pool 3x3/2 SAME -> 18x24
    layer2  16 @18x24, pool -> 9x12
    layer3  8 @9x12, pool (3,5)/2 VALID -> 4x4; layer4 8 @4x4
    latent  the flattened (4,4,8) bottleneck is both mean and variance,
            raw (no softplus): z = mean + mean * eps
    upsample_6 (3,6)/2 -> 9x12 (8 ch), concat layer3's conv, layer6, layer6_2 (8)
    upsample_7 (2,2)/2 -> 18x24 (16), concat layer2's conv, layer7, layer7_2 (16)
    upsample_8 (2,2)/2 -> 36x48 (16), concat layer1's conv, layer8 (16), layer8_2 (8)
    final   3x3 conv -> 1, ReLU (not sigmoid)

Under tensor parallelism (``parallel/mesh.py``) ``UNetVideo``'s wide convs
(``layer3``, ``layer5``, ``conv_dec``, ``upsample_6``, ``layer6``,
``layer7``, and a head of 1024 latents) hold a rank's block of output
channels and run column-parallel (``models/layers.py``); nothing of
``UNetEnergy`` is wide enough to split.

``UNetVideoSkip`` (scope ``UNet``): the legacy skip-connected video VAE
(``acoustic_image_generation_tpu/models/unet_video.py::UNetVideoSkip``),
which no task builds:
224x298x3 -> 8/32/32/64 encoder with strided-conv pools ((2,3) VALID at
stages 2 and 4), a 128-d latent whose variance head is raw (``z = mean +
variance * eps``, no softplus), and a decoder that concatenates every
encoder level back in; BN everywhere but the heads, the dense and the
transposed convs.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.models.blocks import ConvConvPool, VaeHead
from acoustic_image_generation_tpu_torch.models.layers import Conv2d, ConvTransposeTF, Dense
from acoustic_image_generation_tpu_torch.models.unet_ac import VaeOutput


class UNetVideo(nn.Module):
    """Scope ``UNet``: video VAE."""

    def __init__(self, latent_dim=1024, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)

        def ccp(in_ch, filters, **extra):
            return ConvConvPool(in_ch, filters, batch_norm=True, **extra, **kw)

        self.layer1 = ccp(3, (32, 32), pool=True, pool_strides=(3, 3), pool_padding="VALID")
        self.layer2 = ccp(32, (128, 128), pool=True, pool_padding="VALID")
        self.layer3 = ccp(128, (256, 256), pool=True, pool_strides=(3, 3), pool_padding="VALID",
                          pool_kernel=(2, 3))
        self.layer5 = ccp(256, (512, 512))
        self.vae = VaeHead(512, latent_dim=latent_dim, **kw)
        self.dense = Dense(latent_dim, 12 * 16 * 50, **kw)
        self.conv_dec = Conv2d(50, 512, (3, 3), **kw)
        self.upsample_6 = ConvTransposeTF(512, 256, (3, 4), (3, 3), **kw)
        self.layer6 = ccp(256, (256, 256))
        self.layer7 = ccp(256, (256, 256))
        self.upsample_8 = ConvTransposeTF(256, 128, (4, 3), (2, 2), **kw)
        self.layer8 = ccp(128, (128, 128))
        self.layer9 = ccp(128, (128, 128))
        self.upsample_10 = ConvTransposeTF(128, 32, (5, 4), (3, 3), **kw)
        self.layer10 = ccp(32, (32, 32))
        self.layer11 = ccp(32, (32, 32))
        self.final = Conv2d(32, 3, (1, 1), **kw)

    def features(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """The (N,12,16,512) feature map: 224x298 -> 74x99 -> 36x49 -> 12x16."""
        _, pool1 = self.layer1(x, train)
        _, pool2 = self.layer2(pool1, train)
        _, pool3 = self.layer3(pool2, train)
        return self.layer5(pool3, train)

    def _decode_logits(self, z: torch.Tensor, train: bool) -> torch.Tensor:
        net = F.relu(self.dense(z)).reshape(-1, 12, 16, 50)
        up = F.relu(self.conv_dec(net))
        for n in (6, 8, 10):
            up = getattr(self, f"upsample_{n}")(up)
            up = getattr(self, f"layer{n}")(up, train)
            up = getattr(self, f"layer{n + 1}")(up, train)
        return self.final(up)

    def from_features(self, conv5, *, eps=None, generator=None, train: bool = False) -> VaeOutput:
        z, mean, std = self.vae(conv5, eps=eps, generator=generator)
        logits = self._decode_logits(z, train)
        return VaeOutput(torch.sigmoid(logits), z, mean, std, conv5, logits)

    def forward(self, x, *, eps=None, generator=None, train: bool = False) -> VaeOutput:
        conv5 = self.features(x, train=train)
        return self.from_features(conv5, eps=eps, generator=generator, train=train)


class UNetEnergy(nn.Module):
    """Scope ``UNetEnergy``: the energy-map UNet with skip concats."""

    LATENT = 4 * 4 * 8

    def __init__(self, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)

        def ccp(in_ch, filters, **extra):
            return ConvConvPool(in_ch, filters, **extra, **kw)

        self.layer1 = ccp(1, (16, 16), pool=True)
        self.layer2 = ccp(16, (16, 16), pool=True)
        self.layer3 = ccp(16, (8, 8), pool=True, pool_padding="VALID", pool_kernel=(3, 5))
        self.layer4 = ccp(8, (8, 8))
        self.upsample_6 = ConvTransposeTF(8, 8, (3, 6), (2, 2), **kw)
        self.layer6 = ccp(16, (8, 8))
        self.layer6_2 = ccp(8, (8, 8))
        self.upsample_7 = ConvTransposeTF(8, 16, (2, 2), (2, 2), **kw)
        self.layer7 = ccp(32, (16, 16))
        self.layer7_2 = ccp(16, (16, 16))
        self.upsample_8 = ConvTransposeTF(16, 16, (2, 2), (2, 2), **kw)
        self.layer8 = ccp(32, (16, 16))
        self.layer8_2 = ccp(16, (8, 8))
        self.final = Conv2d(8, 1, (3, 3), **kw)

    def forward(self, x, *, eps=None, generator=None, train: bool = False) -> VaeOutput:
        """``eps`` (N, 128), or drawn from ``generator``; with neither,
        ``z = mean``."""
        del train  # no BN in this model
        conv1, pool1 = self.layer1(x)
        conv2, pool2 = self.layer2(pool1)
        conv3, pool3 = self.layer3(pool2)
        conv4 = self.layer4(pool3)
        mean = variance = conv4.reshape(-1, self.LATENT)
        if eps is None and generator is not None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device)
        z = mean if eps is None else mean + variance * eps.to(mean.dtype)
        up = self.upsample_6(z.reshape(-1, 4, 4, 8))
        up = self.layer6_2(self.layer6(torch.cat([up, conv3], -1)))
        up = self.upsample_7(up)
        up = self.layer7_2(self.layer7(torch.cat([up, conv2], -1)))
        up = self.upsample_8(up)
        up = self.layer8_2(self.layer8(torch.cat([up, conv1], -1)))
        return VaeOutput(F.relu(self.final(up)), z, mean, variance, conv4, None)


class UNetVideoSkip(nn.Module):
    """Scope ``UNet``: the legacy skip-connected video VAE, latent 128."""

    def __init__(self, latent_dim=128, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.latent_dim = latent_dim

        def ccp(in_ch, filters, **extra):
            return ConvConvPool(in_ch, filters, batch_norm=True, **extra, **kw)

        self.layer1 = ccp(3, (8, 8), pool=True)
        self.layer2 = ccp(8, (32, 32), pool=True, pool_kernel=(2, 3), pool_padding="VALID")
        self.layer3 = ccp(32, (32, 32), pool=True)
        self.layer4 = ccp(32, (64, 64), pool=True, pool_kernel=(2, 3), pool_padding="VALID")
        self.layer5 = ccp(64, (128, 128))
        self.mean = Conv2d(128, latent_dim, (14, 18), padding="VALID", **kw)
        self.variance = Conv2d(128, latent_dim, (14, 18), padding="VALID", **kw)
        self.dense = Dense(latent_dim, 14 * 18, **kw)
        self.conv_dec = Conv2d(1, 128, (3, 3), **kw)
        self.upsample_6 = ConvTransposeTF(128, 64, (2, 3), (2, 2), **kw)
        self.layer6 = ccp(128, (64, 64))
        self.upsample_7 = ConvTransposeTF(64, 32, (2, 2), (2, 2), **kw)
        self.layer7 = ccp(64, (32, 32))
        self.upsample_8 = ConvTransposeTF(32, 32, (2, 3), (2, 2), **kw)
        self.layer8 = ccp(64, (32, 32))
        self.upsample_9 = ConvTransposeTF(32, 8, (2, 2), (2, 2), **kw)
        self.layer9 = ccp(16, (8, 8))
        self.final = Conv2d(8, 3, (1, 1), **kw)

    def forward(self, x, *, eps=None, generator=None, train: bool = False) -> VaeOutput:
        """224x298x3 -> sigmoid reconstruction. ``eps`` (N, 128), or drawn
        from ``generator``; with neither, ``z = mean``."""
        conv1, pool1 = self.layer1(x, train)
        conv2, pool2 = self.layer2(pool1, train)
        conv3, pool3 = self.layer3(pool2, train)
        conv4, pool4 = self.layer4(pool3, train)
        conv5 = self.layer5(pool4, train)
        mean = self.mean(conv5).reshape(-1, self.latent_dim)
        variance = self.variance(conv5).reshape(-1, self.latent_dim)
        if eps is None and generator is not None:
            eps = torch.randn(variance.shape, generator=generator, device=variance.device)
        z = mean if eps is None else mean + variance * eps.to(variance.dtype)
        net = F.relu(self.dense(z)).reshape(-1, 14, 18, 1)
        net = F.relu(self.conv_dec(net))
        for n, skip in ((6, conv4), (7, conv3), (8, conv2), (9, conv1)):
            net = getattr(self, f"layer{n}")(torch.cat([getattr(self, f"upsample_{n}")(net), skip], -1), train)
        logits = self.final(net)
        return VaeOutput(torch.sigmoid(logits), z, mean, variance, conv5, logits)
