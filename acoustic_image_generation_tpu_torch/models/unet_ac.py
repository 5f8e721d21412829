"""The acoustic-image UNets (36x48xC in and out), on NHWC.

Counterpart of ``acoustic_image_generation_tpu/models/unet_ac.py``:

``UNetAcoustic``, the skip-less acoustic VAE of the embedding, reconstruction,
projection and joint families (``features``, ``encode``, ``from_features``,
``decode``, ``forward``; ``forward(x, external_latent=(mean, std))`` decodes
from another modality's latent, as the projection family's ``unet_z``
variant does):

    layer1  conv pair C->128->128 @36x48, then a stride-3 pool conv -> 12x16
    layer3  conv pair 128->133->133 @12x16
    vae     (12,16) VALID mean/std convs -> (N, latent_dim)
    dense   z -> 2304 -> ReLU -> reshape (N,12,16,12); conv_dec 3x3 -> 133
    upsample_1  TF VALID transposed conv k2 s3 -> 36x48
    layer4, layer5  conv pairs -> 128; final 3x3 conv -> C, sigmoid

No BN: every conv pair runs on ``conv_chain`` (JAX's runs on plain convs,
``fused=False``; the two are identical in f32).

``UNetAcResNet``, the AAAI'21 generator: tiled-MFCC map + ResNet50
``conv_map`` feature -> (N,36,48,12) acoustic image, with ``skips`` in
{0, 1, 2} and ``embedding`` (deterministic AE). The wiring:

    layer1  conv pair 12->128->128 @36x48, then a stride-3 pool conv -> 12x16
    layer2  conv pair 128->133->133 @12x16
    concat  [minmax(layer2), minmax(resnet_feature)] -> 145 channels
    vae     (12,16) VALID mean/std convs -> z (N,150)
    dense   z -> 2304 -> ReLU -> reshape (N,12,16,12) in NHWC order
    conv_dec 3x3 12->133 + ReLU   [skips=2: concat layer2's output]
    layer4, layer5  conv pairs -> 128 @12x16
    upsample_1  TF VALID transposed conv k2 s3 -> 36x48
                [skips>=1: concat layer1's pre-pool output]
    layer6  conv pair -> 128, layer7 conv pair -> 64 @36x48
    final   3x3 conv -> C, sigmoid
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch import NUM_MFCC
from acoustic_image_generation_tpu_torch.models.blocks import LATENT_DIM, ConvConvPool, VaeHead
from acoustic_image_generation_tpu_torch.models.layers import (
    Conv2d,
    ConvTransposeTF,
    Dense,
    minmax_norm,
)


class VaeOutput(NamedTuple):
    output: torch.Tensor  # sigmoid reconstruction, the input's shape
    z: torch.Tensor
    mean: torch.Tensor
    std: torch.Tensor | None  # None in embedding/AE mode
    features: torch.Tensor  # the bottleneck feature map
    logits: torch.Tensor | None  # None where the output is not a sigmoid (UNetEnergy)


class UNetAcoustic(nn.Module):
    """Skip-less acoustic-image VAE (scope ``UNetAcoustic``)."""

    def __init__(self, channels=NUM_MFCC, latent_dim=LATENT_DIM, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layer1 = ConvConvPool(channels, (128, 128), pool=True, pool_strides=(3, 3), **kw)
        self.layer3 = ConvConvPool(128, (133, 133), **kw)
        self.vae = VaeHead(133, latent_dim=latent_dim, **kw)
        self.dense = Dense(latent_dim, 12 * 16 * 12, **kw)
        self.conv_dec = Conv2d(12, 133, (3, 3), **kw)
        self.upsample_1 = ConvTransposeTF(133, 128, (2, 2), (3, 3), **kw)
        self.layer4 = ConvConvPool(128, (128, 128), **kw)
        self.layer5 = ConvConvPool(128, (128, 128), **kw)
        self.final = Conv2d(128, channels, (3, 3), **kw)

    def features(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """The (N,12,16,133) bottleneck feature map (``train`` means nothing
        without BN)."""
        _, pool1 = self.layer1(x)
        return self.layer3(pool1)

    def encode(self, x, *, eps=None, generator=None):
        """Encoder half: ``(z, mean, std, features)``."""
        conv2 = self.features(x)
        z, mean, std = self.vae(conv2, eps=eps, generator=generator)
        return z, mean, std, conv2

    def _decode_logits(self, z: torch.Tensor) -> torch.Tensor:
        net = F.relu(self.dense(z)).reshape(-1, 12, 16, 12)
        net = F.relu(self.conv_dec(net))
        up1 = self.upsample_1(net)
        return self.final(self.layer5(self.layer4(up1)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self._decode_logits(z))

    def from_features(self, conv2, *, eps=None, generator=None) -> VaeOutput:
        """VAE head and decoder over a bottleneck feature map."""
        z, mean, std = self.vae(conv2, eps=eps, generator=generator)
        logits = self._decode_logits(z)
        return VaeOutput(torch.sigmoid(logits), z, mean, std, conv2, logits)

    def forward(self, x, *, external_latent=None, eps=None, generator=None, train: bool = False) -> VaeOutput:
        """The VAE on ``x``. With ``external_latent=(mean2, std2)`` the
        decoder reads ``z = mean2 + std2 * eps`` (``mean2`` without noise)
        instead of this VAE's own sample, whose (mean, std) are still
        returned; ``eps`` is then the shape of ``std2``."""
        del train  # no BN in this model
        conv2 = self.features(x)
        if external_latent is None:
            return self.from_features(conv2, eps=eps, generator=generator)
        _, mean, std = self.vae(conv2)
        mean2, std2 = external_latent
        if eps is None and generator is not None:
            eps = torch.randn(std2.shape, generator=generator, device=std2.device)
        z = mean2 if eps is None else mean2 + std2 * eps.to(std2.dtype)
        logits = self._decode_logits(z)
        return VaeOutput(torch.sigmoid(logits), z, mean, std, conv2, logits)


class UNetAcResNet(nn.Module):
    def __init__(self, skips=1, embedding=False, *, device=None, dtype=torch.float32):
        super().__init__()
        if skips not in (0, 1, 2):
            raise ValueError(f"skips must be 0, 1 or 2, got {skips}")
        kw = dict(device=device, dtype=dtype)
        self.skips = skips
        self.layer1 = ConvConvPool(NUM_MFCC, (128, 128), pool=True, pool_strides=(3, 3), **kw)
        self.layer2 = ConvConvPool(128, (133, 133), **kw)
        self.vae = VaeHead(133 + 12, embedding=embedding, **kw)
        self.dense = Dense(LATENT_DIM, 12 * 16 * 12, **kw)
        self.conv_dec = Conv2d(12, 133, (3, 3), **kw)
        self.layer4 = ConvConvPool(133 * 2 if skips >= 2 else 133, (128, 128), **kw)
        self.layer5 = ConvConvPool(128, (128, 128), **kw)
        self.upsample_1 = ConvTransposeTF(128, 128, (2, 2), (3, 3), **kw)
        self.layer6 = ConvConvPool(256 if skips >= 1 else 128, (128, 128), **kw)
        self.layer7 = ConvConvPool(128, (64, 64), **kw)
        self.final = Conv2d(64, NUM_MFCC, (3, 3), **kw)

    def forward(self, mfccmap, resnet_feature, *, eps=None, generator=None) -> VaeOutput:
        conv1, pool1 = self.layer1(mfccmap)
        conv2_0 = self.layer2(pool1)
        conv2 = minmax_norm(conv2_0, dims=(1, 2, 3))
        feat = minmax_norm(resnet_feature, dims=(1, 2, 3))
        conv2 = torch.cat([conv2, feat.to(conv2.dtype)], dim=-1)

        z, mean, std = self.vae(conv2, eps=eps, generator=generator)

        net = F.relu(self.dense(z)).reshape(-1, 12, 16, 12)
        net = F.relu(self.conv_dec(net))
        if self.skips >= 2:
            net = torch.cat([net, conv2_0], dim=-1)
        conv4 = self.layer4(net)
        conv5 = self.layer5(conv4)
        up1 = self.upsample_1(conv5)
        if self.skips >= 1:
            up1 = torch.cat([up1, conv1], dim=-1)
        conv6 = self.layer6(up1)
        conv7 = self.layer7(conv6)
        logits = self.final(conv7)
        return VaeOutput(torch.sigmoid(logits), z, mean, std, conv2, logits)
