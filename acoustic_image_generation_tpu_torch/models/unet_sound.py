"""``UNetSound``: the audio-spectrogram VAEs, on NHWC.

Counterpart of ``acoustic_image_generation_tpu/models/unet_sound.py::
UNetSound``. ``variant="large"`` (the embedding, projection and joint
families'): a (N,193,257,1) magnitude
spectrogram -> 4 BN conv-pair stages down to (12,16,128) -> VAE head ->
4 stages up through TF-rule transposed convs -> 1-channel sigmoid. BN
everywhere (momentum .99, eps 1e-3), no skip concats:

    layer1  1->16->16 @193x257, pool 3x3/2 VALID -> 96x128
    layer2  16 @96x128, pool SAME -> 48x64; layer3 64 -> 24x32;
    layer4  128 -> 12x16; layer5 128 @12x16 (the features)
    vae     (12,16) VALID mean/std -> (N, latent_dim)
    dense   z -> 1920 -> ReLU -> (N,12,16,10); conv_dec 3x3 -> 128
    upsample_6/8/10 k2 s2 -> 24x32 -> 48x64 -> 96x128 (128, 64, 16 ch),
    each followed by two conv pairs; upsample_12 k3 s2 -> 193x257,
    layer12, layer13 (16 ch); final 1x1 -> 1

``variant="small"`` (the reconstruction family's ``Audio`` model,
``unet_sound.py`` of the reference): a (N,99,257,1) spectrogram, BN on
every conv pair, skip concats on all four up stages, and a latent fixed at
128 whatever ``latent_dim`` says, with a *raw* (no softplus) ``variance``
head:

    layer1  1->8->8 @99x257, pool 3x3/2 VALID -> 49x128
    layer2  8 @49x128, pool (3,2)/2 VALID -> 24x64
    layer3  32 @24x64, pool SAME -> 12x32; layer4 64 -> 6x16; layer5 128 @6x16
    mean, variance  (6,16) VALID convs -> (N,128); z = mean + variance * eps
    dense   z -> 96 -> ReLU -> (N,6,16,1); conv_dec 3x3 -> 128
    upsample_6 k2 s2 -> 12x32 (64), concat layer4's conv, layer6 (64)
    upsample_7 k2 s2 -> 24x64 (32), concat layer3's conv, layer7 (32)
    upsample_8 (3,2)/2 -> 49x128 (8), concat layer2's conv, layer8 (8)
    upsample_9 k3 s2 -> 99x257 (8), concat layer1's conv, layer9 (8)
    final   1x1 -> 1, sigmoid
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.models.blocks import ConvConvPool, VaeHead
from acoustic_image_generation_tpu_torch.models.layers import Conv2d, ConvTransposeTF, Dense
from acoustic_image_generation_tpu_torch.models.unet_ac import VaeOutput


class UNetSound(nn.Module):
    """Scope ``UNetAudio``."""

    SMALL_LATENT = 128

    def __init__(self, variant="large", latent_dim=256, *, device=None, dtype=torch.float32):
        super().__init__()
        if variant not in ("large", "small"):
            raise ValueError(f"UNetSound variant must be 'large' or 'small', got {variant!r}")
        self.variant = variant
        kw = dict(device=device, dtype=dtype)

        def ccp(in_ch, filters, **extra):
            return ConvConvPool(in_ch, filters, batch_norm=True, **extra, **kw)

        if variant == "small":
            self._build_small(ccp, kw)
            return
        self.layer1 = ccp(1, (16, 16), pool=True, pool_padding="VALID")
        self.layer2 = ccp(16, (16, 16), pool=True)
        self.layer3 = ccp(16, (64, 64), pool=True)
        self.layer4 = ccp(64, (128, 128), pool=True)
        self.layer5 = ccp(128, (128, 128))
        self.vae = VaeHead(128, latent_dim=latent_dim, **kw)
        self.dense = Dense(latent_dim, 12 * 16 * 10, **kw)
        self.conv_dec = Conv2d(10, 128, (3, 3), **kw)
        self.upsample_6 = ConvTransposeTF(128, 128, (2, 2), (2, 2), **kw)
        self.layer6 = ccp(128, (128, 128))
        self.layer7 = ccp(128, (128, 128))
        self.upsample_8 = ConvTransposeTF(128, 64, (2, 2), (2, 2), **kw)
        self.layer8 = ccp(64, (64, 64))
        self.layer9 = ccp(64, (64, 64))
        self.upsample_10 = ConvTransposeTF(64, 16, (2, 2), (2, 2), **kw)
        self.layer10 = ccp(16, (16, 16))
        self.layer11 = ccp(16, (16, 16))
        self.upsample_12 = ConvTransposeTF(16, 16, (3, 3), (2, 2), **kw)
        self.layer12 = ccp(16, (16, 16))
        self.layer13 = ccp(16, (16, 16))
        self.final = Conv2d(16, 1, (1, 1), **kw)

    def _build_small(self, ccp, kw) -> None:
        latent = self.SMALL_LATENT
        self.layer1 = ccp(1, (8, 8), pool=True, pool_padding="VALID")
        self.layer2 = ccp(8, (8, 8), pool=True, pool_padding="VALID", pool_kernel=(3, 2))
        self.layer3 = ccp(8, (32, 32), pool=True)
        self.layer4 = ccp(32, (64, 64), pool=True)
        self.layer5 = ccp(64, (128, 128))
        self.mean = Conv2d(128, latent, (6, 16), padding="VALID", **kw)
        self.variance = Conv2d(128, latent, (6, 16), padding="VALID", **kw)
        self.dense = Dense(latent, 6 * 16, **kw)
        self.conv_dec = Conv2d(1, 128, (3, 3), **kw)
        self.upsample_6 = ConvTransposeTF(128, 64, (2, 2), (2, 2), **kw)
        self.layer6 = ccp(128, (64, 64))
        self.upsample_7 = ConvTransposeTF(64, 32, (2, 2), (2, 2), **kw)
        self.layer7 = ccp(64, (32, 32))
        self.upsample_8 = ConvTransposeTF(32, 8, (3, 2), (2, 2), **kw)
        self.layer8 = ccp(16, (8, 8))
        self.upsample_9 = ConvTransposeTF(8, 8, (3, 3), (2, 2), **kw)
        self.layer9 = ccp(16, (8, 8))
        self.final = Conv2d(8, 1, (1, 1), **kw)

    def _small(self, x, eps, generator, train: bool) -> VaeOutput:
        """The small variant's forward: ``eps`` (N, 128), or drawn from
        ``generator``; with neither, ``z = mean``."""
        conv1, pool1 = self.layer1(x, train)
        conv2, pool2 = self.layer2(pool1, train)
        conv3, pool3 = self.layer3(pool2, train)
        conv4, pool4 = self.layer4(pool3, train)
        conv5 = self.layer5(pool4, train)
        mean = self.mean(conv5).reshape(-1, self.SMALL_LATENT)
        variance = self.variance(conv5).reshape(-1, self.SMALL_LATENT)
        if eps is None and generator is not None:
            eps = torch.randn(variance.shape, generator=generator, device=variance.device)
        z = mean if eps is None else mean + variance * eps.to(variance.dtype)
        up = F.relu(self.conv_dec(F.relu(self.dense(z)).reshape(-1, 6, 16, 1)))
        for n, skip in ((6, conv4), (7, conv3), (8, conv2), (9, conv1)):
            up = getattr(self, f"upsample_{n}")(up)
            up = getattr(self, f"layer{n}")(torch.cat([up, skip], -1), train)
        logits = self.final(up)
        return VaeOutput(torch.sigmoid(logits), z, mean, variance, conv5, logits)

    def features(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """The (N,12,16,128) feature map (large variant)."""
        _, pool1 = self.layer1(x, train)
        _, pool2 = self.layer2(pool1, train)
        _, pool3 = self.layer3(pool2, train)
        _, pool4 = self.layer4(pool3, train)
        return self.layer5(pool4, train)

    def _decode_logits(self, z: torch.Tensor, train: bool) -> torch.Tensor:
        net = F.relu(self.dense(z)).reshape(-1, 12, 16, 10)
        up = F.relu(self.conv_dec(net))
        for n in (6, 8, 10, 12):
            up = getattr(self, f"upsample_{n}")(up)
            up = getattr(self, f"layer{n}")(up, train)
            up = getattr(self, f"layer{n + 1}")(up, train)
        return self.final(up)

    def from_features(self, conv5, *, eps=None, generator=None, train: bool = False) -> VaeOutput:
        z, mean, std = self.vae(conv5, eps=eps, generator=generator)
        logits = self._decode_logits(z, train)
        return VaeOutput(torch.sigmoid(logits), z, mean, std, conv5, logits)

    def forward(self, x, *, eps=None, generator=None, train: bool = False) -> VaeOutput:
        if self.variant == "small":
            return self._small(x, eps, generator, train)
        conv5 = self.features(x, train=train)
        return self.from_features(conv5, eps=eps, generator=generator, train=train)
