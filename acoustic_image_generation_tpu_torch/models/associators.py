"""Latent-space translators and the joint-MVAE fuser, on NHWC.

Counterpart of ``acoustic_image_generation_tpu/models/associators.py``:

- ``LatentAssociator``: two MLP stacks that translate one modality's
  Gaussian latent (mean, std) into the acoustic latent space: dense +
  ReLU over ``hidden`` on each branch, then a dense to 150; the std
  branch ends in softplus. ``VIDEO_AC_HIDDEN`` translates the video VAE's
  1024-d latent, ``AUDIO_AC_HIDDEN`` the audio VAE's 256-d one.
- ``AssociatorAudioEncoder``: a (N,193,257,1) spectrogram straight to a
  (150, 150) acoustic latent: BN conv pairs as the large ``UNetSound``'s
  encoder (layer1's pool VALID), then (12,16) VALID mean/std convs, the
  std through softplus.
- ``JointMVAE``: concatenates (N,12,16,C_i) feature maps along channels,
  three ReLU dense(512) layers applied at every position, then one ReLU
  dense head per name in ``heads`` (ac 133, video 512, audio 128). JAX
  builds it without a dtype, so flax promotes its bf16 inputs against the
  f32 kernels and it computes in f32 in either compute dtype; so does the
  port's.

Module names mirror the flax scopes (``mean_0``, ``mean_out``, ``std_0``,
``std_out``; ``layer1``..``layer5``, ``mean``, ``std``; ``dense_0``..
``dense_2``, ``out_ac``, ``out_video``, ``out_audio``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.models.blocks import LATENT_DIM, ConvConvPool
from acoustic_image_generation_tpu_torch.models.layers import Conv2d, Dense

VIDEO_AC_HIDDEN = (512, 512, 256, 256, 150)
AUDIO_AC_HIDDEN = (256, 256)
JOINT_HEADS = {"ac": 133, "video": 512, "audio": 128}
JOINT_WIDTH = 512


class LatentAssociator(nn.Module):
    """(mean_in, std_in) (N, in_dim) -> (mean, softplus std) (N, 150)."""

    def __init__(self, in_dim, hidden=VIDEO_AC_HIDDEN, latent_dim=LATENT_DIM, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.latent_dim = latent_dim
        self.depth = len(hidden)
        dims = (in_dim, *hidden)
        for branch in ("mean", "std"):
            for i in range(self.depth):
                self.add_module(f"{branch}_{i}", Dense(dims[i], dims[i + 1], **kw))
            self.add_module(f"{branch}_out", Dense(dims[-1], latent_dim, **kw))

    def _branch(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = F.relu(getattr(self, f"{name}_{i}")(x))
        return getattr(self, f"{name}_out")(x).reshape(-1, self.latent_dim)

    def forward(self, mean: torch.Tensor, std: torch.Tensor):
        return self._branch("mean", mean), F.softplus(self._branch("std", std))


class AssociatorAudioEncoder(nn.Module):
    """(N,193,257,1) spectrogram -> (mean, softplus std) (N, 150)."""

    def __init__(self, latent_dim=LATENT_DIM, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)

        def ccp(in_ch, filters, **extra):
            return ConvConvPool(in_ch, filters, batch_norm=True, **extra, **kw)

        self.latent_dim = latent_dim
        self.layer1 = ccp(1, (16, 16), pool=True, pool_padding="VALID")
        self.layer2 = ccp(16, (16, 16), pool=True)
        self.layer3 = ccp(16, (64, 64), pool=True)
        self.layer4 = ccp(64, (128, 128), pool=True)
        self.layer5 = ccp(128, (128, 128))
        self.mean = Conv2d(128, latent_dim, (12, 16), padding="VALID", **kw)
        self.std = Conv2d(128, latent_dim, (12, 16), padding="VALID", **kw)

    def forward(self, x: torch.Tensor, *, train: bool = False):
        """``train``: BN on batch statistics, running averages updated in
        place."""
        for n in range(1, 5):
            _, x = getattr(self, f"layer{n}")(x, train)
        x = self.layer5(x, train)
        mean = self.mean(x).reshape(-1, self.latent_dim)
        return mean, F.softplus(self.std(x).reshape(-1, self.latent_dim))


class JointMVAE(nn.Module):
    """Feature maps -> ``{head: (N,12,16,JOINT_HEADS[head])}``, in f32."""

    def __init__(self, in_ch: int, heads=tuple(JOINT_HEADS), *, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.heads = tuple(heads)
        for i in range(3):
            self.add_module(f"dense_{i}", Dense(in_ch if i == 0 else JOINT_WIDTH, JOINT_WIDTH, **kw))
        for h in self.heads:
            self.add_module(f"out_{h}", Dense(JOINT_WIDTH, JOINT_HEADS[h], **kw))

    def forward(self, *feature_maps: torch.Tensor) -> dict:
        net = torch.cat([f.float() for f in feature_maps], dim=-1)
        for i in range(3):
            net = F.relu(getattr(self, f"dense_{i}")(net))
        return {h: F.relu(getattr(self, f"out_{h}")(net)) for h in self.heads}
