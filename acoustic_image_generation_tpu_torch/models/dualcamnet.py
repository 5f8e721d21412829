"""DualCamNet, the acoustic-image classifier.

Counterpart of ``acoustic_image_generation_tpu/models/dualcamnet.py``
(``DualCamNet``, ``clip_logits``). On NHWC frames (N*F, 36, 48, C), frame
major within each clip of F frames:

1. a 12x1x1 conv over the frame axis (C -> C), XLA "SAME": for the even
   kernel 5 frames of padding before and 6 after, whatever F; ReLU. It runs
   as a (12, 1) conv over each clip viewed as (F, 36*48, C);
2. a 5x5 SAME conv to 32, ReLU, a VALID 3/3 max-pool (36x48 -> 12x16);
3. a 5x5 SAME conv to 128, ReLU, the sum over the 12x16 positions;
4. a dense layer to 1000, ReLU, and one to ``num_classes``: logits per
   frame.

Parameters are f32 masters, each layer computes in the compute dtype, the
kernels start as a normal of stddev 0.01 truncated at two stddevs, the
biases at 0. The convs and dense layers are cuDNN's and cuBLAS's, as they
are XLA's in the JAX package: no Pallas kernel sits on this model.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.models.layers import Conv2d, Dense

TEMPORAL_TAPS = 12


class TemporalConv(Conv2d):
    """The 12x1x1 conv3d over the frame axis, as a (12, 1) conv on
    (clips, F, H*W, C). Its weight is (C, C, 12, 1); flax's kernel is
    (12, 1, 1, C, C) (``bridge.py`` carries it across)."""

    def __init__(self, channels: int, *, device=None, dtype=torch.float32):
        super().__init__(channels, channels, (TEMPORAL_TAPS, 1), device=device, dtype=dtype,
                         init="trunc_normal_001")


class DualCamNet(nn.Module):
    def __init__(self, num_classes: int = 10, num_frames: int = 12, channels: int = 12, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.num_frames = num_frames
        kw = dict(device=device, dtype=dtype, init="trunc_normal_001")
        self.conv1 = TemporalConv(channels, device=device, dtype=dtype)
        self.conv2 = Conv2d(channels, 32, (5, 5), **kw)
        self.conv3 = Conv2d(32, 128, (5, 5), **kw)
        self.full1 = Dense(128, 1000, **kw)
        self.full3 = Dense(1000, num_classes, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N*F, H, W, C) frames -> (N*F, num_classes) logits in the compute
        dtype."""
        _, h, w, c = x.shape
        net = F.relu(self.conv1(x.reshape(-1, self.num_frames, h * w, c)))
        net = F.relu(self.conv2(net.reshape(-1, h, w, c)))
        net = F.max_pool2d(net.permute(0, 3, 1, 2), 3, 3).permute(0, 2, 3, 1)
        net = F.relu(self.conv3(net))
        net = net.sum(dim=(1, 2))
        return self.full3(F.relu(self.full1(net)))


def clip_logits(frame_logits: torch.Tensor, num_frames: int = 12) -> torch.Tensor:
    """The mean of each clip's frame logits: (N*F, K) -> (N, K)."""
    return frame_logits.reshape(-1, num_frames, frame_logits.shape[-1]).mean(dim=1)
