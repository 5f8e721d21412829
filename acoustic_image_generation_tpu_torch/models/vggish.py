"""VGGish, the AudioSet audio embedding network, on NHWC.

Counterpart of ``acoustic_image_generation_tpu/models/vggish.py``, which no
task builds: a (N, 96, 64) or (N, 96, 64, 1) log-mel patch -> 3x3 SAME
convs 64, pool, 128, pool, 256, 256, pool, 512, 512, pool (each pool 2x2,
stride 2, SAME) -> flatten (6*4*512) -> two ReLU dense layers of 4096 ->
(N, 1, 1, 4096). Every conv is followed by ReLU; kernels are drawn from a
normal of stddev 0.01 truncated at two stddevs, biases zero (the reference's
slim ``truncated_normal_initializer(stddev=0.01)``). Module names are the
flax scopes (``conv1``, ``conv3_1``, ``fc1_2``); a TF1 VGGish checkpoint's
``slim.repeat`` scopes (``conv3/conv3_1``, ``fc1/fc1_2``) collapse onto them
in ``core/tf1_import.py``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.models.layers import Conv2d, Dense
from acoustic_image_generation_tpu_torch.ops.tf_compat import same_pads

NUM_FRAMES = 96
NUM_BANDS = 64
EMBEDDING_SIZE = 128
CONVS = (("conv1", 1, 64), ("conv2", 64, 128), ("conv3_1", 128, 256), ("conv3_2", 256, 256),
         ("conv4_1", 256, 512), ("conv4_2", 512, 512))
POOL_AFTER = ("conv1", "conv2", "conv3_2", "conv4_2")


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """flax ``max_pool`` with "SAME" padding on NHWC: padded rows and
    columns are -inf."""
    (t, b), (l, r) = same_pads(x.shape[1], window, stride), same_pads(x.shape[2], window, stride)
    xc = x.permute(0, 3, 1, 2)
    if t or b or l or r:
        xc = F.pad(xc, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


class VGGish(nn.Module):
    def __init__(self, *, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype, init="trunc_normal_001")
        for name, i, o in CONVS:
            self.add_module(name, Conv2d(i, o, (3, 3), **kw))
        self.fc1_1 = Dense(6 * 4 * 512, 4096, **kw)
        self.fc1_2 = Dense(4096, 4096, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 96, 64) or (N, 96, 64, 1) log-mel patches -> (N, 1, 1, 4096)."""
        if x.dim() == 3:
            x = x[..., None]
        net = x
        for name, _, _ in CONVS:
            net = F.relu(getattr(self, name)(net))
            if name in POOL_AFTER:
                net = max_pool_same(net, 2, 2)
        net = net.reshape(net.shape[0], -1)
        net = F.relu(self.fc1_2(F.relu(self.fc1_1(net))))
        return net.reshape(-1, 1, 1, 4096)
