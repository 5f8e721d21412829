"""TF-1.x convolution shape rules on NHWC tensors.

Counterpart of ``acoustic_image_generation_tpu/ops/tf_compat.py``:

1. ``tf.layers.conv2d_transpose`` with VALID padding gives
   ``out = in * stride + max(kernel - stride, 0)``. For the generator's
   kernel-2 / stride-3 upsample that is 12x16 -> 36x48, where a plain
   ``F.conv_transpose2d`` gives 35x47; the missing row and column come from
   ``output_padding`` (they hold only the bias, as in TF).
2. tf-slim's ``conv2d_same`` pads ``(k-1)//2`` low and ``k-1-(k-1)//2`` high
   whatever the input size, then runs a VALID conv.

Plus XLA's "SAME" rule for the plain convs: ``out = ceil(in / stride)``,
with any odd pad on the high side.

Public functions take and return NHWC; weights are in torch layout (OIHW,
or (Cin, Cout, kh, kw) for the transposed conv). Inside, the convs run on
the NCHW view of the NHWC tensor (channels-last memory).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pads(in_len: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA/TF "SAME" for one spatial dim."""
    out_len = -(-in_len // stride)
    total = max((out_len - 1) * stride + kernel - in_len, 0)
    return total // 2, total - total // 2


def fixed_pads(kernel: int) -> tuple[int, int]:
    """(low, high) padding of tf-slim ``conv2d_same``."""
    lo = (kernel - 1) // 2
    return lo, kernel - 1 - lo


def conv_nhwc(x, weight, bias, stride, pads) -> torch.Tensor:
    """NHWC conv with explicit ``pads = ((top, bottom), (left, right))``."""
    (t, b), (l, r) = pads
    xc = x.permute(0, 3, 1, 2)
    if t == b and l == r:
        y = F.conv2d(xc, weight, bias, stride, padding=(t, l))
    else:
        y = F.conv2d(F.pad(xc, (l, r, t, b)), weight, bias, stride)
    return y.permute(0, 2, 3, 1)


def conv2d_xla(x, weight, bias, stride: int | tuple[int, int], padding: str) -> torch.Tensor:
    """NHWC conv with XLA's "SAME" or "VALID" padding; ``stride`` an int or
    (sh, sw)."""
    if padding == "VALID":
        return conv_nhwc(x, weight, bias, stride, ((0, 0), (0, 0)))
    kh, kw = weight.shape[2:]
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    pads = (same_pads(x.shape[1], kh, sh), same_pads(x.shape[2], kw, sw))
    return conv_nhwc(x, weight, bias, stride, pads)


def conv2d_same_fixed_pad(x, weight, stride: int, bias=None) -> torch.Tensor:
    """tf-slim ``resnet_utils.conv2d_same``: fixed padding, then VALID.

    For stride 1 this is a plain SAME conv."""
    kh, kw = weight.shape[2:]
    return conv_nhwc(x, weight, bias, stride, (fixed_pads(kh), fixed_pads(kw)))


def conv_transpose_tf(x, weight, strides, bias=None) -> torch.Tensor:
    """``tf.layers.conv2d_transpose`` with VALID padding (the TF default,
    the only one the generator uses) on NHWC input.

    ``weight``: (Cin, Cout, kh, kw), the flax HWIO kernel permuted, NOT
    spatially flipped (``conv_transpose2d`` is already the gradient of a
    forward conv, which is what TF's transposed conv is)."""
    kh, kw = weight.shape[2:]
    sh, sw = strides
    # TF adds max(s - k, 0) trailing rows/cols that no kernel tap reaches.
    out_pad = (max(sh - kh, 0), max(sw - kw, 0))
    y = F.conv_transpose2d(
        x.permute(0, 3, 1, 2), weight, bias, stride=(sh, sw), output_padding=out_pad
    )
    return y.permute(0, 2, 3, 1)
