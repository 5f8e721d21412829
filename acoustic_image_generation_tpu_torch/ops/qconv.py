"""Exact int8 convolutions of the quantized trunk outside any kernel: an
int8 x int8 product with an exact int32 sum.

Counterpart of the ``lax.conv_general_dilated(...,
preferred_element_type=int32)`` calls in
``acoustic_image_generation_tpu/models/quant.py::_qconv``, which JAX leaves
to XLA: the stem's 7x7/2 conv, the 3x3 convs and, with ``fused_gemm`` off,
the 1x1 convs. Here they are an im2col of the padded int8 NHWC tensor
(``Tensor.unfold`` views) and one ``torch._int_mm``, as a plain float
product goes to ``torch.matmul``. The sums must be exact: a block4 3x3 conv
adds 9*512 products of up to 127^2 (7.4e7, above the 2^24 that f32 holds
exactly), so no float product will do.

``torch._int_mm`` on CUDA wants more than 16 rows and K and N multiples of
8; ``int_mm`` pads with zero rows and columns where a shape falls short
(the stem's K = 7*7*3 = 147 becomes 152), on every device alike.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a`` s8 (M, K) @ ``w`` s8 (N, K) transposed -> exact s32 (M, N).
    Either operand may carry extra zero columns past K."""
    m, n = a.shape[0], w.shape[0]
    kp = _round_up(max(a.shape[1], w.shape[1]), 8)
    np_, mp = _round_up(n, 8), max(m, 17)
    if a.shape[1] != kp or mp != m:
        a = F.pad(a, (0, kp - a.shape[1], 0, mp - m))
    if w.shape[1] != kp or np_ != n:
        w = F.pad(w, (0, kp - w.shape[1], 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def im2col_s8(x: torch.Tensor, kernel: tuple[int, int], stride: int, pads) -> torch.Tensor:
    """int8 NHWC ``x`` -> (B*Ho*Wo, kh*kw*C) patches, columns in HWIO order
    (tap row, tap column, channel), with ``pads = ((top, bottom), (left,
    right))`` of zeros. K is padded with zero columns to a multiple of 8."""
    b, _, _, c = x.shape
    kh, kw = kernel
    (t, bo), (l, r) = pads
    if t or bo or l or r:
        x = F.pad(x, (0, 0, l, r, t, bo))
    patches = x.unfold(1, kh, stride).unfold(2, kw, stride)  # (B, Ho, Wo, C, kh, kw)
    ho, wo = patches.shape[1:3]
    k = kh * kw * c
    if k % 8 == 0:
        return patches.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, k)
    cols = x.new_zeros((b * ho * wo, _round_up(k, 8)))
    cols[:, :k].view(b, ho, wo, kh, kw, c).copy_(patches.permute(0, 1, 2, 4, 5, 3))
    return cols


def conv2d_s8(x: torch.Tensor, w: torch.Tensor, kernel: tuple[int, int], stride: int, pads) -> torch.Tensor:
    """int8 NHWC conv -> exact int32 NHWC. ``w`` is (O, kh*kw*C) int8, K in
    HWIO order (the flax kernel reshaped and transposed)."""
    b, h, wd, c = x.shape
    if tuple(kernel) == (1, 1) and not any(p for pair in pads for p in pair):
        x = x[:, ::stride, ::stride, :]
        cols = x.reshape(-1, c)
    else:
        cols = im2col_s8(x, kernel, stride, pads)
    ho = (h + sum(pads[0]) - kernel[0]) // stride + 1
    wo = (wd + sum(pads[1]) - kernel[1]) // stride + 1
    return int_mm(cols, w).reshape(b, ho, wo, w.shape[0])


def max_pool_s8(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """VALID max-pool of an int8 NHWC tensor, in int8 (max commutes with the
    monotone quantization map, so pooling the int8 stream is exact)."""
    return x.unfold(1, window, stride).unfold(2, window, stride).amax(dim=(-2, -1))
