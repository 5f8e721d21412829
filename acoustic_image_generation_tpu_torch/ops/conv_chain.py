"""Chain of stride-1 SAME 3x3 conv + bias (+ ReLU): the CUDA kernel
(``csrc/conv_chain.cu``), its wrapper and its plain version.

Port of the forward of ``acoustic_image_generation_tpu/ops/pallas_conv.py::
conv_chain``. Its function is ``conv_chain_reference`` there: operands
rounded to the compute dtype (``x.dtype``: bf16 or f32), f32 accumulation,
f32 bias and ReLU, and a rounding to the compute dtype after every layer.
The TPU kernel's padded-flat roll layout is not carried over: the CUDA
kernel reads NHWC and masks the SAME padding itself.

Weights are packed once, at load time, into the layout the kernel reads:
``(9*Ci, Co)`` in the compute dtype, row ``(dy*3 + dx)*Ci + ci``, which is
HWIO flattened (``pack_hwio``). Biases are f32 ``(Co,)``.
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Sequence

import torch
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.ops import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pack_hwio(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Ci, Co) HWIO -> (9*Ci, Co) kernel layout."""
    kh, kw, ci, co = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"conv_chain takes 3x3 kernels, got {kh}x{kw}")
    return w.reshape(9 * ci, co).contiguous()


def unpack_oihw(w: torch.Tensor) -> torch.Tensor:
    """(9*Ci, Co) kernel layout -> (Co, Ci, 3, 3) OIHW view."""
    ci = w.shape[0] // 9
    return w.reshape(3, 3, ci, w.shape[1]).permute(3, 2, 0, 1)


def conv_chain_reference(x, weights, biases, relu):
    """Plain PyTorch version: the same dtype discipline through F.conv2d in
    f32. ``x`` (N,H,W,C0); ``weights[i]`` packed (9*C_{i-1}, C_i)."""
    dt = x.dtype
    cur = x
    for w, b, r in zip(weights, biases, relu):
        y = F.conv2d(
            cur.to(dt).float().permute(0, 3, 1, 2),
            unpack_oihw(w.to(dt).float()),
            b.float(),
            padding=1,
        )
        if r:
            y = torch.relu(y)
        cur = y.to(dt).permute(0, 2, 3, 1)
    return cur.contiguous()


@functools.cache
def _entry():
    fn = build.library("conv_chain").aig_conv3x3_bias_relu
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, weights, biases, relu) -> None:
    if x.dim() != 4:
        raise ValueError(f"conv_chain takes NHWC input, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv_chain computes in float32 or bfloat16, got {x.dtype}")
    if not (len(weights) == len(biases) == len(relu) > 0):
        raise ValueError("conv_chain needs one weight, bias and relu flag per conv")
    c = x.shape[-1]
    for w, b in zip(weights, biases):
        if w.dim() != 2 or w.shape[0] != 9 * c:
            raise ValueError(f"packed weight {tuple(w.shape)} does not take {c} channels")
        if b.shape != (w.shape[1],):
            raise ValueError(f"bias {tuple(b.shape)} does not match weight {tuple(w.shape)}")
        c = w.shape[1]


def conv_chain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    relu: Sequence[bool],
) -> torch.Tensor:
    """x (N,H,W,C0) -> (N,H,W,C_k) in x.dtype, through conv+bias(+ReLU) x k.

    On the CPU: the plain version. On CUDA: one kernel launch per conv,
    each counted in ``conv_chain.launches``. Forward only: on CUDA a chain
    that autograd would have to differentiate raises NotImplementedError.
    """
    _check(x, weights, biases, relu)
    if x.device.type == "cpu":
        return conv_chain_reference(x, weights, biases, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv_chain runs on cpu or cuda, got {x.device}")
    if torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in (*weights, *biases))
    ):
        raise NotImplementedError("the conv_chain CUDA kernel is forward only")
    n, h, w_, _ = x.shape
    if n * h * w_ * max(w.shape[1] for w in weights) >= 2**31:
        raise ValueError(f"conv_chain input too large for one launch: {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("conv_chain takes a contiguous NHWC input")
    for w, b in zip(weights, biases):
        if w.dtype != x.dtype or b.dtype != torch.float32:
            raise TypeError(
                f"conv_chain takes weights in {x.dtype} and f32 biases, "
                f"got {w.dtype} and {b.dtype}"
            )
        if w.device != x.device or b.device != x.device:
            raise ValueError("conv_chain operands must share one device")
        if not (w.is_contiguous() and b.is_contiguous()):
            raise ValueError("conv_chain takes contiguous packed weights and biases")
    fn = _entry()
    code = _DTYPES[x.dtype]
    cur = x
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for w, b, r in zip(weights, biases, relu):
            ci, co = cur.shape[-1], w.shape[1]
            y = torch.empty((n, h, w_, co), dtype=x.dtype, device=x.device)
            rc = fn(
                cur.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                n, h, w_, ci, co, int(bool(r)), code, stream,
            )
            build.check(rc, "conv_chain")
            conv_chain.launches += 1
            cur = y
    return cur


conv_chain.launches = 0
