"""Chain of stride-1 SAME 3x3 conv + bias (+ ReLU), forward and backward:
the CUDA kernels (``csrc/conv_chain.cu``), their wrappers, their plain
versions and the ``torch.autograd.Function`` that joins them.

Port of ``acoustic_image_generation_tpu/ops/pallas_conv.py::conv_chain``
(``_conv_chain_fwd`` and ``_conv_chain_bwd``). Its forward function is
``conv_chain_reference`` there: operands rounded to the compute dtype
(``x.dtype``: bf16 or f32), f32 accumulation, f32 bias and ReLU, and a
rounding to the compute dtype after every layer. Its backward, per layer
from last to first: the ReLU gate ``a_i > 0``, dW and db in f32, and the
data grad as a 3x3 conv of the gated cotangent with the weights flipped in
space and transposed. The cotangent is rounded to the compute dtype on
entry and before every product, and kept in f32 between layers; dx comes
back in the compute dtype. The TPU kernels' padded-flat roll layout is not
carried over: the CUDA kernels read NHWC and mask the SAME padding.

Weights are packed as ``(9*Ci, Co)``, row ``(dy*3 + dx)*Ci + ci``, which is
HWIO flattened (``pack_hwio``); biases are f32 ``(Co,)``. ``conv_chain``
takes the weights in any float dtype (the f32 masters in training) and
casts them to the compute dtype inside, so that dW and db come back in f32.
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Sequence

import torch
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.ops import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WGRAD_PIXELS = 32  # the weight-grad kernels walk pixels in steps of this many
WGRAD_BLOCKS = 4 * 132  # blocks the bf16 weight grad aims for: 4 per SM of an H100
WGRAD_F32_PIXELS = 2048  # pixels of one f32 weight-grad slice


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


def pack_transposed(w: torch.Tensor) -> torch.Tensor:
    """(9*Ci, Co) -> (9*Co, Ci): the data grad's weights, flipped in space
    and transposed, row ``t*Co + co`` = ``w[(8 - t)*Ci + ci, co]``, so that
    the forward kernel computes ``dx = conv3x3(g, w')`` (``_pack_w3t`` of the
    TPU kernel, which mirrors only dx because its roll encodes the dy
    mirror)."""
    ci, co = w.shape[0] // 9, w.shape[1]
    return w.reshape(3, 3, ci, co).flip(0, 1).transpose(2, 3).reshape(9 * co, ci).contiguous()


# ------------------------------------------------------------ plain versions


def _reference_layers(x, weights, biases, relu) -> list[torch.Tensor]:
    dt = x.dtype
    cur = x
    outs = []
    for w, b, r in zip(weights, biases, relu):
        y = F.conv2d(
            cur.to(dt).float().permute(0, 3, 1, 2),
            unpack_oihw(w.to(dt).float()),
            b.float(),
            padding=1,
        )
        if r:
            y = torch.relu(y)
        cur = y.to(dt).permute(0, 2, 3, 1).contiguous()
        outs.append(cur)
    return outs


def conv_chain_reference(x, weights, biases, relu):
    """Plain PyTorch version: the same dtype discipline through F.conv2d in
    f32. ``x`` (N,H,W,C0); ``weights[i]`` packed (9*C_{i-1}, C_i)."""
    return _reference_layers(x, weights, biases, relu)[-1]


def conv_chain_backward_reference(x, acts, weights, gy, relu, needs_input_grad=True,
                                  acc=torch.float32):
    """Plain version of the backward: ``torch.nn.grad`` convolutions in
    ``acc`` (f32; f64 for a witness of the f32 path), with the cotangent
    rounded to the compute dtype before every product.

    ``x`` the chain's input, ``acts[i]`` layer i's output (both in the
    compute dtype), ``weights[i]`` packed, ``gy`` the cotangent of the
    chain's output. Returns ``(dx in the compute dtype or None, dW (9*Ci,
    Co) per layer, db per layer)``, dW and db in ``acc``."""
    dt = x.dtype
    g = gy.to(dt).to(acc)
    k = len(weights)
    dws, dbs = [None] * k, [None] * k
    for i in range(k - 1, -1, -1):
        if relu[i]:
            g = torch.where(acts[i] > 0, g, 0.0)
        w = weights[i].to(dt).to(acc)
        ci, co = w.shape[0] // 9, w.shape[1]
        prev = (x if i == 0 else acts[i - 1]).to(dt).to(acc).permute(0, 3, 1, 2)
        gq = g.to(dt).to(acc).permute(0, 3, 1, 2)
        dw = torch.nn.grad.conv2d_weight(prev, (co, ci, 3, 3), gq, padding=1)
        dws[i] = dw.permute(2, 3, 1, 0).reshape(9 * ci, co)
        dbs[i] = g.sum(dim=(0, 1, 2))
        if i > 0 or needs_input_grad:
            g = torch.nn.grad.conv2d_input(prev.shape, unpack_oihw(w), gq, padding=1)
            g = g.permute(0, 2, 3, 1)
    dx = g.to(dt).contiguous() if needs_input_grad else None
    return dx, dws, dbs


# ------------------------------------------------------------ CUDA entries


@functools.cache
def _entries():
    lib = build.library("conv_chain")
    p = ctypes.c_void_p
    i = ctypes.c_int
    sig = {
        "aig_conv3x3_bias_relu": [p, p, p, p, i, i, i, i, i, i, i, p],
        "aig_conv3x3_data_grad": [p, p, p, i, i, i, i, i, i, p],
        "aig_conv3x3_gate": [p, i, p, i, p, p, ctypes.c_longlong, i, i, p],
        "aig_conv3x3_weight_grad": [p, p, p, i, i, i, i, i, i, i, p],
    }
    out = {}
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


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
        if not (w.is_floating_point() and b.dtype == torch.float32):
            raise TypeError(f"conv_chain takes float weights and f32 biases, got {w.dtype}, {b.dtype}")
        c = w.shape[1]
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_chain runs on cpu or cuda, got {x.device}")
    if x.device.type == "cuda":
        n, h, w_, _ = x.shape
        if n * h * w_ * max(x.shape[-1], *(w.shape[1] for w in weights)) >= 2**31:
            raise ValueError(f"conv_chain input too large for one launch: {tuple(x.shape)}")
        for t in (*weights, *biases):
            if t.device != x.device:
                raise ValueError("conv_chain operands must share one device")


def _forward_cuda(x, weights, biases, relu) -> list[torch.Tensor]:
    """One kernel launch per conv; ``weights`` already in ``x.dtype``."""
    fn = _entries()["aig_conv3x3_bias_relu"]
    n, h, w_, _ = x.shape
    code = _DTYPES[x.dtype]
    cur = x.contiguous()
    outs = []
    with torch.cuda.device(x.device):
        for w, b, r in zip(weights, biases, relu):
            ci, co = cur.shape[-1], w.shape[1]
            y = torch.empty((n, h, w_, co), dtype=x.dtype, device=x.device)
            rc = fn(
                cur.data_ptr(), w.contiguous().data_ptr(), b.contiguous().data_ptr(), y.data_ptr(),
                n, h, w_, ci, co, int(bool(r)), code, _stream(x.device),
            )
            build.check(rc, "conv_chain")
            conv_chain.launches += 1
            outs.append(y)
            cur = y
    return outs


def wgrad_splits(m: int, ci: int, co: int, dtype: torch.dtype) -> int:
    """Pixel slices of the weight grad. bf16: enough blocks to fill the
    card, each slice at least 64 steps of ``WGRAD_PIXELS`` pixels deep (the
    kernel tiles the rows of a Ci that is not a multiple of 8 flat over
    (tap, channel), the others one tap at a time). f32: slices of
    ``WGRAD_F32_PIXELS`` pixels, so that each thread's serial f32 sum stays
    short; its rounding grows with its length."""
    if dtype == torch.float32:
        return max(1, -(-m // WGRAD_F32_PIXELS))
    flat = ci % 8 != 0
    tiles = (-(-9 * ci // 64) if flat else 9 * -(-ci // 64)) * -(-co // 64)
    most = max(1, m // (64 * WGRAD_PIXELS))
    return max(1, min(-(-WGRAD_BLOCKS // tiles), most))


def _backward_cuda(x, acts, weights, gy, relu, needs_input_grad):
    fns = _entries()
    dt = x.dtype
    code = _DTYPES[dt]
    n, h, w_, _ = x.shape
    m = n * h * w_
    f32 = dict(dtype=torch.float32, device=x.device)
    k = len(weights)
    dws, dbs = [None] * k, [None] * k
    g = gy.to(dt).contiguous()
    with torch.cuda.device(x.device):
        stream = _stream(x.device)
        for i in range(k - 1, -1, -1):
            w = weights[i]
            ci, co = w.shape[0] // 9, w.shape[1]
            gq = torch.empty((n, h, w_, co), dtype=dt, device=x.device)
            dbs[i] = torch.zeros((co,), **f32)
            rc = fns["aig_conv3x3_gate"](
                g.data_ptr(), int(g.dtype == torch.float32), acts[i].data_ptr(), int(bool(relu[i])),
                gq.data_ptr(), dbs[i].data_ptr(), m, co, code, stream,
            )
            build.check(rc, "conv_chain backward gate")
            conv_chain_backward.launches += 1
            prev = x if i == 0 else acts[i - 1]
            dws[i] = torch.zeros((9 * ci, co), **f32)
            rc = fns["aig_conv3x3_weight_grad"](
                prev.data_ptr(), gq.data_ptr(), dws[i].data_ptr(), n, h, w_, ci, co,
                wgrad_splits(m, ci, co, dt), code, stream,
            )
            build.check(rc, "conv_chain backward weight grad")
            conv_chain_backward.launches += 1
            if i > 0 or needs_input_grad:
                wt = pack_transposed(w)
                g = torch.empty((n, h, w_, ci), **f32)
                rc = fns["aig_conv3x3_data_grad"](
                    gq.data_ptr(), wt.data_ptr(), g.data_ptr(), n, h, w_, co, ci, code, stream,
                )
                build.check(rc, "conv_chain backward data grad")
                conv_chain_backward.launches += 1
    dx = g.to(dt) if needs_input_grad else None
    return dx, dws, dbs


def conv_chain_backward(x, acts, weights, gy, relu, needs_input_grad=True):
    """The chain's backward (see ``conv_chain_backward_reference`` for the
    arguments and the function). On the CPU: the plain version. On CUDA, per
    layer: one gate + bias-grad launch, one weight-grad launch and, unless it
    is the first layer and ``x`` needs no grad, one data-grad launch, each
    counted in ``conv_chain_backward.launches``."""
    weights = [w.to(x.dtype) for w in weights]
    if x.device.type == "cpu":
        return conv_chain_backward_reference(x, acts, weights, gy, relu, needs_input_grad)
    return _backward_cuda(x.contiguous(), acts, weights, gy, relu, needs_input_grad)


conv_chain_backward.launches = 0


class ConvChainFunction(torch.autograd.Function):
    """``conv_chain`` under autograd. The forward saves the input and every
    layer's output (the TPU kernel's residuals); the backward is
    ``conv_chain_backward``. Weights come in any float dtype and are cast to
    the compute dtype inside, so their grads come back in f32."""

    @staticmethod
    def forward(ctx, x, relu, *params):
        k = len(params) // 2
        weights = [w.to(x.dtype) for w in params[:k]]
        biases = params[k:]
        if x.device.type == "cpu":
            acts = _reference_layers(x, weights, biases, relu)
        else:
            acts = _forward_cuda(x, weights, biases, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, *acts, *weights)
        return acts[-1]

    @staticmethod
    def backward(ctx, gy):
        x, *rest = ctx.saved_tensors
        k = len(ctx.relu)
        acts, weights = rest[:k], rest[k:]
        dx, dws, dbs = conv_chain_backward(
            x, acts, weights, gy.contiguous(), ctx.relu, ctx.needs_input_grad[0]
        )
        return (dx, None, *dws, *dbs)


def conv_chain(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    relu: Sequence[bool],
) -> torch.Tensor:
    """x (N,H,W,C0) -> (N,H,W,C_k) in x.dtype, through conv+bias(+ReLU) x k.

    Differentiable in ``x``, the weights and the biases. On the CPU: the
    plain versions. On CUDA: one forward kernel launch per conv, each
    counted in ``conv_chain.launches``, and the backward kernels of
    ``conv_chain_backward``.
    """
    _check(x, weights, biases, relu)
    return ConvChainFunction.apply(x, tuple(bool(r) for r in relu), *weights, *biases)


conv_chain.launches = 0
