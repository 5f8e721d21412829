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

bf16 on CUDA (the wgmma kernels): channels are zero-padded to a multiple of
8 (``pad_channels``) so that every copy is a whole 16-byte chunk; the
chain keeps its intermediates at the padded width and hands out views of
the real channels. Weights go to the kernel K-major (``pack_kmajor``), and
``plan_tiles`` picks each launch's tile. The backward runs one gate launch
a chain and, per layer, a weight grad and a data grad whose epilogue gates
and sums the previous layer's cotangent (``gated_data_grad_reference`` is
that step's plain version).
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Sequence

import torch
import torch.nn.functional as F

from acoustic_image_generation_tpu_torch.ops import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SM_COUNT = 132  # SMs of an H100 SXM
STAGE_K = 64  # K of one stage of the bf16 kernels: channels (forward, data grad) or pixels (weight grad)
TILE_N = (16, 64, 128, 136)  # output-channel tiles the bf16 implicit GEMM is built for
WGRAD_TILE_N = (64, 128, 192)  # the weight grad's: whole 64-channel atoms of its swizzled tiles
WIDE_N = 128  # the tile of outputs wider than the widest tile
WGRAD_BLOCKS = 2 * SM_COUNT  # blocks the bf16 weight grad aims for: 2 resident per SM
WGRAD_MIN_STEPS = 32  # the least stages of STAGE_K pixels in one weight-grad slice
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


# ------------------------------------------------- layouts of the bf16 kernels


def padded_width(c: int) -> int:
    """Channels as the bf16 kernels store them: ``c`` rounded up to 8."""
    return -(-c // 8) * 8


def pad_channels(t: torch.Tensor, reuse: bool = False) -> torch.Tensor:
    """(N, H, W, C) -> contiguous (N, H, W, padded_width(C)), zero in the
    added channels. With ``reuse``, a view of the first C channels of a
    contiguous padded tensor (what the bf16 forward hands out) is taken back
    whole, with no copy; its added channels are then whatever that tensor
    holds, which only the weight grad's discarded rows and the data grad's
    zero columns see."""
    c = t.shape[-1]
    cp = padded_width(c)
    if cp == c:
        return t.contiguous()
    n, h, w, _ = t.shape
    if reuse and t.stride() == (h * w * cp, w * cp, cp, 1):
        return t.as_strided((n, h, w, cp), t.stride())
    out = t.new_zeros((n, h, w, cp))
    out[..., :c] = t
    return out


def pack_kmajor(w: torch.Tensor, cin_p: int, rows: int) -> torch.Tensor:
    """Packed (9*Cin, Cout) -> (rows, K) for the bf16 implicit GEMM, K-major,
    K in the kernel's order (``chunk_tap`` in ``csrc/conv_chain.cu``):
    slices of 64 input channels, and within a slice the 9 taps, so that
    column ``s*576 + tap*64 + c`` holds ``w[tap*Cin + 64*s + c, n]`` (a last,
    narrower slice of w channels likewise, ``tap*w + c``); zero in the
    padded channels, in the rows past Cout and in the columns past 9*cin_p
    (K is rounded up to whole stages of ``STAGE_K``)."""
    cin, cout = w.shape[0] // 9, w.shape[1]
    if cin_p < cin or cin_p % 8 or rows < cout:
        raise ValueError(f"cannot pack ({9 * cin}, {cout}) into {cin_p} channels and {rows} rows")
    k = -(-9 * cin_p // STAGE_K) * STAGE_K
    full = cin // 64 * 64  # whole slices of 64 channels: columns (slice, tap, channel)
    dense = full == cin == cin_p and rows == cout and k == 9 * cin_p
    out = w.new_empty((rows, k)) if dense else w.new_zeros((rows, k))
    src = w.view(9, cin, cout)
    if full:
        out[:cout, : 9 * full].view(cout, full // 64, 9, 64).copy_(
            src[:, :full].view(9, full // 64, 64, cout).permute(3, 1, 0, 2))
    if full < cin:  # the last, narrower slice: columns (tap, channel)
        out[:cout, 9 * full : 9 * cin_p].view(cout, 9, cin_p - full)[:, :, : cin - full].copy_(
            src[:, full:].permute(2, 0, 1))
    return out


def plan_tiles(m: int, cout: int) -> tuple[int, int, int]:
    """``(bm, bn, n_tiles)`` of a bf16 forward or data-grad launch over ``m``
    pixels and ``cout`` output channels: one N tile of the smallest of
    ``TILE_N`` that holds them all (tiles of ``WIDE_N`` above that), and 128
    pixels a block unless that gives fewer than two blocks per SM, then 64."""
    cp = padded_width(cout)
    fits = [bn for bn in TILE_N if bn >= cp]
    bn, n_tiles = (fits[0], 1) if fits else (WIDE_N, -(-cp // WIDE_N))
    bm = 128 if -(-m // 128) * n_tiles >= 2 * SM_COUNT else 64
    return bm, bn, n_tiles


def wgrad_tiles(co: int) -> tuple[int, int, int]:
    """``(bm, bn, n_tiles)`` of a bf16 weight-grad launch with ``co`` output
    channels: columns in the smallest of ``WGRAD_TILE_N`` that holds them
    all (tiles of ``WIDE_N`` above that); 256 rows of the flat (tap,
    channel) order a block, each cotangent stage read once for 256 rows,
    except at 192 columns (128 rows: the accumulators of 256 would not fit
    in registers)."""
    cp = padded_width(co)
    fits = [bn for bn in WGRAD_TILE_N if bn >= cp]
    bn, n_tiles = (fits[0], 1) if fits else (WIDE_N, -(-cp // WIDE_N))
    return (128 if bn == 192 else 256), bn, n_tiles


def wgrad_splits(m: int, ci: int, co: int, dtype: torch.dtype) -> int:
    """Pixel slices of the weight grad. bf16: enough blocks to fill the card
    (``WGRAD_BLOCKS``) over ``wgrad_tiles``'s tiles of rows of the flat
    (tap, padded channel) order and of columns, each slice
    at least ``WGRAD_MIN_STEPS`` stages deep. f32: slices of
    ``WGRAD_F32_PIXELS`` pixels, so that each thread's serial f32 sum stays
    short; its rounding grows with its length."""
    if dtype == torch.float32:
        return max(1, -(-m // WGRAD_F32_PIXELS))
    bm, _, n_tiles = wgrad_tiles(co)
    tiles = -(-9 * padded_width(ci) // bm) * n_tiles
    most = max(1, m // (WGRAD_MIN_STEPS * STAGE_K))
    return max(1, min(-(-WGRAD_BLOCKS // tiles), most))


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


def gated_data_grad_reference(gq, w, act, relu):
    """Plain version of the bf16 backward's fused step: the data grad of a
    layer, ``conv3x3(gq, pack_transposed(w))`` in f32, on ``gq`` (N,H,W,Co)
    in the compute dtype and ``w`` packed (9*Ci, Co), then the previous
    layer's gate. With ``act`` (the previous layer's output): ``g = sums *
    (act > 0)`` if ``relu`` else the sums, returned as ``(g in the compute
    dtype, column sums of g in f32)``, the previous layer's ``gq`` and
    ``db``. With ``act`` None (the chain's first layer): ``(dx, None)``."""
    dt = gq.dtype
    wt = pack_transposed(w.to(dt).float())
    g = F.conv2d(gq.float().permute(0, 3, 1, 2), unpack_oihw(wt), padding=1).permute(0, 2, 3, 1)
    if act is None:
        return g.to(dt).contiguous(), None
    if relu:
        g = torch.where(act > 0, g, 0.0)
    return g.to(dt).contiguous(), g.sum(dim=(0, 1, 2))


# ------------------------------------------------------------ CUDA entries


@functools.cache
def _entries():
    lib = build.library("conv_chain")
    p = ctypes.c_void_p
    i = ctypes.c_int
    sig = {
        "aig_conv3x3_f32": [p, p, p, p, i, i, i, i, i, i, p],
        "aig_conv3x3_bf16": [p, p, p, i, p, i, p, i, p, i, i, i, i, i, i, i, i, i, i, i, p],
        "aig_conv3x3_data_grad_f32": [p, p, p, i, i, i, i, i, p],
        "aig_conv3x3_gate": [p, i, i, p, i, i, p, i, p, ctypes.c_longlong, i, i, p],
        "aig_conv3x3_weight_grad_f32": [p, p, p, i, i, i, i, i, i, p],
        "aig_conv3x3_weight_grad_bf16": [p, p, p, i, i, i, i, i, i, i, i, i, i, i, p],
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
        widest = max(padded_width(x.shape[-1]), *(padded_width(w.shape[1]) for w in weights))
        if n * h * w_ * widest >= 2**31:
            raise ValueError(f"conv_chain input too large for one launch: {tuple(x.shape)}")
        for t in (*weights, *biases):
            if t.device != x.device:
                raise ValueError("conv_chain operands must share one device")


def _conv_bf16(x, wk, plan, y, *, bias=None, relu=False, act=None, db=None, cols=None):
    """One bf16 implicit-GEMM launch (see ``aig_conv3x3_bf16``): ``x`` and
    ``y`` padded NHWC, ``wk`` from ``pack_kmajor``; ``cols`` real output
    channels (the bias's or db's length)."""
    n, h, w_, cip = x.shape
    bm, bn, n_tiles = plan
    ld = y.shape[-1]
    return _entries()["aig_conv3x3_bf16"](
        x.data_ptr(), wk.data_ptr(), None if bias is None else bias.data_ptr(), int(bool(relu)),
        None if act is None else act.data_ptr(), ld, None if db is None else db.data_ptr(), cols or 0,
        y.data_ptr(), ld, ld, n, h, w_, cip, wk.shape[1], cols or 0, bm, bn, n_tiles,
        _stream(x.device),
    )


def _forward_cuda(x, weights, biases, relu) -> list[torch.Tensor]:
    """One kernel launch per conv; ``weights`` already in ``x.dtype``. Each
    layer's output, bf16 as a view of the real channels of its padded
    buffer."""
    n, h, w_, _ = x.shape
    m = n * h * w_
    outs = []
    with torch.cuda.device(x.device):
        if x.dtype == torch.float32:
            fn = _entries()["aig_conv3x3_f32"]
            cur = x.contiguous()
            for w, b, r in zip(weights, biases, relu):
                ci, co = cur.shape[-1], w.shape[1]
                y = torch.empty((n, h, w_, co), dtype=x.dtype, device=x.device)
                build.check(fn(cur.data_ptr(), w.contiguous().data_ptr(), b.contiguous().data_ptr(),
                               y.data_ptr(), n, h, w_, ci, co, int(bool(r)), _stream(x.device)),
                            "conv_chain")
                conv_chain.launches += 1
                outs.append(y)
                cur = y
            return outs
        cur = pad_channels(x)
        for w, b, r in zip(weights, biases, relu):
            co = w.shape[1]
            plan = plan_tiles(m, co)
            wk = pack_kmajor(w, cur.shape[-1], plan[1] * plan[2])
            y = torch.empty((n, h, w_, padded_width(co)), dtype=x.dtype, device=x.device)
            build.check(_conv_bf16(cur, wk, plan, y, bias=b.contiguous(), relu=r, cols=co), "conv_chain")
            conv_chain.launches += 1
            outs.append(y[..., :co])
            cur = y
    return outs


def _launch(parts, part, layer, fn, tensors, *args) -> None:
    """One counted backward launch; with ``parts`` (a list), also keep a
    closure that repeats it on the same tensors, for timing part by part."""
    build.check(fn(*args), f"conv_chain backward {part}")
    conv_chain_backward.launches += 1
    if parts is not None:
        parts.append((part, layer, lambda: build.check(fn(*args), part), tensors))


def _backward_f32(x, acts, weights, gy, relu, needs_input_grad, parts=None):
    """The f32 backward: per layer a gate, a weight grad and a data grad
    with an f32 cotangent out."""
    fns = _entries()
    n, h, w_, _ = x.shape
    m = n * h * w_
    f32 = dict(dtype=torch.float32, device=x.device)
    k = len(weights)
    dws, dbs = [None] * k, [None] * k
    g = gy.to(x.dtype).contiguous()
    stream = _stream(x.device)
    for i in range(k - 1, -1, -1):
        w = weights[i]
        ci, co = w.shape[0] // 9, w.shape[1]
        gq = torch.empty((n, h, w_, co), **f32)
        dbs[i] = torch.zeros((co,), **f32)
        a = acts[i].contiguous()
        _launch(parts, "gate", i, fns["aig_conv3x3_gate"], (g, a, gq, dbs[i]),
                g.data_ptr(), 1, co, a.data_ptr(), co, int(bool(relu[i])), gq.data_ptr(), co,
                dbs[i].data_ptr(), m, co, 0, stream)
        prev = (x if i == 0 else acts[i - 1]).contiguous()
        dws[i] = torch.zeros((9 * ci, co), **f32)
        _launch(parts, "weight grad", i, fns["aig_conv3x3_weight_grad_f32"], (prev, gq, dws[i]),
                prev.data_ptr(), gq.data_ptr(), dws[i].data_ptr(), n, h, w_, ci, co,
                wgrad_splits(m, ci, co, torch.float32), stream)
        if i > 0 or needs_input_grad:
            wt = pack_transposed(w)
            g = torch.empty((n, h, w_, ci), **f32)
            _launch(parts, "data grad", i, fns["aig_conv3x3_data_grad_f32"], (gq, wt, g),
                    gq.data_ptr(), wt.data_ptr(), g.data_ptr(), n, h, w_, co, ci, stream)
    return (g if needs_input_grad else None), dws, dbs


def _backward_bf16(x, acts, weights, gy, relu, needs_input_grad, parts=None):
    """The bf16 backward: one gate launch on the incoming cotangent, then
    per layer the weight grad and the data grad, whose epilogue applies the
    previous layer's gate and sums its db; padded bf16 cotangents between
    layers."""
    fns = _entries()
    dt = x.dtype
    n, h, w_, _ = x.shape
    m = n * h * w_
    f32 = dict(dtype=torch.float32, device=x.device)
    k = len(weights)
    chans = [x.shape[-1]] + [w.shape[1] for w in weights]
    ins = [pad_channels(t, reuse=True) for t in (x, *acts[:-1])]  # each layer's input, padded
    dws, dbs = [None] * k, [None] * k
    stream = _stream(x.device)

    co = chans[-1]
    g = gy.to(dt).contiguous()
    a = pad_channels(acts[-1], reuse=True)
    gq = torch.empty((n, h, w_, padded_width(co)), dtype=dt, device=x.device)
    dbs[-1] = torch.zeros((co,), **f32)
    _launch(parts, "gate", k - 1, fns["aig_conv3x3_gate"], (g, a, gq, dbs[-1]),
            g.data_ptr(), 0, co, a.data_ptr(), a.shape[-1], int(bool(relu[-1])), gq.data_ptr(),
            gq.shape[-1], dbs[-1].data_ptr(), m, co, 1, stream)
    for i in range(k - 1, -1, -1):
        ci, co = chans[i], chans[i + 1]
        bm, bn, n_tiles = wgrad_tiles(co)
        dws[i] = torch.zeros((9 * ci, co), **f32)
        _launch(parts, "weight grad", i, fns["aig_conv3x3_weight_grad_bf16"], (ins[i], gq, dws[i]),
                ins[i].data_ptr(), gq.data_ptr(), dws[i].data_ptr(), n, h, w_, ins[i].shape[-1],
                gq.shape[-1], ci, co, bm, bn, n_tiles, wgrad_splits(m, ci, co, dt), stream)
        if i == 0 and not needs_input_grad:
            break
        plan = plan_tiles(m, ci)
        wt = pack_kmajor(pack_transposed(weights[i]), gq.shape[-1], plan[1] * plan[2])
        out = torch.empty((n, h, w_, padded_width(ci)), dtype=dt, device=x.device)
        act = db = None
        if i > 0:
            dbs[i - 1] = db = torch.zeros((ci,), **f32)
            act = ins[i] if relu[i - 1] else None
        _launch(parts, "data grad", i,
                lambda *args, act=act, db=db, ci=ci: _conv_bf16(*args, act=act, db=db, cols=ci),
                (gq, wt, out, ins[i], db), gq, wt, plan, out)
        gq = out
    return (gq[..., : chans[0]].contiguous() if needs_input_grad else None), dws, dbs


def _backward_cuda(x, acts, weights, gy, relu, needs_input_grad, parts=None):
    with torch.cuda.device(x.device):
        run = _backward_f32 if x.dtype == torch.float32 else _backward_bf16
        return run(x, acts, weights, gy, relu, needs_input_grad, parts)


def backward_parts(x, acts, weights, gy, relu, needs_input_grad=True):
    """Run the CUDA backward once and return ``[(part, layer, fn, tensors)]``,
    one per launch in launch order: ``fn()`` repeats that launch on the same
    tensors (kept alive by ``tensors``), so that each part can be timed
    alone. Sums into dW and db grow with every repeat: for timing only."""
    parts = []
    _backward_cuda(x.contiguous(), acts, [w.to(x.dtype) for w in weights], gy, relu,
                   needs_input_grad, parts)
    return parts


def conv_chain_backward(x, acts, weights, gy, relu, needs_input_grad=True):
    """The chain's backward (see ``conv_chain_backward_reference`` for the
    arguments and the function). On the CPU: the plain version. On CUDA,
    each launch counted in ``conv_chain_backward.launches``: in bf16 one
    gate + bias-grad launch for the chain, and per layer one weight-grad
    launch and, unless it is the first layer and ``x`` needs no grad, one
    data-grad launch with the previous layer's gate and bias grad; in f32
    a gate launch per layer besides."""
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
        return acts[-1].contiguous()

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
