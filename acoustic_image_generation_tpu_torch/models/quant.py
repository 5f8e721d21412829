"""Int8 (W8A8) forward of the frozen ResNet trunk, every BatchNorm folded
into its conv.

Port of ``acoustic_image_generation_tpu/models/quant.py``. With
``trunk_bn="frozen"`` every trunk BN is a fixed affine map, so it folds into
the conv before it: ``W' = W * gamma/sqrt(var+eps)`` per output channel,
``b' = beta - mean * gamma/sqrt(var+eps)``. Weights are then symmetric
per-output-channel int8 (``amax/127`` scales); activations symmetric
per-tensor int8 with static scales from one calibration pass
(``calibrate``). Every conv is an ``s8 x s8`` product with an exact s32
sum, dequantized with ``(a_amax/127) * w_scale`` plus the folded bias in
f32, then ReLU, then requantized to the next site. Between layers only the
int8 stream is kept.

The quantized trunk is a ``QuantTrunk`` module of int8 ``w``, f32
``scale``/``bias`` buffers per conv, named as the ResNet50's convs
(``conv1``, ``block2_unit_4.conv2``, ``block1_unit_1.shortcut``), and one
``act`` buffer of static amaxes, one per site, named as in JAX: ``input``,
``stem_out``, ``{unit}/c2``, ``{unit}/c3``, ``{unit}/out``, ``{unit}/sc``.
Weights are (O, kh*kw*I), K in HWIO order: the layout ``qgemm_s8`` and the
im2col product read (``bridge.load_qtrunk`` converts JAX's HWIO).

``trunk_forward(fused_gemm=True)`` runs every 1x1 conv (conv1, conv3 and
the projection shortcuts; every shortcut is stride 1 or reads the
subsampled grid) through ``ops.qgemm.fused_q1x1``, the ``qgemm_s8`` CUDA
kernel on the card: conv, dequant, bias, shortcut add, ReLU and requant in
one launch, 36 per trunk forward. The stem and the 3x3 convs run as exact
int32 products (``ops/qconv.py``).

Under tensor parallelism (``parallel/mesh.py``) the int8 trunk is whole on
every rank, as JAX keeps it outside its split state: folded and quantized
from the whole float kernels, its amaxes the maxima over the data group.

Under spatial sharding (``parallel/spatial.py``) ``trunk_forward_rows`` runs
the unfused program with static scales on a request's row blocks, each
conv and the max-pool on the input window its shard's output rows read.
The int8 products are exact and every other step is elementwise, so the
split trunk equals the whole one to the bit.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from acoustic_image_generation_tpu_torch.models.resnet import RESNET50_BLOCKS, ConvBN, ResNet50
from acoustic_image_generation_tpu_torch.ops.qconv import conv2d_s8, max_pool_s8
from acoustic_image_generation_tpu_torch.ops.qgemm import fdiv, fused_q1x1
from acoustic_image_generation_tpu_torch.ops.tf_compat import fixed_pads, same_pads
from acoustic_image_generation_tpu_torch.parallel import mesh, spatial

# ------------------------------------------------------------------- fold


def fold_conv_bn(conv: ConvBN) -> tuple[torch.Tensor, torch.Tensor]:
    """``(kernel OIHW f32, bias f32 (O,))`` of ``conv`` with its BN folded
    in, on the BN's running statistics; a kernel split over the model group
    is gathered whole first (every peer calls)."""
    bn = conv.bn
    with torch.no_grad():
        s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        kernel = mesh.full(conv.weight).float()
        return kernel * s[:, None, None, None], bn.bias.float() - bn.running_mean.float() * s


def _quantize_kernel(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: OIHW kernel -> (int8 OIHW,
    scale (O,))."""
    amax = kernel.abs().amax(dim=(1, 2, 3))
    scale = fdiv(torch.clamp_min(amax, 1e-12), 127.0)
    q = torch.clamp(torch.round(kernel / scale[:, None, None, None]), -127, 127)
    return q.to(torch.int8), scale


# ----------------------------------------------------------------- module


class QLayer(nn.Module):
    """One folded int8 conv: ``w`` int8 (O, kh*kw*I) with K in HWIO order,
    ``scale`` f32 (O,) the weight scales, ``bias`` f32 (O,) the folded
    bias."""

    def __init__(self, in_ch: int, out_ch: int, kernel=(1, 1), *, device=None):
        super().__init__()
        self.kernel = tuple(kernel)
        self.in_ch = in_ch
        kh, kw = self.kernel
        self.register_buffer("w", torch.zeros((out_ch, kh * kw * in_ch), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones((out_ch,), dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros((out_ch,), dtype=torch.float32, device=device))

    def set_folded(self, kernel: torch.Tensor, bias: torch.Tensor) -> None:
        """Quantize a folded OIHW ``kernel`` into ``w`` and ``scale``."""
        q, scale = _quantize_kernel(kernel)
        with torch.no_grad():
            self.w.copy_(q.permute(0, 2, 3, 1).reshape(q.shape[0], -1))
            self.scale.copy_(scale)
            self.bias.copy_(bias)


class QUnit(nn.Module):
    """The folded convs of one bottleneck unit; ``shortcut`` is None for an
    identity shortcut."""

    def __init__(self, in_ch: int, depth: int, bottleneck: int, *, device=None):
        super().__init__()
        self.shortcut = QLayer(in_ch, depth, device=device) if depth != in_ch else None
        self.conv1 = QLayer(in_ch, bottleneck, device=device)
        self.conv2 = QLayer(bottleneck, bottleneck, (3, 3), device=device)
        self.conv3 = QLayer(bottleneck, depth, device=device)


class QuantTrunk(nn.Module):
    """The quantized trunk of a ResNet50 with ``blocks`` ((base_depth,
    num_units, stride) per block): folded int8 convs and the static
    activation amaxes, which start at 1.0 until ``calibrate`` sets them."""

    def __init__(self, blocks=RESNET50_BLOCKS, *, device=None):
        super().__init__()
        self.units = _unit_names(blocks)
        self.conv1 = QLayer(3, 64, (7, 7), device=device)
        self.sites = ["input", "stem_out"]
        in_ch = 64
        depths = [base for base, num_units, _ in blocks for _ in range(num_units)]
        for (name, _), base in zip(self.units, depths):
            unit = QUnit(in_ch, base * 4, base, device=device)
            self.add_module(name, unit)
            if unit.shortcut is not None:
                self.sites.append(f"{name}/sc")
            self.sites += [f"{name}/c2", f"{name}/c3", f"{name}/out"]
            in_ch = base * 4
        self._index = {s: i for i, s in enumerate(self.sites)}
        self.register_buffer("act", torch.ones((len(self.sites),), dtype=torch.float32, device=device))

    def amax(self, site: str) -> torch.Tensor:
        """The static amax of ``site``, a 0-dim f32 tensor."""
        return self.act[self._index[site]]


def _unit_names(blocks) -> list[tuple[str, int]]:
    """(unit name, stride) in execution order: the last unit of a block
    carries its stride."""
    out = []
    for b, (_, num_units, block_stride) in enumerate(blocks, start=1):
        for u in range(1, num_units + 1):
            out.append((f"block{b}_unit_{u}", block_stride if u == num_units else 1))
    return out


def quantize_trunk(resnet: ResNet50) -> QuantTrunk:
    """Fold and quantize the trunk of ``resnet`` (conv1 and every unit) on
    its device. ``conv_map`` stays out: it trains. Run ``calibrate`` before
    using the result."""
    qt = QuantTrunk(resnet.blocks, device=resnet.conv1.weight.device)
    with torch.no_grad():
        for path, layer in qt.named_modules():
            if isinstance(layer, QLayer):
                layer.set_folded(*fold_conv_bn(resnet.get_submodule(path)))
    return qt


# ---------------------------------------------------------------- forward


def _quant_act(x, amax, site, collect, observed):
    """Quantize ``x`` at ``site``; in ``collect`` mode with its own amax,
    recorded in ``observed``."""
    xf = x.float()
    if collect:
        # the global batch's amax: each site's dynamic scale, and so every
        # later site's input, is the one-device run's over all the rows
        amax = mesh.all_reduce_(xf.abs().amax(), "max")
        observed[site] = amax
    amax = torch.clamp_min(amax, 1e-12)
    q = torch.round(xf * fdiv(127.0, amax)).clamp_(-127, 127)
    return q.to(torch.int8), amax


def _deq(q, amax):
    return q.float() * fdiv(amax, 127.0)


def _qconv(xq, a_amax, layer: QLayer, stride: int, *, fixed_pad: bool) -> torch.Tensor:
    """int8 conv + dequant + folded bias, f32 NHWC result. Padding: tf-slim's
    fixed pad, or XLA "SAME"."""
    kh, kw = layer.kernel
    if fixed_pad:
        pads = (fixed_pads(kh), fixed_pads(kw))
    else:
        pads = (same_pads(xq.shape[1], kh, stride), same_pads(xq.shape[2], kw, stride))
    acc = conv2d_s8(xq, layer.w, layer.kernel, stride, pads)
    return acc.float().mul_(fdiv(a_amax, 127.0) * layer.scale).add_(layer.bias)


def _fused(xq, layer: QLayer, a_amax, out_amax, **kw):
    return fused_q1x1(xq, layer.w, layer.scale, layer.bias, a_amax, out_amax, **kw)


def trunk_forward(qt: QuantTrunk, x: torch.Tensor, *, collect: bool = False,
                  out_dtype=torch.bfloat16, fused_gemm: bool = False):
    """Quantized trunk: normalized f32 video (N,224,298,3) in [0,1] -> block4
    features (N,14,19,2048) in ``out_dtype``, as ``ResNet50(mode="trunk")``
    over the folded int8 layers. ``collect`` runs with each site's own amax
    and records it. Returns ``(features, observed amaxes)``.

    The ``input`` site quantizes ``x`` in f32, not a cast of it to the
    compute dtype. ``fused_gemm`` (static scales only) runs every 1x1 conv
    through ``qgemm_s8``; its outputs may differ from the unfused path by
    one int8 quantum per site."""
    observed: dict = {}
    use_fused = fused_gemm and not collect

    def qa(v, site):
        return _quant_act(v, qt.amax(site), site, collect, observed)

    xq, a = qa(x, "input")
    y = torch.relu_(_qconv(xq, a, qt.conv1, 2, fixed_pad=True))
    yq, a = qa(y, "stem_out")
    yq = max_pool_s8(yq, 3, 2)
    for name, stride in qt.units:
        unit = getattr(qt, name)
        if use_fused:
            # the residual stays an int8 stream with its amax, consumed by
            # conv3's kernel; a strided 1x1 SAME conv reads only the
            # subsampled grid, so it is the stride-1 GEMM over x[::s, ::s]
            sub = yq if stride == 1 else yq[:, ::stride, ::stride, :]
            if unit.shortcut is not None:
                a_res = qt.amax(f"{name}/sc")
                resq = _fused(sub, unit.shortcut, a, a_res, relu=False)
            else:
                resq, a_res = sub, a
            a2 = qt.amax(f"{name}/c2")
            rq = _fused(yq, unit.conv1, a, a2, relu=True)
            r = torch.relu_(_qconv(rq, a2, unit.conv2, stride, fixed_pad=stride > 1))
            rq, a3 = qa(r, f"{name}/c3")
            a = qt.amax(f"{name}/out")
            yq = _fused(rq, unit.conv3, a3, a, relu=True, residual=resq, residual_amax=a_res)
            continue
        if unit.shortcut is not None:
            scq, a_sc = qa(_qconv(yq, a, unit.shortcut, stride, fixed_pad=False), f"{name}/sc")
            shortcut = _deq(scq, a_sc)
        else:
            # identity subsample = 1x1 stride-s max-pool
            shortcut = _deq(yq[:, ::stride, ::stride, :], a)
        r = torch.relu_(_qconv(yq, a, unit.conv1, 1, fixed_pad=False))
        rq, a2 = qa(r, f"{name}/c2")
        r = torch.relu_(_qconv(rq, a2, unit.conv2, stride, fixed_pad=stride > 1))
        rq, a3 = qa(r, f"{name}/c3")
        r = _qconv(rq, a3, unit.conv3, 1, fixed_pad=False)
        yq, a = qa(torch.relu_(shortcut.add_(r)), f"{name}/out")
    return _deq(yq, a).to(out_dtype), observed


def _qconv_rows(xq: spatial.Rows, layers: list, a_amax: list, stride: int, *, fixed_pad: bool,
                name: str) -> spatial.Rows:
    """``_qconv`` on row blocks: ``layers[i]`` and ``a_amax[i]`` on shard
    ``i``'s device, the row padding the whole image's."""
    kh, kw = layers[0].kernel
    if fixed_pad:
        hp, wp = fixed_pads(kh), fixed_pads(kw)
    else:
        hp, wp = same_pads(xq.height, kh, stride), same_pads(xq.width, kw, stride)

    def run(i, win):
        layer = layers[i]
        acc = conv2d_s8(win, layer.w, layer.kernel, stride, ((0, 0), wp))
        return acc.float().mul_(fdiv(a_amax[i], 127.0) * layer.scale).add_(layer.bias)

    return spatial.layer(xq, kh, stride, hp, run, name)


def trunk_forward_rows(qts: list, x: spatial.Rows, *, out_dtype=torch.bfloat16) -> spatial.Rows:
    """``trunk_forward`` with static scales, unfused, on row blocks:
    ``qts[i]`` is the calibrated ``QuantTrunk`` on shard ``i``'s device,
    ``x`` the normalized f32 video's rows. Returns the block4 feature's rows
    in ``out_dtype``, equal to the bit to ``trunk_forward``'s."""

    def amaxes(site):
        return [torch.clamp_min(qt.amax(site), 1e-12) for qt in qts]

    def quant(rows, site):
        a = amaxes(site)
        return rows.map(lambda i, v: _quant_act(v, a[i], site, False, None)[0]), a

    def deq(rows, a):
        return rows.map(lambda i, q: _deq(q, a[i]))

    def layers(path):
        return [qt.get_submodule(path) for qt in qts]

    xq, a = quant(x, "input")
    y = _qconv_rows(xq, layers("conv1"), a, 2, fixed_pad=True, name="conv1").map(lambda i, v: torch.relu_(v))
    yq, a = quant(y, "stem_out")
    yq = spatial.layer(yq, 3, 2, (0, 0), lambda i, w: max_pool_s8(w, 3, 2), "pool1")
    for name, stride in qts[0].units:
        unit = getattr(qts[0], name)
        if unit.shortcut is not None:
            sc = _qconv_rows(yq, layers(f"{name}.shortcut"), a, stride, fixed_pad=False, name=f"{name}/shortcut")
            shortcut = deq(*quant(sc, f"{name}/sc"))
        elif stride > 1:  # rows at even global indices: each window starts at one
            shortcut = deq(spatial.layer(yq, 1, stride, (0, 0), lambda i, w, s=stride: w[:, ::s, ::s],
                                         f"{name}/subsample"), a)
        else:
            shortcut = deq(yq, a)
        r = _qconv_rows(yq, layers(f"{name}.conv1"), a, 1, fixed_pad=False, name=f"{name}/conv1")
        rq, a2 = quant(r.map(lambda i, v: torch.relu_(v)), f"{name}/c2")
        r = _qconv_rows(rq, layers(f"{name}.conv2"), a2, stride, fixed_pad=stride > 1, name=f"{name}/conv2")
        rq, a3 = quant(r.map(lambda i, v: torch.relu_(v)), f"{name}/c3")
        r = _qconv_rows(rq, layers(f"{name}.conv3"), a3, 1, fixed_pad=False, name=f"{name}/conv3")
        yq, a = quant(shortcut.zip(r, lambda i, s, v: torch.relu_(s.add_(v))), f"{name}/out")
    return deq(yq, a).map(lambda i, v: v.to(out_dtype))


def calibrate(qt: QuantTrunk, video: torch.Tensor) -> QuantTrunk:
    """One-pass static calibration: run the trunk with dynamic scales on a
    representative batch of normalized frames and store the observed
    per-site amaxes in ``qt.act`` (in place). Returns ``qt``. With more than
    one rank, ``video`` is this rank's rows of the batch and each amax is
    taken over every rank's (an all-reduce ``MAX`` a site), so every rank
    holds the one-device calibration of the whole batch."""
    with torch.no_grad():
        _, observed = trunk_forward(qt, video, collect=True)
        qt.act.copy_(torch.stack([observed[s] for s in qt.sites]))
    return qt
