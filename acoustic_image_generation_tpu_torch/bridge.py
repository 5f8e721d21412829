"""Move the JAX package's variables into the port's modules and back.

``load_flax(task, params, batch_stats)`` takes the trees that the JAX
task's ``init_variables`` returns (or a checkpoint's), as nested dicts of
numpy arrays: for ``GenerationTask`` ``params = {"resnet": ...,
"generator": ...}``, ``batch_stats = {"resnet": ...}``; for the
classification tasks ``params = {"dualcamnet": ...}`` (with ``"resnet"``
and ``"generator"`` for ``GeneratedClassificationTask``), ``batch_stats``
``{}`` (``{"resnet": ...}``); for ``EmbedTask``
``params = {"acoustic": ..., "audio": ..., "video": ...}``, ``batch_stats =
{"audio": ..., "video": ...}``. Module paths of the port mirror the flax
scopes, and the layouts change as follows:

- conv kernels: HWIO -> OIHW; DualCamNet's temporal conv3d kernel
  (12, 1, 1, C, C) DHWIO -> (C, C, 12, 1);
- Dense kernels: (in, out) -> (out, in);
- ``ConvTransposeTF`` kernels: HWIO -> (in, out, kh, kw), not flipped;
- BN: ``scale``/``bias`` params, ``mean``/``var`` batch stats, under the
  trunk's ``.../BatchNorm`` scope or a UNet's ``bn_i``/``bn_pool_n``;
- ``MeanStd``'s scale-less BN (``models/decoders.py``): ``bias`` param,
  ``mean``/``var`` batch stats under its ``BatchNorm_0`` scope;
- chain convs: HWIO -> the kernel's packed (9*Ci, Co), once, here;
- trunk quirk: the fixed-pad convs (the root ``conv1`` and ``conv2`` of each
  stride-2 unit) keep ``kernel`` directly under their scope, every other
  trunk conv under ``.../conv/kernel``.

A model of ``models/`` alone (``DecoderVideo``, ``DecoderEnergy``,
``DecoderAudio``, ``MeanStd``, ``VGGish``, ``UNetVideoSkip``, which no task
builds) loads and gives back its own flax module's trees the same way.

Every flax leaf must land on exactly one port tensor and every port tensor
must be set; anything else raises. The values land in the port's f32
masters unrounded. ``to_flax(task)`` gives the trees back, as numpy f32,
so that the two packages' trajectories compare leaf by leaf. Under FSDP or
tensor parallelism (``parallel/mesh.py``) ``load_flax`` keeps each rank's
shard or block of a whole leaf, and ``to_flax`` gathers them whole first
(every rank of the group calls).

``load_qtrunk(qt, tree)`` and ``qtrunk_to_tree(qt)`` do the same for the
int8 trunk of ``models/quant.py`` (JAX's ``quantize_trunk``/``calibrate``
pytree; int8 HWIO weights become the kernels' (O, kh*kw*I)).
"""

from __future__ import annotations

import warnings
from collections.abc import Mapping

import numpy as np
import torch

from acoustic_image_generation_tpu_torch.models.blocks import ChainConv
from acoustic_image_generation_tpu_torch.models.decoders import CenterBatchNorm
from acoustic_image_generation_tpu_torch.models.dualcamnet import TemporalConv
from acoustic_image_generation_tpu_torch.models.layers import BatchNorm, Conv2d, ConvTransposeTF, Dense
from acoustic_image_generation_tpu_torch.models.quant import QLayer, QuantTrunk
from acoustic_image_generation_tpu_torch.models.resnet import ConvBN
from acoustic_image_generation_tpu_torch.parallel import mesh


def _hwio_to_oihw(a):
    return a.transpose(3, 2, 0, 1)


def _oihw_to_hwio(a):
    return a.transpose(2, 3, 1, 0)


def _hwio_to_iohw(a):  # its own inverse
    return a.transpose(2, 3, 0, 1)


def _dhwio_to_oihw(a):
    d, h, w, ci, co = a.shape
    return a.reshape(d, h * w, ci, co).transpose(3, 2, 0, 1)


def _oihw_to_dhwio(a):
    co, ci, d, hw = a.shape
    return a.transpose(2, 3, 1, 0).reshape(d, hw, 1, ci, co)


def _hwio_to_packed(a):
    kh, kw, ci, co = a.shape
    return a.reshape(kh * kw * ci, co)


def _packed_to_hwio(a):
    return a.reshape(3, 3, a.shape[0] // 9, a.shape[1])


def _same(a):
    return a


_INVERSE = {
    _hwio_to_oihw: _oihw_to_hwio,
    _dhwio_to_oihw: _oihw_to_dhwio,
    _hwio_to_iohw: _hwio_to_iohw,
    np.transpose: np.transpose,
    _hwio_to_packed: _packed_to_hwio,
    _same: _same,
}


# each layout's flax axes as port dims: flax axis k is port dim _AXES[fn][k]
# (None: spread over a port dim, as a packed kernel's Ci)
_AXES = {
    _hwio_to_oihw: (2, 3, 1, 0),
    _dhwio_to_oihw: (2, 3, None, 1, 0),
    _hwio_to_iohw: (2, 3, 0, 1),
    np.transpose: (1, 0),
    _hwio_to_packed: (None, None, None, 1),
}


def flax_layout(fn, shape: tuple) -> tuple[tuple, tuple]:
    """``(flax shape, port dim of each flax axis)`` of a port tensor of
    ``shape`` in layout ``fn`` (a transform of ``targets``)."""
    if fn is _same:
        return tuple(shape), tuple(range(len(shape)))
    if fn is _hwio_to_packed:
        return (3, 3, shape[0] // 9, shape[1]), _AXES[fn]
    if fn is _dhwio_to_oihw:
        return (shape[2], shape[3], 1, shape[1], shape[0]), _AXES[fn]
    axes = _AXES[fn]
    return tuple(shape[d] for d in axes), axes


def targets(task: torch.nn.Module):
    """(port tensor, collection, flax path, layout transform) for every
    weight of ``task``."""
    def batch_norm(bn, path):
        return [
            (bn.weight, "params", path + ("scale",), _same),
            (bn.bias, "params", path + ("bias",), _same),
            (bn.running_mean, "batch_stats", path + ("mean",), _same),
            (bn.running_var, "batch_stats", path + ("var",), _same),
        ]

    out = []
    in_convbn = {id(m.bn) for m in task.modules() if isinstance(m, ConvBN)}
    for name, m in task.named_modules():
        p = tuple(name.split("."))
        if isinstance(m, ConvBN):
            kpath = p + (("kernel",) if m.fixed_pad else ("conv", "kernel"))
            out += [(m.weight, "params", kpath, _hwio_to_oihw)] + batch_norm(m.bn, p + ("BatchNorm",))
        elif isinstance(m, BatchNorm) and id(m) not in in_convbn:
            out += batch_norm(m, p)
        elif isinstance(m, CenterBatchNorm):
            out += [(m.bias, "params", p + ("bias",), _same),
                    (m.running_mean, "batch_stats", p + ("mean",), _same),
                    (m.running_var, "batch_stats", p + ("var",), _same)]
        elif isinstance(m, (Conv2d, ConvTransposeTF, Dense, ChainConv)):
            fn = {
                Conv2d: _hwio_to_oihw,
                TemporalConv: _dhwio_to_oihw,
                ConvTransposeTF: _hwio_to_iohw,
                Dense: np.transpose,
                ChainConv: _hwio_to_packed,
            }[type(m)]
            out += [
                (m.weight, "params", p + ("kernel",), fn),
                (m.bias, "params", p + ("bias",), _same),
            ]
    return out


def _strided(a: np.ndarray) -> torch.Tensor:
    """A tensor over ``a``'s memory, strides kept (a read-only buffer, such
    as a checkpoint's, is only read): torch's strided copies of the layout
    transforms run on all cores, numpy's on one."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # a read-only buffer: the tensor is only copied from
        return torch.from_numpy(a)


def _flatten(tree: Mapping, prefix=()) -> dict:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def load_flax(task: torch.nn.Module, params: Mapping, batch_stats: Mapping) -> None:
    """Copy the flax trees into ``task``'s tensors (cast to each tensor's
    dtype and device)."""
    trees = {"params": _flatten(params), "batch_stats": _flatten(batch_stats)}
    used = set()
    covered = set()
    for tensor, coll, path, fn in targets(task):
        if path not in trees[coll]:
            raise KeyError(f"no flax {coll} leaf {'/'.join(path)} for a port tensor")
        value = fn(np.asarray(trees[coll][path], np.float32))
        if value.shape != mesh.whole_shape(tensor):
            raise ValueError(
                f"{coll} {'/'.join(path)}: {value.shape} does not fit port tensor {mesh.whole_shape(tensor)}"
            )
        mesh.copy_full_(tensor, _strided(value))  # an FSDP shard keeps its rows, a split tensor its block
        used.add((coll, path))
        covered.add(id(tensor))
    left = sorted("/".join((c, *p)) for c, t in trees.items() for p in t if (c, p) not in used)
    if left:
        raise KeyError(f"flax leaves with no port tensor: {left}")
    unset = [n for n, t in (*task.named_parameters(), *task.named_buffers()) if id(t) not in covered]
    if unset:
        raise KeyError(f"port tensors with no flax leaf: {unset}")


def _qtargets(qt: QuantTrunk):
    """(port tensor, JAX path, layout transform, inverse) for every leaf of
    the quantized trunk: ``w`` HWIO int8 <-> (O, kh*kw*I); ``scale`` and
    ``bias`` as they are; each ``act`` site a 0-dim f32."""
    out = []
    for name, m in qt.named_modules():
        if not isinstance(m, QLayer):
            continue
        p = tuple(name.split("."))
        (kh, kw), ci = m.kernel, m.in_ch

        def hwio_to_ok(a):
            return a.transpose(3, 0, 1, 2).reshape(a.shape[3], -1)

        def ok_to_hwio(a, kh=kh, kw=kw, ci=ci):
            return a.reshape(a.shape[0], kh, kw, ci).transpose(1, 2, 3, 0)

        out += [(m.w, p + ("w",), hwio_to_ok, ok_to_hwio),
                (m.scale, p + ("scale",), _same, _same),
                (m.bias, p + ("bias",), _same, _same)]
    out += [(qt.amax(site), ("act", site), _same, _same) for site in qt.sites]
    return out


def load_qtrunk(qt: QuantTrunk, tree: Mapping) -> QuantTrunk:
    """Copy JAX's quantized trunk (``quant.quantize_trunk``/``calibrate``'s
    tree, as numpy arrays: int8 HWIO ``w``, f32 ``scale``, ``bias``, and the
    ``act`` amaxes) into ``qt``. Every leaf must land on exactly one port
    tensor and every port tensor must be set. Returns ``qt``."""
    flat = _flatten(tree)
    used = set()
    for tensor, path, fn, _ in _qtargets(qt):
        if path not in flat:
            raise KeyError(f"no quantized-trunk leaf {'/'.join(path)} for a port tensor")
        value = np.array(fn(np.asarray(flat[path])), order="C")
        if value.shape != tuple(tensor.shape):
            raise ValueError(f"{'/'.join(path)}: {value.shape} does not fit port tensor {tuple(tensor.shape)}")
        with torch.no_grad():
            tensor.copy_(torch.from_numpy(value).to(tensor.dtype))
        used.add(path)
    left = sorted("/".join(p) for p in flat if p not in used)
    if left:
        raise KeyError(f"quantized-trunk leaves with no port tensor: {left}")
    return qt


def qtrunk_to_tree(qt: QuantTrunk) -> dict:
    """The inverse of ``load_qtrunk``: JAX's tree layout, numpy arrays."""
    tree: dict = {}
    for tensor, path, _, inverse in _qtargets(qt):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(inverse(tensor.detach().cpu().numpy()), order="C")
    return tree


def to_flax(task: torch.nn.Module) -> tuple[dict, dict]:
    """``(params, batch_stats)`` of ``task`` as nested dicts of numpy f32
    arrays in the flax layouts: the inverse of ``load_flax``."""
    trees = {"params": {}, "batch_stats": {}}
    for tensor, coll, path, fn in targets(task):
        node = trees[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        value = mesh.full(tensor).detach().to("cpu", torch.float32).numpy()
        node[path[-1]] = _strided(_INVERSE[fn](value)).clone(memory_format=torch.contiguous_format).numpy()
    return trees["params"], trees["batch_stats"]
