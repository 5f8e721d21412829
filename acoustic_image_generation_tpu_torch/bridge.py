"""Load the JAX package's generation variables into the port's modules.

``load_flax(task, params, batch_stats)`` takes the trees that the JAX
``GenerationTask.init_variables`` returns (or a checkpoint's), as nested
dicts of numpy arrays: ``params = {"resnet": ..., "generator": ...}``,
``batch_stats = {"resnet": ...}``. Module paths of the port mirror the flax
scopes, and the layouts change as follows:

- conv kernels: HWIO -> OIHW;
- Dense kernels: (in, out) -> (out, in);
- ``ConvTransposeTF`` kernels: HWIO -> (in, out, kh, kw), not flipped;
- BN: ``scale``/``bias`` params, ``mean``/``var`` batch stats;
- chain convs: HWIO -> the kernel's packed (9*Ci, Co), once, here;
- trunk quirk: the fixed-pad convs (the root ``conv1`` and ``conv2`` of each
  stride-2 unit) keep ``kernel`` directly under their scope, every other
  trunk conv under ``.../conv/kernel``.

Every flax leaf must land on exactly one port tensor and every port tensor
must be set; anything else raises.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from acoustic_image_generation_tpu_torch.models.blocks import ChainConv
from acoustic_image_generation_tpu_torch.models.layers import Conv2d, ConvTransposeTF, Dense
from acoustic_image_generation_tpu_torch.models.resnet import ConvBN


def _hwio_to_oihw(a):
    return a.transpose(3, 2, 0, 1)


def _hwio_to_iohw(a):
    return a.transpose(2, 3, 0, 1)


def _hwio_to_packed(a):
    kh, kw, ci, co = a.shape
    return a.reshape(kh * kw * ci, co)


def _same(a):
    return a


def targets(task: torch.nn.Module):
    """(port tensor, collection, flax path, layout transform) for every
    weight of ``task``."""
    out = []
    for name, m in task.named_modules():
        p = tuple(name.split("."))
        if isinstance(m, ConvBN):
            kpath = p + (("kernel",) if m.fixed_pad else ("conv", "kernel"))
            bn = p + ("BatchNorm",)
            out += [
                (m.weight, "params", kpath, _hwio_to_oihw),
                (m.bn.weight, "params", bn + ("scale",), _same),
                (m.bn.bias, "params", bn + ("bias",), _same),
                (m.bn.running_mean, "batch_stats", bn + ("mean",), _same),
                (m.bn.running_var, "batch_stats", bn + ("var",), _same),
            ]
        elif isinstance(m, (Conv2d, ConvTransposeTF, Dense, ChainConv)):
            fn = {
                Conv2d: _hwio_to_oihw,
                ConvTransposeTF: _hwio_to_iohw,
                Dense: np.transpose,
                ChainConv: _hwio_to_packed,
            }[type(m)]
            out += [
                (m.weight, "params", p + ("kernel",), fn),
                (m.bias, "params", p + ("bias",), _same),
            ]
    return out


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
        value = np.array(fn(np.asarray(trees[coll][path], np.float32)), order="C")
        if value.shape != tuple(tensor.shape):
            raise ValueError(
                f"{coll} {'/'.join(path)}: {value.shape} does not fit port tensor {tuple(tensor.shape)}"
            )
        with torch.no_grad():
            tensor.copy_(torch.from_numpy(value))
        used.add((coll, path))
        covered.add(id(tensor))
    left = sorted("/".join((c, *p)) for c, t in trees.items() for p in t if (c, p) not in used)
    if left:
        raise KeyError(f"flax leaves with no port tensor: {left}")
    unset = [n for n, t in (*task.named_parameters(), *task.named_buffers()) if id(t) not in covered]
    if unset:
        raise KeyError(f"port tensors with no flax leaf: {unset}")
