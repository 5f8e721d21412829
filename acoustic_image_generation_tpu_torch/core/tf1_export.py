"""The port's variable trees -> TF1 checkpoints with the reference's names.

Counterpart of ``acoustic_image_generation_tpu/core/tf1_export.py``, the
inverse of ``core/tf1_import.py``: the flax-layout trees of
``bridge.to_flax`` are written under the reference's TF variable names, so
a model trained by the port restores in the reference's TF1 stack (its
``*_init_checkpoint`` warm starts, its evaluation scripts) and in either
package's ``.ckpt`` warm start. Names, as JAX writes them:

- tf.layers (the UNet zoo): ``kernel``/``bias``, BN ``bn_*/gamma|beta`` and
  the moving statistics; transposed convs (``upsample_*``) stored (kh, kw,
  out, in);
- slim (ResNet50, DualCamNet): ``weights``/``biases``, ``BatchNorm/*``; a
  conv under a ``conv`` submodule and a bare fixed-pad kernel both become
  ``<module>/weights``;
- ``blockN_unit_M`` -> ``blockN/unit_M/bottleneck_v1``; VGGish's
  ``conv3_1`` -> ``conv3/conv3_1``; ``vae/mean|std`` -> ``mean``/``std``;
  ``conv_dec`` -> ``conv2d``.

The file is written by ``core/tf1_format.py`` (numpy; no ``tensorflow``).
"""

from __future__ import annotations

import re

import numpy as np

from acoustic_image_generation_tpu_torch.core import tf1_format

_REPEAT_UNIT = re.compile(r"^(conv3|conv4|fc1)_\d+$")
_RESNET_BLOCK_UNIT = re.compile(r"^(block\d+)_(unit_\d+)$")

# task param-tree key -> reference TF scope (shared with train/warmstart)
SCOPES = {
    "resnet": "resnet_v1_50",
    "generator": "UNetAcRes",
    "acoustic": "UNetAcoustic",
    "audio": "UNetAudio",
    "video": "UNet",
    "dualcamnet": "DualCamNet",
}
# scopes whose variables use slim naming (weights/biases, BatchNorm/*)
_SLIM_KEYS = {"resnet", "dualcamnet"}


def _module_path(parts: list[str], *, slim: bool) -> list[str]:
    """Inverse of import_scope's module renames, leaf excluded."""
    out: list[str] = []
    for p in parts:
        m = _RESNET_BLOCK_UNIT.match(p)
        if m:
            out += [m.group(1), m.group(2), "bottleneck_v1"]
        elif p == "conv_dec":
            out.append("conv2d")
        elif slim and _REPEAT_UNIT.match(p):
            out += [p.split("_")[0], p]
        else:
            out.append(p)
    # VAE head submodule: flax ``vae/mean`` <- TF bare ``mean`` scope
    if out and out[0] == "vae":
        out = out[1:]
    return out


def export_scope(
    variables: dict, scope: str, *, slim: bool = False
) -> dict[str, np.ndarray]:
    """Flatten ``{"params": tree, "batch_stats": tree?}`` into TF1
    checkpoint names under ``scope/``."""
    tensors: dict[str, np.ndarray] = {}
    prefix = scope.rstrip("/")

    def emit(parts: list[str], leaf: str, value) -> None:
        name = "/".join([prefix] + _module_path(parts, slim=slim) + [leaf])
        if name in tensors:
            raise ValueError(f"duplicate export name {name}")
        tensors[name] = np.asarray(value)

    def walk_params(node: dict, parts: list[str]) -> None:
        # A BN param node holds {scale, bias} — and scale-less BNs
        # (use_scale=False, e.g. the mean_std convention) are recognized
        # by the module name so their offset still exports as 'beta'.
        is_bn = "kernel" not in node and (
            "scale" in node
            or (parts and (parts[-1] == "BatchNorm" or parts[-1].startswith("bn_")))
        )
        for k, v in node.items():
            if isinstance(v, dict):
                walk_params(v, parts + [k])
                continue
            if is_bn and k == "scale":
                emit(parts, "gamma", v)
            elif is_bn and k == "bias":
                emit(parts, "beta", v)
            elif k == "kernel":
                if parts and parts[-1].startswith("upsample"):
                    # ConvTransposeTF HWIO -> TF (kh, kw, out, in)
                    emit(parts, "kernel", np.transpose(np.asarray(v), (0, 1, 3, 2)))
                elif slim:
                    # slim convs/denses store 'weights'; drop the _ConvBN
                    # 'conv' wrapper (flax X/conv/kernel <-> TF X/weights)
                    p = parts[:-1] if parts and parts[-1] == "conv" else parts
                    emit(p, "weights", v)
                else:
                    emit(parts, "kernel", v)
            elif k == "bias":
                emit(parts, "biases" if slim else "bias", v)
            else:
                raise ValueError(
                    f"unknown param leaf {'/'.join(parts + [k])!r}"
                )

    def walk_stats(node: dict, parts: list[str]) -> None:
        for k, v in node.items():
            if isinstance(v, dict):
                walk_stats(v, parts + [k])
            elif k == "mean":
                emit(parts, "moving_mean", v)
            elif k == "var":
                emit(parts, "moving_variance", v)
            else:
                raise ValueError(
                    f"unknown batch_stats leaf {'/'.join(parts + [k])!r}"
                )

    walk_params(variables.get("params", {}), [])
    walk_stats(variables.get("batch_stats") or {}, [])
    return tensors


def save_tf1_checkpoint(
    path: str, tensors: dict[str, np.ndarray], *, global_step: int | None = None
) -> str:
    """Write a TF1 V2 checkpoint of ``tensors`` (and an int64
    ``global_step``) as ``tf.compat.v1.train.Saver(write_meta_graph=False)``
    writes it (``core/tf1_format.py``). Returns ``path``."""
    tensors = dict(tensors)
    if global_step is not None:
        tensors["global_step"] = np.asarray(global_step, np.int64)
    return tf1_format.write_checkpoint(path, tensors)


def export_state(
    params: dict,
    batch_stats: dict | None,
    path: str,
    *,
    global_step: int | None = None,
) -> str:
    """Export every recognized top-level model of a task's param tree to
    ONE reference-named checkpoint: flagship generator+trunk (UNetAcRes +
    resnet_v1_50, the scopes the reference's ``trainer/mfcctrainer.py``
    restores), embed/joint
    per-modality VAEs (UNetAcoustic/UNetAudio/UNet — the reference's
    ``acoustic/audio/visual_init_checkpoint`` warm-start scopes), and
    DualCamNet. Unrecognized keys (e.g. associators, whose reference
    counterparts were never checkpoint-restored standalone) are skipped —
    callers can report ``sorted(set(params) - set(SCOPES))``."""
    stats = batch_stats or {}
    known = [k for k in params if k in SCOPES]
    if not known:
        raise ValueError(f"no exportable model keys among {sorted(params)}")
    tensors: dict[str, np.ndarray] = {}
    for k in known:
        tensors.update(
            export_scope(
                {"params": params[k], "batch_stats": stats.get(k)},
                SCOPES[k],
                slim=k in _SLIM_KEYS,
            )
        )
    return save_tf1_checkpoint(path, tensors, global_step=global_step)


def export_generation_checkpoint(
    params: dict, batch_stats: dict, path: str, *, global_step: int | None = None
) -> str:
    """Flagship (GenerationTask) convenience over :func:`export_state`."""
    if "generator" not in params or "resnet" not in params:
        raise ValueError("flagship export needs 'generator' and 'resnet' trees")
    return export_state(params, batch_stats, path, global_step=global_step)
