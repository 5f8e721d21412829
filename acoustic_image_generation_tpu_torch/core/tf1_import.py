"""TF1 checkpoints -> the flax-layout variable trees of the port.

Counterpart of ``acoustic_image_generation_tpu/core/tf1_import.py``: the
reference trains with ``tf.train.Saver`` under TF variable scopes
(``UNetAcRes/...``, ``resnet_v1_50/...``, ``DualCamNet/...``,
``UNetAudio/``, ``UNet/``, ``UNetAcoustic/...``); these functions map those
names onto the trees that ``bridge.to_flax`` yields and ``bridge.load_flax``
takes (nested dicts of numpy arrays), with JAX's names and renames:

- tf.layers conv and dense ``kernel``/``bias`` as they are; transposed
  convs (``upsample_*``) are stored (kh, kw, out, in) and come back HWIO;
- slim ``weights``/``biases`` become ``kernel``/``bias``; BN ``gamma``,
  ``beta``, ``moving_mean``, ``moving_variance`` become ``scale``/``bias``
  params and ``mean``/``var`` statistics;
- ResNet units ``blockN/unit_M/bottleneck_v1`` merge into ``blockN_unit_M``;
- the VAE heads ``mean``/``std`` go under ``vae``, the unnamed decoder conv
  ``conv2d`` becomes ``conv_dec``, VGGish's repeat scopes collapse;
- ``merge_into`` re-nests a slim conv under its ``conv`` submodule where the
  template has one, and checks every shape.

The file is read by ``core/tf1_format.py`` (numpy; no ``tensorflow``).
"""

from __future__ import annotations

import copy
import re

import numpy as np

from acoustic_image_generation_tpu_torch.core import tf1_format


def load_tf1_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Every tensor of a TF checkpoint (V1 or V2 format) by name; bf16
    tensors widened to f32 (exactly)."""
    out = tf1_format.read_checkpoint(path)
    for name, value in out.items():
        if value.dtype == tf1_format.DTYPES[tf1_format._DT_BFLOAT16]:
            out[name] = (value.astype(np.uint32) << 16).view(np.float32)
    return out


def _set(tree: dict, path: list[str], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


# slim.repeat scopes that nest unit vars under the repeat name (VGGish
# conv3/conv4/fc1, the reference's models/vggish.py:66-73)
_REPEAT_SCOPES = ("conv3", "conv4", "fc1")

_SKIP_SUFFIXES = ("/Adam", "/Adam_1", "/Momentum")
_SKIP_NAMES = ("global_step", "beta1_power", "beta2_power")


def _is_optimizer_var(name: str) -> bool:
    return name in _SKIP_NAMES or any(name.endswith(s) for s in _SKIP_SUFFIXES)


def import_scope(
    ckpt: dict[str, np.ndarray], scope: str
) -> tuple[dict, dict]:
    """Map all variables under ``scope/`` to (params, batch_stats) trees.

    Handles the naming conventions of every reference model family:
    tf.layers (``kernel``/``bias``), slim (``weights``/``biases``,
    ``BatchNorm/*``), tf.layers BN (``bn_*/gamma`` etc.), and transposed
    convs (``upsample_*/kernel``, layout-fixed).
    """
    params: dict = {}
    stats: dict = {}
    prefix = scope.rstrip("/") + "/"
    for name, value in sorted(ckpt.items()):
        if not name.startswith(prefix) or _is_optimizer_var(name):
            continue
        rel = name[len(prefix):]
        parts = rel.split("/")
        leaf = parts[-1]
        parent = parts[:-1]
        # resnet blockN/unit_M/bottleneck_v1/... -> blockN_unit_M/...
        parent = _normalize_resnet(parent)
        # tf.layers default scopes of the UNet zoo -> our module names:
        # the VAE head convs live in a "vae" submodule, the unnamed decoder
        # conv ("conv2d") is "conv_dec"
        if parent == ["mean"] or parent == ["std"]:
            parent = ["vae", parent[0]]
        elif parent == ["conv2d"]:
            parent = ["conv_dec"]
        # slim.repeat nests units under the repeat scope ("conv3/conv3_1",
        # "fc1/fc1_2" in VGGish, vggish.py:66-73) — collapse to the unit
        # name, which is what our flat flax modules use. Restricted to the
        # known repeat-scope names so a genuinely nested scope like
        # "foo/foo_bar" in some future checkpoint is not silently renamed.
        parent = [
            p for i, p in enumerate(parent)
            if not (
                p in _REPEAT_SCOPES
                and i + 1 < len(parent)
                and parent[i + 1].startswith(p + "_")
            )
        ]
        if leaf == "kernel":
            if parent and parent[-1].startswith("upsample"):
                value = np.transpose(value, (0, 1, 3, 2))  # (kh,kw,out,in)->HWIO
            _set(params, parent + ["kernel"], value)
        elif leaf == "bias":
            _set(params, parent + ["bias"], value)
        elif leaf == "weights":
            # slim convs are HWIO; slim/base dense are (in, out): both map
            # onto a bare 'kernel'; merge_into re-nests under 'conv' when
            # the flax template wraps the conv in a named submodule
            _set(params, parent + ["kernel"], value)
        elif leaf == "biases":
            _set(params, parent + ["bias"], value)
        elif leaf == "gamma":
            _set(params, parent + ["scale"], value)
        elif leaf == "beta":
            _set(params, parent + ["bias"], value)
        elif leaf == "moving_mean":
            _set(stats, parent + ["mean"], value)
        elif leaf == "moving_variance":
            _set(stats, parent + ["var"], value)
        # anything else (save counters etc.) is ignored
    return params, stats


_RESNET_UNIT = re.compile(r"^unit_\d+$")


def _normalize_resnet(parent: list[str]) -> list[str]:
    """['block2','unit_4','bottleneck_v1','conv1'] -> ['block2_unit_4','conv1'];
    also root 'conv1'/'conv_map'/'logits' stay as-is. slim convs keep their
    dedicated fixed-pad naming (root conv1 and stride-2 conv2 store a bare
    ``kernel`` in our tree, handled by _is_slim_conv)."""
    out: list[str] = []
    i = 0
    while i < len(parent):
        p = parent[i]
        if p.startswith("block") and i + 1 < len(parent) and _RESNET_UNIT.match(parent[i + 1]):
            merged = f"{p}_{parent[i + 1]}"
            i += 2
            if i < len(parent) and parent[i] == "bottleneck_v1":
                i += 1
            out.append(merged)
            continue
        out.append(p)
        i += 1
    return out


def merge_into(template: dict, imported: dict, *, strict: bool = False) -> dict:
    """Overlay imported values onto a template pytree (init'd params),
    fixing the conv/kernel vs kernel nesting mismatch automatically and
    checking shapes."""
    out = copy.deepcopy(template)

    def walk(dst: dict, src: dict, path=()):
        for k, v in src.items():
            if isinstance(v, dict):
                if k in dst and isinstance(dst[k], dict):
                    walk(dst[k], v, path + (k,))
                elif (
                    k == "conv"
                    and "kernel" in v
                    and "kernel" in dst
                ):
                    # imported slim conv nested under 'conv', but the
                    # template holds a bare fixed-pad kernel
                    _assign(dst, "kernel", v["kernel"], path + (k,))
                elif k == "vae" and "vae" not in dst and "mean" in dst:
                    # models with bare mean/std(-or-variance) conv heads
                    # instead of a VaeHead submodule (UNetSound small,
                    # AssociatorAudioEncoder): re-route each head
                    names = {"mean": "mean",
                             "std": "std" if "std" in dst else "variance"}
                    for sub, subtree in v.items():
                        walk(dst[names[sub]], subtree, path + (names[sub],))
                elif strict:
                    raise KeyError(f"no template node for {'/'.join(path + (k,))}")
            else:
                if k in dst and not isinstance(dst[k], dict):
                    _assign(dst, k, v, path + (k,))
                elif (
                    k == "kernel"
                    and "conv" in dst
                    and isinstance(dst["conv"], dict)
                    and "kernel" in dst["conv"]
                ):
                    # imported bare slim kernel, template wraps the conv in
                    # an nn.Conv submodule named 'conv' (_ConvBN)
                    _assign(dst["conv"], "kernel", v, path + ("conv", k))
                elif strict:
                    raise KeyError(f"no template leaf for {'/'.join(path + (k,))}")

    def _assign(dst, k, v, path):
        expected = np.shape(dst[k])
        if tuple(expected) != tuple(np.shape(v)):
            raise ValueError(
                f"shape mismatch at {'/'.join(path)}: template {expected} "
                f"vs checkpoint {np.shape(v)}"
            )
        dst[k] = np.asarray(v, dtype=np.asarray(dst[k]).dtype)

    walk(out, imported)
    return out


def import_resnet50_imagenet(
    ckpt_path: str, template_variables: dict, *, scope: str = "resnet_v1_50"
) -> dict:
    """ImageNet warm-start excluding ``logits``/``conv_map``
    (``vision.py:27``): returns {'params': ..., 'batch_stats': ...} with
    everything else overlaid from the checkpoint."""
    ckpt = load_tf1_checkpoint(ckpt_path)
    params, stats = import_scope(ckpt, scope)
    for head in ("logits", "conv_map"):
        params.pop(head, None)
        stats.pop(head, None)
    return {
        "params": merge_into(template_variables["params"], params),
        "batch_stats": merge_into(template_variables["batch_stats"], stats),
    }
