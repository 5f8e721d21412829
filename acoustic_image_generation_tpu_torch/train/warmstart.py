"""Warm starts: a fresh state initialized, whole or per model, from
checkpoints.

Counterpart of ``acoustic_image_generation_tpu/train/warmstart.py``:
``init_checkpoint`` restores the parameters and BN statistics of a
checkpoint in the JAX package's file format (``train/checkpoint.py``) and
leaves the optimizer's slots alone; ``visual_init_checkpoint`` (the
``resnet`` or the embedding task's ``video``), ``acoustic_init_checkpoint``
(the ``generator`` or ``acoustic``) and ``audio_init_checkpoint`` (``audio``)
overlay one model each, from either format: a TF1 V2 checkpoint (detected,
as JAX detects it, by its ``.index`` sibling) is imported under the model's
reference scope (``core/tf1_import.py``; the ImageNet ResNet50's ``logits``
and ``conv_map`` are skipped), anything else is read as the JAX package's
file. A V1 file therefore reaches only ``tf1_import.import_resnet50_imagenet``,
as in JAX.
"""

from __future__ import annotations

import os

from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core import tf1_import
from acoustic_image_generation_tpu_torch.core.config import ExperimentConfig
from acoustic_image_generation_tpu_torch.core.tf1_export import SCOPES
from acoustic_image_generation_tpu_torch.train.checkpoint import read_state_dict
from acoustic_image_generation_tpu_torch.train.state import TrainState


def _is_tf_checkpoint(path: str) -> bool:
    return os.path.exists(path + ".index")


def _overlay(tree: dict, source: dict, where: str) -> dict:
    """``tree`` with every leaf taken from ``source`` at the same path."""
    out = {}
    for k, v in tree.items():
        if k not in source:
            raise KeyError(f"checkpoint has no leaf {where}/{k}")
        out[k] = _overlay(v, source[k], f"{where}/{k}") if isinstance(v, dict) else source[k]
    return out


def _overlay_trees(params: dict, stats: dict, model_key: str, path: str, loaded: dict) -> None:
    """``overlay_model`` on the flax trees ``params`` and ``stats`` (in
    place); ``loaded`` keeps each file read once, by path."""
    tf1 = _is_tf_checkpoint(path)
    if path not in loaded:
        loaded[path] = tf1_import.load_tf1_checkpoint(path) if tf1 else read_state_dict(path)
    source = loaded[path]
    if tf1:
        imported_p, imported_s = tf1_import.import_scope(source, SCOPES.get(model_key, model_key))
        if model_key == "resnet":  # the ImageNet warm start skips the new heads
            for head in ("logits", "conv_map"):
                imported_p.pop(head, None)
                imported_s.pop(head, None)
        params[model_key] = tf1_import.merge_into(params[model_key], imported_p)
        if model_key in stats and imported_s:
            stats[model_key] = tf1_import.merge_into(stats[model_key], imported_s)
    else:
        src_params = source.get("params", source)
        sub = src_params[model_key] if model_key in src_params else src_params
        params[model_key] = _overlay(params[model_key], sub, model_key)
        src_stats = source.get("batch_stats", {})
        if model_key in stats and model_key in src_stats:
            stats[model_key] = _overlay(stats[model_key], src_stats[model_key], model_key)


def overlay_model(state: TrainState, model_key: str, path: str) -> TrainState:
    """Replace the parameters (and BN statistics, if any) of the model
    ``model_key`` (``resnet``, ``generator``, ...) with a checkpoint's:
    the checkpoint's ``params[model_key]`` when it has that key, else its
    whole ``params`` tree (a checkpoint of that model alone). A TF1
    checkpoint's tensors under the model's reference scope are merged over
    the model's current values, each shape checked."""
    params, stats = bridge.to_flax(state.task)
    _overlay_trees(params, stats, model_key, path, {})
    bridge.load_flax(state.task, params, stats)
    return state


def restore_params_only(state: TrainState, path: str) -> TrainState:
    """The checkpoint's parameters and BN statistics; the optimizer's slots
    and the step stay. Only the JAX package's file format, as JAX's
    ``restore_params_only``: a TF1 checkpoint raises."""
    if _is_tf_checkpoint(path):
        raise ValueError(f"{path} is a TF1 checkpoint: init_checkpoint takes the JAX package's file format; "
                         "warm-start a model from it with visual_, acoustic_ or audio_init_checkpoint")
    restored = read_state_dict(path)
    params, stats = bridge.to_flax(state.task)
    bridge.load_flax(state.task, _overlay(params, restored["params"], "params"),
                     _overlay(stats, restored["batch_stats"], "batch_stats"))
    return state


def apply_init_checkpoints(state: TrainState, config: ExperimentConfig) -> TrainState:
    """The four init flags of ``config.run`` onto ``state`` (in place). The
    model overlays go onto one copy of the task's trees, loaded back once,
    and a file that several flags name is read once."""
    run = config.run
    if run.init_checkpoint:
        state = restore_params_only(state, run.init_checkpoint)
    pairs = [
        (run.visual_init_checkpoint, ("resnet", "video")),
        (run.acoustic_init_checkpoint, ("generator", "acoustic")),
        (run.audio_init_checkpoint, ("audio",)),
    ]
    pairs = [(path, candidates) for path, candidates in pairs if path]
    if not pairs:
        return state
    params, stats = bridge.to_flax(state.task)
    loaded: dict = {}  # one read of a file that several flags name
    for path, candidates in pairs:
        key = next((k for k in candidates if k in params), None)
        if key is None:
            raise KeyError(f"no model key {candidates} in state for checkpoint {path}")
        _overlay_trees(params, stats, key, path, loaded)
    bridge.load_flax(state.task, params, stats)
    return state
