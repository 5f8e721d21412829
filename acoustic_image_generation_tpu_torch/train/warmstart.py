"""Warm starts: a fresh state initialized, whole or per model, from
checkpoints.

Counterpart of ``acoustic_image_generation_tpu/train/warmstart.py`` for
checkpoints in the JAX package's file format (``train/checkpoint.py``):
``init_checkpoint`` restores the parameters and BN statistics and leaves the
optimizer's slots alone; ``visual_init_checkpoint`` (the ``resnet``),
``acoustic_init_checkpoint`` (the ``generator``) and
``audio_init_checkpoint`` (an ``audio`` model) overlay one model each. A
TF1 ``.ckpt`` (one with an ``.index`` sibling) raises: importing it needs
the ``tensorflow`` package (``ROADMAP.md`` Queue 1, item 5).
"""

from __future__ import annotations

import os

from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core.config import ExperimentConfig
from acoustic_image_generation_tpu_torch.train.checkpoint import read_state_dict
from acoustic_image_generation_tpu_torch.train.state import TrainState


def _read(path: str) -> dict:
    if os.path.exists(path + ".index"):
        raise NotImplementedError(
            f"{path} is a TF1 checkpoint; its import needs the tensorflow package and is not ported "
            "(ROADMAP.md Queue 1, item 5)"
        )
    return read_state_dict(path)


def _overlay(tree: dict, source: dict, where: str) -> dict:
    """``tree`` with every leaf taken from ``source`` at the same path."""
    out = {}
    for k, v in tree.items():
        if k not in source:
            raise KeyError(f"checkpoint has no leaf {where}/{k}")
        out[k] = _overlay(v, source[k], f"{where}/{k}") if isinstance(v, dict) else source[k]
    return out


def overlay_model(state: TrainState, model_key: str, path: str) -> TrainState:
    """Replace the parameters (and BN statistics, if any) of the model
    ``model_key`` (``resnet``, ``generator``, ...) with a checkpoint's:
    the checkpoint's ``params[model_key]`` when it has that key, else its
    whole ``params`` tree (a checkpoint of that model alone)."""
    restored = _read(path)
    params, stats = bridge.to_flax(state.task)
    src_params = restored.get("params", restored)
    sub = src_params[model_key] if model_key in src_params else src_params
    params[model_key] = _overlay(params[model_key], sub, model_key)
    src_stats = restored.get("batch_stats", {})
    if model_key in stats and model_key in src_stats:
        stats[model_key] = _overlay(stats[model_key], src_stats[model_key], model_key)
    bridge.load_flax(state.task, params, stats)
    return state


def restore_params_only(state: TrainState, path: str) -> TrainState:
    """The checkpoint's parameters and BN statistics; the optimizer's slots
    and the step stay."""
    restored = _read(path)
    params, stats = bridge.to_flax(state.task)
    bridge.load_flax(state.task, _overlay(params, restored["params"], "params"),
                     _overlay(stats, restored["batch_stats"], "batch_stats"))
    return state


def apply_init_checkpoints(state: TrainState, config: ExperimentConfig) -> TrainState:
    """The four init flags of ``config.run`` onto ``state`` (in place)."""
    run = config.run
    if run.init_checkpoint:
        state = restore_params_only(state, run.init_checkpoint)
    pairs = [
        (run.visual_init_checkpoint, ("resnet", "video")),
        (run.acoustic_init_checkpoint, ("generator", "acoustic")),
        (run.audio_init_checkpoint, ("audio",)),
    ]
    keys = set(bridge.to_flax(state.task)[0])
    for path, candidates in pairs:
        if not path:
            continue
        for key in candidates:
            if key in keys:
                state = overlay_model(state, key, path)
                break
        else:
            raise KeyError(f"no model key {candidates} in state for checkpoint {path}")
    return state
