"""The rank bodies of ``tests/test_torch_parallel_project.py`` and
``tests/test_torch_parallel_classify.py``: functions that ``mesh.launch``
runs on each of two CPU ranks over gloo (spawned processes import them from
here; they import the port only, never JAX). Each takes a plain dict of
numpy arrays and settings and returns one of numpy arrays and numbers; the
trees of parameters and moments come from rank 0 alone."""

import hashlib

import numpy as np
import torch

from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train.classify import (
    ClassificationTask,
    ClassifyConfig,
    CorrespondenceTask,
    GeneratedClassificationTask,
)
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from acoustic_image_generation_tpu_torch.train.joint import JointConfig, JointTask
from acoustic_image_generation_tpu_torch.train.project import ProjectConfig, ProjectTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, step_generator
from parallel_task_ranks import LR, config, local, sampled

PROJECT = {"Audio": dict(encoder_type="Audio"), "Video": dict(encoder_type="Video"), "fusion": dict(fusion=True),
           "l2": dict(encoder_type="Video", l2=True)}
JOINT = {"default": {}, "fusion": dict(fusion=True), "moddrop": dict(moddrop=True),
         "onlyaudiovideo": dict(onlyaudiovideo=True)}
UNITS = (1, 1, 1, 1)  # the generated classifier's and the generation task's ResNet
CLASSIFY = {  # ClassifyConfig of each case (the generation task: its GenerationConfig)
    "real": dict(),
    "mfccmap": dict(mfccmap=True),
    "generated": dict(generation=GenerationConfig(resnet_units=UNITS, compute_dtype="float32")),
    "augment": dict(correspondence=True),
    "no_video": dict(correspondence=True, correspondence_video=True),
    "music": dict(correspondence=True, datatype="music", num_channels=13, num_classes=9),
    "generation": dict(resnet_units=UNITS, correspondence=True, correspondence_video=True),
}


VAES = ("acoustic", "video", "audio")
_FROZEN = {}  # this process's frozen VAE modules, loaded once


def load_sharing_vaes(task, init):
    """Load the flax trees ``init`` into ``task``, its frozen VAEs the
    modules an earlier task of this process loaded (a gigabyte of weights,
    the same trees in every case; they neither train nor update a
    statistic, and a case that changed them would fail every later case's
    comparison)."""
    params, stats = init
    for name, module in task.named_children():
        if name in VAES and name in _FROZEN:
            setattr(task, name, _FROZEN[name])
            continue
        bridge.load_flax(module, params[name], stats.get(name, {}))
        if name in VAES:
            _FROZEN[name] = module
    return task


def project_task(wiring: str, init) -> ProjectTask:
    return load_sharing_vaes(ProjectTask(ProjectConfig(compute_dtype="float32", learning_rate=LR,
                                                       **PROJECT[wiring]), device="cpu"), init)


def joint_task(mode: str, init) -> JointTask:
    return load_sharing_vaes(JointTask(JointConfig(compute_dtype="float32", learning_rate=LR, **JOINT[mode]),
                                       device="cpu"), init)


def classify_task(name: str, init=None):
    """The case's task (``generation``: the generation task with the
    correspondence augmentation), from ``init`` (flax trees) or else
    ``init_params(0)``."""
    if name == "generation":
        task = GenerationTask(GenerationConfig(compute_dtype="float32", learning_rate=LR, **CLASSIFY[name]),
                              device="cpu")
    else:
        cls = {"generated": GeneratedClassificationTask}.get(name, ClassificationTask)
        cfg = ClassifyConfig(compute_dtype="float32", learning_rate=LR, **CLASSIFY[name])
        task = (CorrespondenceTask if cfg.correspondence else cls)(cfg, device="cpu")
    if init is None:
        return task.init_params(0)
    bridge.load_flax(task, *init)
    return task


def summary(trainer, state, metrics: list, keep: tuple) -> dict:
    """What a run returns: its metrics; a digest of what a step may change
    (the trained parameters and their Adam moments, every BN running
    average; FSDP's shards gathered a leaf at a time); the running averages
    of the modules in ``keep``; the bytes of this rank's Adam moments and
    the names of its sharded parameters; and on rank 0 the parameters and
    Adam's first moments (TF1's: 0.1 of the first step's gradient) of the
    modules in ``keep`` (top-level flax names), in the flax layout, each
    ``sampled``."""
    h = hashlib.sha1()
    stats, params, moments = {}, {}, {}
    flax = lambda fn, t: np.asarray(bridge._INVERSE[fn](t.numpy()))
    for tensor, coll, path, fn in bridge.targets(trainer.task):
        if coll == "params" and not tensor.requires_grad:
            continue
        key = "/".join(path)
        whole = [mesh.full(tensor)]
        if coll == "params":
            slot = state.optimizer.state[tensor]
            whole += [mesh.full(slot["m"], like=tensor), mesh.full(slot["v"], like=tensor)]
        whole = [t.detach().to("cpu", torch.float32).contiguous() for t in whole]
        h.update(key.encode())
        for t in whole:
            h.update(t.numpy())
        if path[0] not in keep:
            continue
        if coll == "batch_stats":
            stats[key] = flax(fn, whole[0])
        elif mesh.is_main():
            params[key], moments[key] = sampled(flax(fn, whole[0])), sampled(flax(fn, whole[1]))
    out = dict(metrics=metrics, digest=h.hexdigest(), stats=stats,
               moments=sum(mesh.local(s["m"]).numel() * 2 * 4 for s in state.optimizer.state.values()),
               sharded=sorted(n for n, p in trainer.task.named_parameters() if mesh.is_sharded(p)))
    if mesh.is_main():
        out.update(params=params, mu=moments)
    return out


def step(task, raw: dict, fsdp: bool = False, eps=None, moddrop=None, run_dir="unused", record=False,
         loader=None):
    """One step on this rank's rows of the global batch ``raw``, after
    ``evaluate`` over ``loader`` where given; with ``record`` the step's
    prepared batch as the rank saw it, and the noise the trainer draws for
    it (``_rank_noise``, from the step's generator). Returns the trainer,
    its state, the step's metrics and what was evaluated and recorded."""
    trainer = Trainer(task, config(fsdp, run_dir))
    seen = {}
    state = trainer.init_state()
    if loader is not None:
        seen["eval"] = trainer.evaluate(state, loader, use_cache=False)
    if record:
        rows = raw["audio"].shape[0] * raw["audio"].shape[1] // mesh.world()
        eps_, _ = trainer._rank_noise(None, step_generator(task.cfg.seed, 0, task.device), rows)
        seen["eps"] = {k: v.numpy() for k, v in eps_.items()} if isinstance(eps_, dict) else eps_
        prepare = trainer._prepare

        def prepared(*args, **kw):
            out = prepare(*args, **kw)
            seen["batch"] = {k: None if v is None else v.numpy() for k, v in out._asdict().items()}
            return out

        trainer._prepare = prepared
    state, m = trainer.train_step(state, local(raw), eps=eps, moddrop=moddrop)
    return trainer, state, [{k: float(v) for k, v in m.items()}], seen


class RankLoader:
    """This rank's share of global batches (dicts with ``valid``), as the
    host-sharded loader gives it: its rows, and the valid ones among them
    (the valid clips are a prefix of the global batch)."""

    def __init__(self, raws: list):
        self.raws = raws

    def batches(self, epoch=0):
        for raw in self.raws:
            lo, hi = mesh.row_range(raw["audio"].shape[0])
            yield dict(local({k: v for k, v in raw.items() if k != "valid"}),
                       valid=max(0, min(raw["valid"] - lo, hi - lo)))


# ----------------------------------------------------------- projection, joint


def project_cases(spec: dict) -> dict:
    """Every case of ``test_torch_parallel_project.py`` on this rank: a
    step of each projection wiring and joint mode under DDP from JAX's
    weights and with JAX's noise (the ``Audio`` wiring after ``evaluate``
    over a remainder batch; the ``Audio`` wiring and the ``moddrop`` mode
    also return the noise the trainer draws where none is handed in); the
    ``Audio`` wiring and the default joint mode under FSDP, the former's
    state written as ``epoch_final.ckpt``."""
    torch.set_num_threads(2)
    out, raw = {}, spec["raw"]
    cases = [("project", w, False) for w in PROJECT] + [("project", "Audio", True)]
    cases += [("joint", m, False) for m in JOINT] + [("joint", "default", True)]
    for family, name, fsdp in cases:
        init = spec[f"{family}_init"][name]
        task = (project_task if family == "project" else joint_task)(name, init)
        label = f"{family} {name}" + (" fsdp" if fsdp else "")
        evaluate = label == "project Audio"
        trainer, state, metrics, seen = step(
            task, raw, fsdp, spec[f"{family}_eps"][name], spec["moddrop"] if name == "moddrop" else None,
            spec["run_dir"], record=label in ("project Audio", "joint moddrop"),
            loader=RankLoader(spec["eval_raws"]) if evaluate else None)
        out[label] = summary(trainer, state, metrics, tuple(init[0]))
        out[label].update(seen)
        if label == "project Audio fsdp":
            trainer.save("final", state)
        del trainer, state, task
    return out


# ------------------------------------------------------------ classification


def classify_cases(spec: dict) -> dict:
    """Every case of ``test_torch_parallel_classify.py`` on this rank: a
    step of each case under DDP from JAX's weights (the generated
    classifier and the generation task with JAX's noise, the latter also
    returning the noise the trainer draws for the doubled batch; the music
    shuffle with the trainer's permutations, recorded with the rank's
    prepared batch); DualCamNet on real images, the music shuffle and the generation
    task with correspondence under FSDP (the first's state written as
    ``epoch_final.ckpt``); ``evaluate`` over remainder batches of the real
    images, the silence map and the music shuffle."""
    torch.set_num_threads(2)
    out = {}
    for name, case in spec["cases"].items():
        keep = ("dualcamnet",) if name != "generation" else ("resnet", "generator")
        for fsdp in (False, True) if name in spec["fsdp"] else (False,):
            label = f"{name} fsdp" if fsdp else name
            raws = spec["eval_raws"].get(name) if not fsdp else None
            trainer, state, metrics, seen = step(classify_task(name, case["init"]), case["raw"], fsdp,
                                                 eps=case["eps"], run_dir=spec["run_dir"],
                                                 record=name in ("music", "generation") and not fsdp,
                                                 loader=None if raws is None else RankLoader(raws))
            out[label] = summary(trainer, state, metrics, keep)
            out[label].update(seen)
            if label == "real fsdp":
                trainer.save("final", state)
            del trainer, state
    return out
