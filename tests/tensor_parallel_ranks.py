"""The rank bodies of ``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_tensor_parallel_tasks.py``,
``tests/test_torch_tensor_parallel_families.py`` and
``tests/test_torch_tensor_parallel_correspondence.py``: functions that
``mesh.launch`` runs on each CPU rank over gloo, the ranks laid out as a
``(data, model)`` grid with ``tensor_parallel=2`` (spawned processes import
them from here; they import the port only, never JAX). Each takes a plain
dict and returns one of numpy arrays and numbers."""

import dataclasses
import hashlib
import os
import pickle
import time

import numpy as np
import torch

import parallel_family_ranks as pfr
import parallel_ranks as pr
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core.config import (
    ExperimentConfig,
    OptimConfig,
    ParallelConfig,
    RunConfig,
)
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, preprocess
from acoustic_image_generation_tpu_torch.models.layers import Conv2d, ConvTransposeTF
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train.classify import ClassifyConfig, CorrespondenceTask
from acoustic_image_generation_tpu_torch.train.embed import EmbedConfig, EmbedTask
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from acoustic_image_generation_tpu_torch.train.joint import JointConfig, JointTask
from acoustic_image_generation_tpu_torch.train.project import ProjectConfig, ProjectTask
from acoustic_image_generation_tpu_torch.train.reconstruct import ReconstructConfig, ReconstructTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, step_generator
from acoustic_image_generation_tpu_torch.train.warmstart import apply_init_checkpoints

TP = 2
LR = pr.LR


def config(run_dir="unused", epochs=1) -> ExperimentConfig:
    return ExperimentConfig(optim=OptimConfig(learning_rate=LR, num_epochs=epochs),
                            run=RunConfig(checkpoint_dir=run_dir, exp_name="tp"),
                            parallel=ParallelConfig(compute_dtype="float32", num_devices=mesh.world(),
                                                    tensor_parallel=TP))


def local(raw: dict) -> dict:
    """This data rank's clips of a global batch."""
    return {k: mesh.shard_rows(v) for k, v in raw.items()}


def layout(trainer: Trainer, state) -> dict:
    """The rank's split tensors and what it holds of them: each split
    parameter's local shape and dim, the bytes of the split parameters and
    of their Adam slots on this rank and whole, the frozen parameters that
    have Adam slots (none should), and a digest of every replicated tensor
    (parameters, BN statistics, Adam slots), which the peers must hold bit
    for bit."""
    opt = state.optimizer.state
    split, local_bytes, whole_bytes, slot_bytes, whole_slot_bytes = {}, 0, 0, 0, 0
    h = hashlib.sha1()
    for name, t in (*trainer.task.named_parameters(), *trainer.task.named_buffers()):
        slots = [opt[t][k] for k in ("m", "v")] if t in opt else []
        if mesh.tp_dim(t) is None:
            h.update(name.encode())
            for x in (t, *slots):
                h.update(x.detach().contiguous().numpy().tobytes())
            continue
        split[name] = (tuple(t.shape), mesh.tp_dim(t))
        local_bytes += t.numel() * t.element_size()
        whole_bytes += int(np.prod(mesh.whole_shape(t))) * t.element_size()
        slot_bytes += sum(s.numel() * s.element_size() for s in slots)
        whole_slot_bytes += len(slots) * int(np.prod(mesh.whole_shape(t))) * t.element_size()
    frozen_slots = sorted(n for n, p in trainer.task.named_parameters() if not p.requires_grad and p in opt)
    return dict(split=split, bytes=local_bytes, whole_bytes=whole_bytes, slot_bytes=slot_bytes,
                whole_slot_bytes=whole_slot_bytes, frozen_slots=frozen_slots, replicated=h.hexdigest(),
                grid=(mesh.data_rank(), mesh.model_rank(), mesh.data_world(), mesh.model_world()))


def trajectory(task, raws, eps, run_dir=None) -> dict:
    """``len(raws)`` steps of this data rank's rows with the global noise;
    with ``run_dir`` the final state written there as ``epoch_final.ckpt``;
    the losses, what the rank computed in each step before the broadcast
    (``own``), the whole parameters and statistics (``to_flax`` gathers),
    and the layout."""
    trainer = Trainer(task, config(run_dir or "unused"))
    trainer.own_steps = []
    state = trainer.init_state()
    losses = []
    for raw in raws:
        state, metrics = trainer.train_step(state, local(raw), eps=eps)
        losses.append({k: float(v) for k, v in metrics.items()})
    if run_dir:
        trainer.save("final", state)
    params, stats = bridge.to_flax(trainer.task)
    return dict(losses=losses, own=trainer.own_steps, params=params, stats=stats, **layout(trainer, state))


def collectives_case(spec: dict) -> dict:
    """A ``Conv2d`` (split on dim 0) and a ``ConvTransposeTF`` (split on
    dim 1) of ``spec["conv"]``'s weights as column-parallel layers: the
    output, the input's gradient and this rank's weight and the whole
    bias's gradients of ``sum(y * w)``."""
    out = {}
    for kind, (make, dim) in {"conv": (lambda: Conv2d(8, 16), 0),
                              "transpose": (lambda: ConvTransposeTF(8, 16, (3, 3), (3, 3)), 1)}.items():
        layer = make()
        w, b = spec[kind]
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(w))
            layer.bias.copy_(torch.from_numpy(b))
        mesh.split_(layer.weight, dim)
        x = torch.from_numpy(spec["conv_x"]).requires_grad_(True)
        y = layer(x)
        torch.sum(y * torch.from_numpy(spec[kind + "_w"])).backward()
        out[kind] = dict(y=y.detach().numpy(), dx=x.grad.numpy(), dw=layer.weight.grad.numpy(),
                         db=layer.bias.grad.numpy())
    return out


def generation_cases(spec: dict) -> dict:
    """The generation task's cases at ``(data 1, model 2)``: the collectives
    alone; two steps from ``spec["init"]`` with ``spec["eps"]`` (the final
    state written); two with ``fused_bn_stats``; a step of the int8 trunk
    (its tree, built whole)."""
    torch.set_num_threads(2)
    mesh.make_grid(TP)
    out = {"collectives": collectives_case(spec)}
    out["steps"] = trajectory(pr.task(spec["init"]), spec["raws"], spec["eps"], spec["run_dir"])
    fused = trajectory(pr.fuse_bn_stats(pr.task(spec["init"])), spec["raws"], spec["eps"])
    out["fused"] = dict(losses=fused["losses"], own=fused["own"], stats=fused["stats"],
                        replicated=fused["replicated"])
    trainer = Trainer(pr.task(spec["init"], trunk_bn="frozen", trunk_quant="int8"), config())
    trainer.own_steps = []
    state, metrics = trainer.train_step(trainer.init_state(), spec["raws"][0], eps=spec["eps"])
    out["int8"] = dict(loss=float(metrics["loss"]), qtrunk=bridge.qtrunk_to_tree(trainer.qtrunk),
                       own=trainer.own_steps, replicated=layout(trainer, state)["replicated"])
    return out


def grid_cases(spec: dict) -> dict:
    """The generation task's cases at ``(data 2, model 2)``: two steps as
    at ``(1, 2)``; ``fit`` over two epochs of the cached path from shards
    (the disk tier on), with ``evaluate`` of each epoch over a validation
    split that ends in a remainder batch."""
    torch.set_num_threads(1)
    out = {"steps": trajectory(pr.task(spec["init"]), spec["raws"], spec["eps"])}
    task = pr.task(spec["init"], trunk_bn="frozen", cache_trunk_features=True,
                   cache_disk_dir=os.path.join(spec["run_dir"], "disk"))
    trainer = Trainer(task, config(spec["run_dir"], epochs=2))
    trainer.own_steps = []
    train = AcousticImageDataLoader(spec["train_list"], "training", 2, shard_index=mesh.data_rank(),
                                    shard_count=mesh.data_world())
    valid = AcousticImageDataLoader(spec["valid_list"], "validation", 2, shard_index=mesh.data_rank(),
                                    shard_count=mesh.data_world())
    tiers = []
    step = trainer.train_step

    def recorded(*args, **kw):
        out = step(*args, **kw)
        tiers.append(trainer.last_tier)
        return out

    trainer.train_step = recorded
    state = trainer.fit(train, valid)
    trainer.train_step = step
    out["cached"] = dict(tiers=tiers, trunk_runs=trainer.trunk_runs, step=state.step,
                         disk=len(trainer.feature_cache.disk), own=trainer.own_steps,
                         eval=trainer.evaluate(state, valid, use_cache=False),
                         valid=[b.valid for b in valid.batches(0)], **layout(trainer, state))
    return out


# -------------------------------------------------------- the other tasks


def embed_task(init) -> EmbedTask:
    task = EmbedTask(EmbedConfig(compute_dtype="float32", learning_rate=LR), device="cpu")
    bridge.load_flax(task, *init)
    return task


def reconstruct_task(kind: str, init) -> ReconstructTask:
    task = ReconstructTask(ReconstructConfig(encoder_type=kind, compute_dtype="float32", learning_rate=LR),
                           device="cpu")
    bridge.load_flax(task, *init)
    return task


def task_summary(trainer, state, metrics, keep: tuple) -> dict:
    """A run of one of the other tasks: its metrics and layout; the BN
    running averages; on model rank 0 the trained parameters and their
    Adam first moments under the top-level modules ``keep``, whole, in the
    flax layout (every rank gathers), each sampled as
    ``parallel_task_ranks.sampled`` does."""
    from parallel_task_ranks import sampled

    stats, params, mu = {}, {}, {}
    flax = lambda fn, t: np.asarray(bridge._INVERSE[fn](t.detach().to("cpu", torch.float32).contiguous().numpy()))
    for tensor, coll, path, fn in bridge.targets(trainer.task):
        key = "/".join(path)
        if coll == "batch_stats":
            stats[key] = flax(fn, tensor)
        elif path[0] in keep and tensor.requires_grad:
            whole = mesh.full(tensor)
            m = mesh.full(state.optimizer.state[tensor]["m"], like=tensor)
            if mesh.is_main():
                params[key], mu[key] = sampled(flax(fn, whole)), sampled(flax(fn, m))
    out = dict(metrics=metrics, stats=stats, **layout(trainer, state))
    if mesh.is_main():
        out.update(params=params, mu=mu)
    return out


def task_cases(spec: dict) -> dict:
    """One step of each of ``spec["cases"]`` at ``(1, 2)`` from JAX's
    weights with JAX's noise: the embedding family's default variant, or a
    reconstruction of ``kind``."""
    torch.set_num_threads(2)
    out = {}
    for name, case in spec["cases"].items():
        task = embed_task(case["init"]) if name == "embed" else reconstruct_task(name, case["init"])
        trainer = Trainer(task, config())
        trainer.own_steps = []
        state = trainer.init_state()
        metrics = []
        for raw in case["raws"]:
            state, m = trainer.train_step(state, local(raw), eps=case["eps"], moddrop=case.get("moddrop"))
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = task_summary(trainer, state, metrics, ("video",) if name == "embed" else ("model",))
        out[name]["own"] = trainer.own_steps
        del trainer, state, task
    return out


# ------------------------------- the projection, joint and classification families, the correspondence augmentation

CORRESPONDENCE = {  # tests/test_torch_tensor_parallel_correspondence.py's cases: the task's configuration
    "generation augment": dict(resnet_units=pr.UNITS, trunk_bn="frozen", correspondence=True),
    "generation no_video": dict(resnet_units=pr.UNITS, trunk_bn="frozen", correspondence=True,
                                correspondence_video=True),
    "augment": dict(correspondence=True),
    "music": dict(correspondence=True, datatype="music", num_channels=13, num_classes=9),
}
TRAINED = {"project Video": ("assoc_video",), "project Audio": ("assoc_audio_enc",), "joint moddrop": ("associator",),
           "joint onlyaudiovideo": ("associator1",), "classify generated": ("dualcamnet",),
           "classify real": ("dualcamnet",), "generation augment": ("resnet", "generator"),
           "generation no_video": ("resnet", "generator"), "augment": ("dualcamnet",), "music": ("dualcamnet",)}


def case_task(case: str, init):
    """A case's task, whole, from the flax trees ``init`` (``None``: left
    uninitialized): ``project <wiring>``, ``joint <mode>`` and ``classify
    <name>`` as ``parallel_family_ranks`` builds them (each with its own
    frozen VAEs: its trainer splits them), or a case of
    ``CORRESPONDENCE``."""
    family, _, name = case.partition(" ")
    if family == "classify":
        return pfr.classify_task(name, init)
    if family == "project":
        task = ProjectTask(ProjectConfig(compute_dtype="float32", learning_rate=LR, **pfr.PROJECT[name]), device="cpu")
    elif family == "joint":
        task = JointTask(JointConfig(compute_dtype="float32", learning_rate=LR, **pfr.JOINT[name]), device="cpu")
    elif family == "generation":
        task = GenerationTask(GenerationConfig(compute_dtype="float32", learning_rate=LR, **CORRESPONDENCE[case]),
                              device="cpu")
    else:
        task = CorrespondenceTask(ClassifyConfig(compute_dtype="float32", learning_rate=LR, **CORRESPONDENCE[case]),
                                  device="cpu")
    if init is not None:
        bridge.load_flax(task, *init)
    return task


def ckpt_name(case: str) -> str:
    return case.replace(" ", "_")


def trees_equal(a, b) -> bool:
    """Whether two flax trees hold the same keys, shapes and values."""
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(trees_equal(a[k], b[k]) for k in b)
    return np.asarray(a).shape == np.asarray(b).shape and np.array_equal(a, b)


VAES = ("acoustic", "video", "audio")
_VAES = {}  # this rank's frozen VAE modules, split by the first trainer and shared by the later cases


def vae_task(case: str, init):
    """A projection or joint case's task, whole but for its frozen VAEs:
    the modules the first such case of this process loaded from ``init``
    (a gigabyte, the same trees in every case; split by that case's
    trainer, they keep their blocks in the later ones)."""
    task = case_task(case, None)
    params, stats = init
    for name, module in task.named_children():
        if name in _VAES:
            setattr(task, name, _VAES[name])
            continue
        bridge.load_flax(module, params[name], stats.get(name, {}))
        if name in VAES:
            _VAES[name] = module
    return task


def warm_start(trainer, state, path: str, init: dict) -> dict:
    """The three VAEs warm-started from the whole checkpoint at ``path``
    (zeroed first, blocks and statistics), as the command line's
    ``visual_``, ``acoustic_`` and ``audio_init_checkpoint`` do it: each
    split tensor's local shape and dim, and whether the video VAE gathered
    whole is ``init`` (its flax trees) bit for bit."""
    with torch.no_grad():
        for name in VAES:
            for t in (*getattr(trainer.task, name).parameters(), *getattr(trainer.task, name).buffers()):
                t.zero_()
    run = RunConfig(visual_init_checkpoint=path, acoustic_init_checkpoint=path, audio_init_checkpoint=path)
    apply_init_checkpoints(state, dataclasses.replace(config(), run=run))
    video = trainer.task.video
    params, stats = bridge.to_flax(video)
    return dict(split={n: (tuple(p.shape), mesh.tp_dim(p)) for n, p in video.named_parameters()
                       if mesh.tp_dim(p) is not None},
                equal=trees_equal(params, init[0]["video"]) and trees_equal(stats, init[1]["video"]))


def recording(trainer, seen: dict):
    """Record in ``seen`` the batch the trainer's step prepares (the last
    one) and every shuffle permutation drawn; returns what undoes the
    latter."""
    prepare = trainer._prepare

    def prepared(*args, **kw):
        out = prepare(*args, **kw)
        seen["batch"] = {k: None if v is None else v.numpy() for k, v in out._asdict().items()}
        return out

    trainer._prepare = prepared
    seen["perms"] = []
    shuffle = preprocess.shuffle_permutations

    def drawn(*args, **kw):
        out = shuffle(*args, **kw)
        seen["perms"].append([p.numpy() for p in out])
        return out

    preprocess.shuffle_permutations = drawn
    return lambda: setattr(preprocess, "shuffle_permutations", shuffle)


def grid_case(case: str, c: dict, run_dir: str, loader=None, record: bool = False, warm: str | None = None) -> tuple:
    """One step of ``case`` on this rank's rows of ``c["raw"]`` with the
    global noise ``c["eps"]`` (and ``c["moddrop"]``), after ``evaluate``
    over ``loader`` where given, its VAEs warm-started from the checkpoint
    ``warm`` where given; with ``record`` the noise the trainer draws for
    the step (one process's draw for the global batch, doubled by the
    correspondence augmentation, cut to the rank's rows), the batch it
    prepares and the permutations it draws. Returns the trainer, its state
    and the summary."""
    task = vae_task(case, c["init"]) if case.startswith(("project", "joint")) else case_task(case, c["init"])
    trainer = Trainer(task, config(run_dir))
    trainer.own_steps = []
    state = trainer.init_state()
    seen, restore = {}, lambda: None
    if warm is not None:
        seen["warm"] = warm_start(trainer, state, warm, c["init"])
    if loader is not None:
        seen["eval"] = trainer.evaluate(state, loader, use_cache=False)
    if record:
        rows = c["raw"]["audio"].shape[0] * c["raw"]["audio"].shape[1] // mesh.data_world()
        eps, _ = trainer._rank_noise(None, step_generator(0, 0, "cpu"), rows)
        seen["eps"] = None if eps is None else eps.numpy()
        restore = recording(trainer, seen)
    try:
        state, m = trainer.train_step(state, local(c["raw"]), eps=c["eps"], moddrop=c.get("moddrop"))
    finally:
        restore()
    out = task_summary(trainer, state, [{k: float(v) for k, v in m.items()}], TRAINED[case])
    out.update(seen, own=trainer.own_steps, split_paths=sorted(
        "/".join(path) for t, coll, path, _ in bridge.targets(trainer.task)
        if coll == "params" and mesh.tp_dim(t) is not None))
    return trainer, state, out


def read_inputs(spec: dict) -> dict:
    """``spec`` and the pickled dict at ``spec["inputs"]``, which the test
    writes (renamed into place whole) while the ranks start: the cases'
    flax trees, batches and noise reach each rank through the file, not
    through the spawn's pipes."""
    while not os.path.exists(spec["inputs"]):
        time.sleep(0.1)
    with open(spec["inputs"], "rb") as f:
        return dict(spec, **pickle.load(f))


def family_cases(spec: dict) -> dict:
    """Every case of ``test_torch_tensor_parallel_families.py`` on this rank
    of ``(1, 2)``: a step of each from JAX's weights with JAX's noise, its
    state written as ``epoch_<case>.ckpt`` on a background thread, as
    ``Trainer.fit`` writes it; the ``spec["evaluate"]`` case after
    ``evaluate`` over a remainder batch, the ``spec["warm"]`` case's VAEs
    warm-started from the first case's checkpoint. The cases (each's flax
    trees, batch and noise) and the remainder batches come in a pickle at
    ``spec["inputs"]``, which the test writes while the ranks start."""
    torch.set_num_threads(2)
    spec = read_inputs(spec)
    out, first = {}, None
    saver = ckpt.AsyncCheckpointer()
    try:
        for case, c in spec["cases"].items():
            loader = pfr.RankLoader(spec["eval_raws"]) if case == spec["evaluate"] else None
            if case == spec["warm"]:  # its source written whole
                saver.wait()
                mesh.barrier()
            trainer, state, out[case] = grid_case(case, c, spec["run_dir"], loader,
                                                  warm=first if case == spec["warm"] else None)
            path = saver.save(trainer.run_dir, ckpt_name(case), state, write=mesh.is_main())
            first = first or path
            del trainer, state
    finally:
        saver.close()
    _VAES.clear()
    return out


def correspondence_cases(spec: dict) -> dict:
    """Every case of ``test_torch_tensor_parallel_correspondence.py`` on this
    rank of ``(2, 2)``: a step of each from JAX's weights (the generation
    task with JAX's noise), recording the noise, the prepared batch and the
    shuffle's permutations; ``evaluate`` over remainder batches of the
    silence map and the music shuffle first. The inputs come as
    ``family_cases``' do (``read_inputs``)."""
    torch.set_num_threads(1)
    spec = read_inputs(spec)
    out = {}
    for case, c in spec["cases"].items():
        raws = spec["eval_raws"].get(case)
        trainer, state, out[case] = grid_case(case, c, "unused", None if raws is None else pfr.RankLoader(raws),
                                              record=True)
        del trainer, state
    return out
