"""The rank bodies of ``tests/test_torch_tensor_parallel.py`` and
``tests/test_torch_tensor_parallel_tasks.py``: functions that
``mesh.launch`` runs on each CPU rank over gloo, the ranks laid out as a
``(data, model)`` grid with ``tensor_parallel=2`` (spawned processes import
them from here; they import the port only, never JAX). Each takes a plain
dict and returns one of numpy arrays and numbers."""

import hashlib
import os

import numpy as np
import torch

import parallel_ranks as pr
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core.config import (
    ExperimentConfig,
    OptimConfig,
    ParallelConfig,
    RunConfig,
)
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader
from acoustic_image_generation_tpu_torch.models.layers import Conv2d, ConvTransposeTF
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train.embed import EmbedConfig, EmbedTask
from acoustic_image_generation_tpu_torch.train.reconstruct import ReconstructConfig, ReconstructTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer

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
    of their Adam slots on this rank and whole, and a digest of every
    replicated tensor (parameters, BN statistics, Adam slots), which the
    peers must hold bit for bit."""
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
    return dict(split=split, bytes=local_bytes, whole_bytes=whole_bytes, slot_bytes=slot_bytes,
                whole_slot_bytes=whole_slot_bytes, replicated=h.hexdigest(),
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


def task_summary(trainer, state, metrics, keep: str) -> dict:
    """A run of one of the other tasks: its metrics and layout; the BN
    running averages; on model rank 0 the parameters and Adam's first
    moments of the top-level module ``keep``, whole, in the flax layout
    (every rank gathers), each sampled as ``parallel_task_ranks.sampled``
    does."""
    from parallel_task_ranks import sampled

    stats, params, mu = {}, {}, {}
    flax = lambda fn, t: np.asarray(bridge._INVERSE[fn](t.detach().to("cpu", torch.float32).contiguous().numpy()))
    for tensor, coll, path, fn in bridge.targets(trainer.task):
        key = "/".join(path)
        if coll == "batch_stats":
            stats[key] = flax(fn, tensor)
        elif path[0] == keep:
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
        out[name] = task_summary(trainer, state, metrics, "video" if name == "embed" else "model")
        out[name]["own"] = trainer.own_steps
        del trainer, state, task
    return out
