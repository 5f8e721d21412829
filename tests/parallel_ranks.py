"""The rank bodies of ``tests/test_torch_parallel.py``: functions that
``mesh.launch`` runs on each of two CPU ranks over gloo (spawned processes
import them from here; they import the port only, never JAX). Each takes a
plain dict and returns one of numpy arrays and numbers."""

import dataclasses

import numpy as np
import torch

from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core.config import ExperimentConfig, OptimConfig, ParallelConfig, RunConfig
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader
from acoustic_image_generation_tpu_torch.data.preprocess import normalize_video
from acoustic_image_generation_tpu_torch.models.resnet import ConvBN
from acoustic_image_generation_tpu_torch.ops.conv_stats import conv1x1_batch_stats
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train.classify import ClassificationTask, ClassifyConfig
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, step_generator

UNITS = (1, 1, 1, 1)
LR = 1e-4


def task(init=None, **cfg) -> GenerationTask:
    t = GenerationTask(GenerationConfig(resnet_units=UNITS, compute_dtype="float32", learning_rate=LR, **cfg),
                       device="cpu").init_params(0)
    if init is not None:
        bridge.load_flax(t, *init)
    return t


def fuse_bn_stats(t: GenerationTask) -> GenerationTask:
    """Put every eligible 1x1 trunk conv on ``matmul_stats`` (the
    ``fused_bn_stats`` switch of ``ResNet50``)."""
    for m in t.resnet.modules():
        if isinstance(m, ConvBN) and m is not t.resnet.conv_map:
            m.fused_stats = not m.fixed_pad and m.weight.shape[2:] == (1, 1) and m.stride == 1
    return t


def config(run_dir="unused", fsdp=False) -> ExperimentConfig:
    return ExperimentConfig(optim=OptimConfig(learning_rate=LR), run=RunConfig(checkpoint_dir=run_dir, exp_name="par"),
                            parallel=ParallelConfig(compute_dtype="float32", num_devices=mesh.world(), fsdp=fsdp))


def local(raw: dict) -> dict:
    """This rank's clips of a global batch."""
    return {k: mesh.shard_rows(v) for k, v in raw.items()}


def trajectory(spec, fsdp: bool, run_dir: str) -> dict:
    """``spec["raws"]`` steps from ``spec["init"]`` with the global noise
    ``spec["eps"]``; writes the final state as ``epoch_final.ckpt``."""
    trainer = Trainer(task(spec["init"]), config(run_dir, fsdp))
    state = trainer.init_state()
    losses = []
    for raw in spec["raws"]:
        state, metrics = trainer.train_step(state, local(raw), eps=spec["eps"])
        losses.append({k: float(v) for k, v in metrics.items()})
    trainer.save("final", state)
    params, stats = bridge.to_flax(trainer.task)
    moments = sum(s["m"].numel() * s["m"].element_size() * 2 for s in state.optimizer.state.values())
    placements = {n: (mesh.shard_dim(p) if mesh.is_sharded(p) else None)
                  for n, p in trainer.task.named_parameters() if p.requires_grad}
    return dict(losses=losses, params=params, stats=stats, moments_bytes=moments, placements=placements)


def run_cases(spec: dict) -> dict:
    torch.set_num_threads(2)
    out = {"rank": mesh.rank()}
    out["ddp"] = trajectory(spec, False, spec["ddp_dir"])
    out["fsdp"] = trajectory(spec, True, spec["fsdp_dir"])

    # the VAE noise without eps: the global draw, this rank's rows
    trainer = Trainer(task(spec["init"]), config())
    rows = spec["raws"][0]["audio"].shape[1] * spec["raws"][0]["audio"].shape[0] // mesh.world()
    noise, _ = trainer._rank_noise(None, step_generator(0, 0, "cpu"), rows)
    _, metrics = trainer.train_step(trainer.init_state(), local(spec["raws"][0]))
    out["noise"] = dict(rows=noise.numpy(), loss=float(metrics["loss"]))

    # fused_bn_stats: the trunk's train-mode BN statistics over the global batch
    fused = fuse_bn_stats(task(spec["init"]))
    video = normalize_video(torch.from_numpy(local(spec["raws"][0])["video"]).flatten(0, 1))
    with torch.no_grad():
        fused.resnet(video, mode="trunk", train=True)
        conv = fused.resnet.block1_unit_1.conv1
        x = torch.from_numpy(spec["stats_input"])
        _, mean, var = conv1x1_batch_stats(mesh.shard_rows(x), conv.weight.reshape(conv.weight.shape[0], -1).t())
    out["fused"] = dict(running={n: b.numpy().copy() for n, b in fused.resnet.named_buffers()},
                        mean=mean.numpy(), var=var.numpy())

    # the int8 trunk's calibration on this rank's rows
    int8 = task(spec["init"], trunk_bn="frozen", trunk_quant="int8")
    out["amax"] = int8.build_qtrunk(video).act.numpy()

    # the cached step: a fill, then the device tier, each rank over its own windows
    cached = Trainer(task(spec["init"], trunk_bn="frozen", cache_trunk_features=True), config())
    state = cached.init_state()
    ids = np.arange(spec["raws"][0]["audio"].shape[0])
    cache_losses, tiers = [], []
    for raw in spec["raws"][:2]:
        state, metrics = cached.train_step(state, local(dict(raw, window_ids=ids)), eps=spec["eps"])
        cache_losses.append(float(metrics["loss"]))
        tiers.append(cached.last_tier)
    out["cached"] = dict(losses=cache_losses, tiers=tiers, trunk_runs=cached.trunk_runs,
                         windows=sorted(cached.device_cache.slots))

    # evaluate with a remainder batch (ae: no noise) from the rank's loader
    ae = Trainer(task(spec["ae_init"], ae=True), config())
    loader = AcousticImageDataLoader(spec["valid_list"], "validation", 2, shard_index=mesh.rank(),
                                     shard_count=mesh.world())
    out["eval"] = dict(sums=ae.evaluate(ae.init_state(), loader, use_cache=False),
                       valid=[b.valid for b in loader.batches(0)])

    # the trainer takes the other tasks: under DDP, and with tensor_parallel=2 as a (1, 2) grid
    refusals = {}
    makers = (("classification", lambda: ClassificationTask(ClassifyConfig(compute_dtype="float32"), device="cpu")),
              ("correspondence", lambda: task(correspondence=True)))
    for name, make in makers:
        try:
            Trainer(make(), config())
            refusals[name] = None
        except NotImplementedError as e:
            refusals[name] = str(e)
    out["refusals"] = refusals
    tp = dataclasses.replace(config(), parallel=dataclasses.replace(config().parallel, tensor_parallel=2))
    out["tensor_parallel"] = {}
    for name, make in makers:
        trainer = Trainer(make(), tp)
        out["tensor_parallel"][name] = sum(mesh.tp_dim(p) is not None for p in trainer.task.parameters())
    return out
