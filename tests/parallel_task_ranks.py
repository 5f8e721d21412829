"""The rank bodies of ``tests/test_torch_parallel_embed.py`` and
``tests/test_torch_parallel_reconstruct.py``: functions that ``mesh.launch``
runs on each of two CPU ranks over gloo (spawned processes import them from
here; they import the port only, never JAX). Each takes a plain dict of
numpy arrays and settings and returns one of numpy arrays and numbers; the
trees of parameters and moments come from rank 0 alone."""

import hashlib

import numpy as np
import torch

from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core.config import ExperimentConfig, OptimConfig, ParallelConfig, RunConfig
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader
from acoustic_image_generation_tpu_torch.models.blocks import UNET_BN_EPS, UNET_BN_MOMENTUM
from acoustic_image_generation_tpu_torch.models.layers import BatchNorm
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train.embed import EmbedConfig, EmbedTask
from acoustic_image_generation_tpu_torch.train.reconstruct import ReconstructConfig, ReconstructTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer

LR = 1e-4
VARIANTS = ("triplet", "fusion", "moddrop", "proxy", "l2")
SAMPLED = 1 << 22  # a leaf of more entries comes back as every stride-th entry of its flat flax layout


def config(fsdp=False, run_dir="unused") -> ExperimentConfig:
    return ExperimentConfig(optim=OptimConfig(learning_rate=LR), run=RunConfig(checkpoint_dir=run_dir, exp_name="par"),
                            parallel=ParallelConfig(compute_dtype="float32", num_devices=mesh.world(), fsdp=fsdp))


def embed_task(variant: str, init) -> EmbedTask:
    flags = {v: v == variant for v in ("fusion", "moddrop", "l2", "proxy")}
    task = EmbedTask(EmbedConfig(compute_dtype="float32", learning_rate=LR, **flags), device="cpu")
    bridge.load_flax(task, *init)
    return task


def reconstruct_task(kind: str, init) -> ReconstructTask:
    task = ReconstructTask(ReconstructConfig(encoder_type=kind, compute_dtype="float32", learning_rate=LR),
                           device="cpu")
    bridge.load_flax(task, *init)
    return task


def local(raw: dict) -> dict:
    """This rank's clips of a global batch."""
    return {k: mesh.shard_rows(v) for k, v in raw.items()}


def update_bound(steps: int, init: np.ndarray) -> np.ndarray:
    """How far apart two runs' updates of a tensor from ``init`` may lie
    after ``steps`` steps of TF1's Adam, entry by entry: twice the largest
    update it can make at each step (lr at step 1, 1.0013 lr at step 2: the
    bias-corrected rate times the largest ``m / sqrt(v)`` any gradients
    give), plus the f32 rounding of each step and of the parameter. Two runs
    whose gradients differ in sign at every step reach it."""
    b1, b2, total = 0.9, 0.999, 0.0
    for t in range(1, steps + 1):
        ratio = sum(((1 - b1) * b1 ** (t - i)) ** 2 / ((1 - b2) * b2 ** (t - i)) for i in range(1, t + 1))
        total += np.sqrt(1 - b2**t) / (1 - b1**t) * np.sqrt(ratio)
    eps = np.finfo(np.float32).eps
    return 2 * LR * (1 + 4 * eps) * total + 2 * steps * eps * np.abs(init)


def sampled(a: np.ndarray) -> np.ndarray:
    """``a``, or every stride-th entry of it flattened (about 2^20 of them)
    when it has more than ``SAMPLED`` entries."""
    if a.size <= SAMPLED:
        return a
    # read in place: a flattening copy of a transposed view of 100M entries takes numpy seconds
    return a[np.unravel_index(np.arange(0, a.size, -(-a.size // (1 << 20))), a.shape)]


def train(task, raws: list, eps: list, fsdp: bool, moddrop=None, run_dir="unused"):
    """``len(raws)`` steps of this rank's rows of each global batch, with
    the global noise of each step; returns the trainer, its state and each
    step's metrics."""
    trainer = Trainer(task, config(fsdp, run_dir))
    state = trainer.init_state()
    metrics = []
    for raw, e in zip(raws, eps):
        state, m = trainer.train_step(state, local(raw), eps=e, moddrop=moddrop)
        metrics.append({k: float(v) for k, v in m.items()})
    return trainer, state, metrics


def run_summary(trainer, state, metrics: list, keep: tuple) -> dict:
    """What a run returns: its metrics; a digest of its whole state
    (parameters, BN running averages, Adam's moments; FSDP's shards
    gathered a leaf at a time); the BN running averages; the bytes of this
    rank's Adam moments and the names of its sharded parameters; and on rank
    0 the parameters and Adam's first moments (TF1's: 0.1 of the first
    step's gradient) of the top-level modules in ``keep``, in the flax
    layout, keyed by flax path, each ``sampled``."""
    h = hashlib.sha1()
    stats, params, moments = {}, {}, {}
    flax = lambda fn, t: np.asarray(bridge._INVERSE[fn](t.numpy()))
    for tensor, coll, path, fn in bridge.targets(trainer.task):
        key = "/".join(path)
        whole = [mesh.full(tensor)]
        if coll == "params":
            slot = state.optimizer.state[tensor]
            whole += [mesh.full(slot["m"], like=tensor), mesh.full(slot["v"], like=tensor)]
        whole = [t.detach().to("cpu", torch.float32).contiguous() for t in whole]
        h.update(key.encode())
        for t in whole:
            h.update(t.numpy())
        if coll == "batch_stats":
            stats[key] = flax(fn, whole[0])
        elif path[0] in keep and mesh.is_main():
            params[key], moments[key] = sampled(flax(fn, whole[0])), sampled(flax(fn, whole[1]))
    out = dict(metrics=metrics, digest=h.hexdigest(), stats=stats,
               moments=sum(mesh.local(s["m"]).numel() * 2 * 4 for s in state.optimizer.state.values()),
               sharded=sorted(n for n, p in trainer.task.named_parameters() if mesh.is_sharded(p)))
    if mesh.is_main():
        out.update(params=params, mu=moments)
    return out


def rel_l2(a: dict, b: dict, prefix: str) -> float:
    """||a - b|| / ||b|| over the leaves of ``b`` under ``prefix``."""
    keys = [k for k in b if k.startswith(prefix + "/")]
    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2)) for k in keys)
    den = sum(float(np.sum(b[k].astype(np.float64) ** 2)) for k in keys)
    return float(np.sqrt(num / den))


def bn_case(spec: dict) -> dict:
    """A VAE BN (momentum .99, eps 1e-3) in train mode on this rank's rows
    of ``spec["bn_x"]``, its loss ``sum(y * w)`` over the rows, backward:
    the rows of ``y`` and of ``x``'s gradient, the scale's and bias's
    gradients from this rank's rows, the running averages."""
    x = torch.from_numpy(mesh.shard_rows(spec["bn_x"])).requires_grad_(True)
    w = torch.from_numpy(mesh.shard_rows(spec["bn_w"]))
    bn = BatchNorm(x.shape[-1], UNET_BN_EPS, UNET_BN_MOMENTUM)
    bn.reset_parameters()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(spec["bn_scale"]))
        bn.bias.copy_(torch.from_numpy(spec["bn_bias"]))
    y = bn(x, train=True)
    torch.sum(y * w).backward()
    return dict(y=y.detach().numpy(), dx=x.grad.numpy(), dscale=bn.weight.grad.numpy(), dbias=bn.bias.grad.numpy(),
                mean=bn.running_mean.numpy(), var=bn.running_var.numpy())


def gather_case(spec: dict) -> dict:
    """``all_gather_rows`` of this rank's rows of ``spec["gather_x"]`` and
    of integer labels, and the gradient of a term that couples the gathered
    rows (every rank computes the same)."""
    x = torch.from_numpy(mesh.shard_rows(spec["gather_x"])).requires_grad_(True)
    g = mesh.all_gather_rows(x)
    term = torch.sum((g @ g.T) ** 2)
    term.backward()
    labels = mesh.all_gather_rows(torch.arange(x.shape[0]) + 100 * mesh.rank())
    return dict(gathered=g.detach().numpy(), term=float(term), dx=x.grad.numpy(), labels=labels.numpy())


# ---------------------------------------------------------------- embedding


def embed_cases(spec: dict) -> dict:
    """Every case of ``test_torch_parallel_embed.py`` on this rank: the BN
    layer and the gather alone; a step of each variant under DDP (rank 0
    returns the acoustic VAE's tensors, and the triplet run's every first
    moment); the triplet step under FSDP (its moments' gap to DDP's, a VAE
    at a time); ``evaluate`` over a validation split with a remainder
    batch."""
    torch.set_num_threads(2)
    out = {"bn": bn_case(spec), "gather": gather_case(spec)}
    vaes = ("acoustic", "audio", "video")
    for variant in VARIANTS:
        trainer, state, metrics = train(embed_task(variant, spec["init"]), spec["raws"], spec["eps"], False,
                                        moddrop=spec["moddrop"])
        out[variant] = run_summary(trainer, state, metrics, vaes if variant == "triplet" else ("acoustic",))
        del trainer, state
    trainer, state, metrics = train(embed_task("triplet", spec["init"]), spec["raws"], spec["eps"], True)
    out["fsdp"] = run_summary(trainer, state, metrics, vaes)
    del trainer, state
    if mesh.is_main():
        ddp, fsdp = out["triplet"]["mu"], out["fsdp"].pop("mu")
        out["fsdp"]["mu_gap"] = {m: rel_l2(fsdp, ddp, m) for m in vaes}

    # evaluate over the validation split, a remainder batch at the end, from the rank's loader
    trainer = Trainer(embed_task("triplet", spec["init"]), config())
    loader = AcousticImageDataLoader(spec["valid_list"], "validation", 2, shard_index=mesh.rank(),
                                     shard_count=mesh.world())
    out["eval"] = dict(means=trainer.evaluate(trainer.init_state(), loader, use_cache=False),
                       valid=[b.valid for b in loader.batches(0)])
    return out


# ----------------------------------------------------------- reconstruction


def reconstruct_cases(spec: dict) -> dict:
    """Every case of ``test_torch_parallel_reconstruct.py`` on this rank:
    each encoder type from JAX's weights and with JAX's noise, under DDP or
    FSDP as ``spec["cases"]`` says; the ``Audio`` run's final state written
    as ``epoch_final.ckpt``."""
    torch.set_num_threads(2)
    out = {}
    for kind, case in spec["cases"].items():
        trainer, state, metrics = train(reconstruct_task(kind, case["init"]), case["raws"], case["eps"],
                                        case["fsdp"], run_dir=spec["run_dir"])
        out[kind] = run_summary(trainer, state, metrics, ("model",))
        if kind == "Audio":
            trainer.save("final", state)
        del trainer, state
    return out
