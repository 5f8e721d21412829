"""Checkpoints in the JAX package's file format, and best-epoch bookkeeping.

Counterpart of ``acoustic_image_generation_tpu/train/checkpoint.py``: the
same run layout (``{checkpoint_dir}/{exp_name}/``: ``epoch_{name}.ckpt``,
``model.txt``, ``metrics.jsonl``, the crash checkpoint's ``.meta.json``).

An ``epoch_{name}.ckpt`` holds the MessagePack (``core/msgpack.py``) of the
state dict of JAX's ``TrainState``, in its key order: ``step`` (int32),
``params`` and ``batch_stats`` (``bridge.to_flax``'s trees, f32), and
``opt_state``. For a task with ``param_labels`` (generation, the generated
classifier) it is laid out as ``optax.multi_transform`` over ``adam_tf1``::

    {"inner_states": {"frozen": {"inner_state": {}},
                      "train": {"inner_state": {"0": {"count": int32, "mu": tree, "nu": tree},
                                                "1": {}}}}}

``mu`` and ``nu`` follow the parameter tree, where a frozen subtree is
one ``{}`` (optax's ``MaskedNode``) at the level of JAX's labels: the
shallowest that holds no trained tensor (``resnet/block1_unit_1``, or
``resnet`` and ``generator`` whole for the generated classifier). A task
without labels (the classification and correspondence tasks, where every
parameter trains) has ``adam_tf1``'s chain state alone,
``{"0": {"count", "mu", "nu"}, "1": {}}``, as JAX's trainer builds no
``multi_transform`` for it. So
the JAX package restores a checkpoint the port wrote, and the port one that
JAX wrote. ``TF1Adam`` keeps a step per tensor; the file's single ``count``
is that step, which the port's ``TrainState.step`` equals. A state whose
per-tensor steps disagree with ``state.step`` was torn by a fault inside
the optimizer's update (JAX's functional state cannot be): it is refused
with ``TornStateError`` rather than written.

On more than one rank (``parallel/mesh.py``) the file is the one-process
file, byte for byte: FSDP's shards of the parameters and of their Adam
slots, or the blocks of the kernels split over a model group (tensor
parallelism), are gathered whole first (every rank takes part), and only
the rank that writes (``write=True``, rank 0) encodes and writes it. Every
rank restores the whole file and keeps its shards or blocks.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
from datetime import datetime

import numpy as np
import torch

from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core import msgpack
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train.state import TrainState


class TornStateError(RuntimeError):
    """The optimizer's per-tensor step counts disagree with ``state.step``."""


def _trainable(state: TrainState) -> list[torch.Tensor]:
    return [p for group in state.optimizer.param_groups for p in group["params"]]


def slot_count(state: TrainState) -> int:
    """The optimizer's step count: every trained tensor's TF1 Adam step (0
    before its first update) must equal ``state.step``."""
    opt = state.optimizer
    steps = {int(opt.state[p]["step"]) if opt.state.get(p) else 0 for p in _trainable(state)}
    if steps - {state.step}:
        raise TornStateError(
            f"the optimizer's per-tensor steps {sorted(steps)} disagree with the state's step "
            f"{state.step}: a fault inside the update left the parameters part-updated"
        )
    return state.step


def sharded(state: TrainState) -> bool:
    """Whether any tensor of ``state`` is an FSDP shard or split over a
    model group (then every rank gathers)."""
    return any(mesh.is_split(p) for p in state.task.parameters())


def _collect(state: TrainState, copy: bool) -> dict:
    """What a checkpoint holds, as tensors in the port's layouts: live, or
    (``copy``) cloned on their device so that later in-place updates leave
    them alone. Sharded tensors and their slots are gathered whole."""
    take = (lambda t: t.detach().clone()) if copy else (lambda t: t.detach())
    count = slot_count(state)
    opt = state.optimizer
    trainable = {id(p) for p in _trainable(state)}
    leaves, slots = [], []
    for tensor, coll, path, fn in bridge.targets(state.task):
        leaves.append((coll, path, fn, take(mesh.full(tensor))))
        if coll == "params":
            slot = opt.state.get(tensor) if id(tensor) in trainable else None
            if id(tensor) not in trainable:
                slots.append((path, fn, None, None))
            elif slot:
                slots.append((path, fn, take(mesh.full(slot["m"], like=tensor)),
                              take(mesh.full(slot["v"], like=tensor))))
            else:
                zeros = torch.zeros(mesh.whole_shape(tensor), dtype=tensor.dtype, device=tensor.device)
                slots.append((path, fn, zeros, zeros))
    return {"step": state.step, "count": count, "leaves": leaves, "slots": slots,
            "labelled": hasattr(state.task, "param_labels")}


def _host(fn, tensor) -> np.ndarray:
    return np.array(bridge._INVERSE[fn](tensor.to("cpu", torch.float32).numpy()), order="C")


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _sorted(tree):
    """Keys sorted at every level, as JAX's tree functions leave its dicts."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _state_dict(collected: dict) -> dict:
    """JAX's ``TrainState`` state dict (numpy leaves, its key order) of
    ``_collect``'s result; runs on the host."""
    trees = {"params": {}, "batch_stats": {}}
    for coll, path, fn, tensor in collected["leaves"]:
        _put(trees[coll], path, _host(fn, tensor))
    mu, nu = {}, {}
    # a frozen subtree's slots are one {} (optax's MaskedNode) at the
    # shallowest level that holds no trained tensor, where JAX's labels sit
    live = {path[:i] for path, _, m, _ in collected["slots"] if m is not None for i in range(1, len(path) + 1)}
    for path, fn, m, v in collected["slots"]:
        if m is None:
            node = next(path[:i] for i in range(1, len(path) + 1) if path[:i] not in live)
            _put(mu, node, {})
            _put(nu, node, {})
        else:
            _put(mu, path, _host(fn, m))
            _put(nu, path, _host(fn, v))
    adam = {"count": np.asarray(collected["count"], np.int32), "mu": _sorted(mu), "nu": _sorted(nu)}
    opt_state = {"0": adam, "1": {}}
    if collected["labelled"]:
        opt_state = {"inner_states": {"frozen": {"inner_state": {}}, "train": {"inner_state": opt_state}}}
    return {"step": np.asarray(collected["step"], np.int32), "params": _sorted(trees["params"]),
            "batch_stats": _sorted(trees["batch_stats"]), "opt_state": opt_state}


def state_dict(state: TrainState) -> dict:
    """The state dict of JAX's ``TrainState`` for ``state``."""
    return _state_dict(_collect(state, copy=False))


def _write(path: str, tree: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.writelines(msgpack.pack(tree))
    os.replace(tmp, path)  # a checkpoint file is never half-written


def save_checkpoint(run_dir: str, name, state: TrainState, *, write: bool = True) -> str:
    """Write ``epoch_{name}.ckpt``; with ``write=False`` only take part in
    gathering FSDP's shards or the split tensors (the other ranks)."""
    path = os.path.join(run_dir, f"epoch_{name}.ckpt")
    if not write and not sharded(state):
        return path
    collected = _collect(state, copy=False)
    if write:
        os.makedirs(run_dir, exist_ok=True)
        _write(path, _state_dict(collected))
    return path


class AsyncCheckpointer:
    """Checkpoint writes on a background thread. ``save`` first snapshots
    the state by copying it on its device (the copies are queued on the
    stream ahead of the next step's in-place update), then hands the
    snapshot to the writer thread, which copies it to the host, encodes it
    and writes the file; the thread holds no reference to the live
    tensors. One save is in flight at a time; a second ``save`` waits for
    the first and raises its error. ``close()`` makes every accepted save
    durable."""

    def __init__(self) -> None:
        self._pool = cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix="aig-ckpt")
        self._pending: cf.Future | None = None

    def save(self, run_dir: str, name, state: TrainState, *, write: bool = True) -> str:
        """Snapshot ``state`` and write it in the background; ``write=False``
        only takes part in gathering FSDP's shards (the other ranks)."""
        if not write:
            return save_checkpoint(run_dir, name, state, write=False)
        snapshot = _collect(state, copy=True)
        self.wait()
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, f"epoch_{name}.ckpt")
        self._pending = self._pool.submit(lambda: _write(path, _state_dict(snapshot)))
        return path

    def wait(self) -> None:
        """Block until the in-flight save (if any) is durable; re-raises
        the writer thread's error."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()


def save_resume_meta(ckpt_path: str, *, epoch: int, step_in_epoch: int) -> str:
    """Sidecar of a crash checkpoint: its exact position in the epoch."""
    path = ckpt_path + ".meta.json"
    with open(path, "w") as f:
        json.dump({"epoch": int(epoch), "step_in_epoch": int(step_in_epoch)}, f)
    return path


def load_resume_meta(ckpt_path: str) -> dict | None:
    try:
        with open(ckpt_path + ".meta.json") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_state_dict(path: str) -> dict:
    with open(path, "rb") as f:
        return msgpack.msgpack_restore(f.read())


def _leaf(tree: dict, path: tuple, what: str):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            raise KeyError(f"checkpoint has no {what} leaf {'/'.join(path)}")
        tree = tree[k]
    return tree


def restore_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore a checkpoint (either package's) into ``template``: the task's
    parameters and BN statistics (``bridge.load_flax``), the optimizer's
    slots and step, and the step. In place; returns ``template``."""
    sd = read_state_dict(path)
    bridge.load_flax(template.task, sd["params"], sd["batch_stats"])
    opt_state = sd["opt_state"]
    if "inner_states" in opt_state:
        opt_state = opt_state["inner_states"]["train"]["inner_state"]
    adam = opt_state["0"]
    step, count = int(sd["step"]), int(adam["count"])
    if count != step:
        raise ValueError(f"{path}: optimizer count {count} differs from step {step}; the port keeps one count")
    opt = template.optimizer
    trainable = {id(p) for p in _trainable(template)}
    for tensor, coll, tpath, fn in bridge.targets(template.task):
        if coll != "params" or id(tensor) not in trainable:
            continue
        m, v = (_leaf(adam[k], tpath, k) for k in ("mu", "nu"))
        slot = {"step": count}
        for key, value in (("m", m), ("v", v)):
            arr = np.array(fn(np.asarray(value, np.float32)), order="C")
            if arr.shape != mesh.whole_shape(tensor):
                raise ValueError(f"{path}: slot {key} of {'/'.join(tpath)} is {arr.shape}, not {mesh.whole_shape(tensor)}")
            slot[key] = mesh.local_rows_of(torch.from_numpy(arr), tensor).to(tensor.device, tensor.dtype)
        opt.state[tensor] = slot
    template.step = step
    return template


def restore_params(path: str, task: torch.nn.Module) -> torch.nn.Module:
    """Partial restore: the checkpoint's parameters into ``task``, its BN
    statistics kept (JAX's ``restore_params``). Returns ``task``."""
    sd = read_state_dict(path)
    bridge.load_flax(task, sd["params"], bridge.to_flax(task)[1])
    return task


class BestTracker:
    """Best-validation-metric gate and ``model.txt`` writer; ``mode='min'``
    for losses, ``'max'`` for accuracies."""

    def __init__(self, run_dir: str, exp_name: str, mode: str = "min", *, write: bool = True):
        self.write = write  # False: track the best epoch, leave model.txt to the rank that writes
        self.run_dir = run_dir
        self.exp_name = exp_name
        self.mode = mode
        self.best_epoch = -1
        self.best_loss = float("inf") if mode == "min" else float("-inf")

    def update(self, epoch: int, loss: float) -> bool:
        """True (and recorded) iff this epoch's metric is a new best (<= or
        >=, as the reference's ``total_loss <= best_loss``)."""
        better = loss <= self.best_loss if self.mode == "min" else loss >= self.best_loss
        if better:
            self.best_epoch = epoch
            self.best_loss = loss
            if not self.write:
                return True
            os.makedirs(self.run_dir, exist_ok=True)
            with open(os.path.join(self.run_dir, "model.txt"), "w") as f:
                f.write(
                    f"{datetime.now()}: {self.exp_name}\n"
                    f"Best Epoch: {epoch}\n"
                    f"Validation_mse_Loss: {loss:6f}\n"
                )
            return True
        return False

    @staticmethod
    def read_best_epoch(run_dir: str) -> int:
        """The best epoch recorded in ``model.txt``."""
        with open(os.path.join(run_dir, "model.txt")) as f:
            for line in f:
                if line.startswith("Best Epoch:"):
                    return int(line.split(":")[1])
        raise ValueError(f"no best epoch recorded in {run_dir}/model.txt")


class MetricsWriter:
    """Append-only ``metrics.jsonl``."""

    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")

    def write(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
