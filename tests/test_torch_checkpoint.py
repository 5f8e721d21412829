"""The port's checkpoints against the JAX package's, in f32 on the CPU: the
MessagePack codec against ``flax.serialization`` byte for byte, checkpoint
files in both directions, the trajectory continued across packages, the
background writer's snapshot, the torn-state refusal and the warm starts.

Tolerances, and why: the codec and the file layout are compared byte for
byte, and a restore leaf for leaf, exactly. The step after a restore is
held as ``tests/test_torch_train.py`` holds its trajectory: the loss to
1e-5 relative; each trained tensor's update (new - restored) entry by
entry within 2 lr, 99% within lr/4 and within 10% in L2 norm (Adam turns a
gradient at rounding-noise level into a full +-lr step of either sign); each
tensor's Adam moments within 1e-2 in L2 norm (they differ by 0.1 and 0.001
of the two frameworks' gradient gap, which for a tensor whose gradient is
near rounding noise, such as the ``conv_dec`` bias, reads 1.4e-3 of the
gradient); the frozen trunk bit-frozen.
"""

import os

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.core import rng as jrng
from acoustic_image_generation_tpu.core.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    ParallelConfig,
    RunConfig,
)
from acoustic_image_generation_tpu.data.pipeline import RawBatch as JaxRawBatch
from acoustic_image_generation_tpu.parallel import make_mesh
from acoustic_image_generation_tpu.train import checkpoint as jckpt
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxTask
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core import config as pconfig
from acoustic_image_generation_tpu_torch.core import msgpack
from acoustic_image_generation_tpu_torch.core.tf1_export import export_state
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train import warmstart
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir, tmp_path  # noqa: F401

UNITS = (1, 1, 1, 1)
LR = 1e-4


def _raw(seed, clips=1, frames=2):
    rng = np.random.default_rng(seed)
    return dict(
        acoustic=rng.random((clips, frames, 36, 48, 12)).astype(np.float32),
        audio=rng.integers(-(2**15), 2**15, (clips, frames, 1024)).astype(np.int32),
        video=rng.integers(0, 256, (clips, frames, 224, 298, 3)).astype(np.uint8),
        action=np.zeros((clips,), np.int32),
        location=np.zeros((clips,), np.int32),
    )


def _jax_batch(raw):
    return JaxRawBatch(valid=raw["acoustic"].shape[0], **raw)


def _jax_cfg(tmp):
    return ExperimentConfig(
        data=DataConfig(batch_size=1),
        model=ModelConfig(resnet_units=UNITS),
        optim=OptimConfig(learning_rate=LR),
        run=RunConfig(checkpoint_dir=str(tmp), exp_name="jax", seed=0),
        parallel=ParallelConfig(compute_dtype="float32"),
    )


def _port_task():
    return GenerationTask(GenerationConfig(resnet_units=UNITS, compute_dtype="float32", learning_rate=LR),
                          device="cpu")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's Trainer: init, the init's checkpoint bytes, two steps and their
    checkpoint, then the third step with the noise it drew."""
    with module_dir(tmp_path_factory, "jax_ckpt", need_mb=400) as tmp:  # two full checkpoints
        cfg = _jax_cfg(tmp)
        jtr = JaxTrainer(JaxTask(cfg), cfg, mesh=make_mesh(1))
        state = jtr.init_state(_jax_batch(_raw(100)))
        init_path = jckpt.save_checkpoint(str(tmp), "init", state)
        for s in range(2):
            state, _ = jtr.train_step(state, _jax_batch(_raw(100 + s)))
        two_path = jckpt.save_checkpoint(str(tmp), "two", state)
        raw = _raw(102)
        rngs = jrng.train_step_rngs(jtr.base_key, 2)
        out, _ = jtr.task._forward(state.params, state.batch_stats,
                                   jtr._prepare(jtr.device_batch(_jax_batch(raw)), key=rngs["data"]), rngs,
                                   train=True)
        eps = np.asarray((out.z - out.mean) / out.std)
        two = jax.device_get(state)
        state, metrics = jtr.train_step(state, _jax_batch(raw))
        yield dict(cfg=cfg, trainer=jtr, init_path=init_path, two_path=two_path, two=two, eps=eps, raw=raw,
                   three=jax.device_get(state), loss=float(metrics["loss"]))


# ---------------------------------------------------------------- codec


def _tree(big):
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 4, 5)).astype(np.float32)
    b16 = rng.standard_normal((7, 9)).astype(np.float32)
    jax_tree = {"step": np.asarray(np.int32(7)), "p": {"w": f32, "i": rng.integers(-9, 9, (big,), dtype=np.int32),
                                                      "e": {}},
                "bf": jnp.asarray(b16, jnp.bfloat16), "s32": np.float32(1.5), "s64": np.int64(-3),
                "py": {"int": 2**40, "neg": -100000, "f": 2.5, "t": True, "n": None, "k" * 300: "v" * 70000}}
    port_tree = dict(jax_tree, bf=torch.from_numpy(b16).to(torch.bfloat16))
    return jax_tree, port_tree


@pytest.mark.parametrize("big", [0, 1, 40, 70000])
def test_msgpack_matches_flax_byte_for_byte(big):
    jax_tree, port_tree = _tree(big)
    data = fs.to_bytes(jax_tree)
    assert msgpack.to_bytes(port_tree) == data
    back = msgpack.msgpack_restore(data)
    want = fs.msgpack_restore(data)
    assert back.keys() == want.keys()
    for (k, got), (k2, ref) in zip(_leaves(back), _leaves(want)):
        assert k == k2
        if isinstance(got, torch.Tensor):  # bfloat16 comes back as torch, its bits equal
            assert got.dtype == torch.bfloat16 and got.shape == ref.shape, k
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(ref).view(np.int16), err_msg=k)
        else:
            assert type(got) is type(ref), k
            np.testing.assert_array_equal(got, ref, err_msg=k)
            assert getattr(got, "dtype", None) == getattr(ref, "dtype", None), k


def test_msgpack_chunks_leaves_over_the_limit_as_flax(monkeypatch):
    """flax splits a leaf over MAX_CHUNK_SIZE bytes (2**30) into chunks; the
    limit is lowered on both sides so that a small leaf takes that path."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    leaf = np.arange(50, dtype=np.float32).reshape(5, 10)
    tree = {"a": leaf, "b": {"c": leaf[:2]}}
    data = fs.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    assert msgpack.to_bytes(tree) == data
    back = msgpack.msgpack_restore(data)
    np.testing.assert_array_equal(back["a"], leaf)
    np.testing.assert_array_equal(back["b"]["c"], leaf[:2])


def test_msgpack_refuses_what_it_cannot_read_or_write():
    data = msgpack.to_bytes({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack.msgpack_restore(data[:-1])
    with pytest.raises(ValueError, match="trailing"):
        msgpack.msgpack_restore(data + b"\xc0")
    with pytest.raises(TypeError):
        msgpack.to_bytes({"a": (1, 2)})  # flax's strict types: tuples are not state-dict nodes


# ---------------------------------------------------------------- files


def test_fresh_state_file_equals_jax_byte_for_byte(jax_run, tmp_path):
    """JAX's init state and the port's state from the same weights (step 0,
    no Adam slots yet) give the same checkpoint file."""
    sd = ckpt.read_state_dict(jax_run["init_path"])
    task = _port_task()
    bridge.load_flax(task, sd["params"], sd["batch_stats"])
    path = ckpt.save_checkpoint(str(tmp_path), "init", Trainer(task).init_state())
    with open(path, "rb") as f, open(jax_run["init_path"], "rb") as g:
        assert f.read() == g.read()
    # the optimizer's layout: multi_transform over adam_tf1, a frozen subtree one {}
    adam = sd["opt_state"]["inner_states"]["train"]["inner_state"]
    assert sd["opt_state"]["inner_states"]["frozen"] == {"inner_state": {}} and adam["1"] == {}
    assert adam["0"]["mu"]["resnet"]["conv1"] == {} and adam["0"]["nu"]["resnet"]["block1_unit_1"] == {}
    kernel = sd["params"]["resnet"]["conv_map"]["conv"]["kernel"]
    assert adam["0"]["mu"]["resnet"]["conv_map"]["conv"]["kernel"].shape == kernel.shape


def test_jax_checkpoint_restores_into_the_port_and_continues_its_trajectory(jax_run):
    """Two JAX steps, their checkpoint restored into the port (parameters,
    statistics, Adam slots, step), then the third step on both sides with
    JAX's noise injected into the port."""
    task = _port_task()
    trainer = Trainer(task)
    state = trainer.restore(jax_run["two_path"], trainer.init_state())
    two = jax_run["two"]
    assert state.step == 2 and ckpt.slot_count(state) == 2
    got_p, got_s = bridge.to_flax(task)
    want_two = dict(_leaves(two.params))
    for key, value in _leaves(got_p):
        np.testing.assert_array_equal(value, want_two[key], err_msg=key)
    mu = dict(_leaves(two.opt_state.inner_states["train"].inner_state[0].mu))
    for tensor, coll, path, fn in bridge.targets(task):
        if coll == "params" and tensor.requires_grad:
            slot = state.optimizer.state[tensor]
            m = bridge._INVERSE[fn](slot["m"].numpy())
            np.testing.assert_array_equal(m, mu["/".join(path)], err_msg="/".join(path))
            assert slot["step"] == 2

    state, metrics = trainer.train_step(state, jax_run["raw"], eps=jax_run["eps"])
    np.testing.assert_allclose(float(metrics["loss"]), jax_run["loss"], rtol=1e-5)
    three = jax_run["three"]
    before, want = dict(_leaves(two.params)), dict(_leaves(three.params))
    labels = task.param_labels()
    name_of = {id(t): n for n, t in task.named_parameters()}
    paths = {"/".join(path): name_of.get(id(t)) for t, _, path, _ in bridge.targets(task)}
    got_p, _ = bridge.to_flax(task)
    for key, value in _leaves(got_p):
        if labels[paths[key]] == "frozen":
            np.testing.assert_array_equal(value, before[key], err_msg=key)
            continue
        d_port, d_jax = value - before[key], want[key] - before[key]
        gap = np.abs(d_port - d_jax)
        assert gap.max() <= 2 * LR, (key, float(gap.max() / LR))
        assert np.quantile(gap, 0.99) <= LR / 4, (key, float(np.quantile(gap, 0.99) / LR))
        assert np.linalg.norm(gap) <= 0.1 * np.linalg.norm(d_jax), key
    adam3 = three.opt_state.inner_states["train"].inner_state[0]
    got3 = ckpt.state_dict(state)["opt_state"]["inner_states"]["train"]["inner_state"]["0"]
    assert int(got3["count"]) == int(adam3.count) == 3
    worst = 0.0
    for slot in ("mu", "nu"):
        want3 = dict(_leaves(getattr(adam3, slot)))
        for key, value in _leaves(got3[slot]):
            if isinstance(value, np.ndarray):
                ref = np.asarray(want3[key])
                worst = max(worst, np.linalg.norm(value - ref) / np.linalg.norm(ref))
                assert np.linalg.norm(value - ref) <= 1e-2 * np.linalg.norm(ref), (slot, key)
    print("moments, largest relative L2 gap", worst)


def test_port_checkpoint_restores_in_jax(jax_run, tmp_path):
    """A state the port trained, saved by the port, restored by the JAX
    package into its own template: every leaf equal, and JAX writes the
    same bytes back."""
    sd = ckpt.read_state_dict(jax_run["init_path"])
    task = _port_task()
    bridge.load_flax(task, sd["params"], sd["batch_stats"])
    trainer = Trainer(task)
    state = trainer.init_state()
    state, _ = trainer.train_step(state, _raw(7), eps=np.zeros((2, 150), np.float32))
    path = ckpt.save_checkpoint(str(tmp_path), 0, state)
    template = jax.device_get(jax_run["trainer"].init_state(_jax_batch(_raw(100))))
    restored = jckpt.restore_checkpoint(path, template)
    with open(path, "rb") as f:
        assert fs.to_bytes(jax.device_get(restored)) == f.read()
    assert int(restored.step) == 1
    assert int(restored.opt_state.inner_states["train"].inner_state[0].count) == 1
    want = ckpt.state_dict(state)
    ref = dict(_leaves(want))
    got = dict(_leaves(fs.to_state_dict(restored)))
    assert got.keys() == ref.keys()
    for key, value in got.items():
        if isinstance(ref[key], dict):  # a frozen leaf's empty slot
            assert value == {} and ref[key] == {}, key
        else:
            np.testing.assert_array_equal(np.asarray(value), ref[key], err_msg=key)
    params = jckpt.restore_params(path, template.params)
    np.testing.assert_array_equal(params["generator"]["conv_dec"]["kernel"],
                                  want["params"]["generator"]["conv_dec"]["kernel"])


def test_async_checkpointer_writes_the_snapshot_taken_at_save(tmp_path):
    task = _port_task().init_params(0)
    trainer = Trainer(task)
    state, _ = trainer.train_step(trainer.init_state(), _raw(3), eps=np.zeros((2, 150), np.float32))
    sync = ckpt.save_checkpoint(str(tmp_path / "sync"), 1, state)
    saver = ckpt.AsyncCheckpointer()
    path = saver.save(str(tmp_path / "async"), 1, state)
    with torch.no_grad():  # the next step's in-place update, before the write is durable
        for p in task.parameters():
            p.add_(1.0)
        for slot in state.optimizer.state.values():
            slot["m"].add_(1.0)
    saver.close()
    with open(sync, "rb") as f, open(path, "rb") as g:
        assert f.read() == g.read()
    assert not os.path.exists(path + ".tmp")


def test_torn_state_is_refused(tmp_path):
    task = _port_task().init_params(0)
    trainer = Trainer(task)
    state, _ = trainer.train_step(trainer.init_state(), _raw(3), eps=np.zeros((2, 150), np.float32))
    first = next(p for p in task.parameters() if p.requires_grad)
    state.optimizer.state[first]["step"] += 1  # one tensor updated past the state's step
    with pytest.raises(ckpt.TornStateError, match="part-updated"):
        ckpt.save_checkpoint(str(tmp_path), 1, state)
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------- warm starts


def test_warm_starts(tmp_path):
    a, b = (ckpt.save_checkpoint(str(tmp_path), f"seed{seed}", Trainer(_port_task().init_params(seed)).init_state())
            for seed in (1, 2))
    pa, sa = bridge.to_flax(ckpt.restore_checkpoint(a, Trainer(_port_task()).init_state()).task)
    pb, sb = bridge.to_flax(ckpt.restore_checkpoint(b, Trainer(_port_task()).init_state()).task)

    def same(tree, ref):
        return all(np.array_equal(v, dict(_leaves(ref))[k]) for k, v in _leaves(tree))

    # the generator from a, the ResNet (and its statistics) from b
    task = _port_task().init_params(3)
    trainer = Trainer(task)
    state = trainer.init_state()
    cfg = pconfig.ExperimentConfig(run=pconfig.RunConfig(acoustic_init_checkpoint=a, visual_init_checkpoint=b))
    warmstart.apply_init_checkpoints(state, cfg)
    p, s = bridge.to_flax(task)
    assert same(p["generator"], pa["generator"]) and same(p["resnet"], pb["resnet"])
    assert same(s["resnet"], sb["resnet"])
    assert state.step == 0 and not state.optimizer.state

    # init_checkpoint: parameters and statistics; the slots and the step stay
    state, _ = trainer.train_step(state, _raw(4), eps=np.zeros((2, 150), np.float32))
    slots = {id(k): v["m"].clone() for k, v in state.optimizer.state.items()}
    warmstart.apply_init_checkpoints(state, pconfig.ExperimentConfig(run=pconfig.RunConfig(init_checkpoint=a)))
    p, s = bridge.to_flax(task)
    assert same(p, pa) and same(s, sa) and state.step == 1
    assert all(torch.equal(v["m"], slots[id(k)]) for k, v in state.optimizer.state.items())

    ckpt.restore_params(b, task)
    assert same(bridge.to_flax(task)[0], pb) and same(bridge.to_flax(task)[1], sa)

    # a TF1 checkpoint (an .index sibling) of a's trunk and statistics:
    # imported under resnet_v1_50, its conv_map (a head the ImageNet start
    # skips) left as it was; init_checkpoint takes the JAX format only
    tf1 = export_state({"resnet": pa["resnet"]}, {"resnet": sa["resnet"]}, str(tmp_path / "model.ckpt-100"))
    warmstart.overlay_model(state, "resnet", tf1)
    p, s = bridge.to_flax(task)
    trunk = lambda tree: {k: v for k, v in tree.items() if k != "conv_map"}
    assert same(trunk(p["resnet"]), trunk(pa["resnet"])) and same(s["resnet"], sa["resnet"])
    assert same(p["resnet"]["conv_map"], pb["resnet"]["conv_map"]) and same(p["generator"], pb["generator"])
    with pytest.raises(ValueError, match="TF1"):
        warmstart.restore_params_only(state, tf1)
