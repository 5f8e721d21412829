"""The port's ``optax.adam`` (``train/optim.py::Adam``), which its trainer
runs with ``optim.tf1_adam=False`` as JAX's does, against optax, in f32 on
the CPU.

- Three steps on a tree of random tensors, gradients spread over seven
  decades: the moments and the parameters equal to ``optax.adam``'s eager
  operations to the bit. Under ``jit`` XLA on the CPU contracts the moment
  updates and the parameter add into FMAs (as it does the int8 dequant,
  ``ROADMAP.md``), and computes ``b2^t`` with ``pow`` on the traced count,
  where eager JAX multiplies (``1 - 0.999^3`` then differs by 2e-5
  relative): the jitted parameters are held within 2 f32 ulps of each
  parameter plus 2e-5 of the step's update (read 1.05e-5).
- A checkpoint of the JAX trainer's optimizer for DualCamNet (no labels:
  ``optax.adam``'s chain state alone, ``{"0": {count, mu, nu}, "1": {}}``)
  after two steps, written by the JAX package, restores into the port's
  trainer; the port's next step with the same gradients and JAX's give the
  same file, byte for byte.
- The trainer picks the optimizer by ``optim.tf1_adam``, and a step with
  either trains.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from acoustic_image_generation_tpu.core import config as jconfig
from acoustic_image_generation_tpu.parallel import make_mesh
from acoustic_image_generation_tpu.train import checkpoint as jckpt
from acoustic_image_generation_tpu.train.classify import ClassificationTask as JaxClassify
from acoustic_image_generation_tpu.train.state import TrainState as JaxTrainState
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core import config as pconfig
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train.classify import ClassificationTask, ClassifyConfig
from acoustic_image_generation_tpu_torch.train.optim import Adam, TF1Adam
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import tmp_path  # noqa: F401

LR = 1e-3
SHAPES = {"a": (37, 129), "b": (3, 3, 12, 16), "c": ()}


def _grads(rng, shapes):
    return {k: np.asarray(rng.standard_normal(s) * 10.0 ** rng.uniform(-6, 1, s), np.float32) for k, s in shapes.items()}


def _optax_steps(tx, params, grads_list, opt=None):
    """``tx`` applied eagerly (every operation rounded on its own); the
    parameters and optimizer state after each step."""
    out = []
    with jax.disable_jit():
        opt = tx.init(params) if opt is None else opt
        for g in grads_list:
            updates, opt = tx.update(g, opt, params)
            params = jax.device_get(optax.apply_updates(params, updates))
            out.append((params, jax.device_get(opt)))
    return out


def test_adam_equals_eager_optax_to_the_bit():
    rng = np.random.default_rng(0)
    params = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in SHAPES.items()}
    grads = [_grads(rng, SHAPES) for _ in range(3)]
    want = _optax_steps(optax.adam(LR), params, grads)
    tensors = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = Adam(list(tensors.values()), LR)
    for step, (g, (want_p, want_opt)) in enumerate(zip(grads, want), start=1):
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
        adam = want_opt[0]
        assert int(adam.count) == step
        for k, t in tensors.items():
            slot = opt.state[t]
            assert slot["step"] == step
            np.testing.assert_array_equal(slot["m"].numpy(), adam.mu[k], err_msg=f"mu {k} step {step}")
            np.testing.assert_array_equal(slot["v"].numpy(), adam.nu[k], err_msg=f"nu {k} step {step}")
            np.testing.assert_array_equal(t.detach().numpy(), want_p[k], err_msg=f"param {k} step {step}")


def test_jitted_optax_within_two_ulps():
    rng = np.random.default_rng(1)
    params = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in SHAPES.items()}
    tx = optax.adam(LR)
    update = jax.jit(tx.update)
    opt_state, jp = tx.init(params), params
    tensors = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = Adam(list(tensors.values()), LR)
    for _ in range(3):
        g = _grads(rng, SHAPES)
        updates, opt_state = update(g, opt_state)
        jp = jax.device_get(optax.apply_updates(jp, updates))
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
        for k, t in tensors.items():
            bound = 2 * np.spacing(np.abs(jp[k])) + 2e-5 * np.abs(np.asarray(updates[k]))
            assert (np.abs(t.detach().numpy() - jp[k]) <= bound).all(), k


def _classify(tf1_adam: bool):
    task = ClassificationTask(ClassifyConfig(compute_dtype="float32", learning_rate=LR), device="cpu").init_params(0)
    config = pconfig.ExperimentConfig(optim=pconfig.OptimConfig(learning_rate=LR, tf1_adam=tf1_adam))
    return task, Trainer(task, config)


def test_jax_checkpoint_restores_and_the_next_step_equals_jax(tmp_path):
    task, trainer = _classify(tf1_adam=False)
    params, stats = bridge.to_flax(task)
    jcfg = jconfig.ExperimentConfig(optim=jconfig.OptimConfig(learning_rate=LR, tf1_adam=False),
                                    parallel=jconfig.ParallelConfig(compute_dtype="float32"))
    jtr = JaxTrainer(JaxClassify(jcfg), jcfg, mesh=make_mesh(1))
    rng = np.random.default_rng(2)
    shapes = {path: np.shape(v) for path, v in bridge._flatten(params).items()}

    def tree(flat):
        out = {}
        for path, v in flat.items():
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v
        return out

    grads = [tree(_grads(rng, shapes)) for _ in range(3)]
    (_, _), (p2, opt2) = _optax_steps(jtr.tx, params, grads[:2])
    jax_path = jckpt.save_checkpoint(str(tmp_path / "jax"), 2,
                                     JaxTrainState(step=np.int32(2), params=p2, batch_stats=stats, opt_state=opt2))
    (p3, opt3), = _optax_steps(jtr.tx, p2, grads[2:], opt=opt2)
    want = jckpt.save_checkpoint(str(tmp_path / "jax"), 3,
                                 JaxTrainState(step=np.int32(3), params=p3, batch_stats=stats, opt_state=opt3))

    state = trainer.restore(jax_path, trainer.init_state())
    assert isinstance(state.optimizer, Adam) and state.step == 2 and ckpt.slot_count(state) == 2
    again = ckpt.save_checkpoint(str(tmp_path / "port"), 2, state)
    with open(again, "rb") as f, open(jax_path, "rb") as g:
        assert f.read() == g.read()
    flat = bridge._flatten(grads[2])
    for tensor, coll, path, fn in bridge.targets(task):
        if coll == "params":
            tensor.grad = torch.from_numpy(np.array(fn(flat[path]), order="C"))
    state.optimizer.step()
    state.step += 1
    got = ckpt.save_checkpoint(str(tmp_path / "port"), 3, state)
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("tf1_adam", [True, False], ids=["tf1", "optax"])
def test_trainer_picks_the_optimizer_and_trains(tf1_adam):
    task, trainer = _classify(tf1_adam)
    state = trainer.init_state()
    assert type(state.optimizer) is (TF1Adam if tf1_adam else Adam)
    rng = np.random.default_rng(3)
    raw = dict(acoustic=rng.random((2, 12, 36, 48, 12), dtype=np.float32),
               audio=rng.integers(-2**15, 2**15, (2, 12, 1024)).astype(np.int32),
               video=np.zeros((2, 12, 1, 1, 3), np.uint8), action=np.array([0, 1], np.int32),
               location=np.zeros(2, np.int32))
    losses = [float(trainer.train_step(state, raw)[1]["loss"]) for _ in range(4)]
    assert state.step == 4 and ckpt.slot_count(state) == 4
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
