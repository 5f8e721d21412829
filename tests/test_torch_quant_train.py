"""The int8 frozen trunk through the port's entry points against the JAX
package, in f32 on the CPU: two train steps, ``generate`` and the eval's
masked loss sums, from the same init, the same quantized trunk carried
across (``bridge.load_qtrunk``) and the same injected noise. One unit per
block; the generator at full width; ``fused_qgemm`` off on both sides (the
trunk's fused path is held against JAX's in ``tests/test_torch_quant.py``).

JAX's side runs its ``trunk_features(qtrunk)`` eagerly and its jitted step
on those features, the head-only path its ``_forward(qtrunk=...)`` takes;
the port's features then equal JAX's (``tests/test_torch_quant.py``).

Tolerances, and why:

- losses: 1e-4 relative (f32 summation order).
- trained-leaf updates: the limits of ``test_three_step_trajectory_matches_jax``
  (``tests/test_torch_train.py``): every entry within 2 lr, 99% within
  lr/4, each leaf within 10% in L2 norm; the trunk bit-frozen and its BN
  statistics unchanged on both sides, ``conv_map``'s moved.
- ``generate``: 1e-4 absolute on the sigmoid output, as the f32 serving
  test (``tests/test_torch_serving.py``).
- the calibration the trainer runs itself, against JAX's ``build_qtrunk``
  (whose calibration pass is jitted, with its epilogues fused into FMAs):
  amaxes within 1e-2 relative (read: 2.2e-3), int8 weights within 1. The
  port's ``calibrate`` equals JAX's collect pass run eagerly
  (``tests/test_torch_quant.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from acoustic_image_generation_tpu.core.config import ExperimentConfig, ModelConfig, ParallelConfig
from acoustic_image_generation_tpu.data.preprocess import preprocess_batch as jax_preprocess
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxTask
from acoustic_image_generation_tpu.train.optim import adam_tf1
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.models.quant import QuantTrunk
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from torch_threads import few_torch_threads  # noqa: F401

UNITS = (1, 1, 1, 1)
STEPS = 2
LR = 1e-4


def _raw(seed, clips=1, frames=2):
    rng = np.random.default_rng(seed)
    f = (clips, frames)
    return dict(
        acoustic=rng.random((*f, 36, 48, 12)).astype(np.float32),
        audio=rng.integers(-(2**15), 2**15, (*f, 1024)).astype(np.int32),
        video=rng.integers(0, 256, (*f, 224, 298, 3)).astype(np.uint8),
    )


def _jax_batch(raw):
    flat = {k: jnp.asarray(v.reshape(-1, *v.shape[2:])) for k, v in raw.items()}
    zeros = jnp.zeros((flat["video"].shape[0],), jnp.int32)
    return jax_preprocess(flat["acoustic"], flat["audio"], flat["video"], zeros, zeros, compute_filtered=False)


def _randomize_trunk_stats(stats, rng):
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out[k] = _randomize_trunk_stats(v, rng) if k != "conv_map" else v
        elif k == "mean":
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


def _config():
    return GenerationConfig(resnet_units=UNITS, compute_dtype="float32", trunk_bn="frozen", trunk_quant="int8")


@functools.cache
def _jax_run():
    """JAX: init (trunk BN statistics drawn away from (0, 1)), the int8 trunk
    built and calibrated on the first batch, STEPS train steps, then the
    eval losses and ``generate`` on a 2-clip batch with the trained state."""
    task = JaxTask(ExperimentConfig(
        model=ModelConfig(resnet_units=UNITS, trunk_bn="frozen", trunk_quant="int8"),
        parallel=ParallelConfig(compute_dtype="float32"),
    ))
    tx = optax.multi_transform({"train": adam_tf1(LR), "frozen": optax.set_to_zero()}, task.param_labels)
    params, stats = jax.device_get(jax.jit(task.init_variables)(jax.random.key(0), _jax_batch(_raw(100))))
    stats = {"resnet": _randomize_trunk_stats(stats["resnet"], np.random.default_rng(3))}
    init = (params, stats)
    qt = jax.device_get(task.build_qtrunk(params, stats, _jax_batch(_raw(100)).video))

    def features(batch):
        # eagerly, one XLA op at a time, as tests/test_quant.py runs the int8
        # trunk: under jit XLA fuses the dequant into FMAs, which moves 1.8%
        # of the features by a quantum or two
        return task.trunk_features(params, stats, batch.video, qt)

    @jax.jit
    def step(params, stats, opt, batch, key, feat):
        rngs = {"latent": key}
        out, _ = task._forward(params, stats, batch, rngs, train=True, trunk_feat=feat)

        def loss_fn(p):
            total, _, new_stats = task.loss(p, stats, batch, rngs, train=True, trunk_feat=feat)
            return total, new_stats

        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), new_stats, opt, loss, (out.z - out.mean) / out.std

    opt = tx.init(params)
    losses, eps = [], []
    for s in range(STEPS):
        batch = _jax_batch(_raw(100 + s))
        params, stats, opt, loss, e = step(params, stats, opt, batch, jax.random.key(10 + s), features(batch))
        losses.append(float(loss))
        eps.append(np.asarray(e))

    @jax.jit
    def evaluate(params, stats, batch, key, feat):
        rngs = {"latent": key}
        out, _ = task._forward(params, stats, batch, rngs, train=False, trunk_feat=feat)
        losses, _ = task.eval_losses(params, stats, batch, rngs, trunk_feat=feat)
        return losses, out.output.astype(jnp.float32), (out.z - out.mean) / out.std

    batch = _jax_batch(_raw(200, clips=2, frames=1))
    ev = jax.device_get(evaluate(params, stats, batch, jax.random.key(20), features(batch)))
    return init, qt, losses, eps, jax.device_get((params, stats)), ev


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@functools.cache
def _port_run():
    init, qt_tree, _, jax_eps, _, ev = _jax_run()
    task = GenerationTask(_config(), device="cpu")
    bridge.load_flax(task, *init)
    trainer = Trainer(task)
    trainer.qtrunk = bridge.load_qtrunk(QuantTrunk(task.resnet.blocks), qt_tree)
    state = trainer.init_state()
    losses = []
    for s in range(STEPS):
        state, metrics = trainer.train_step(state, _raw(100 + s), eps=jax_eps[s])
        losses.append(float(metrics["loss"]))
    return trainer, state, losses


def test_int8_train_steps_match_jax():
    init, _, jax_losses, _, (jax_params, jax_stats), _ = _jax_run()
    trainer, state, losses = _port_run()
    assert state.step == STEPS
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)

    task = trainer.task
    got_p, got_s = bridge.to_flax(task)
    labels = task.param_labels()
    name_of = {id(t): n for n, t in task.named_parameters()}
    paths = {"/".join(path): name_of.get(id(t)) for t, _, path, _ in bridge.targets(task)}
    init_p, want_p = dict(_leaves(init[0])), dict(_leaves(jax_params))
    for path, value in _leaves(got_p):
        key = "/".join(path)
        if labels[paths[key]] == "frozen":
            np.testing.assert_array_equal(value, init_p[path], err_msg=key)
            np.testing.assert_array_equal(want_p[path], init_p[path], err_msg=key)
            continue
        d_port, d_jax = value - init_p[path], want_p[path] - init_p[path]
        gap = np.abs(d_port - d_jax)
        assert gap.max() <= 2 * LR, (key, float(gap.max() / LR))
        assert np.quantile(gap, 0.99) <= LR / 4, (key, float(np.quantile(gap, 0.99) / LR))
        assert np.linalg.norm(gap) <= 0.1 * np.linalg.norm(d_jax), key
        assert np.abs(d_port).max() > 0.5 * LR, key
    init_s, want_s = dict(_leaves(init[1])), dict(_leaves(jax_stats))
    for path, value in _leaves(got_s):
        if "conv_map" in path:  # the head's train-mode BN moved, on both sides alike
            moved = np.abs(want_s[path] - init_s[path]).max()
            assert moved > 0 and np.abs(value - want_s[path]).max() <= 1e-3 * moved, path
        else:  # the frozen trunk's statistics did not move
            np.testing.assert_array_equal(value, init_s[path], err_msg="/".join(path))
            np.testing.assert_array_equal(want_s[path], init_s[path], err_msg="/".join(path))


def test_int8_generate_and_eval_losses_match_jax():
    *_, (jax_losses, jax_gen, eps) = _jax_run()
    trainer, state, _ = _port_run()
    raw = _raw(200, clips=2, frames=1)
    sums, count = trainer.eval_step(state, raw, eps=eps)
    assert float(count) == 2
    for k, v in jax_losses.items():
        np.testing.assert_allclose(float(sums[k]), float(np.sum(v)), rtol=1e-4, err_msg=k)
    # a padded remainder batch: only the first clip's frames count
    sums, count = trainer.eval_step(state, dict(raw, valid=1), eps=eps)
    assert float(count) == 1
    np.testing.assert_allclose(float(sums["mse"]), float(jax_losses["mse"][0]), rtol=1e-4)

    batch = trainer._prepare(raw)
    with torch.no_grad():
        gen = trainer.task.generate(batch.mfcc, batch.video, eps=torch.from_numpy(eps.copy()), qtrunk=trainer.qtrunk)
    np.testing.assert_allclose(gen.numpy(), jax_gen, rtol=0, atol=1e-4)


def test_trainer_calibrates_the_int8_trunk_once_from_the_first_batch():
    init, qt_tree, *_ = _jax_run()
    task = GenerationTask(_config(), device="cpu")
    bridge.load_flax(task, *init)
    trainer = Trainer(task)
    state = trainer.init_state()
    eps = np.zeros((2, 150), np.float32)
    trainer.train_step(state, _raw(100), eps=eps)
    qt = trainer.qtrunk
    got = dict(_leaves(bridge.qtrunk_to_tree(qt)))
    for k, want in _leaves(qt_tree):
        if k[-1] == "w":
            assert np.abs(got[k].astype(np.int32) - want.astype(np.int32)).max() <= 1, k
        elif k[0] == "act":
            np.testing.assert_allclose(got[k], want, rtol=1e-2, err_msg="/".join(k))
    before = qt.act.clone()
    trainer.train_step(state, _raw(101), eps=eps)
    assert trainer.qtrunk is qt and torch.equal(qt.act, before)
