"""The port's embedding train step against the JAX package, in f32 on the
CPU: a 2-step trajectory of ``Trainer.train_step`` on an ``EmbedTask`` (full
width, 3 seconds a step, the default batch-hard triplet variant) against
JAX's ``EmbedTask.loss`` + ``value_and_grad`` + TF1 Adam (the JAX
Trainer's optimizer for a task without parameter labels), with JAX's noise
handed in. The audio is of low amplitude (|x| <= 4), so that the audio
VAE's MSE against its raw-magnitude target stays well conditioned.

Tolerances, and why. The loss terms within 1e-4 relative (the
reconstruction terms pass through the decoders' train-mode BNs, see
``test_torch_embed_models.py``), except the KL term after the first step:
it is small and much of it is what the first step added, so it carries
the update gaps below (read 1e-3 relative); held to 1e-2.

The first step's gradients in L2 relative to the jitted JAX step's, a
loose second check (``test_torch_embed_grads.py`` holds them tightly
against JAX run eagerly): the acoustic VAE (no BN) leaf by leaf within
1e-4 (read 8.5e-6). The audio and video VAEs' train-mode BNs divide by
fast-variance batch statistics, which magnify rounding: JAX eager against
JAX jitted reads up to 3.0e-2 on a leaf (audio) and 7.2e-3 (video), and
two compilations of JAX's step differed by up to 1.7e-1 on the audio VAE's
first conv kernel. So each of their leaves within 0.5, and all of each
VAE's leaves together within 5e-2. The biases of the convs that a
train-mode BN follows are left out: BN removes any per-channel constant,
so their true gradient is zero, both sides hold rounding noise, and Adam
may move them or not.

The updates (new - initial): Adam normalizes every entry's step by its own
gradient history, so an entry whose gradient is at noise level takes a
full +-lr step in either framework with the sign the noise gives it. Every
entry within 2 lr a step. The acoustic VAE's leaves also: 99% of the
entries within lr/4 and the update within 10% in L2 norm. The BN running
averages within 1e-3 relative, and they moved.
"""

import functools
import re

import jax
import numpy as np
import optax
import torch

from acoustic_image_generation_tpu.train.embed import EmbedTask as JaxEmbed
from acoustic_image_generation_tpu.train.optim import adam_tf1
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from test_torch_embed import draws, jax_batch, jax_cfg, jax_init, port_task, raw_clips
from torch_threads import few_torch_threads  # noqa: F401

STEPS = 2
LR = 1e-4
AMP = 4


@functools.cache
def jax_trajectory():
    jt = JaxEmbed(jax_cfg(lr=LR))
    tx = adam_tf1(LR)

    @jax.jit
    def step(params, stats, opt, batch, key):
        def loss_fn(p):
            total, metrics, new_stats = jt.loss(p, stats, batch, {"latent": key, "moddrop": key}, train=True)
            return total, (metrics, new_stats)

        (loss, (metrics, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), new_stats, opt, metrics, grads

    params, stats = jax_init()
    opt = tx.init(params)
    metrics = []
    for s in range(STEPS):
        params, stats, opt, m, grads = step(params, stats, opt, jax_batch(raw_clips(10 + s, amplitude=AMP)),
                                            jax.random.key(20 + s))
        metrics.append(jax.device_get(m))
        if s == 0:
            first_grads = _leaves(jax.device_get(grads))
    return metrics, first_grads, jax.device_get((params, stats))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _bn_cancelled(key: str) -> bool:
    """A conv bias that a train-mode BN follows (true gradient zero)."""
    return bool(re.search(r"\['(audio|video)'\]\['layer\d+'\]\['(conv|pool)_\d'\]\['bias'\]", key))


def _port_grads(task) -> dict:
    """The port's gradients in the flax layout, keyed as ``_leaves``."""
    out = {}
    for tensor, coll, path, fn in bridge.targets(task):
        if coll == "params":
            key = jax.tree_util.keystr(tuple(jax.tree_util.DictKey(p) for p in path))
            out[key] = np.array(bridge._INVERSE[fn](tensor.grad.numpy()))
    return out


def _check_first_grads(grads: dict, want: dict) -> None:
    assert grads.keys() == want.keys()
    gaps = {"audio": [], "video": []}
    for key, g in grads.items():
        if _bn_cancelled(key):
            continue
        gap = np.linalg.norm(g - want[key]) / np.linalg.norm(want[key])
        model = key.split("'")[1]
        assert gap <= (1e-4 if model == "acoustic" else 0.5), (key, float(gap))
        if model != "acoustic":
            gaps[model].append((np.sum((g - want[key]) ** 2), np.sum(want[key] ** 2)))
    for model, pairs in gaps.items():
        total = np.sqrt(sum(p[0] for p in pairs) / sum(p[1] for p in pairs))
        assert total <= 0.05, (model, float(total))


def test_two_step_trajectory_matches_jax():
    jax_metrics, jax_grads, (jax_params, jax_stats) = jax_trajectory()
    task = port_task(lr=LR)
    trainer = Trainer(task)
    state = trainer.init_state()
    assert len(state.optimizer.param_groups[0]["params"]) == len(list(task.parameters()))
    for s in range(STEPS):
        eps, _ = draws(jax.random.key(20 + s))
        state, metrics = trainer.train_step(state, raw_clips(10 + s, amplitude=AMP), eps=eps)
        assert set(metrics) == set(jax_metrics[s])
        for name, value in metrics.items():
            rtol = 1e-2 if s and name == "latent_loss" else 1e-4
            np.testing.assert_allclose(float(value), float(jax_metrics[s][name]), rtol=rtol,
                                       err_msg=f"step {s} {name}")
        if s == 0:
            _check_first_grads(_port_grads(task), jax_grads)
    assert state.step == STEPS

    got_p, got_s = (_leaves(t) for t in bridge.to_flax(task))
    init_p, init_s = (_leaves(t) for t in jax_init())
    want_p, want_s = _leaves(jax_params), _leaves(jax_stats)
    assert got_p.keys() == want_p.keys() and got_s.keys() == want_s.keys()
    for key, value in got_p.items():
        d_port = value - init_p[key]
        d_jax = want_p[key] - init_p[key]
        gap = np.abs(d_port - d_jax)
        assert gap.max() <= 2 * STEPS * LR, (key, float(gap.max() / LR))
        if not _bn_cancelled(key):  # every other parameter of the three VAEs moved
            assert np.abs(d_jax).max() > 0.5 * LR and np.abs(d_port).max() > 0.5 * LR, key
        if key.startswith("['acoustic']"):
            assert np.quantile(gap, 0.99) <= LR / 4, (key, float(np.quantile(gap, 0.99) / LR))
            assert np.linalg.norm(gap) <= 0.1 * np.linalg.norm(d_jax), key
    for key, value in got_s.items():
        np.testing.assert_allclose(value, want_s[key], rtol=1e-3, atol=1e-3, err_msg=key)
        assert not np.array_equal(value, init_s[key]), key  # the audio and video BNs moved


def test_train_step_draws_its_noise_from_the_step_generator():
    """Without injected noise the step draws eps and the moddrop flags from
    its ``(seed, step)`` generator: two trainers from the same weights and
    seed take the same step."""
    raw = raw_clips(30, 1)
    losses = []
    for _ in range(2):
        task = port_task("moddrop")
        trainer = Trainer(task)
        state, metrics = trainer.train_step(trainer.init_state(), raw)
        losses.append(float(metrics["loss"]))
        assert metrics["triplet"].dtype == torch.float32
    assert losses[0] == losses[1]
    # the eval step draws nothing: its sums are the eval forward's, every time
    sums, n = trainer.eval_step(state, raw)
    with torch.no_grad():
        want, _ = task.eval_losses(trainer._prepare(raw, train=False))
    assert float(n) == 1 and set(sums) == set(want)
    for k, v in want.items():
        assert float(sums[k]) == float(v.sum()) == float(trainer.eval_step(state, raw)[0][k]), k
