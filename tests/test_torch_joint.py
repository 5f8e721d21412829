"""The port's joint-MVAE task against the JAX package, in f32 on the CPU, at
full width on 2 seconds of synthetic clips: ``JointMVAE`` (3 and 2 inputs);
``JointTask.loss`` and its metrics in the default, ``fusion``,
``onlyaudiovideo`` and ``moddrop`` modes (the acoustic map dropped, and
kept), with JAX's stage-2 noise and moddrop draw handed in; one
``onlyaudiovideo`` train step (``associator1`` moved as JAX's, the VAEs and
the other associator bit-frozen) and its checkpoint both ways; ``eval_losses``, ``evaluate`` over a padded batch and
``embeddings``; the parameter labels.

Tolerances, and why (those of ``test_torch_embed.py``): the same f32
arithmetic summed in another order. ``JointMVAE`` within 1e-5 of each
output's largest entry; loss terms within 1e-4 relative (the frozen VAEs
run eval-mode BN); the eval losses within 1e-4 relative; the latents within
1e-5 of the largest. The train step as ``task_parity.check_step`` states
it (no train-mode BN here, so every trained leaf to every bound).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.models.associators import JointMVAE as JaxJointMVAE
from acoustic_image_generation_tpu.train.joint import JointTask as JaxJoint
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.models.associators import JointMVAE
from acoustic_image_generation_tpu_torch.train.joint import JointConfig, JointTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, eval_generator
from task_parity import (
    PaddedLoader,
    check_checkpoints_cross,
    check_step,
    jax_batch,
    jax_cfg,
    jax_step,
    raw_clips,
    rel,
    with_normals,
)
from test_torch_embed_models import perturb
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import tmp_path  # noqa: F401

MODES = {"default": {}, "fusion": dict(fusion=True), "onlyaudiovideo": dict(onlyaudiovideo=True),
         "moddrop": dict(moddrop=True)}
NOISE = ("acoustic", "video", "audio")  # JAX's stage-2 draws, in its order


def jax_task(mode):
    return JaxJoint(jax_cfg(embedding=True, jointmvae=True, **MODES[mode]))


@functools.cache
def jax_init():
    """JAX's initial trees of the ``onlyaudiovideo`` mode (both associators)
    and the fusion mode's 2-input associator, biases and BN parameters and
    statistics drawn away from their initial values."""
    params, stats = jax.jit(jax_task("onlyaudiovideo").init_variables)(jax.random.key(0),
                                                                      jax_batch(raw_clips(0, 1)))
    maps = [jnp.zeros((1, 12, 16, c)) for c in (512, 128)]
    fused2 = jax.jit(lambda: JaxJointMVAE().init(jax.random.key(2), *maps))()["params"]
    params = dict(params, fusion_associator=fused2)
    return perturb(jax.device_get(params), np.random.default_rng(1)), \
        perturb(jax.device_get(stats), np.random.default_rng(2))


def trees(mode):
    params, stats = jax_init()
    params = {k: v for k, v in params.items() if k in ("acoustic", "video", "audio", "associator")}
    if mode == "fusion":
        params["associator"] = jax_init()[0]["fusion_associator"]
    if mode == "onlyaudiovideo":
        params["associator1"] = jax_init()[0]["associator1"]
    return params, stats


def port_task(mode):
    task = JointTask(JointConfig(compute_dtype="float32", **MODES[mode]), device="cpu")
    bridge.load_flax(task, *trees(mode))
    return task


cached_task = functools.cache(port_task)


@pytest.fixture(scope="module", autouse=True)
def _free_trees():
    yield
    jax_init.cache_clear()
    cached_task.cache_clear()


@pytest.mark.parametrize("heads", [("ac", "video", "audio"), ("ac",)], ids=["three_heads", "ac_head"])
def test_joint_mvae_matches_flax(heads):
    rng = np.random.default_rng(3)
    chans = (133, 512, 128) if len(heads) == 3 else (512, 128)
    maps = [np.maximum(rng.standard_normal((2, 12, 16, c)), 0).astype(np.float32) for c in chans]
    jm = JaxJointMVAE(heads=heads)
    params = perturb(jax.jit(jm.init)(jax.random.key(0), *maps)["params"], rng)
    port = JointMVAE(sum(chans), heads)
    bridge.load_flax(port, params, {})
    want = jax.jit(lambda p, *m: jm.apply({"params": p}, *m))(params, *maps)
    with torch.no_grad():
        got = port(*(torch.from_numpy(m) for m in maps))
    assert set(got) == set(want) == set(heads)
    for h in heads:
        assert got[h].dtype == torch.float32 and rel(got[h].numpy(), want[h]) <= 1e-5, h


def _moddrop_key(keep: bool):
    """A key whose moddrop draw keeps (or drops) the acoustic map."""
    for i in range(100):
        key = jax.random.key(i)
        if bool(jax.random.uniform(key, (1,))[0] < 0.2) == keep:
            return key
    raise AssertionError("no such key")


@pytest.mark.parametrize("mode,keep", [("default", None), ("fusion", None), ("onlyaudiovideo", None),
                                       ("moddrop", False), ("moddrop", True)])
def test_loss_matches_jax(mode, keep):
    raw = raw_clips(1)
    key = jax.random.key(7) if keep is None else _moddrop_key(keep)
    params, stats = trees(mode)
    jt = jax_task(mode)
    (total, metrics, new_stats), draws = with_normals(
        lambda p, s, b: jt.loss(p, s, b, {"latent": key, "moddrop": key}, train=True))(params, stats, jax_batch(raw))
    eps = {k: torch.from_numpy(np.array(d)) for k, d in zip(NOISE, draws)}
    task = cached_task(mode)
    with torch.no_grad():
        got_total, got = task.loss(Trainer(task)._prepare(raw), train=True, eps=eps,
                                   moddrop=None if keep is None else float(keep))
    assert set(got) == set(metrics), (set(got), set(metrics))
    assert len(draws) == (1 if mode == "onlyaudiovideo" else 3)
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(total), rtol=1e-4)
    for path, value in jax.tree_util.tree_leaves_with_path(bridge.to_flax(task)[1]):  # eval-mode BN only
        np.testing.assert_array_equal(value, dict(jax.tree_util.tree_leaves_with_path(stats))[path])


def test_param_labels_match_jax():
    for mode in ("default", "onlyaudiovideo"):
        task = cached_task(mode)
        labels = task.param_labels()
        want = jax_task(mode).param_labels(trees(mode)[0])
        name_of = {id(p): n for n, p in task.named_parameters()}
        for tensor, coll, path, _ in bridge.targets(task):
            if coll == "params":
                assert labels[name_of[id(tensor)]] == want[path[0]], path
                assert tensor.requires_grad == (want[path[0]] == "train"), path
        assert [k for k, v in want.items() if v == "train"] == [task.trained]


def test_train_step_matches_jax_and_checkpoints_cross(tmp_path):
    """One ``onlyaudiovideo`` step: ``associator1`` moves as JAX's; the VAEs
    and the 3-input associator that gives its target stay bit-frozen."""
    raw = raw_clips(2)
    params, stats = trees("onlyaudiovideo")
    key = jax.random.key(11)
    (jstate, loss, _), draws = jax_step(jax_task("onlyaudiovideo"), params, stats, jax_batch(raw),
                                        {"latent": key, "moddrop": key})
    task = port_task("onlyaudiovideo")
    trainer = Trainer(task)
    state, got = trainer.train_step(trainer.init_state(), raw, eps=dict(zip(NOISE, draws)))
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-4)
    trained, frozen = check_step(task, params, jstate.params)
    assert trained == 8 and frozen > 100  # associator1's dense_0-2 and out_ac, kernel and bias
    check_checkpoints_cross(trainer, state, jstate, tmp_path)


def test_eval_losses_evaluate_and_embeddings_match_jax():
    raw = raw_clips(3)
    params, stats = trees("default")
    jt, task = jax_task("default"), cached_task("default")
    key = jax.random.key(13)
    (want, _), draws = with_normals(lambda p, s, b: jt.eval_losses(p, s, b, {"latent": key}))(
        params, stats, jax_batch(raw))
    trainer = Trainer(task)
    batch = trainer._prepare(raw)
    with torch.no_grad():
        got, recon = task.eval_losses(batch, eps={"acoustic": torch.from_numpy(np.array(draws[0]))})
    assert got["mse"].shape == (2,) and recon.shape == (2, 36, 48, 12)
    np.testing.assert_allclose(got["mse"].numpy(), np.asarray(want["mse"]), rtol=1e-4)
    state = trainer.init_state()
    with torch.no_grad():
        one, _ = task.eval_losses(batch, generator=eval_generator(0, 0, "cpu"))
    assert trainer.evaluate(state, PaddedLoader(raw)) == {"mse": pytest.approx(float(one["mse"][0]), rel=1e-6)}
    eps = {m: np.array(jax.random.normal(jax.random.fold_in(key, i), (2, d)))
           for i, (m, d) in enumerate((("acoustic", 150), ("audio", 256), ("video", 1024)))}
    for use_mean in (True, False):
        want = jax.jit(lambda p, s, b: jt.embeddings(p, s, b, key, use_mean=use_mean))(params, stats, jax_batch(raw))
        with torch.no_grad():
            got = task.embeddings(batch, use_mean=use_mean,
                                  eps=None if use_mean else {k: torch.from_numpy(v) for k, v in eps.items()})
        assert set(got) == set(want) == {"acoustic", "acoustic_true", "audio", "video"}
        for k, v in got.items():
            assert v.dtype == torch.float32 and rel(v.numpy(), want[k]) <= 1e-5, (k, use_mean)
