"""The port's classification tasks against the JAX package's, in f32 on the
CPU: each task's loss and gradients, the three correspondence
augmentations, a two-step TF1 Adam trajectory through each trainer, the
eval step's per-half, per-clip mask on a padded batch, and the
real-vs-generated accuracy. ResNet 1/1/1/1 for the generated task's frozen
trunk (the generator has no width option); 2 clips of 12 frames, 1 for the
generated task.

Tolerances, and why:

- losses 1e-5 relative and gradients 1e-4 of each leaf's largest entry,
  plus 2e-7 absolute: the same f32 arithmetic summed in another order, on
  the same batch (the JAX batch's arrays handed to the port); the logits'
  gradient (softmax - label) / clips holds terms up to 0.5 that cancel
  across the clips (to 7e-4 in the correspondence task's last bias, read
  7.5e-8 apart: about one f32 ulp of 0.5). 1e-3 for the generated task,
  whose DualCamNet sees the two generators' images, which differ by their
  own f32 rounding through trunk, VAE and decoder (read: 1.8e-4);
- the augmentations move and label rows only: equal to the bit, the
  shuffle with JAX's permutations handed in;
- the trajectories run each package's own preprocessing: the losses
  within 1e-5 relative, and each trained tensor held as
  ``test_torch_train.py`` holds its trajectory, over the two steps'
  updates: each entry within 2 lr, 99% within lr/4, the tensor within 10%
  in L2 norm (an entry whose gradient sits at rounding-noise level takes a
  full +-lr Adam step of either sign); the generated task's trunk and
  generator bit-frozen on both sides. The correspondence trajectory takes
  the zeroed-video variant, whose two halves hold the same acoustic
  images; on the silence map the first step's loss is held to 2e-3
  relative, because its fake half is the MFCC of low-passed audio, whose
  upper mel bands are f32 rounding noise: the two packages' silence maps
  differ by up to 1e-2 (``test_torch_mfcc.py``), enough to flip the sign of
  Adam's first steps on some entries;
- the eval sums 1e-5 relative, the counts exact; the accuracies of
  ``real_vs_generated_accuracy`` exact (JAX's noise handed in).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.core import config as jconfig
from acoustic_image_generation_tpu.core import rng as rng_mod
from acoustic_image_generation_tpu.data import preprocess as jpre
from acoustic_image_generation_tpu.parallel import make_mesh
from acoustic_image_generation_tpu.train import classify as jclassify
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.cli import main as pmain
from acoustic_image_generation_tpu_torch.core import config as pconfig
from acoustic_image_generation_tpu_torch.data import preprocess as ppre
from acoustic_image_generation_tpu_torch.train import classify
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from torch_threads import few_torch_threads  # noqa: F401

LR = 1e-4
CLIPS, FRAMES = 2, 12
STEPS = 2
TASKS = {
    "real": ({}, {"mfcc": True}),
    "mfccmap": ({}, {"mfcc": True, "mfccmap": True}),
    "correspondence": ({"correspondence": True}, {}),
    "generated": ({}, {}),
}
JAX_TASKS = {"real": jclassify.ClassificationTask, "mfccmap": jclassify.ClassificationTask,
             "correspondence": jclassify.CorrespondenceTask, "generated": jclassify.GeneratedClassificationTask}


def _clips(name):
    return 1 if name == "generated" else CLIPS


def _config(mod, name, **data_over):
    data, model = TASKS[name]
    return mod.ExperimentConfig(
        data=mod.DataConfig(batch_size=_clips(name), **{**data, **data_over}),
        model=mod.ModelConfig(model="DualCamNet", resnet_units=(1, 1, 1, 1), **model),
        optim=mod.OptimConfig(learning_rate=LR),
        parallel=mod.ParallelConfig(compute_dtype="float32"),
    )


def _raw(seed, clips=CLIPS, valid=None):
    """Raw clips as the loader gives them; ``valid`` < clips zero-fills the
    rest (a padded remainder batch)."""
    rng = np.random.default_rng(seed)
    raw = dict(
        acoustic=rng.random((clips, FRAMES, 36, 48, 12)).astype(np.float32),
        audio=rng.integers(-(2**15), 2**15, (clips, FRAMES, 1024)).astype(np.int32),
        video=rng.integers(0, 256, (clips, FRAMES, 224, 298, 3)).astype(np.uint8),
        action=rng.integers(0, 10, clips).astype(np.int32),
        location=rng.integers(0, 61, clips).astype(np.int32),
    )
    valid = clips if valid is None else valid
    for key in ("acoustic", "audio", "video", "action", "location"):
        raw[key][valid:] = 0
    raw["valid"] = valid
    return raw


def _jax_raw(raw):
    out = {k: jnp.asarray(v) for k, v in raw.items() if k != "valid"}
    out["valid"] = jnp.int32(raw["valid"])
    return out


def _jax_trainer(name, **data_over):
    cfg = _config(jconfig, name, **data_over)
    task = JAX_TASKS[name](cfg)
    trainer = JaxTrainer(task, cfg, mesh=make_mesh(1))
    state = trainer.init_state(types.SimpleNamespace(**_raw(100, _clips(name))))
    return task, trainer, state


def _port_task(name, params, stats, **data_over):
    task = pmain.select_task(_config(pconfig, name, **data_over), "cpu")
    bridge.load_flax(task, params, stats)
    return task


def _port_batch(jb):
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    return ppre.Batch(audio=t(jb.audio), mfcc=t(jb.mfcc), video=t(jb.video), acoustic=t(jb.acoustic),
                      action=t(jb.action), location=t(jb.location), filtered_mfcc=t(jb.filtered_mfcc),
                      correspondence=t(jb.correspondence))


@functools.cache
def _jax_eps_fn(generation):
    def eps(params, stats, batch, rngs):
        out, _ = generation._forward({"resnet": params["resnet"], "generator": params["generator"]},
                                     stats, batch, rngs, train=False)
        return (out.z - out.mean) / out.std

    return jax.jit(eps)


def _jax_eps(jtask, params, stats, batch, rngs):
    """The VAE noise JAX's generated task draws for ``batch``."""
    return np.array(_jax_eps_fn(jtask.generation)(params, stats, batch, rngs))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_config_maps_the_experiment():
    cfg = pconfig.classify_config(_config(pconfig, "correspondence", datatype="music", sample_length=2),
                                  generated=True)
    assert (cfg.num_classes, cfg.num_channels, cfg.sample_length) == (9, 13, 2)
    assert cfg.correspondence and cfg.datatype == "music" and cfg.compute_dtype == "float32"
    assert cfg.generation.resnet_units == (1, 1, 1, 1) and cfg.generation.datatype == "music"
    assert pconfig.classify_config(_config(pconfig, "real")).generation is None
    with pytest.raises(ValueError, match="correspondence"):
        classify.CorrespondenceTask(classify.ClassifyConfig(), device="cpu")
    with pytest.raises(ValueError, match="generation"):
        classify.GeneratedClassificationTask(classify.ClassifyConfig(), device="cpu")


@pytest.mark.parametrize("name", list(TASKS))
def test_loss_and_gradients_match_jax(name):
    jtask, jtr, jstate = _jax_trainer(name)
    params, stats = jax.device_get((jstate.params, jstate.batch_stats))
    rngs = rng_mod.train_step_rngs(jtr.base_key, 0)
    jbatch = jtr._prepare(_jax_raw(_raw(7, _clips(name))), key=rngs["data"])

    def loss_fn(p):
        loss, metrics, _ = jtask.loss(p, stats, jbatch, rngs, train=True)
        return loss, metrics

    (jloss, jmetrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    task = _port_task(name, params, stats)
    kw = {}
    if name == "generated":
        kw["eps"] = torch.from_numpy(_jax_eps(jtask, params, stats, jbatch, rngs))
    total, metrics = task.loss(_port_batch(jbatch), **kw)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jloss), rtol=1e-5)
    tol = 1e-3 if name == "generated" else 1e-4
    assert float(metrics["accuracy"]) == float(jmetrics["accuracy"])
    for tensor, coll, path, fn in bridge.targets(task):
        if coll != "params":
            continue
        if path[0] != "dualcamnet":  # the generated task's frozen models
            assert tensor.grad is None and not tensor.requires_grad
            continue
        want = fn(_get(grads, path))
        got = tensor.grad.numpy()
        assert np.abs(got - want).max() <= tol * np.abs(want).max() + 2e-7, "/".join(path)


def _batch_fields(seed, clips=4, frames=3):
    rng = np.random.default_rng(seed)
    n = clips * frames
    return dict(
        acoustic=rng.random((n, 36, 48, 12)).astype(np.float32),
        audio=rng.standard_normal((n, 1024)).astype(np.float32),
        mfcc=rng.random((n, 12)).astype(np.float32),
        video=rng.random((n, 4, 5, 3)).astype(np.float32),
        action=np.repeat(rng.integers(0, 2, clips), frames).astype(np.int32),
        location=np.repeat(rng.integers(0, 2, clips), frames).astype(np.int32),
        filtered_mfcc=rng.random((n, 12)).astype(np.float32),
    )


def _assert_same_batch(got, want):
    for field in jpre.Batch._fields:
        w = getattr(want, field)
        g = getattr(got, field)
        assert (g is None) == (w is None), field
        if w is not None:
            assert g.dtype == {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32}[w.dtype]
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)


@pytest.mark.parametrize("variant", ["silence_map", "no_video", "shuffle", "shuffle_eval_padded"])
def test_correspondence_augmentations_match_jax(variant):
    fields = _batch_fields(3)
    jb = jpre.Batch(**{k: jnp.asarray(v) for k, v in fields.items()})
    pb = ppre.Batch(**{k: torch.from_numpy(v) for k, v in fields.items()})
    if variant == "silence_map":
        _assert_same_batch(ppre.correspondence_augment(pb), jpre.correspondence_augment(jb))
        return
    if variant == "no_video":
        _assert_same_batch(ppre.correspondence_augment_no_video(pb), jpre.correspondence_augment_no_video(jb))
        return
    clips, frames = 4, 3
    train = variant == "shuffle"
    valid = None if train else 3
    key = jax.random.key(11)
    want = jpre.correspondence_shuffle(jb, key, frames=frames, final_shuffle=train, valid_clips=valid)
    # JAX's permutations, drawn as its correspondence_shuffle draws them
    k1, k2 = jax.random.split(key)
    if valid is None:
        clip_perm = jax.random.permutation(k1, clips)
    else:
        ranks = jnp.where(jnp.arange(clips) < valid, jax.random.uniform(k1, (clips,)),
                          2.0 + jnp.arange(clips, dtype=jnp.float32))
        clip_perm = jnp.argsort(ranks)
        assert int(clip_perm[-1]) == clips - 1  # the padded clip pairs with itself
    final = torch.from_numpy(np.array(jax.random.permutation(k2, 2 * clips))) if train else None
    got = ppre.correspondence_shuffle(pb, torch.from_numpy(np.array(clip_perm)), final, frames=frames)
    _assert_same_batch(got, want)
    # some shuffled pairs match (label 1), some do not
    assert 0 < float(got.correspondence[:, 1].sum()) < 2 * clips * frames


def test_shuffle_permutations_pair_real_clips_only():
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        clip_perm, final = ppre.shuffle_permutations(6, g, valid_clips=4, final_shuffle=False)
        assert final is None
        assert sorted(clip_perm[:4].tolist()) == [0, 1, 2, 3] and clip_perm[4:].tolist() == [4, 5]
    clip_perm, final = ppre.shuffle_permutations(6, g)
    assert sorted(clip_perm.tolist()) == list(range(6)) and sorted(final.tolist()) == list(range(12))


def _trajectory_over(name):
    return {"correspondence_video": True} if name == "correspondence" else {}


@functools.cache
def _jax_trajectory(name, steps=STEPS, **over):
    """``steps`` steps of JAX's trainer from its init; the init, each step's
    loss and (the generated task) noise, and the final parameters."""
    jtask, jtr, state = _jax_trainer(name, **over)
    init = jax.device_get((state.params, state.batch_stats))
    losses, eps = [], []
    for s in range(steps):
        raw = _jax_raw(_raw(200 + s, _clips(name)))
        if name == "generated":
            rngs = rng_mod.train_step_rngs(jtr.base_key, s)
            batch = jtr._prepare(raw, key=rngs["data"])
            eps.append(_jax_eps(jtask, *jax.device_get((state.params, state.batch_stats)), batch, rngs))
        state, metrics = jtr._train_step(state, raw, None)
        losses.append(float(metrics["loss"]))
    return init, losses, eps, jax.device_get(state.params)


@pytest.mark.parametrize("name", list(TASKS))
def test_two_step_trajectory_matches_jax_trainer(name):
    init, jax_losses, jax_eps, jax_params = _jax_trajectory(name, **_trajectory_over(name))
    task = _port_task(name, *init, **_trajectory_over(name))
    trainer = Trainer(task)
    state = trainer.init_state()
    losses = []
    for s in range(STEPS):
        state, metrics = trainer.train_step(state, _raw(200 + s, _clips(name)), eps=jax_eps[s] if jax_eps else None)
        losses.append(float(metrics["loss"]))
    assert state.step == STEPS
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    got = dict(_leaves(bridge.to_flax(task)[0]))
    start = dict(_leaves(init[0]))
    want = dict(_leaves(jax_params))
    assert got.keys() == want.keys()
    for path, value in got.items():
        key = "/".join(path)
        if path[0] != "dualcamnet":
            np.testing.assert_array_equal(value, start[path], err_msg=key)
            np.testing.assert_array_equal(want[path], start[path], err_msg=key)
            continue
        d_port, d_jax = value - start[path], want[path] - start[path]
        gap = np.abs(d_port - d_jax)
        assert gap.max() <= 2 * LR, (key, float(gap.max() / LR))
        assert np.quantile(gap, 0.99) <= LR / 4, (key, float(np.quantile(gap, 0.99) / LR))
        assert np.linalg.norm(gap) <= 0.1 * np.linalg.norm(d_jax), key
        assert np.abs(d_port).max() > 0.5 * LR, key
    if name == "generated":
        assert len(state.optimizer.state) == 10  # Adam slots for DualCamNet's tensors only


def test_silence_map_step_matches_jax_trainer():
    init, jax_losses, _, _ = _jax_trajectory("correspondence", steps=1)
    trainer = Trainer(_port_task("correspondence", *init))
    state = trainer.init_state()
    batch = trainer._prepare(_raw(200), generator=None)
    assert batch.acoustic.shape[0] == 2 * CLIPS * FRAMES and batch.filtered_mfcc is not None
    assert batch.correspondence[:CLIPS * FRAMES, 1].all() and not batch.correspondence[CLIPS * FRAMES:, 1].any()
    _, metrics = trainer.train_step(state, _raw(200))
    np.testing.assert_allclose(float(metrics["loss"]), jax_losses[0], rtol=2e-3)


@pytest.mark.parametrize("name", ["real", "correspondence", "generated"])
def test_eval_step_masks_each_half_per_clip(name):
    """A remainder batch whose last clip is zero padding (its acoustic
    frames normalize to NaN): only the valid clips of each half count. The
    correspondence case uses the zeroed-video variant, whose second half
    repeats the real acoustic images, so both halves are exact."""
    over = {"correspondence_video": True} if name == "correspondence" else {}
    jtask, jtr, jstate = _jax_trainer(name, **over)
    params, stats = jax.device_get((jstate.params, jstate.batch_stats))
    clips = _clips(name) + 1
    raw = _raw(9, clips=clips, valid=clips - 1)
    key = jax.random.key(5)
    jsums, jcount = jax.device_get(jtr._eval_step(jstate, _jax_raw(raw), key))
    task = _port_task(name, params, stats, **over)
    eps = None
    if name == "generated":
        jbatch = jtr._prepare(_jax_raw(raw), key=key, train=False)
        eps = _jax_eps(jtask, params, stats, jbatch, {"latent": key})
    trainer = Trainer(task)
    sums, count = trainer.eval_step(trainer.init_state(), raw, eps=eps)
    halves = 2 if name == "correspondence" else 1
    assert float(count) == float(jcount) == (clips - 1) * halves
    assert sums.keys() == jsums.keys() == {"cross_loss", "accuracy"}
    for k in sums:
        assert np.isfinite(float(sums[k]))
        np.testing.assert_allclose(float(sums[k]), float(jsums[k]), rtol=1e-5, err_msg=k)


def test_real_vs_generated_accuracy_matches_jax(tmp_path):
    from acoustic_image_generation_tpu.data.pipeline import AcousticImageDataLoader as JaxLoader
    from acoustic_image_generation_tpu.evaluation.real_vs_generated import (
        real_vs_generated_accuracy as jax_real_vs_generated,
    )
    from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxGeneration
    from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, write_synthetic_dataset
    from acoustic_image_generation_tpu_torch.evaluation.real_vs_generated import real_vs_generated_accuracy
    from acoustic_image_generation_tpu_torch.train.generation import GenerationTask

    lists = write_synthetic_dataset(str(tmp_path / "ds"), num_classes=2, videos_per_class=1, seconds_per_video=2)
    jcfg = _config(jconfig, "real")
    jloader = JaxLoader(lists["testing"], "testing", 2, drop_remainder=False)
    first = next(iter(jloader.batches(0)))
    gen_task = JaxGeneration(jcfg)
    gen_state = jax.device_get(JaxTrainer(gen_task, jcfg, mesh=make_mesh(1)).init_state(first))
    cls_task = jclassify.ClassificationTask(jcfg)
    cls_state = jax.device_get(JaxTrainer(cls_task, jcfg, mesh=make_mesh(1)).init_state(first))
    # a decisive classifier: random weights scaled up, so near-ties are rare
    cls_params = jax.tree_util.tree_map(lambda w: w * 30.0, cls_state.params["dualcamnet"])
    want = jax_real_vs_generated(gen_task, gen_state, cls_task, cls_params, jloader, seed=3)

    eps = []
    for i, rb in enumerate(jloader.batches(0)):
        f = rb.acoustic.shape[1]
        flat = lambda x: jnp.asarray(x.reshape(-1, *x.shape[2:]))
        batch = jpre.preprocess_batch(flat(rb.acoustic), flat(rb.audio), flat(rb.video),
                                      jnp.repeat(rb.action, f), jnp.repeat(rb.location, f))
        key = jax.random.fold_in(jax.random.key(3), i)
        out, _ = gen_task._forward(gen_state.params, gen_state.batch_stats, batch, {"latent": key}, train=False)
        eps.append(np.array((out.z - out.mean) / out.std))

    pcfg = _config(pconfig, "real")
    pgen = GenerationTask(pconfig.generation_config(pcfg), device="cpu")
    bridge.load_flax(pgen, gen_state.params, gen_state.batch_stats)
    pcls = _port_task("real", {"dualcamnet": cls_params}, {})
    loader = AcousticImageDataLoader(lists["testing"], "testing", 2, drop_remainder=False)
    got = real_vs_generated_accuracy(pgen, pcls, loader, seed=3, eps=eps)
    assert got == want
    assert got["n"] == loader.num_windows > 0
