"""The port's projection task and its modules against the JAX package, in
f32 on the CPU, at full width on 2 or 3 seconds of synthetic clips (the
loss on 3, actions 0, 1 and 0, so that the triplet term has positive
triplets): the latent
associators, the audio encoder associator and ``UNetAcoustic``'s
``external_latent``; ``ProjectTask.loss`` and its metrics for the
``Video``, ``Audio`` and ``fusion`` wirings and ``l2``, with JAX's noise
handed in; one train step of the ``Audio`` wiring (associators moved as
JAX's, VAEs bit-frozen) and its checkpoint both ways; ``eval_losses``,
``evaluate`` over a padded batch and ``embeddings``; the parameter labels.

Tolerances, and why (those of ``test_torch_embed.py``): the same f32
arithmetic summed in another order. Module outputs within 1e-5 of each
tensor's largest entry, 1e-3 through train-mode BN (``AssociatorAudio
Encoder``; its running averages within 1e-3). Loss terms within 1e-4
relative, the L2 term 1e-5; the BN running averages within 1e-3; the eval
losses within 1e-4 relative; the latents within 1e-5 of the largest. The
train step as ``task_parity.check_step`` states it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.models import associators as jassoc
from acoustic_image_generation_tpu.models.unet_ac import UNetAcoustic as JaxAcoustic
from acoustic_image_generation_tpu.train.project import ProjectTask as JaxProject
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.models import associators
from acoustic_image_generation_tpu_torch.models.unet_ac import UNetAcoustic
from acoustic_image_generation_tpu_torch.train.project import ProjectConfig, ProjectTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, eval_generator
from task_parity import (
    TRAIN_BN_LEAF,
    PaddedLoader,
    check_checkpoints_cross,
    check_step,
    jax_batch,
    jax_cfg,
    jax_step,
    kept_buffers,
    raw_clips,
    rel,
    with_normals,
)
from test_torch_embed_models import perturb
from torch_threads import few_torch_threads  # noqa: F401

WIRINGS = {"video": dict(encoder_type="Video"), "audio": dict(encoder_type="Audio"), "fusion": dict(fusion=True),
           "l2": dict(encoder_type="Video", l2=True)}
ASSOC = {"video": ("assoc_video",), "l2": ("assoc_video",), "audio": ("assoc_audio_enc",),
         "fusion": ("assoc_video", "assoc_audio")}


def jax_task(name):
    return JaxProject(jax_cfg(embedding=True, project=True, **WIRINGS[name]))


@functools.cache
def jax_init():
    """JAX's initial trees of the fusion wiring and the audio encoder
    associator, biases and BN parameters and statistics drawn away from
    their initial values."""
    params, stats = jax.jit(jax_task("fusion").init_variables)(jax.random.key(0), jax_batch(raw_clips(0, 1)))
    enc = jax.jit(lambda: jassoc.AssociatorAudioEncoder().init(jax.random.key(1), jnp.zeros((1, 193, 257, 1)),
                                                                 train=False))()
    params = dict(params, assoc_audio_enc=enc["params"])
    stats = dict(stats, assoc_audio_enc=enc["batch_stats"])
    return perturb(jax.device_get(params), np.random.default_rng(1)), \
        perturb(jax.device_get(stats), np.random.default_rng(2))


def trees(name):
    params, stats = jax_init()
    keep = {"acoustic", "video", "audio", *ASSOC[name]}
    return {k: v for k, v in params.items() if k in keep}, {k: v for k, v in stats.items() if k in keep}


def port_task(name):
    task = ProjectTask(ProjectConfig(compute_dtype="float32", **WIRINGS[name]), device="cpu")
    bridge.load_flax(task, *trees(name))
    return task


cached_task = functools.cache(port_task)  # the video VAE's head alone is 800 MB of f32


@pytest.fixture(scope="module", autouse=True)
def _free_trees():
    """The module's trees and tasks (several GB) go when its tests end."""
    yield
    jax_init.cache_clear()
    cached_task.cache_clear()


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("which", ["video", "audio"])
def test_latent_associator_matches_flax(which):
    hidden, dim = {"video": (jassoc.VIDEO_AC_HIDDEN, 1024), "audio": (jassoc.AUDIO_AC_HIDDEN, 256)}[which]
    rng = np.random.default_rng(3)
    mean, std = (rng.standard_normal((3, dim)).astype(np.float32) for _ in range(2))
    jm = jassoc.LatentAssociator(hidden)
    variables = {"params": perturb(jax.jit(jm.init)(jax.random.key(0), mean, std)["params"], rng)}
    port = associators.LatentAssociator(dim, hidden)
    bridge.load_flax(port, variables["params"], {})
    want = jm.apply(variables, mean, std)
    with torch.no_grad():
        got = port(torch.from_numpy(mean), torch.from_numpy(std))
    for g, w in zip(got, want):
        assert rel(g.numpy(), w) <= 1e-5
    assert float(got[1].min()) > 0  # softplus


def test_audio_encoder_associator_matches_flax():
    """Train mode; eval mode runs in the task's ``eval_losses`` below."""
    train = True
    x = (np.random.default_rng(4).random((2, 193, 257, 1)) * 5).astype(np.float32)
    jm = jassoc.AssociatorAudioEncoder()
    v = jax.jit(lambda x: jm.init(jax.random.key(0), x, train=False))(x[:1])
    variables = {"params": perturb(v["params"], np.random.default_rng(1)),
                 "batch_stats": perturb(v["batch_stats"], np.random.default_rng(2))}
    port = associators.AssociatorAudioEncoder()
    bridge.load_flax(port, variables["params"], variables["batch_stats"])
    (mean, std), mut = jax.jit(lambda v, x: jm.apply(v, x, train=train, mutable=["batch_stats"]))(variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=train)
    assert rel(got[0].numpy(), mean) <= 1e-3 and rel(got[1].numpy(), std) <= 1e-3
    want = dict(jax.tree_util.tree_leaves_with_path(mut["batch_stats"]))
    for path, value in jax.tree_util.tree_leaves_with_path(bridge.to_flax(port)[1]):
        np.testing.assert_allclose(value, np.asarray(want[path]), rtol=1e-3, atol=1e-3)


def test_external_latent_matches_flax():
    """``UNetAcoustic`` decoding from another modality's (mean, std), with
    JAX's reparameterization noise handed in, and without noise."""
    rng = np.random.default_rng(5)
    x = rng.random((2, 36, 48, 12), dtype=np.float32)
    mean2 = rng.standard_normal((2, 150)).astype(np.float32)
    std2 = (0.5 + rng.random((2, 150))).astype(np.float32)
    jm = JaxAcoustic(channels=12)
    params = perturb(jax.jit(jm.init)(jax.random.key(0), x[:1])["params"], rng)
    port = UNetAcoustic(12)
    bridge.load_flax(port, params, {})
    key = jax.random.key(9)
    out, draws = with_normals(lambda p, x, m, s: jm.apply({"params": p}, x, external_latent=(m, s),
                                                          rngs={"latent": key}))(params, x, mean2, std2)
    plain = jax.jit(lambda p, x, m, s: jm.apply({"params": p}, x, external_latent=(m, s)))(params, x, mean2, std2)
    with torch.no_grad():
        t = lambda a: torch.from_numpy(np.array(a))
        got = port(t(x), external_latent=(t(mean2), t(std2)), eps=t(draws[1]))
        got_plain = port(t(x), external_latent=(t(mean2), t(std2)))
    for g, w in ((got, out), (got_plain, plain)):
        for name in ("output", "z", "mean", "std", "features"):
            assert rel(getattr(g, name).numpy(), getattr(w, name)) <= 1e-5, name
    np.testing.assert_array_equal(got_plain.z.numpy(), mean2)


# ---------------------------------------------------------------- the task


def _loss(name, train, key, raw):
    params, stats = trees(name)
    jt = jax_task(name)
    (total, metrics, new_stats), draws = with_normals(
        lambda p, s, b: jt.loss(p, s, b, {"latent": key}, train=train))(params, stats, jax_batch(raw))
    eps = {"latent": draws[1]} if name == "l2" else {"latent": draws[1], "triplet": draws[2]}
    return total, metrics, new_stats, {k: torch.from_numpy(np.array(v)) for k, v in eps.items()}


@pytest.mark.parametrize("name", list(WIRINGS))
def test_loss_matches_jax(name):
    """Train mode (the audio encoder associator's BN on batch statistics)."""
    raw = raw_clips(1, 3)
    total, metrics, new_stats, eps = _loss(name, True, jax.random.key(7), raw)
    with kept_buffers(cached_task(name)) as task, torch.no_grad():
        got_total, got = task.loss(Trainer(task)._prepare(raw), train=True, eps=eps)
        got_stats = bridge.to_flax(task)[1]
    assert set(got) == set(metrics), (set(got), set(metrics))
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(total), rtol=1e-4)
    if name != "l2":
        assert float(got["triplet"]) > 0
    want = dict(jax.tree_util.tree_leaves_with_path(new_stats))
    for path, value in jax.tree_util.tree_leaves_with_path(got_stats):
        np.testing.assert_allclose(value, np.asarray(want[path]), rtol=1e-3, atol=1e-3)
    # the frozen VAEs' statistics stay as they were: eval mode in every step
    for model in ("video", "audio"):
        init = dict(jax.tree_util.tree_leaves_with_path(trees(name)[1][model]))
        for path, value in jax.tree_util.tree_leaves_with_path(got_stats[model]):
            np.testing.assert_array_equal(value, init[path])


def test_param_labels_match_jax():
    for name in ("video", "audio", "fusion"):
        task = cached_task(name)
        labels = task.param_labels()
        want = jax_task(name).param_labels(trees(name)[0])
        name_of = {id(p): n for n, p in task.named_parameters()}
        for tensor, coll, path, _ in bridge.targets(task):
            if coll == "params":
                assert labels[name_of[id(tensor)]] == want[path[0]], path
                assert tensor.requires_grad == (want[path[0]] == "train"), path
        assert {k for k, v in want.items() if v == "train"} == set(ASSOC[name])
        assert len(Trainer(task).init_state().optimizer.param_groups[0]["params"]) == \
            sum(p.requires_grad for p in task.parameters())


def test_train_step_matches_jax_and_checkpoints_cross(tmp_path):
    """One step of the ``Audio`` wiring (the associator with train-mode BN
    and the 8e-5 L2 term): the trained tensors as JAX's, the VAEs and their
    statistics bit-frozen; then its checkpoint both ways."""
    raw = raw_clips(2, amplitude=4)
    params, stats = trees("audio")
    key = jax.random.key(11)
    (jstate, loss, metrics), draws = jax_step(jax_task("audio"), params, stats, jax_batch(raw), {"latent": key})
    task = port_task("audio")
    trainer = Trainer(task)
    state = trainer.init_state()
    state, got = trainer.train_step(state, raw, eps={"latent": draws[1], "triplet": draws[2]})
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-4)
    trained, frozen = check_step(task, params, jstate.params, noisy=TRAIN_BN_LEAF)
    assert trained == 60 and frozen > 100  # every leaf of assoc_audio_enc
    want = dict(jax.tree_util.tree_leaves_with_path(jstate.batch_stats))
    for path, value in jax.tree_util.tree_leaves_with_path(bridge.to_flax(task)[1]):
        np.testing.assert_allclose(value, np.asarray(want[path]), rtol=1e-3, atol=1e-3)
    check_checkpoints_cross(trainer, state, jstate, tmp_path)


def test_eval_losses_evaluate_and_embeddings_match_jax():
    """``eval_losses`` of the ``Audio`` wiring (its associator's BN on the
    running averages) and ``evaluate`` on a padded batch; ``embeddings`` of
    the ``fusion`` wiring (both associators), with and without ``--mean``."""
    raw = raw_clips(3)
    params, stats = trees("audio")
    key = jax.random.key(13)
    (want, _), draws = with_normals(lambda p, s, b: jax_task("audio").eval_losses(p, s, b, {"latent": key}))(
        params, stats, jax_batch(raw))
    task = cached_task("audio")
    trainer = Trainer(task)
    batch = trainer._prepare(raw)
    with torch.no_grad():
        got, recon = task.eval_losses(batch, eps={"latent": torch.from_numpy(np.array(draws[1]))})
    assert got["mse"].shape == (2,) and recon.shape == (2, 36, 48, 12)
    np.testing.assert_allclose(got["mse"].numpy(), np.asarray(want["mse"]), rtol=1e-4)
    # evaluate: the valid clip's seconds only, with the eval batch's generator
    state = trainer.init_state()
    with torch.no_grad():
        one, _ = task.eval_losses(batch, generator=eval_generator(0, 0, "cpu"))
    assert trainer.evaluate(state, PaddedLoader(raw)) == {"mse": pytest.approx(float(one["mse"][0]), rel=1e-6)}

    params, stats = trees("fusion")
    task = cached_task("fusion")
    batch = Trainer(task)._prepare(raw)
    eps = np.array(jax.random.normal(key, (2, 150), jnp.float32))
    for use_mean in (True, False):
        want = jax.jit(lambda p, s, b: jax_task("fusion").embeddings(p, s, b, key, use_mean=use_mean))(
            params, stats, jax_batch(raw))
        with torch.no_grad():
            got = task.embeddings(batch, use_mean=use_mean, eps=None if use_mean else torch.from_numpy(eps))
        assert set(got) == set(want) == {"acoustic", "video", "audio"}
        for k, v in got.items():
            assert v.shape == (2, 150) and v.dtype == torch.float32
            assert rel(v.numpy(), want[k]) <= 1e-5, (k, use_mean)
