"""The port's reconstruction task and its new models against the JAX
package, in f32 on the CPU, at full width: ``UNetEnergy`` (on
``conv_chain``'s plain version) and the small ``UNetSound``, with and
without JAX's noise; ``ReconstructTask.loss`` and its metrics for every
``encoder_type`` (``Ac`` and ``Energy`` on 4 frames, ``Audio`` on 2
seconds, ``Video`` on 2 frames), with JAX's noise handed in; one
``Energy`` train step (every tensor moved as JAX's) and its checkpoint both
ways; ``eval_losses`` per frame and per second, and ``evaluate`` over a
padded batch.

Tolerances, and why (those of ``test_torch_embed_models.py`` and
``test_torch_embed.py``): the same f32 arithmetic summed in another order.
The models' outputs within 1e-4 of each tensor's largest entry in eval
mode, 1e-3 through train-mode BN (and the running averages within 1e-3).
Loss terms within 1e-4 relative, the eval losses within 1e-4 relative.
The train step as ``task_parity.check_step`` states it (no BN in
``UNetEnergy``: every leaf to every bound).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.models.unet_sound import UNetSound as JaxSound
from acoustic_image_generation_tpu.models.unet_video import UNetEnergy as JaxEnergy
from acoustic_image_generation_tpu.train.reconstruct import ReconstructTask as JaxReconstruct
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.models.unet_sound import UNetSound
from acoustic_image_generation_tpu_torch.models.unet_video import UNetEnergy
from acoustic_image_generation_tpu_torch.train.reconstruct import ReconstructConfig, ReconstructTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, eval_generator
from task_parity import (
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
from torch_tmp import tmp_path  # noqa: F401

TYPES = ("Ac", "Energy", "Audio", "Video")
CLIPS = {"Ac": (2, 2), "Energy": (2, 2), "Audio": (2, 12), "Video": (2, 1)}  # clips, frames


def jax_task(kind):
    return JaxReconstruct(jax_cfg(model="UNet", encoder_type=kind))


def raw_for(kind, seed):
    clips, frames = CLIPS[kind]
    return raw_clips(seed, clips, frames, amplitude=4)  # a low-amplitude spectrogram, as the embed tests'


@functools.cache
def jax_init(kind):
    """JAX's initial trees, biases and BN parameters and statistics drawn
    away from their initial values."""
    params, stats = jax.jit(jax_task(kind).init_variables)(jax.random.key(0), jax_batch(raw_for(kind, 0)))
    return perturb(jax.device_get(params), np.random.default_rng(1)), \
        perturb(jax.device_get(stats), np.random.default_rng(2))


def port_task(kind):
    task = ReconstructTask(ReconstructConfig(encoder_type=kind, compute_dtype="float32"), device="cpu")
    bridge.load_flax(task, *jax_init(kind))
    return task


cached_task = functools.cache(port_task)


@pytest.fixture(scope="module", autouse=True)
def _free_trees():
    yield
    jax_init.cache_clear()
    cached_task.cache_clear()


# ---------------------------------------------------------------- models


def _check_model(jm, port, x, train, tol):
    """Eval or train mode, sampled with JAX's noise; unsampled, z = mean."""
    v = jax.jit(lambda x: jm.init({"params": jax.random.key(0)}, x, train=False))(x[:1])
    variables = {"params": perturb(v["params"], np.random.default_rng(1))}
    stats = {}
    if "batch_stats" in v:
        stats = variables["batch_stats"] = perturb(v["batch_stats"], np.random.default_rng(2))
    bridge.load_flax(port, variables["params"], stats)
    (out, mut), draws = with_normals(lambda v, x: jm.apply(v, x, train=train, rngs={"latent": jax.random.key(5)},
                                                           mutable=["batch_stats"]))(variables, x)
    with kept_buffers(port), torch.no_grad():
        got = port(torch.from_numpy(x), train=train, eps=torch.from_numpy(np.array(draws[0])))
        got_stats = bridge.to_flax(port)[1]
        plain = port(torch.from_numpy(x), train=train)
    assert len(draws) == 1
    for name in ("output", "z", "mean", "std", "features"):
        assert rel(getattr(got, name).numpy(), getattr(out, name)) <= tol, name
    torch.testing.assert_close(plain.mean, got.mean, rtol=0, atol=0)
    torch.testing.assert_close(plain.z, plain.mean, rtol=0, atol=0)
    want = dict(jax.tree_util.tree_leaves_with_path(mut.get("batch_stats", {})))
    for path, value in jax.tree_util.tree_leaves_with_path(got_stats):
        np.testing.assert_allclose(value, np.asarray(want[path]), rtol=1e-3, atol=1e-3)
    return got


def test_unet_energy_matches_jax():
    """The raw latent: mean == variance == the flattened bottleneck."""
    x = np.random.default_rng(3).random((3, 36, 48, 1)).astype(np.float32)
    got = _check_model(JaxEnergy(), UNetEnergy(), x, False, 1e-4)
    assert got.output.shape == x.shape and got.mean.shape == (3, 128) and got.logits is None
    assert got.std is got.mean and float(got.output.min()) >= 0  # ReLU, not sigmoid


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_unet_sound_small_matches_jax(train):
    x = (np.random.default_rng(4).random((2, 99, 257, 1)) * 5).astype(np.float32)
    got = _check_model(JaxSound(variant="small", latent_dim=256), UNetSound("small", 256), x, train,
                       1e-3 if train else 1e-4)
    assert got.output.shape == x.shape and got.mean.shape == (2, 128)  # fixed at 128


# ---------------------------------------------------------------- the task


@pytest.mark.parametrize("kind", TYPES)
def test_loss_matches_jax(kind):
    """Train mode (the BN models on batch statistics)."""
    raw = raw_for(kind, 1)
    params, stats = jax_init(kind)
    (total, metrics, new_stats), draws = with_normals(
        lambda p, s, b: jax_task(kind).loss(p, s, b, {"latent": jax.random.key(7)}, train=True))(
        params, stats, jax_batch(raw))
    with kept_buffers(cached_task(kind)) as task, torch.no_grad():
        got_total, got = task.loss(Trainer(task)._prepare(raw), eps=torch.from_numpy(np.array(draws[0])))
        got_stats = bridge.to_flax(task)[1]
    assert set(got) == set(metrics), (set(got), set(metrics))
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(total), rtol=1e-4)
    want = dict(jax.tree_util.tree_leaves_with_path(new_stats))
    assert len(want) == len(jax.tree_util.tree_leaves(got_stats))
    for path, value in jax.tree_util.tree_leaves_with_path(got_stats):
        np.testing.assert_allclose(value, np.asarray(want[path]), rtol=1e-3, atol=1e-3)


def test_train_step_matches_jax_and_checkpoints_cross(tmp_path):
    """One ``Energy`` step (every conv pair on ``conv_chain``'s plain
    backward): every tensor moved as JAX's; its checkpoint (plain TF1 Adam,
    no labels) both ways."""
    raw = raw_for("Energy", 2)
    params, stats = jax_init("Energy")
    (jstate, loss, _), draws = jax_step(jax_task("Energy"), params, stats, jax_batch(raw),
                                        {"latent": jax.random.key(11)})
    task = port_task("Energy")
    trainer = Trainer(task)
    state, got = trainer.train_step(trainer.init_state(), raw, eps=draws[0])
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-4)
    assert check_step(task, params, jstate.params) == [2 * (4 * 2 + 3 + 6 * 2 + 3 + 1), 0]
    check_checkpoints_cross(trainer, state, jstate, tmp_path)


@pytest.mark.parametrize("kind", ["Ac", "Audio"])
def test_eval_losses_and_evaluate_match_jax(kind):
    """Per frame (``Ac``) and per second (``Audio``, eval-mode BN), and
    ``evaluate`` over a padded batch: the valid clip's frames or seconds."""
    raw = raw_for(kind, 3)
    params, stats = jax_init(kind)
    (want, _), draws = with_normals(
        lambda p, s, b: jax_task(kind).eval_losses(p, s, b, {"latent": jax.random.key(13)}))(
        params, stats, jax_batch(raw))
    task = cached_task(kind)
    trainer = Trainer(task)
    batch = trainer._prepare(raw)
    with torch.no_grad():
        got, recon = task.eval_losses(batch, eps=torch.from_numpy(np.array(draws[0])))
    rows = {"Ac": 4, "Audio": 2}[kind]
    assert got["mse"].shape == (rows,) and recon.shape[0] == rows
    np.testing.assert_allclose(got["mse"].numpy(), np.asarray(want["mse"]), rtol=1e-4)
    with torch.no_grad():
        one, _ = task.eval_losses(batch, generator=eval_generator(0, 0, "cpu"))
    valid = one["mse"][: rows // 2]
    got = trainer.evaluate(trainer.init_state(), PaddedLoader(raw))
    assert got == {"mse": pytest.approx(float(valid.sum()) / len(valid), rel=1e-6)}
