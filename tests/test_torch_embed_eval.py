"""The embedding family's evaluation, statistics and epoch loop against the
JAX package, in f32 on the CPU, at full width on synthetic shards and
clips: ``Trainer.eval_step`` and ``evaluate`` over a padded remainder batch
(the spectrograms normalized), ``compute_spectrogram_stats`` and
``normalize_spectrogram``, a train step of the music data's 13 channels
with normalization (its loss terms and BN averages against JAX's train-mode
loss) and the eval after it, and ``fit`` for two epochs,
whose snapshots JAX's ``restore_checkpoint`` reads.

Tolerances, and why. The statistics: the spectrograms are the plain
``stft``, within 1e-5 of the peak of JAX's (``test_torch_stft.py``), summed
in f32 numpy on both sides, so the mean within 1e-5 of its largest entry.
The std is the root of a difference of two sums, which cancels where a bin
barely varies (the synthetic tones), so it is held through its square: the
variance within 5e-5 of the largest second moment (up to 2e-5 from the
spectrograms' gap, the rest the f32 sums; read 3.1e-7);
``normalize_spectrogram`` is the same two IEEE operations, bit for bit. The
eval losses and the step's loss terms within 1e-4 relative, as
``test_torch_embed.py`` holds them (f32 in another order through the
decoders' BNs); the BN averages within 1e-3 as ``test_torch_embed_train.py``
holds them (which also holds the updates of a step against JAX's), and the
restored leaves bit for bit. Noise: the eval forward draws none; the step takes JAX's ``eps``.
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.core import config as jconfig
from acoustic_image_generation_tpu.data import stats as jstats
from acoustic_image_generation_tpu.data.pipeline import AcousticImageDataLoader as JaxLoader
from acoustic_image_generation_tpu.parallel import make_mesh
from acoustic_image_generation_tpu.train import checkpoint as jckpt
from acoustic_image_generation_tpu.train.embed import EmbedTask as JaxEmbed
from acoustic_image_generation_tpu.train.state import TrainState as JaxState
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core import config as pconfig
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, stats, write_synthetic_dataset
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train.embed import EmbedConfig, EmbedTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from test_torch_embed import draws, jax_batch, raw_clips
from test_torch_embed_models import perturb

LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two torch threads, beside the other test workers (the full-width
    VAEs on the CPU)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@functools.cache
def weights():
    """Full-width trees of the port's initializers, their biases, BN
    parameters and statistics drawn away from their initial values."""
    params, stats = bridge.to_flax(EmbedTask(EmbedConfig(compute_dtype="float32"), device="cpu").init_params(0))
    return perturb(params, np.random.default_rng(1)), perturb(stats, np.random.default_rng(2))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Shards: 2 training windows (one batch), 3 validation windows
    (batches of 2: the second padded, valid 1); the statistics of all five
    in ``stats2s`` beside the lists."""
    tmp = tmp_path_factory.mktemp("embed_eval")
    full = write_synthetic_dataset(str(tmp / "ds"), num_classes=2, videos_per_class=2, seconds_per_video=2)
    lists = {}
    for split, n in (("training", 2), ("validation", 3)):
        with open(full[split] if split == "training" else full["training"]) as f:
            files = f.read().split()
        files = files[:n] if split == "training" else files[-n:]
        lists[split] = str(tmp / f"{split}.txt")
        with open(lists[split], "w") as f:
            f.write("\n".join(files) + "\n")
    # over both classes' tones, so that no bin's variance cancels to nothing
    with open(tmp / "all.txt", "w") as f:
        f.write(open(lists["training"]).read() + open(lists["validation"]).read())
    mean, std = stats.compute_spectrogram_stats(AcousticImageDataLoader(str(tmp / "all.txt"), "testing", 2),
                                                device="cpu")
    stats.save_stats(str(tmp / "stats2s"), mean, std)
    yield lists, tmp
    shutil.rmtree(tmp, ignore_errors=True)  # the full-width checkpoints: hundreds of MB each


def _config(mod, tmp, name, batch_size=2, epochs=2, datatype="outdoor"):
    return mod.ExperimentConfig(
        data=mod.DataConfig(batch_size=batch_size, datatype=datatype, normalize_spectrogram=True,
                            train_file=str(tmp / "training.txt")),
        model=mod.ModelConfig(embedding=True),
        optim=mod.OptimConfig(learning_rate=LR, num_epochs=epochs),
        run=mod.RunConfig(checkpoint_dir=str(tmp / "runs"), exp_name=name, seed=0),
        parallel=mod.ParallelConfig(compute_dtype="float32"),
    )


@pytest.fixture(scope="module")
def jax_side(data):
    """JAX's trainer of the normalized task, its state at ``weights()``
    weights."""
    lists, tmp = data
    cfg = _config(jconfig, tmp, "jax")
    jtr = JaxTrainer(JaxEmbed(cfg), cfg, mesh=make_mesh(1))
    params, batch_stats = weights()
    return jtr, JaxState(step=jnp.int32(0), params=params, batch_stats=batch_stats, opt_state=jtr.tx.init(params))


def _port_trainer(tmp, name, seed=None, **kw):
    """The port's trainer of the normalized task at ``weights()``,
    or at its own initializers' from ``seed``."""
    cfg = _config(pconfig, tmp, name, **kw)
    task = EmbedTask(pconfig.embed_config(cfg), device="cpu")
    if seed is None:
        bridge.load_flax(task, *weights())
    else:
        task.init_params(seed)
    return Trainer(task, cfg)


def test_spectrogram_stats_and_normalization_match_jax(data):
    lists, tmp = data
    got = stats.compute_spectrogram_stats(AcousticImageDataLoader(lists["validation"], "validation", 2),
                                          device="cpu")
    want = jstats.compute_spectrogram_stats(JaxLoader(lists["validation"], "validation", 2))
    assert all(g.shape == (99, 257) and g.dtype == np.float32 for g in got)
    (mean, std), (jmean, jstd) = got, want
    assert np.abs(mean - jmean).max() <= 1e-5 * np.abs(jmean).max()
    second = jmean.astype(np.float64) ** 2 + jstd.astype(np.float64) ** 2
    gap = np.abs(std.astype(np.float64) ** 2 - jstd.astype(np.float64) ** 2).max() / second.max()
    assert gap <= 5e-5
    # the stats2s files: JAX's names, read by either package
    mean, std = stats.load_stats(str(tmp / "stats2s"))
    jmean, jstd = jstats.load_stats(str(tmp / "stats2s"))
    assert mean.tobytes() == jmean.tobytes() and std.tobytes() == jstd.tobytes()
    spec = np.abs(np.random.default_rng(0).normal(size=(3, 99, 257)) * 100).astype(np.float32)
    normalized = stats.normalize_spectrogram(torch.from_numpy(spec), mean, std)
    assert normalized.numpy().tobytes() == np.asarray(jstats.normalize_spectrogram(spec, mean, std)).tobytes()
    # a task reads the statistics beside its training list
    task = EmbedTask(pconfig.embed_config(_config(pconfig, tmp, "t")), device="cpu")
    assert all(np.array_equal(t.numpy(), a) for t, a in zip(task.spec_stats, (mean, std)))


def test_eval_step_and_evaluate_over_a_padded_batch_match_jax(data, jax_side):
    lists, tmp = data
    jtr, jstate = jax_side
    trainer = _port_trainer(tmp, "eval")
    state = trainer.init_state()
    batches = list(AcousticImageDataLoader(lists["validation"], "validation", 2).batches(0))
    assert [b.valid for b in batches] == [2, 1]
    jbatch = list(JaxLoader(lists["validation"], "validation", 2).batches(0))[1]
    want, want_n = jtr._eval_step(jstate, jtr.device_batch(jbatch), jax.random.key(0))
    got, n = trainer.eval_step(state, batches[1])
    assert float(n) == float(want_n) == 1
    assert set(got) == set(want) == {"mse", "mse_acoustic", "mse_audio", "mse_video"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    got = trainer.evaluate(state, AcousticImageDataLoader(lists["validation"], "validation", 2))
    want = jtr.evaluate(jstate, JaxLoader(lists["validation"], "validation", 2))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@functools.cache
def _music_step(stats_dir):
    """JAX's train-mode loss of the music task (13 channels, normalized
    spectrograms) at ``_music_init``'s weights: its terms and the BN
    running averages it updates."""
    cfg = jconfig.ExperimentConfig(
        data=jconfig.DataConfig(datatype="music", normalize_spectrogram=True, stats_dir=stats_dir),
        model=jconfig.ModelConfig(embedding=True),
        parallel=jconfig.ParallelConfig(compute_dtype="float32"))
    jt = JaxEmbed(cfg)
    loss = jax.jit(lambda p, s, b, k: jt.loss(p, s, b, {"latent": k}, train=True)[1:])
    metrics, new_stats = loss(*_music_init(), jax_batch(_music_clips()), jax.random.key(5))
    return jt, jax.device_get((new_stats, metrics))


@functools.cache
def _music_init():
    """Weights of the 13-channel task: the port's initializers, seeded."""
    task = EmbedTask(EmbedConfig(num_channels=13, compute_dtype="float32"), device="cpu").init_params(6)
    return bridge.to_flax(task)


def _music_clips():
    raw = raw_clips(11, amplitude=2**15)
    raw["acoustic"] = np.concatenate([raw["acoustic"], raw["acoustic"][..., :1] * 0.5], axis=-1)
    return raw


def test_music_step_with_normalization_and_its_eval_match_jax(data):
    _, tmp = data
    stats_dir = str(tmp / "stats2s")
    jt, (jstats_new, jmetrics) = _music_step(stats_dir)
    cfg = pconfig.ExperimentConfig(
        data=pconfig.DataConfig(datatype="music", normalize_spectrogram=True, stats_dir=stats_dir),
        model=pconfig.ModelConfig(embedding=True), optim=pconfig.OptimConfig(learning_rate=LR),
        parallel=pconfig.ParallelConfig(compute_dtype="float32"))
    task = EmbedTask(pconfig.embed_config(cfg), device="cpu")
    assert task.cfg.num_channels == 13
    init_p, init_s = _music_init()
    bridge.load_flax(task, init_p, init_s)
    trainer = Trainer(task, cfg)
    eps, _ = draws(jax.random.key(5))
    state, metrics = trainer.train_step(trainer.init_state(), _music_clips(), eps=eps)
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-4, err_msg=k)
    got_p, got_s = bridge.to_flax(task)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))
    moved = [k for k, v in flat(got_p).items() if not np.array_equal(v, flat(init_p)[k])]
    assert len(moved) == len(flat(init_p))  # Adam moved every parameter
    for key, value in flat(got_s).items():
        np.testing.assert_allclose(value, np.asarray(flat(jstats_new)[key]), rtol=1e-3, atol=1e-3)
    # the eval after the step, at the port's new weights on both sides
    raw = _music_clips()
    sums, n = trainer.eval_step(state, raw)
    want_losses, _ = jax.jit(lambda p, s, b: jt.eval_losses(p, s, b, {"latent": jax.random.key(0)}))(
        got_p, got_s, jax_batch(raw))
    assert float(n) == 3
    for k, v in want_losses.items():
        np.testing.assert_allclose(float(sums[k]), float(np.sum(v)), rtol=1e-4, err_msg=k)


def test_fit_snapshots_restore_in_jax(data, jax_side):
    """Two epochs of one step with validation; the best snapshot restores
    in JAX's ``restore_checkpoint`` to the file's leaves (the trainer's,
    when it is the last epoch's), and JAX's ``evaluate`` of it gives the
    validation losses the port recorded."""
    lists, tmp = data
    jtr, jstate = jax_side
    trainer = _port_trainer(tmp, "fit", seed=0)
    state = trainer.fit(AcousticImageDataLoader(lists["training"], "training", 2),
                        AcousticImageDataLoader(lists["validation"], "validation", 2))
    assert state.step == 2
    with open(os.path.join(trainer.run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records] == [0, 1] and all(r["steps"] == 1 for r in records)
    best = ckpt.BestTracker.read_best_epoch(trainer.run_dir)
    assert best == min(range(2), key=lambda e: (records[e]["valid"]["mse"], -e))
    assert os.path.exists(os.path.join(trainer.run_dir, "epoch_0.ckpt"))  # every 10th epoch, and the best
    path = os.path.join(trainer.run_dir, f"epoch_{best}.ckpt")
    restored = jckpt.restore_checkpoint(path, jstate)
    want = ckpt.read_state_dict(path)
    assert int(restored.step) == int(want["step"]) == best + 1
    got = dict(jax.tree_util.tree_leaves_with_path(jax.device_get((restored.params, restored.batch_stats))))
    ref = dict(jax.tree_util.tree_leaves_with_path((want["params"], want["batch_stats"])))
    assert got.keys() == ref.keys()
    assert all(np.array_equal(np.asarray(v), ref[k]) for k, v in got.items())
    if best == 1:  # the last epoch's snapshot holds the trainer's weights
        port = dict(jax.tree_util.tree_leaves_with_path(bridge.to_flax(trainer.task)))
        assert all(np.array_equal(port[k], v) for k, v in ref.items())
    # JAX's evaluation of the restored weights: the validation losses the port recorded
    val = jtr.evaluate(restored, JaxLoader(lists["validation"], "validation", 2))
    for k, v in val.items():
        np.testing.assert_allclose(records[best]["valid"][k], v, rtol=1e-4, err_msg=k)
