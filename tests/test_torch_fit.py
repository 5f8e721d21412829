"""The port's epoch loop (``Trainer.fit``) against the JAX package's, its
resumes and its crash checkpoint, in f32 on the CPU, at ResNet 1/1/1/1 on
the synthetic shards: 2 training windows in batches of 1 (2 steps an
epoch), 1 validation window.

Tolerances, and why: against JAX's ``fit`` (``ae=True``, so no sampled
noise, from the same weights and shards) the per-epoch validation losses
within 1e-4 relative (read 3.1e-7: the same f32 arithmetic in another
order, after four steps whose updates differ as below); the final trained
tensors held as ``tests/test_torch_train.py`` holds its trajectory, over
the updates of the four steps: each entry within 2 lr, 99% within lr/4 and
each tensor within 10% in L2 norm (an entry whose gradient sits at
rounding-noise level takes a full +-lr Adam step of either sign; read:
0.23 lr, 0.04 lr and 1.2%, the layer2 conv_1 bias); the trunk bit-frozen. The port against itself (an ordinary resume, a
mid-epoch resume from the crash checkpoint) is bit for bit
(``tests/test_torch_fit_resume.py``; the shared pieces are in
``tests/fit_common.py``).
"""

import json

import jax
import numpy as np

from acoustic_image_generation_tpu.core import config as jconfig
from acoustic_image_generation_tpu.data.pipeline import AcousticImageDataLoader as JaxLoader
from acoustic_image_generation_tpu.parallel import make_mesh
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxTask
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core import config as pconfig
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train.generation import GenerationTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from fit_common import LR, STEPS_PER_EPOCH, _config, _leaves, _loaders, _port, _records, lists  # noqa: F401
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import tmp_path  # noqa: F401


def test_fit_matches_jax(lists, tmp_path):
    jcfg = _config(jconfig, tmp_path / "jax", "fit", ae=True)
    jtrain = JaxLoader(lists["training"], "training", 1)
    jtr = JaxTrainer(JaxTask(jcfg), jcfg, mesh=make_mesh(1))
    jstate = jtr.init_state(next(iter(jtrain.batches(0))))
    init = jax.device_get((jstate.params, jstate.batch_stats))
    jfinal = jax.device_get(jtr.fit(jtrain, JaxLoader(lists["validation"], "validation", 1), state=jstate))

    trainer = _port(tmp_path / "port", "fit", ae=True)
    bridge.load_flax(trainer.task, *init)
    state = trainer.fit(*_loaders(lists), state=trainer.init_state())
    assert state.step == int(jfinal.step) == 2 * STEPS_PER_EPOCH
    with open(f"{jtr.run_dir}/metrics.jsonl") as f:
        want = [json.loads(line) for line in f]
    got = _records(trainer)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    assert [r["steps"] for r in got] == [r["steps"] for r in want]
    for g, w in zip(got, want):
        assert g["valid"].keys() == w["valid"].keys()
        for k in w["valid"]:
            np.testing.assert_allclose(g["valid"][k], w["valid"][k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(g["train"]["loss"], w["train"]["loss"], rtol=1e-4)
    assert ckpt.BestTracker.read_best_epoch(trainer.run_dir) == ckpt.BestTracker.read_best_epoch(jtr.run_dir)

    labels = trainer.task.param_labels()
    name_of = {id(t): n for n, t in trainer.task.named_parameters()}
    paths = {"/".join(p): name_of.get(id(t)) for t, _, p, _ in bridge.targets(trainer.task)}
    before, after = dict(_leaves(init[0])), dict(_leaves(jfinal.params))
    for key, value in _leaves(bridge.to_flax(trainer.task)[0]):
        if labels[paths[key]] == "frozen":
            np.testing.assert_array_equal(value, before[key], err_msg=key)
            continue
        d_port, d_jax = value - before[key], np.asarray(after[key]) - before[key]
        gap = np.abs(d_port - d_jax)
        assert gap.max() <= 2 * LR, (key, float(gap.max() / LR))
        assert np.quantile(gap, 0.99) <= LR / 4, (key, float(np.quantile(gap, 0.99) / LR))
        assert np.linalg.norm(gap) <= 0.1 * np.linalg.norm(d_jax), key
    # the port restores JAX's last snapshot to the bit
    restored = _port(tmp_path / "again", "again", ae=True)
    restored.restore(f"{jtr.run_dir}/epoch_1.ckpt", restored.init_state())
    for key, value in _leaves(bridge.to_flax(restored.task)[0]):
        np.testing.assert_array_equal(value, np.asarray(after[key]), err_msg=key)


def test_fit_rides_the_feature_cache_and_attaches_the_disk_tier(lists, tmp_path):
    """Frozen trunk with the feature cache: the trunk runs for the first
    epoch's training batches and the first validation pass (one batch)
    only; the disk tier is attached before the first epoch."""
    trainer = _port(tmp_path, "cached", trunk_bn="frozen", cache_trunk_features=True,
                    cache_disk_dir=str(tmp_path / "store"))
    train, valid = _loaders(lists)
    state = trainer.fit(train, valid)
    assert trainer.trunk_runs == STEPS_PER_EPOCH + 1
    assert trainer.feature_cache.disk is not None
    records = _records(trainer)
    assert [r["steps"] for r in records] == [STEPS_PER_EPOCH] * 2
    assert trainer.evaluate(state, valid) == records[1]["valid"]  # from the eval cache, no trunk run
    assert trainer.trunk_runs == STEPS_PER_EPOCH + 1


def test_logger_writes_what_jax_writes(tmp_path):
    """The run logger against the JAX package's: the same jsonl records, WAV
    bytes and TensorBoard summaries, and PNGs of the same pixels (the JAX
    package writes them through matplotlib)."""
    import io

    import matplotlib.image

    from acoustic_image_generation_tpu.utils import logger as jlogger
    from acoustic_image_generation_tpu.utils import tb_events as jtb
    from acoustic_image_generation_tpu_torch.utils import logger as plogger
    from acoustic_image_generation_tpu_torch.utils import tb_events as ptb

    rng = np.random.default_rng(0)
    heat = rng.random((36, 48)).astype(np.float32)
    frame = rng.random((224, 298, 3)).astype(np.float32)
    sound = np.sin(np.linspace(0, 100, 12288))
    paths = {}
    for name, mod in (("jax", jlogger), ("port", plogger)):
        log = mod.Logger(str(tmp_path / name))
        log.log_scalars({"mse": 0.25, "huber": 0.125}, 3)
        log.log_histogram("w", heat, 3)
        paths[name] = [log.log_image("gen", heat, 3, cmap="jet"), log.log_image("video", frame, 3),
                       log.log_sound("mic", sound, 3)]
        log.close()
    records = {name: [{k: v for k, v in json.loads(line).items() if k != "time"}
                      for line in open(tmp_path / name / "metrics.jsonl")] for name in paths}
    assert records["port"] == records["jax"]
    for got, want in zip(paths["port"][:2], paths["jax"][:2]):
        np.testing.assert_array_equal(matplotlib.image.imread(got), matplotlib.image.imread(want))
    assert open(paths["port"][2], "rb").read() == open(paths["jax"][2], "rb").read()
    png = open(paths["port"][0], "rb").read()
    assert ptb.image_value("gen", png) == jtb.image_value("gen", png)
    assert ptb.histogram_value("w", heat) == jtb.histogram_value("w", heat)
    assert ptb.encode_event(1.5, 3, summary=ptb.encode_summary([ptb.scalar_value("a", 0.5)])) == \
        jtb.encode_event(1.5, 3, summary=jtb.encode_summary([jtb.scalar_value("a", 0.5)]))
    assert len(list((tmp_path / "port").glob("events.out.tfevents.*"))) == 1
    np.testing.assert_array_equal(matplotlib.image.imread(io.BytesIO(plogger.encode_png(
        plogger.to_rgba(frame)))), matplotlib.image.imread(paths["jax"][1]))


def test_fit_logs_media_with_tensorboard(lists, tmp_path):
    cfg = _config(pconfig, tmp_path, "media", epochs=1, ae=True)
    cfg = pconfig.ExperimentConfig(data=cfg.data, model=cfg.model, optim=cfg.optim, parallel=cfg.parallel,
                                   run=pconfig.RunConfig(checkpoint_dir=str(tmp_path), exp_name="media",
                                                         tensorboard=str(tmp_path / "tb"), async_checkpoint=False))
    trainer = Trainer(GenerationTask(pconfig.generation_config(cfg), device="cpu").init_params(0), cfg)
    trainer.fit(*_loaders(lists))
    media = sorted(p.name for p in (tmp_path / "tb" / "media" / "media").glob("*.png"))
    assert media == ["valid_generated_0.png", "valid_real_0.png", "valid_video_0.png"]
    assert list((tmp_path / "tb" / "media").glob("events.out.tfevents.*"))
    assert (tmp_path / "media" / "epoch_0.ckpt").exists()
