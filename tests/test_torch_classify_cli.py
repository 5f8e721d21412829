"""The classification family from the command line and its files, against
the JAX package, in f32 on the CPU (ResNet 1/1/1/1): the task dispatch,
``fit`` with the best epoch kept by accuracy, checkpoints that either
package restores from the other's (the generated task's frozen subtrees
included) and the warm starts onto its generator and trunk.

Tolerances, and why: files and restored leaves are equal to the bit (the
same MessagePack of the same f32 values); against JAX's ``fit`` from the
same weights (real images, no sampled noise) the validation cross-entropy
within 1e-4 relative per epoch (the same f32 arithmetic in another order,
after two Adam steps) and the accuracies and best epoch equal.
"""

import json
import os
import types

import flax.serialization as fs
import jax
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.cli import main as jmain
from acoustic_image_generation_tpu.core import config as jconfig
from acoustic_image_generation_tpu.data.pipeline import AcousticImageDataLoader as JaxLoader
from acoustic_image_generation_tpu.parallel import make_mesh
from acoustic_image_generation_tpu.train import checkpoint as jckpt
from acoustic_image_generation_tpu.train import warmstart as jwarm
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.cli import main as pmain
from acoustic_image_generation_tpu_torch.core import config as pconfig
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, write_synthetic_dataset
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train import classify, warmstart
from acoustic_image_generation_tpu_torch.train.generation import GenerationTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from torch_threads import few_torch_threads  # noqa: F401

LR = 1e-4
FLAGS = ["--resnet_units", "1,1,1,1", "--compute_dtype", "float32", "--learning_rate", "1e-4"]
TASK_FLAGS = {
    "real": ["--model", "DualCamNet", "--mfcc", "1"],
    "generated": ["--model", "DualCamNet"],
    "correspondence": ["--model", "DualCamNet", "--correspondence", "1"],
}


def _parse(mod, argv):
    return mod.config_from_args(mod.build_parser().parse_args(argv))


def _raw(seed, clips=1):
    rng = np.random.default_rng(seed)
    return dict(
        acoustic=rng.random((clips, 12, 36, 48, 12)).astype(np.float32),
        audio=rng.integers(-(2**15), 2**15, (clips, 12, 1024)).astype(np.int32),
        video=rng.integers(0, 256, (clips, 12, 224, 298, 3)).astype(np.uint8),
        action=rng.integers(0, 10, clips).astype(np.int32),
        location=rng.integers(0, 61, clips).astype(np.int32),
        valid=clips,
    )


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _assert_same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for key, value in got.items():
        if isinstance(value, dict):
            assert value == want[key] == {}, key
        else:
            np.testing.assert_array_equal(np.asarray(value), np.asarray(want[key]), err_msg=key)


def test_dispatch_matches_jax():
    cases = [
        (TASK_FLAGS["real"], classify.ClassificationTask, 10),
        (TASK_FLAGS["real"] + ["--mfccmap", "1"], classify.ClassificationTask, 10),
        (["--model", "DualCamNet", "--mfcc", "0", "--datatype", "old"], classify.GeneratedClassificationTask, 14),
        (TASK_FLAGS["correspondence"], classify.CorrespondenceTask, 2),
    ]
    for argv, cls, classes in cases:
        jtask = jmain.select_task(_parse(jmain, argv + FLAGS))
        task = pmain.select_task(_parse(pmain, argv + FLAGS), "cpu")
        assert type(task) is cls and type(jtask).__name__ == cls.__name__, argv
        assert task.dualcamnet.full3.out_features == jtask.model.num_classes == classes
        mfccmap = "--mfccmap" in argv
        assert task.cfg.mfccmap == mfccmap
        assert task.reads_mfcc == (mfccmap or cls is classify.GeneratedClassificationTask)
    # --model UNet is the reconstruction family, on the modality of --encoder_type
    argv = ["--model", "UNet", "--encoder_type", "Ac", "--datatype", "music"]
    task = pmain.select_task(_parse(pmain, argv + FLAGS), "cpu")
    jtask = jmain.select_task(_parse(jmain, argv + FLAGS))
    assert type(task).__name__ == type(jtask).__name__ == "ReconstructTask"
    assert task.encoder_type == jtask.encoder_type == "Ac"
    assert task.model.final.weight.shape[0] == jtask.cfg.data.num_channels == 13


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("classify_cli")
    full = write_synthetic_dataset(str(tmp / "ds"), num_classes=2, videos_per_class=2, seconds_per_video=2)
    out = {}
    for split, n in (("training", 4), ("validation", 2)):
        with open(full[split]) as f:
            files = f.read().split()[:n]
        out[split] = str(tmp / f"{split}.txt")
        with open(out[split], "w") as f:
            f.write("\n".join(files) + "\n")
    return out


def _fit_argv(lists, tmp, name, epochs):
    return TASK_FLAGS["real"] + FLAGS + [
        "--batch_size", "2", "--num_epochs", str(epochs), "--train_file", lists["training"],
        "--valid_file", lists["validation"], "--checkpoint_dir", str(tmp), "--exp_name", name]


def test_fit_matches_jax_and_keeps_the_most_accurate_epoch(lists, tmp_path):
    argv = _fit_argv(lists, tmp_path / "jax", "fit", 2)
    jcfg = _parse(jmain, argv)
    jtask = jmain.select_task(jcfg)
    jtrain = JaxLoader(lists["training"], "training", 2)
    jtr = JaxTrainer(jtask, jcfg, mesh=make_mesh(1))
    jstate = jtr.init_state(next(iter(jtrain.batches(0))))
    init = jax.device_get(jstate.params)
    jtr.fit(jtrain, JaxLoader(lists["validation"], "validation", 2), state=jstate)

    cfg = _parse(pmain, _fit_argv(lists, tmp_path / "port", "fit", 2))
    task = pmain.select_task(cfg, "cpu")
    bridge.load_flax(task, init, {})
    trainer = Trainer(task, cfg)
    trainer.fit(AcousticImageDataLoader(lists["training"], "training", 2),
                AcousticImageDataLoader(lists["validation"], "validation", 2))

    def records(run_dir):
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    got, want = records(trainer.run_dir), records(jtr.run_dir)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        assert g["valid"]["accuracy"] == w["valid"]["accuracy"]
        np.testing.assert_allclose(g["valid"]["cross_loss"], w["valid"]["cross_loss"], rtol=1e-4)
    accs = [r["valid"]["accuracy"] for r in got]
    best = max(range(len(accs)), key=lambda e: (accs[e], e))  # ">=": a tie goes to the later epoch
    assert ckpt.BestTracker.read_best_epoch(trainer.run_dir) == jckpt.BestTracker.read_best_epoch(jtr.run_dir) == best
    assert os.path.exists(os.path.join(trainer.run_dir, f"epoch_{best}.ckpt"))


def test_best_tracker_gates_accuracy_as_a_maximum(tmp_path, monkeypatch):
    """Validation accuracies 0.5, 0.75, 0.25: the best epoch is 1, and the
    snapshots are epoch 0 (every tenth) and the two bests."""
    cfg = _parse(pmain, TASK_FLAGS["real"] + FLAGS + ["--num_epochs", "3", "--checkpoint_dir", str(tmp_path),
                                                      "--exp_name", "max"])
    trainer = Trainer(pmain.select_task(cfg, "cpu"), cfg)
    accs = iter([0.5, 0.75, 0.25])
    monkeypatch.setattr(trainer, "evaluate", lambda *a, **k: {"accuracy": next(accs), "cross_loss": 1.0})
    batches = types.SimpleNamespace(batches=lambda epoch: iter([_raw(epoch)]), num_windows=1, batch_size=1)
    trainer.fit(batches, batches)
    assert ckpt.BestTracker.read_best_epoch(trainer.run_dir) == 1
    assert sorted(f for f in os.listdir(trainer.run_dir) if f.endswith(".ckpt")) == ["epoch_0.ckpt", "epoch_1.ckpt"]


@pytest.mark.parametrize("name", ["real", "generated"])
def test_checkpoints_restore_in_either_package(name, tmp_path):
    """A fresh state's file is JAX's byte for byte (plain Adam for the real
    classifier, ``multi_transform`` with the frozen ``resnet`` and
    ``generator`` as one {} each for the generated one); after a step, each
    package restores the other's file leaf for leaf."""
    argv = TASK_FLAGS[name] + FLAGS + ["--batch_size", "1"]
    jcfg = _parse(jmain, argv)
    jtask = jmain.select_task(jcfg)
    jtr = JaxTrainer(jtask, jcfg, mesh=make_mesh(1))
    jstate = jtr.init_state(types.SimpleNamespace(**_raw(1)))
    jax_init = jckpt.save_checkpoint(str(tmp_path / "jax"), "init", jstate)
    template = jax.device_get(jstate)

    task = pmain.select_task(_parse(pmain, argv), "cpu")
    bridge.load_flax(task, template.params, template.batch_stats)
    trainer = Trainer(task)
    state = trainer.init_state()
    port_init = ckpt.save_checkpoint(str(tmp_path / "port"), "init", state)
    with open(port_init, "rb") as f, open(jax_init, "rb") as g:
        assert f.read() == g.read()
    sd = ckpt.read_state_dict(port_init)
    if name == "generated":
        inner = sd["opt_state"]["inner_states"]["train"]["inner_state"]["0"]
        assert inner["mu"]["resnet"] == inner["mu"]["generator"] == {} and inner["nu"]["generator"] == {}
        assert set(inner["mu"]["dualcamnet"]) == {"conv1", "conv2", "conv3", "full1", "full3"}
    else:
        assert set(sd["opt_state"]) == {"0", "1"} and sd["batch_stats"] == {}

    # the port's file after a step, restored by JAX
    eps = np.random.default_rng(2).standard_normal((12, 150)).astype(np.float32)
    state, _ = trainer.train_step(state, _raw(3), eps=eps if name == "generated" else None)
    path = ckpt.save_checkpoint(str(tmp_path / "port"), 1, state)
    restored = jax.device_get(jckpt.restore_checkpoint(path, template))
    assert int(restored.step) == 1
    _assert_same_tree(jax.tree_util.tree_map(np.asarray, fs.to_state_dict(restored)), ckpt.state_dict(state))

    # JAX's file after a step, restored by the port
    jstate, _ = jtr._train_step(jstate, {k: np.asarray(v) if k != "valid" else np.int32(v)
                                         for k, v in _raw(4).items()}, None)
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), 1, jstate)
    fresh = pmain.select_task(_parse(pmain, argv), "cpu")
    ftrainer = Trainer(fresh)
    back = ftrainer.restore(jpath, ftrainer.init_state())
    assert back.step == 1
    _assert_same_tree(ckpt.state_dict(back), ckpt.read_state_dict(jpath))
    if name == "generated":
        frozen = [p for n, p in fresh.named_parameters() if not n.startswith("dualcamnet")]
        assert frozen and all(p not in back.optimizer.state for p in frozen)


def test_warm_starts_of_the_generated_task_match_jax(tmp_path):
    """``--acoustic_init_checkpoint`` (a generation run's file) onto the
    generator, ``--visual_init_checkpoint`` onto the trunk and
    ``--init_checkpoint`` (a generated classifier's file) params only, on
    both packages from the same files."""
    gen = GenerationTask(pconfig.generation_config(_parse(pmain, FLAGS + ["--embedding", "1", "--mfcc", "1"])),
                         device="cpu").init_params(11)
    gen_path = ckpt.save_checkpoint(str(tmp_path), "gen", Trainer(gen).init_state())
    donor_cfg = _parse(pmain, TASK_FLAGS["generated"] + FLAGS)
    donor = pmain.select_task(donor_cfg, "cpu")
    donor.init_params(12)
    donor_path = ckpt.save_checkpoint(str(tmp_path), "donor", Trainer(donor).init_state())

    flags = TASK_FLAGS["generated"] + FLAGS + ["--acoustic_init_checkpoint", gen_path,
                                               "--visual_init_checkpoint", gen_path]
    jcfg = _parse(jmain, flags)
    jtask = jmain.select_task(jcfg)
    jinit = JaxTrainer(jtask, jcfg, mesh=make_mesh(1)).init_state(types.SimpleNamespace(**_raw(1)))
    task = pmain.select_task(_parse(pmain, flags), "cpu")
    bridge.load_flax(task, *jax.device_get((jinit.params, jinit.batch_stats)))
    jstate = jwarm.apply_init_checkpoints(jinit, jcfg)
    state = warmstart.apply_init_checkpoints(Trainer(task).init_state(), _parse(pmain, flags))
    params, stats = bridge.to_flax(task)
    want_p, want_s = jax.device_get((jstate.params, jstate.batch_stats))
    _assert_same_tree(params, jax.tree_util.tree_map(np.asarray, want_p))
    _assert_same_tree(stats, jax.tree_util.tree_map(np.asarray, want_s))
    gen_p, gen_s = bridge.to_flax(gen)
    _assert_same_tree(params["generator"], gen_p["generator"])
    _assert_same_tree(params["resnet"], gen_p["resnet"])
    _assert_same_tree(stats["resnet"], gen_s["resnet"])
    assert state.step == 0

    # --init_checkpoint: every model's parameters and statistics, the slots and step kept
    state = warmstart.apply_init_checkpoints(state, _parse(pmain, TASK_FLAGS["generated"] + FLAGS + [
        "--init_checkpoint", donor_path]))
    _assert_same_tree(bridge.to_flax(task)[0], bridge.to_flax(donor)[0])
    assert state.step == 0 and not state.optimizer.state
