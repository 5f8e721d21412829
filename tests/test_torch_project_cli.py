"""The projection family from the command line, on the CPU over synthetic
shards, against the JAX package: ``cli.main --mode train --embedding 1
--project 1 --encoder_type Video`` for two epochs; ``--mode test``;
``tools extract`` of both splits against JAX's ``tools extract`` on the
same checkpoint; ``tools knn`` against JAX's. Then the warm starts: a joint
task's acoustic and audio VAEs from a TF1 ``.ckpt`` and its video VAE from
the projection run's JAX-format checkpoint, in one
``apply_init_checkpoints``; the reconstruction task's ``model`` key refused
by both packages. (A TF1 file of all three VAEs is about 1.2 GB, most of it
the video VAE's 1024-d head, and its crc32c checks alone take tens of
seconds here: the three-scope TF1 round trip runs on the card, in
``chip_smoke.py``'s phase 14.)

Tolerances, and why: the VAEs, frozen through the run, and the
warm-started ones equal to their source to the bit; the extracted latent
means within 1e-5 of JAX's largest (``test_torch_project.py`` holds the
embeddings so); ``knn`` over the port's files equal to the JAX tool's
output on the same files. The lists are cut to a few windows and the run
uses two threads.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.cli import tools as jtools
from acoustic_image_generation_tpu.train import warmstart as jwarmstart
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.cli import main as pmain
from acoustic_image_generation_tpu_torch.cli import tools
from acoustic_image_generation_tpu_torch.core import config as pconfig
from acoustic_image_generation_tpu_torch.core.tf1_export import export_state
from acoustic_image_generation_tpu_torch.data import write_synthetic_dataset
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train import warmstart
from acoustic_image_generation_tpu_torch.train.checkpoint import BestTracker
from acoustic_image_generation_tpu_torch.train.joint import JointConfig, JointTask
from acoustic_image_generation_tpu_torch.train.reconstruct import ReconstructConfig, ReconstructTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from torch_threads import few_torch_threads  # noqa: F401

VAES = ("acoustic", "video", "audio")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _same_vaes(got, want, models=VAES):
    for model in models:
        ref = dict(_leaves(want[model]))
        for key, value in _leaves(got[model]):
            np.testing.assert_array_equal(value, ref[key], err_msg=f"{model}/{key}")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Shards of two classes cut to 2 training, 2 validation and 4 test
    windows, and a two-epoch projection run of batches of 2."""
    tmp = tmp_path_factory.mktemp("project_cli")
    full = write_synthetic_dataset(str(tmp / "ds"), num_classes=2, videos_per_class=2, seconds_per_video=2)
    lists = {}
    for split, keep in (("training", slice(0, 8, 4)), ("validation", slice(1, 8, 4)), ("testing", slice(0, 8, 2))):
        lists[split] = str(tmp / "ds" / "lists" / f"cut_{split}.txt")
        with open(full[split]) as f:
            files = f.read().split()[keep]
        with open(lists[split], "w") as f:
            f.write("\n".join(files) + "\n")
    flags = ["--embedding", "1", "--project", "1", "--encoder_type", "Video", "--compute_dtype", "float32",
             "--batch_size", "2", "--train_file", lists["training"], "--valid_file", lists["validation"],
             "--test_file", lists["testing"], "--checkpoint_dir", str(tmp / "runs"), "--exp_name", "project"]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # beside the other test workers
    assert pmain.main(flags + ["--device", "cpu", "--mode", "train", "--num_epochs", "2"]) == 0
    run_dir = tmp / "runs" / "project"
    best = run_dir / f"epoch_{BestTracker.read_best_epoch(str(run_dir))}.ckpt"
    yield tmp, flags, run_dir, best
    torch.set_num_threads(threads)
    shutil.rmtree(tmp, ignore_errors=True)  # full-width checkpoints: about 1 GB each


def test_train_and_test_from_the_command_line(run):
    tmp, flags, run_dir, best = run
    records = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
    assert [r["epoch"] for r in records] == [0, 1] and all(r["steps"] == 1 for r in records)
    assert set(records[0]["train"]) == {"loss", "mse", "huber", "latent_loss", "triplet"}
    assert all(np.isfinite(r["valid"]["mse"]) and np.isfinite(r["train"]["loss"]) for r in records)
    config = json.load(open(run_dir / "configuration.txt"))
    assert config["model"]["project"] is True and config["model"]["encoder_type"] == "Video"
    sd = ckpt.read_state_dict(str(best))
    first = ckpt.read_state_dict(str(run_dir / "epoch_0.ckpt"))
    _same_vaes(sd["params"], first["params"])  # frozen through the run
    assert set(sd["params"]) == {*VAES, "assoc_video"}
    assert sd["opt_state"]["inner_states"]["train"]["inner_state"]["0"]["mu"]["video"] == {}
    del sd, first
    assert pmain.main(flags + ["--device", "cpu", "--mode", "test", "--restore_checkpoint", str(best)]) == 0
    text = (run_dir / "test_accuracy.txt").read_text()
    assert text.strip().split(" - ")[1].startswith("mse: ") and np.isfinite(float(text.split("mse: ")[1]))


def test_extract_and_knn_against_jax(run, capsys):
    tmp, flags, run_dir, best = run
    epoch = best.name.split("_")[1].split(".")[0]
    port_dir, jax_dir = tmp / "features", tmp / "jax_features"
    assert tools.main(["extract", "--set", "training", str(best), str(port_dir), "--", *flags, "--device",
                       "cpu"]) == 0
    assert tools.main(["extract", "--mean", "--set", "testing", str(best), str(port_dir), "--", *flags,
                       "--device", "cpu"]) == 0
    assert jtools.main(["extract", "--mean", "--set", "testing", str(best), str(jax_dir), "--", *flags,
                        "--num_devices", "1"]) == 0
    for mod in ("acoustic", "video"):
        name = f"testing_{mod}_{epoch}"
        got, want = np.load(port_dir / name / "testing_data.npy"), np.load(jax_dir / name / "testing_data.npy")
        assert got.shape == (4, 150) and np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), mod
        for part in ("labels", "scenario"):
            np.testing.assert_array_equal(np.load(port_dir / name / f"testing_{part}.npy"),
                                          np.load(jax_dir / name / f"testing_{part}.npy"))
        assert np.load(port_dir / f"training_{mod}_{epoch}" / "training_data.npy").shape == (2, 150)
    assert not (port_dir / f"testing_audio_{epoch}").exists()  # the Video wiring has no audio latent
    capsys.readouterr()
    train_dir, test_dir = str(port_dir / f"training_video_{epoch}"), str(port_dir / f"testing_video_{epoch}")
    assert tools.main(["knn", "--device", "cpu", "--k", "1", train_dir, test_dir]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert jtools.main(["knn", "--k", "1", train_dir, test_dir]) == 0
    assert got == capsys.readouterr().out.strip().splitlines()[-1]


def test_warm_starts_of_the_joint_and_reconstruction_tasks_as_jax(run):
    """A joint task's acoustic and audio VAEs from a TF1 ``.ckpt`` of the
    projection run's, its video VAE from the run's JAX-format checkpoint,
    bit-equal; the reconstruction task's tree has no key that an init flag
    names, and both packages refuse it."""
    tmp, best = run[0], str(run[3])
    sd = ckpt.read_state_dict(best)
    tf1 = str(tmp / "vaes.ckpt")
    export_state({k: sd["params"][k] for k in ("acoustic", "audio")}, sd["batch_stats"], tf1)
    warm = pconfig.ExperimentConfig(run=pconfig.RunConfig(
        acoustic_init_checkpoint=tf1, audio_init_checkpoint=tf1, visual_init_checkpoint=best))
    joint = JointTask(JointConfig(compute_dtype="float32"), device="cpu").init_params(9)
    warmstart.apply_init_checkpoints(Trainer(joint).init_state(), warm)
    got = bridge.to_flax(joint)
    _same_vaes(got[0], sd["params"])
    _same_vaes(got[1], sd["batch_stats"], ("video", "audio"))
    del joint, got, sd
    energy = ReconstructTask(ReconstructConfig(encoder_type="Energy", compute_dtype="float32"), device="cpu")
    only = pconfig.ExperimentConfig(run=pconfig.RunConfig(acoustic_init_checkpoint=best))
    with pytest.raises(KeyError, match="no model key"):
        warmstart.apply_init_checkpoints(Trainer(energy.init_params(0)).init_state(), only)

    class State:  # JAX's apply_init_checkpoints reads only the state's parameter keys first
        params = {"model": {}}

    with pytest.raises(KeyError, match="no model key"):
        jwarmstart.apply_init_checkpoints(State(), only)
