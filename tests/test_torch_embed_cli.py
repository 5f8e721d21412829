"""The embedding family from the command line, on the CPU over synthetic
shards, against the JAX package's tools: ``cli.main --mode train
--embedding 1 --normalize_spectrogram 1`` (two epochs, validation,
snapshots), ``--mode test``, ``tools extract`` of both splits, and ``tools
knn``, ``retrieve`` and ``aggregate``. (``tools export-tf1`` and the
``.ckpt`` warm starts: ``test_torch_tf1.py``.)

Tolerances, and why: the extracted latent means equal to the restored
task's own ``embeddings`` (``test_torch_embed.py`` holds those against
JAX's); ``knn`` and ``retrieve`` over the port's files equal to the JAX
tools' outputs on the same files (the same distances,
``test_torch_retrieval.py``). The lists are cut to a few windows and the
tests run on two threads: every pass runs the full-width VAEs on the CPU.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.cli import tools as jtools
from acoustic_image_generation_tpu_torch.cli import main as pmain
from acoustic_image_generation_tpu_torch.cli import tools
from acoustic_image_generation_tpu_torch.core import config as pconfig
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, stats, write_synthetic_dataset
from acoustic_image_generation_tpu_torch.train.checkpoint import BestTracker
from acoustic_image_generation_tpu_torch.train.embed import EmbedTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, as_raw
from torch_threads import few_torch_threads  # noqa: F401

MODALITIES = ("acoustic", "audio", "video")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Shards of two classes cut to 2 training, 2 validation and 4 test
    windows, their statistics, and a two-epoch CLI run of batches of 2."""
    tmp = tmp_path_factory.mktemp("embed_cli")
    full = write_synthetic_dataset(str(tmp / "ds"), num_classes=2, videos_per_class=2, seconds_per_video=2)
    lists = {}
    for split, keep in (("training", slice(0, 8, 4)), ("validation", slice(1, 8, 4)), ("testing", slice(0, 8, 2))):
        lists[split] = str(tmp / "ds" / "lists" / f"cut_{split}.txt")
        with open(full[split]) as f:
            files = f.read().split()[keep]
        with open(lists[split], "w") as f:
            f.write("\n".join(files) + "\n")
    # over every training window (both tones), so that no bin's variance cancels to nothing
    mean, std = stats.compute_spectrogram_stats(AcousticImageDataLoader(full["training"], "training", 4),
                                                device="cpu")
    stats.save_stats(os.path.join(os.path.dirname(lists["training"]), "stats2s"), mean, std)
    flags = ["--embedding", "1", "--compute_dtype", "float32", "--batch_size", "2", "--normalize_spectrogram", "1",
             "--train_file", lists["training"], "--valid_file", lists["validation"], "--test_file", lists["testing"],
             "--checkpoint_dir", str(tmp / "runs"), "--exp_name", "embed", "--device", "cpu"]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # beside the other test workers
    assert pmain.main(flags + ["--mode", "train", "--num_epochs", "2"]) == 0
    run_dir = tmp / "runs" / "embed"
    best = run_dir / f"epoch_{BestTracker.read_best_epoch(str(run_dir))}.ckpt"
    yield tmp, flags, run_dir, best
    torch.set_num_threads(threads)
    shutil.rmtree(tmp, ignore_errors=True)  # the full-width checkpoints: hundreds of MB each


def test_train_and_test_from_the_command_line(run):
    tmp, flags, run_dir, best = run
    records = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
    assert [r["epoch"] for r in records] == [0, 1] and all(r["steps"] == 1 for r in records)
    assert set(records[0]["valid"]) == {"mse", "mse_acoustic", "mse_audio", "mse_video"}
    assert all(np.isfinite(r["valid"]["mse"]) and np.isfinite(r["train"]["loss"]) for r in records)
    config = json.load(open(run_dir / "configuration.txt"))
    assert config["model"]["embedding"] is True and config["data"]["normalize_spectrogram"] is True
    # normalized spectrograms: the audio VAE's MSE on the z-scale, not on raw magnitudes (10^3-10^5)
    assert records[-1]["valid"]["mse_audio"] < 10
    assert pmain.main(flags + ["--mode", "test", "--restore_checkpoint", str(best)]) == 0
    text = (run_dir / "test_accuracy.txt").read_text()
    results = dict((k, float(v)) for k, v in (part.split(": ") for part in text.strip().split(" - ")[1:]))
    assert set(results) == {"mse", "mse_acoustic", "mse_audio", "mse_video"}
    assert all(np.isfinite(v) for v in results.values()) and results["mse_audio"] < 10


def test_extract_knn_retrieve_aggregate_against_jax(run, capsys):
    tmp, flags, run_dir, best = run
    epoch = best.name.split("_")[1].split(".")[0]
    port_dir = tmp / "features"  # sampled latents of the training set, the means of the test set
    assert tools.main(["extract", "--set", "training", str(best), str(port_dir), "--", *flags]) == 0
    assert tools.main(["extract", "--mean", "--set", "testing", str(best), str(port_dir), "--", *flags]) == 0
    config = pmain.config_from_args(pmain.build_parser().parse_args(flags))
    trainer = Trainer(EmbedTask(pconfig.embed_config(config), device="cpu"), config)
    trainer.restore(str(best), trainer.init_state())
    for split, path, rows in (("training", config.data.train_file, 2), ("testing", config.data.test_file, 4)):
        want, labels = {}, []
        for raw in AcousticImageDataLoader(path, split, 2).batches(0):
            with torch.no_grad():
                z = trainer.task.embeddings(trainer._prepare(as_raw(raw), train=False), use_mean=True)
            for mod in MODALITIES:
                want.setdefault(mod, []).append(z[mod].numpy())
            labels.append(raw.action)
        for mod in MODALITIES:
            name = f"{split}_{mod}_{epoch}"
            got = np.load(port_dir / name / f"{split}_data.npy")
            assert got.shape == (rows, 128)
            np.testing.assert_array_equal(np.argmax(np.load(port_dir / name / f"{split}_labels.npy"), 1),
                                          np.concatenate(labels))
            if split == "testing":
                np.testing.assert_array_equal(got, np.concatenate(want[mod]))
            else:  # sampled: mean + std * eps, one eps shared by the three
                assert not np.array_equal(got, np.concatenate(want[mod]))
    capsys.readouterr()

    def outputs(module, argv):
        assert module.main(argv) == 0
        return capsys.readouterr().out.strip().splitlines()[-1]

    for mod in MODALITIES:
        train_dir, test_dir = str(port_dir / f"training_{mod}_{epoch}"), str(port_dir / f"testing_{mod}_{epoch}")
        got = outputs(tools, ["knn", "--device", "cpu", "--k", "3", train_dir, test_dir])
        got_file = open(os.path.join(test_dir, "testing_knn_value.txt")).read()
        assert got == outputs(jtools, ["knn", "--k", "3", train_dir, test_dir])
        assert got_file == open(os.path.join(test_dir, "testing_knn_value.txt")).read()
    anchor, gallery = str(port_dir / f"testing_acoustic_{epoch}"), str(port_dir / f"testing_video_{epoch}")
    got = outputs(tools, ["retrieve", "--device", "cpu", "--num_classes", "2", anchor, gallery])
    got_file = open(os.path.join(anchor, "testing_retrieval.txt")).read()
    assert json.loads(got) == json.loads(outputs(jtools, ["retrieve", "--num_classes", "2", anchor, gallery]))
    assert got_file == open(os.path.join(anchor, "testing_retrieval.txt")).read()
    values = [str(port_dir / f"testing_{mod}_{epoch}" / "testing_knn_value.txt") for mod in MODALITIES]
    (tmp / "named.txt").write_text("rank1 0.5\nrank1 0.75\n\nrank5 1.0\n")
    argv = ["aggregate", *values, str(tmp / "named.txt"), "--out"]
    assert tools.main(argv + [str(tmp / "port.xlsx")]) == 0
    got = capsys.readouterr().out
    assert jtools.main(argv + [str(tmp / "jax.xlsx")]) == 0
    assert got == capsys.readouterr().out
    assert set(json.loads(got)) == {"testing_knn_value.txt", "rank1", "rank5"}
