"""The port's command line against the JAX package's: the parser's flags
and defaults, the configuration it builds, the task dispatch, the device
policy, the reference protocol through the real entry point (``main
--mode train``, the best epoch from ``model.txt``, ``main --mode test
--restore_checkpoint``) and the ``iou``, ``auc`` and ``generate`` tools
(``generate --artifact`` on the ``export-serving`` artifact of the run),
at a small size (ResNet 1/1/1/1, f32) on the CPU."""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.cli import main as jmain
from acoustic_image_generation_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from acoustic_image_generation_tpu.train.checkpoint import BestTracker as JaxBestTracker
from acoustic_image_generation_tpu_torch.cli import main as pmain
from acoustic_image_generation_tpu_torch.cli import tools
from acoustic_image_generation_tpu_torch.core import config as pconfig
from acoustic_image_generation_tpu_torch.data import write_synthetic_dataset
from acoustic_image_generation_tpu_torch.dsp.energy import find_logen
from acoustic_image_generation_tpu_torch.train.checkpoint import BestTracker
from acoustic_image_generation_tpu_torch.train.classify import ClassificationTask
from acoustic_image_generation_tpu_torch.train.embed import EmbedTask
from acoustic_image_generation_tpu_torch.train.generation import GenerationTask
from acoustic_image_generation_tpu_torch.train.joint import JointTask
from acoustic_image_generation_tpu_torch.train.project import ProjectTask
from acoustic_image_generation_tpu_torch.train.reconstruct import ReconstructTask
from torch_threads import THREADS, few_torch_threads  # noqa: F401
from torch_tmp import module_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _actions(parser):
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_keeps_every_jax_flag_and_default():
    jax_actions, port_actions = _actions(jmain.build_parser()), _actions(pmain.build_parser())
    # --device, and a flag for a DataConfig field JAX's parser leaves at its default
    assert set(port_actions) - set(jax_actions) == {"device", "normalize_spectrogram"}
    assert set(jax_actions) <= set(port_actions)
    for dest, ja in jax_actions.items():
        pa = port_actions[dest]
        assert (pa.option_strings, pa.default, pa.choices, pa.nargs) == \
            (ja.option_strings, ja.default, ja.choices, ja.nargs), dest
        assert (pa.type is None) == (ja.type is None), dest
    device = port_actions["device"]
    assert device.default == "cuda" and device.choices == ["cuda", "cpu"]
    assert port_actions["normalize_spectrogram"].default == 0


@pytest.mark.parametrize("argv", [
    [],
    ["--mode", "test", "--embedding", "1", "--mfcc", "1", "--num_skip_conn", "2", "--ae", "1",
     "--latent_loss", "1e-5", "--resnet_units", "1,2,1,1", "--batch_size", "64", "--compute_dtype", "float32"],
    ["--trunk_bn", "frozen", "--cache_trunk_features", "1", "--trunk_quant", "int8", "--fused_qgemm", "1",
     "--cache_disk_dir", "d", "--cache_features_dtype", "f8_e4m3", "--fused_conv", "1", "--MSE", "0",
     "--huber_loss", "0", "--bce_loss", "1", "--seed", "3", "--exp_name", "e", "--tensorboard", "tb"],
])
def test_config_from_args_equals_jax(argv):
    want = jmain.config_from_args(jmain.build_parser().parse_args(argv))
    got = pmain.config_from_args(pmain.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert got.to_json() == want.to_json()


def test_dispatch_runs_the_generation_task_and_names_what_waits():
    def parse(argv):
        return pmain.config_from_args(pmain.build_parser().parse_args(argv))

    task = pmain.select_task(parse(["--embedding", "1", "--mfcc", "1", "--num_skip_conn", "2", "--ae", "1",
                                    "--resnet_units", "1,1,1,1", "--compute_dtype", "float32"]), "cpu")
    assert isinstance(task, GenerationTask) and task.device == torch.device("cpu")
    assert task.generator.skips == 2 and task.cfg.ae and task.dtype == torch.float32
    # the projection, joint and reconstruction families, dispatched as JAX's select_task does:
    # --project before --jointmvae before --mfcc, then --model UNet (full-width tasks: three cases)
    cases = {("--embedding", "1", "--project", "1", "--jointmvae", "1", "--fusion", "1", "--l2", "1"):
                 (ProjectTask, "wiring", "fusion"),
             ("--embedding", "1", "--mfcc", "1", "--jointmvae", "1", "--onlyaudiovideo", "1", "--moddrop", "1"):
                 (JointTask, "trained", "associator1"),
             ("--model", "UNet", "--encoder_type", "Energy", "--project", "1"):
                 (ReconstructTask, "encoder_type", "Energy")}
    for argv, (cls, attr, value) in cases.items():
        task = pmain.select_task(parse(list(argv) + ["--compute_dtype", "float32"]), "cpu")
        jtask = jmain.select_task(jmain.config_from_args(jmain.build_parser().parse_args(list(argv))))
        assert type(task) is cls and type(jtask).__name__ == cls.__name__, argv
        assert getattr(task, attr) == value, argv
        del task
    assert pconfig.project_config(parse(["--embedding", "1", "--project", "1", "--l2", "1"])).l2
    assert pconfig.joint_config(parse(["--moddrop", "1", "--datatype", "music"])) == pconfig.JointConfig(
        moddrop=True, num_channels=13, compute_dtype="bfloat16")
    assert pconfig.reconstruct_config(parse(["--model", "UNet"])).encoder_type == "Video"
    # the embedding family: its variant, latents and the music data's 13 channels
    embed = pmain.select_task(parse(["--embedding", "1", "--proxy", "1", "--num_class", "64", "--datatype", "music",
                                     "--compute_dtype", "float32"]), "cpu")
    assert isinstance(embed, EmbedTask) and embed.cfg.proxy and embed.cfg.latent_dim == 64
    assert embed.cfg.num_channels == 13 and embed.acoustic.layer1.conv_1.weight.shape[0] == 9 * 13
    # the classification family is ported (tests/test_torch_classify_cli.py)
    assert isinstance(pmain.select_task(parse(["--model", "DualCamNet", "--mfcc", "1"]), "cpu"), ClassificationTask)
    # more than one device trains the generation, embedding and reconstruction tasks only
    # (tests/test_torch_parallel*.py)
    with pytest.raises(NotImplementedError, match=r"item 8\.1, second half"):
        pmain.select_task(parse(["--embedding", "1", "--project", "1", "--num_devices", "4"]), "cpu")
    assert isinstance(pmain.select_task(parse(["--embedding", "1", "--num_devices", "4"]), "cpu"), EmbedTask)


def test_cli_runs_on_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = ["--embedding", "1", "--mfcc", "1", "--resnet_units", "1,1,1,1"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmain.main(gen + ["--mode", "test", "--test_file", "t.txt", "--restore_checkpoint", "c.ckpt"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tools.main(["iou", "c.ckpt", "--"] + gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tools.main(["generate", "c.ckpt", "out", "--"] + gen)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``main --mode train`` in a subprocess, two epochs, then ``main --mode
    test --restore_checkpoint`` on the best epoch, as the reference's
    sweep scripts run them."""
    with module_dir(tmp_path_factory, "torch_cli", need_mb=500) as tmp:  # the run's snapshots
        lists = write_synthetic_dataset(str(tmp / "ds"), num_classes=2, videos_per_class=2, seconds_per_video=2)
        small = {}
        for split, n in (("training", 2), ("validation", 1), ("testing", 2)):
            with open(lists[split]) as f:
                files = f.read().split()[:n]
            small[split] = str(tmp / f"{split}.txt")
            with open(small[split], "w") as f:
                f.write("\n".join(files) + "\n")
        flags = ["--embedding", "1", "--mfcc", "1", "--resnet_units", "1,1,1,1", "--compute_dtype", "float32",
                 "--device", "cpu", "--batch_size", "1", "--num_epochs", "2", "--learning_rate", "0.001",
                 "--exp_name", "cli", "--checkpoint_dir", str(tmp / "ckpt"), "--train_file", small["training"],
                 "--valid_file", small["validation"], "--test_file", small["testing"]]
        entry = [sys.executable, "-m", "acoustic_image_generation_tpu_torch.cli.main"]
        env = dict(os.environ, OMP_NUM_THREADS=str(THREADS))  # a few torch threads, as in this process
        subprocess.run([*entry, *flags, "--mode", "train"], check=True, cwd=ROOT, env=env, timeout=600)
        run_dir = tmp / "ckpt" / "cli"
        best = BestTracker.read_best_epoch(str(run_dir))
        ckpt = str(run_dir / f"epoch_{best}.ckpt")
        subprocess.run([*entry, *flags, "--mode", "test", "--restore_checkpoint", ckpt], check=True, cwd=ROOT,
                       env=env, timeout=600)
        yield dict(flags=flags, run_dir=run_dir, best=best, ckpt=ckpt, tmp=tmp)


def test_train_then_test_through_the_entry_point(run):
    run_dir = run["run_dir"]
    assert (run_dir / "test_accuracy.txt").exists() and (run_dir / "epoch_0.ckpt").exists()
    # the JAX package reads the run's bookkeeping
    assert JaxBestTracker.read_best_epoch(str(run_dir)) == run["best"]
    cfg = JaxExperimentConfig.load(str(run_dir / "configuration.txt"))
    assert cfg.model.mfcc and cfg.data.batch_size == 1 and list(cfg.model.resnet_units) == [1, 1, 1, 1]
    text = (run_dir / "test_accuracy.txt").read_text()
    assert "cli - mse:" in text and "mse3:" in text


def test_iou_auc_and_generate_tools(run):
    out = run["tmp"] / "iou"
    assert tools.main(["iou", "--out_dir", str(out), run["ckpt"], "--"] + run["flags"]) == 0
    names = sorted(os.listdir(out))
    assert names == ["area.txt"] + [f"intersection_{t / 10}_accuracy.txt" for t in range(11)]
    area = float((out / "area.txt").read_text())
    assert tools.main(["auc", str(out)]) == 0
    assert float((out / "area.txt").read_text()) == area and 0.0 <= area <= 1.0

    gen = run["tmp"] / "gen"
    assert tools.main(["generate", "--energy", run["ckpt"], str(gen), "--"] + run["flags"]) == 0
    images = np.load(gen / "testing_generated.npy")
    energy = np.load(gen / "testing_energy.npy")
    labels = np.load(gen / "testing_labels.npy")
    assert images.shape == (24, 36, 48, 12) and energy.shape == (24, 36, 48) and labels.shape == (24,)
    assert np.isfinite(images).all() and np.isfinite(energy).all()
    np.testing.assert_array_equal(energy, find_logen(torch.from_numpy(images)).numpy())
    # the same checkpoint through a serving artifact: the same images, energy maps and labels
    art, gen_art = run["tmp"] / "artifact", run["tmp"] / "gen_artifact"
    # --external_weights is the JAX command line's and changes nothing; only the port's platforms are taken
    assert tools.main(["export-serving", "--energy", "--external_weights", run["ckpt"], str(art), "--"]
                      + run["flags"]) == 0
    assert tools.main(["export-serving", "--platforms", "tpu,cpu", run["ckpt"], str(run["tmp"] / "tpu"), "--"]
                      + run["flags"]) == 2
    assert tools.main(["generate", "--energy", "--artifact", str(art), run["ckpt"], str(gen_art), "--"]
                      + run["flags"]) == 0
    for name in ("testing_generated.npy", "testing_energy.npy", "testing_labels.npy"):
        np.testing.assert_array_equal(np.load(gen_art / name), np.load(gen / name), err_msg=name)
