"""The port's command line on two CPU ranks (``main --device cpu
--num_devices 2``: two spawned processes over gloo) against the JAX
package's ``main --num_devices 2`` (one process, a two-device CPU mesh), at
ResNet 1/1/1/1 in f32 on the synthetic shards: 2 windows a split in
batches of 2 (one clip a rank), 2 epochs, then ``--mode test`` on each
run's best snapshot. Both start from one checkpoint (the port's random
weights at step 0, written in JAX's format) and run the deterministic
autoencoder (``--ae 1``), so no noise differs.

Tolerances, and why: the per-epoch validation and training losses within
1e-4 relative, as ``tests/test_torch_fit.py`` holds one process against
JAX's ``fit`` (the same f32 arithmetic in another order, after steps whose
Adam updates differ at rounding level); the test metrics, written with six
decimals, within 2e-6 plus 1e-4 relative.
"""

import concurrent.futures as cf
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.cli import main as jmain
from acoustic_image_generation_tpu_torch.cli import main as pmain
from acoustic_image_generation_tpu_torch.core import config as pconfig
from acoustic_image_generation_tpu_torch.data import write_synthetic_dataset
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train.checkpoint import BestTracker
from acoustic_image_generation_tpu_torch.train.generation import GenerationTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _test_metrics(run_dir):
    """``test_accuracy.txt``'s metrics: "<time>: <exp> - k: v - k: v"."""
    with open(os.path.join(run_dir, "test_accuracy.txt")) as f:
        line = f.read().strip()
    return {k: float(v) for k, v in (part.split(": ") for part in line.split(" - ")[1:])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with module_dir(tmp_path_factory, "parallel_cli", need_mb=1000) as tmp:  # the checkpoints: hundreds of MB
        lists = write_synthetic_dataset(str(tmp / "ds"), num_classes=2, videos_per_class=1, seconds_per_video=1, seed=3)
        ckpt_dir = str(tmp / "ckpt")
        common = ["--embedding", "1", "--mfcc", "1", "--ae", "1", "--resnet_units", "1,1,1,1", "--compute_dtype",
                  "float32", "--batch_size", "2", "--train_file", lists["training"],
                  "--valid_file", lists["validation"], "--test_file", lists["testing"], "--checkpoint_dir", ckpt_dir,
                  "--num_devices", "2"]
        # the common start: the port's seed-0 weights at step 0, in JAX's file format
        cfg = pmain.config_from_args(pmain.build_parser().parse_args(common + ["--exp_name", "start"]))
        one = dataclasses.replace(cfg, parallel=pconfig.ParallelConfig(compute_dtype="float32"))
        start = Trainer(GenerationTask(pconfig.generation_config(one), device="cpu").init_params(0), one)
        start_ckpt = start.save("start", start.init_state())

        train = common + ["--mode", "train", "--num_epochs", "2", "--restore_checkpoint", start_ckpt]
        with cf.ThreadPoolExecutor(1) as pool:
            port = pool.submit(pmain.main, train + ["--device", "cpu", "--exp_name", "port"])
            jmain.main(train + ["--exp_name", "jax"])
            assert port.result() == 0
        out = {}
        with cf.ThreadPoolExecutor(1) as pool:
            waits = []
            for name in ("port", "jax"):
                run_dir = os.path.join(ckpt_dir, name)
                best = BestTracker.read_best_epoch(run_dir)
                out[name] = dict(dir=run_dir, best=best)
                test = common + ["--mode", "test", "--exp_name", name, "--restore_checkpoint",
                                 os.path.join(run_dir, f"epoch_{best}.ckpt")]
                if name == "port":
                    waits.append(pool.submit(pmain.main, test + ["--device", "cpu"]))
                else:
                    jmain.main(test)
            assert all(w.result() == 0 for w in waits)
        yield out


def test_train_on_two_ranks_matches_jax_cli(runs):
    got, want = _records(runs["port"]["dir"]), _records(runs["jax"]["dir"])
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]  # one writer: one line an epoch
    assert [r["steps"] for r in got] == [r["steps"] for r in want] == [1, 1]
    for g, w in zip(got, want):
        assert g["valid"].keys() == w["valid"].keys()
        for k in w["valid"]:
            np.testing.assert_allclose(g["valid"][k], w["valid"][k], rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(g["train"]["loss"], w["train"]["loss"], rtol=1e-4)
    assert runs["port"]["best"] == runs["jax"]["best"]
    assert sorted(f for f in os.listdir(runs["port"]["dir"]) if f.endswith(".ckpt")) == \
        sorted(f for f in os.listdir(runs["jax"]["dir"]) if f.endswith(".ckpt"))


def test_test_mode_on_two_ranks_matches_jax_cli(runs):
    got, want = _test_metrics(runs["port"]["dir"]), _test_metrics(runs["jax"]["dir"])
    assert got.keys() == want.keys() and "mse" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=2e-6, err_msg=k)


def test_devices_the_cli_takes(monkeypatch):
    parse = lambda argv: pmain.config_from_args(pmain.build_parser().parse_args(argv))
    gen = ["--embedding", "1", "--mfcc", "1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pmain.num_devices(parse(gen), "cuda") == 4  # unset: every visible GPU for the generation task
    assert pmain.num_devices(parse(gen), "cpu") == 1
    # so do the embedding and reconstruction tasks; the others take one
    assert pmain.num_devices(parse(["--embedding", "1"]), "cuda") == 4
    assert pmain.num_devices(parse(["--model", "UNet", "--encoder_type", "Audio"]), "cuda") == 4
    assert pmain.num_devices(parse(["--embedding", "1", "--project", "1"]), "cuda") == 1
    assert pmain.num_devices(parse(gen + ["--num_devices", "3"]), "cuda") == 3
    with pytest.raises(RuntimeError, match="5 ranks need 5 CUDA devices; 4 are visible"):
        pmain.main(gen + ["--num_devices", "5", "--train_file", "t", "--valid_file", "v"])
    # what waits is refused before any rank starts
    with pytest.raises(NotImplementedError, match=r"projection task trains on one device only.*item 8\.1"):
        pmain.main(["--embedding", "1", "--project", "1", "--num_devices", "2", "--device", "cpu"])


def test_torchrun_environment(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    assert mesh.from_env() is None
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.from_env() == (3, 4, 1)
    assert mesh.world() == 1 and mesh.rank() == 0  # no group in this process
