"""The port's multi-seed sweeps (``scripts/sweep_torch.py``,
``scripts/sweep_embed_torch.py``) on the CPU, against the JAX package's
``scripts/sweep.py``:

- the parsers (``parse_test_accuracy``, ``default_disk_store``) and the
  trimmed mean (``evaluation/aggregate.py``) equal to JAX's on the same
  inputs;
- ``sweep_torch.py --device cpu`` over two seeds of DualCamNet on the tiled
  MFCC map (tiny lists, one epoch): each seed's test metrics are JAX's
  parse of its ``test_accuracy.txt``, and the aggregate is JAX's
  ``aggregate_runs`` of them;
- ``sweep_embed_torch.py`` over two seeds, the second handed in as a
  finished result that its per-seed cache check accepts (eight command-line
  runs of the full-width embedding VAEs a seed would take the file past its
  time); the first runs train, extract, kNN and retrieval from the command
  line; ``meanstd.json`` is JAX's ``aggregate_runs`` of both seeds; and the
  cache check refuses an incomplete or mismatched file.

The scripts run as their own processes, as a user runs them.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from acoustic_image_generation_tpu.evaluation.aggregate import aggregate_runs as jax_aggregate
from acoustic_image_generation_tpu_torch.data import write_synthetic_dataset
from acoustic_image_generation_tpu_torch.evaluation.aggregate import aggregate_runs
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir, tmp_path  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jsweep, sweep, sweep_embed = script("sweep"), script("sweep_torch"), script("sweep_embed_torch")


def run_script(name, argv, env=None, timeout=600):
    env = dict({k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, OMP_NUM_THREADS="2", **(env or {}))
    out = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", name), *argv], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_parsers_and_trimmed_mean_match_jax():
    lines = ["2026-10-19 01:02:03.4: acres_seed0 - accuracy: 0.812500 - loss: 1.250000",
             "ts: exp - mse: 0.013 - mse0: 0.01 - not a number: x - huber: 2e-3",
             "no metrics here", ""]
    for line in lines:
        assert sweep.parse_test_accuracy(line) == jsweep.parse_test_accuracy(line)
    for flags in (["--cache_trunk_features", "1"], ["--cache_trunk_features", "0"],
                  ["--cache_trunk_features", "1", "--cache_disk_dir", "d"], ["--mfcc", "1"]):
        assert sweep.default_disk_store(flags, "ckpt") == jsweep.default_disk_store(flags, "ckpt")
    rng = np.random.default_rng(0)
    values = {"a": list(rng.random(5)), "b": [0.5, 0.25], "c": list(rng.random(3)), "d": [1.0]}
    assert aggregate_runs(values) == jax_aggregate(values)


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    """Two classes of synthetic shards, cut to two windows a split, one of
    each class."""
    with module_dir(tmp_path_factory, "sweep") as tmp:
        full = write_synthetic_dataset(str(tmp / "ds"), num_classes=2, videos_per_class=2, seconds_per_video=2)
        out = {}
        for split, keep in (("training", slice(0, 8, 4)), ("validation", slice(1, 8, 4)), ("testing", slice(2, 8, 4))):
            with open(full[split]) as f:
                files = f.read().split()[keep]
            out[split] = str(tmp / f"{split}.txt")
            with open(out[split], "w") as f:
                f.write("\n".join(files) + "\n")
        yield tmp, ["--train_file", out["training"], "--valid_file", out["validation"], "--test_file",
                    out["testing"], "--batch_size", "2", "--compute_dtype", "float32"]


def test_sweep_runs_two_seeds_on_the_cpu(lists):
    tmp, data = lists
    ckpt = str(tmp / "runs")
    flags = ["--model", "DualCamNet", "--mfcc", "1", "--mfccmap", "1", "--num_epochs", "1", *data]
    out = run_script("sweep_torch.py", ["--seeds", "2", "--checkpoint_dir", ckpt, "--exp_name", "dcn",
                                        "--device", "cpu", "--", *flags])
    per_seed = {}
    for seed in (0, 1):
        run_dir = os.path.join(ckpt, f"dcn_seed{seed}")
        config = json.load(open(os.path.join(run_dir, "configuration.txt")))
        assert config["run"]["seed"] == seed
        results = jsweep.parse_test_accuracy(open(os.path.join(run_dir, "test_accuracy.txt")).read())
        assert results and all(np.isfinite(v) for v in results.values())
        results["best_epoch"] = 0
        assert f"seed {seed}: {results}" in out
        for k, v in results.items():
            per_seed.setdefault(k, []).append(v)
    got = json.load(open(os.path.join(ckpt, "dcn_aggregate.json")))
    assert got == json.loads(json.dumps(jax_aggregate(per_seed)))
    assert all(v["n"] == 2 for v in got.values())


def test_embed_sweep_cache_check(tmp_path):
    path = str(tmp_path / "seed_3.json")
    good = {"knn15": {"audio": 0.5}, "retrieval_rank1": {"video->audio": 0.25}, "seed": 3, "epochs": 7}
    assert sweep_embed.load_seed(path, 3, 7) is None  # no file
    for bad in ("{not json", json.dumps(dict(good, seed=4)), json.dumps(dict(good, epochs=8)),
                json.dumps({k: v for k, v in good.items() if k != "knn15"}),
                json.dumps({k: v for k, v in good.items() if k != "retrieval_rank1"}), json.dumps([1, 2])):
        with open(path, "w") as f:
            f.write(bad)
        assert sweep_embed.load_seed(path, 3, 7) is None, bad
    with open(path, "w") as f:
        json.dump(good, f)
    assert sweep_embed.load_seed(path, 3, 7) == good


def test_embed_sweep_runs_a_seed_and_aggregates_two(lists):
    tmp, data = lists
    out_dir = tmp / "embed_sweep"
    out_dir.mkdir()
    handed = {"knn15": {"acoustic": 0.75, "audio": 0.5, "video": 1.0},
              "retrieval_rank1": {"video->acoustic": 0.25, "audio->acoustic": 0.5, "video->audio": 0.75},
              "epochs": 1, "seed": 1, "wall_s": 1.0}
    (out_dir / "seed_1.json").write_text(json.dumps(handed))
    env = {"AIG_SWEEP_SEEDS": "0,1", "AIG_EMBED_EPOCHS": "1", "AIG_SWEEP_DIR": str(out_dir)}
    run_script("sweep_embed_torch.py", ["--", "--device", "cpu", *data], env=env)
    assert not (out_dir / "runs" / "embed_seed1").exists()  # the handed-in seed did not run
    ran = json.loads((out_dir / "seed_0.json").read_text())
    assert ran["seed"] == 0 and ran["epochs"] == 1
    assert set(ran["knn15"]) == set(handed["knn15"]) and set(ran["retrieval_rank1"]) == set(handed["retrieval_rank1"])
    assert all(0 <= v <= 1 for part in ("knn15", "retrieval_rank1") for v in ran[part].values())
    feats = out_dir / "features_seed0"
    for mod, v in ran["knn15"].items():
        (path,) = feats.glob(f"testing_{mod}_*/testing_knn_value.txt")
        assert v == round(float(path.read_text()), 4)
    metrics = {}
    for r in (ran, handed):
        for mod, v in r["knn15"].items():
            metrics.setdefault(f"knn15/{mod}", []).append(v)
        for pair, v in r["retrieval_rank1"].items():
            metrics.setdefault(f"rank1/{pair}", []).append(v)
    assert json.loads((out_dir / "meanstd.json").read_text()) == json.loads(json.dumps(jax_aggregate(metrics)))
    assert (out_dir / "meanstd.xlsx").stat().st_size > 0
