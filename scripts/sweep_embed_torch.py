#!/usr/bin/env python
"""Multi-seed embedding sweep of the PyTorch/CUDA port, with the trimmed
aggregation of the reference's reporting protocol.

The port's counterpart of ``scripts/sweep_embed.py``: each seed runs the
port's embedding workflow from the command line, each step a fresh
process (``python -m acoustic_image_generation_tpu_torch.cli.main --mode
train --embedding 1``, then ``cli.tools extract`` of the training and test
sets at the best epoch, ``knn`` (k = 15) of each modality and ``retrieve``
for video->acoustic, audio->acoustic and video->audio), and writes
``seed_{S}.json``: ``knn15`` per modality and ``retrieval_rank1`` per pair,
the keys of ``scripts/study_embed.py``, rounded to 4 places, with its
``seed``, ``epochs`` and ``wall_s``. A seed whose file is complete and
matches (seed, epochs, both keys) is reused, not run again. The seeds'
values are aggregated (one min and one max dropped,
``evaluation/aggregate.py``) into ``meanstd.json`` and ``meanstd.xlsx``.
It imports nothing of JAX.

    AIG_SWEEP_SEEDS=0,1,2,3,4 AIG_EMBED_EPOCHS=120 AIG_SWEEP_DIR=out \\
        python scripts/sweep_embed_torch.py -- --train_file ... --valid_file ... \\
        --test_file ... [--device cpu] [other cli.main flags]

The flags after ``--`` go to every ``cli.main`` run and ``extract`` (the
data, the device, the dtype); ``knn`` and ``retrieve`` take their
``--device`` and the data's class count from them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

SEEDS = [int(s) for s in os.environ.get("AIG_SWEEP_SEEDS", "0,1,2,3,4").split(",")]
EPOCHS = int(os.environ.get("AIG_EMBED_EPOCHS", "120"))
OUT_DIR = os.environ.get("AIG_SWEEP_DIR", os.path.join(REPO, "build", "embed_sweep"))
MODALITIES = ("acoustic", "audio", "video")
PAIRS = (("video", "acoustic"), ("audio", "acoustic"), ("video", "audio"))
K = 15


def load_seed(path: str, seed: int, epochs: int | None = None):
    """A cached seed result, only if it is complete and matches (``epochs``:
    ``AIG_EMBED_EPOCHS`` unless given)."""
    epochs = EPOCHS if epochs is None else epochs
    try:
        with open(path) as f:
            r = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(r, dict) or r.get("seed") != seed or r.get("epochs") != epochs:
        return None
    if "knn15" not in r or "retrieval_rank1" not in r:
        return None
    return r


def _run(*argv) -> None:
    subprocess.run([sys.executable, "-m", *argv], check=True, cwd=REPO)


def run_seed(seed: int, flags: list[str]) -> dict:
    """Train, extract, kNN and retrieval for one seed, from the command
    line; the seed's result."""
    from acoustic_image_generation_tpu_torch.cli.main import build_parser, config_from_args
    from acoustic_image_generation_tpu_torch.train.checkpoint import BestTracker

    t0 = time.time()
    main_args = build_parser().parse_args(flags)
    device, num_classes = main_args.device, config_from_args(main_args).data.num_classes
    runs, exp = os.path.join(OUT_DIR, "runs"), f"embed_seed{seed}"
    main_flags = ["--checkpoint_dir", runs, "--exp_name", exp, "--seed", str(seed), *flags]
    _run("acoustic_image_generation_tpu_torch.cli.main", "--mode", "train", "--num_epochs", str(EPOCHS), *main_flags)
    run_dir = os.path.join(runs, exp)
    best = BestTracker.read_best_epoch(run_dir)
    ckpt = os.path.join(run_dir, f"epoch_{best}.ckpt")
    feats = os.path.join(OUT_DIR, f"features_seed{seed}")
    tools = "acoustic_image_generation_tpu_torch.cli.tools"
    for split in ("training", "testing"):
        _run(tools, "extract", "--set", split, ckpt, feats, "--", *main_flags)
    results = {"knn15": {}, "retrieval_rank1": {}}
    for mod in MODALITIES:
        test_dir = os.path.join(feats, f"testing_{mod}_{best}")
        _run(tools, "knn", "--k", str(K), "--device", device, os.path.join(feats, f"training_{mod}_{best}"), test_dir)
        with open(os.path.join(test_dir, "testing_knn_value.txt")) as f:
            results["knn15"][mod] = round(float(f.read()), 4)
    for a, g in PAIRS:
        anchor = os.path.join(feats, f"testing_{a}_{best}")
        _run(tools, "retrieve", "--num_classes", str(num_classes), "--device", device, anchor,
             os.path.join(feats, f"testing_{g}_{best}"))
        with open(os.path.join(anchor, "testing_retrieval.txt")) as f:
            results["retrieval_rank1"][f"{a}->{g}"] = round(json.load(f)["rank1"], 4)
    results.update(epochs=EPOCHS, seed=seed, wall_s=round(time.time() - t0, 1))
    return results


def main(argv=None) -> int:
    from acoustic_image_generation_tpu_torch.evaluation.aggregate import aggregate_runs

    flags = ["--embedding", "1", *(f for f in (sys.argv[1:] if argv is None else argv) if f != "--")]
    os.makedirs(OUT_DIR, exist_ok=True)
    runs = []
    for seed in SEEDS:
        out = os.path.join(OUT_DIR, f"seed_{seed}.json")
        r = load_seed(out, seed)
        if r is None:
            print(f"--- seed {seed}", flush=True)
            with open(out, "w") as f:
                json.dump(run_seed(seed, flags), f)
            r = load_seed(out, seed)
            if r is None:
                raise RuntimeError(f"seed {seed} produced no valid result at {out}")
        runs.append(r)

    metrics: dict[str, list[float]] = {}
    for r in runs:
        for mod, v in r["knn15"].items():
            metrics.setdefault(f"knn15/{mod}", []).append(v)
        for pair, v in r["retrieval_rank1"].items():
            metrics.setdefault(f"rank1/{pair}", []).append(v)
    agg = aggregate_runs(metrics, os.path.join(OUT_DIR, "meanstd.json"))
    aggregate_runs(metrics, os.path.join(OUT_DIR, "meanstd.xlsx"))
    print(json.dumps(agg, indent=1, sort_keys=True), flush=True)
    print(f"artifacts: {OUT_DIR}/meanstd.json, {OUT_DIR}/meanstd.xlsx", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
