#!/usr/bin/env python
"""Multi-seed experiment orchestration for the PyTorch/CUDA port.

The port's counterpart of ``scripts/sweep.py``: run a configuration of
``python -m acoustic_image_generation_tpu_torch.cli.main`` over N seeds,
read each run's best epoch from ``model.txt`` (``BestTracker``), test that
checkpoint (``--mode test --restore_checkpoint``), parse its
``test_accuracy.txt``, then report the trimmed mean +- std over the seeds
(one min and one max dropped, ``evaluation/aggregate.py``) into
``{checkpoint_dir}/{exp_name}_aggregate.json``. It imports nothing of JAX.

Usage:
    python scripts/sweep_torch.py --seeds 5 --checkpoint_dir ckpt \\
        --exp_name acres [--device cuda|cpu] -- --embedding 1 --mfcc 1 \\
        --train_file ... --valid_file ... --test_file ...
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_test_accuracy(text: str) -> dict:
    """Parse a ``test_accuracy*.txt`` line ("ts: exp - k: v - k: v ...")
    into {metric: float}."""
    results: dict = {}
    for part in text.split(" - "):
        if ":" in part:
            k, _, v = part.rpartition(":")
            try:
                results[k.strip().split()[-1]] = float(v)
            except ValueError:
                pass
    return results


def default_disk_store(flags: list[str], checkpoint_dir: str) -> list[str]:
    """With ``--cache_trunk_features`` on and no ``--cache_disk_dir``, put
    the cross-run disk tier of trunk features beside the checkpoints: every
    seed shares the frozen trunk and the window table, so seeds 1..N-1 skip
    the trunk."""
    try:
        i = flags.index("--cache_trunk_features")
        caching = i + 1 < len(flags) and flags[i + 1] not in ("0", "false")
    except ValueError:
        caching = False
    if caching and "--cache_disk_dir" not in flags:
        return [*flags, "--cache_disk_dir", os.path.join(checkpoint_dir, "_feature_store")]
    return list(flags)


def run_seed(seed: int, args, train_flags: list[str]) -> dict:
    """Train one seed, test its best epoch; its test metrics and best
    epoch."""
    from acoustic_image_generation_tpu_torch.train.checkpoint import BestTracker

    exp = f"{args.exp_name}_seed{seed}"
    base = [sys.executable, "-m", "acoustic_image_generation_tpu_torch.cli.main",
            "--checkpoint_dir", args.checkpoint_dir, "--exp_name", exp, "--seed", str(seed), *train_flags]
    if args.device:
        base += ["--device", args.device]
    subprocess.run([*base, "--mode", "train"], check=True, cwd=REPO)
    run_dir = os.path.join(args.checkpoint_dir, exp)
    best = BestTracker.read_best_epoch(run_dir)
    ckpt = os.path.join(run_dir, f"epoch_{best}.ckpt")
    subprocess.run([*base, "--mode", "test", "--restore_checkpoint", ckpt], check=True, cwd=REPO)
    results = {}
    test_file = os.path.join(run_dir, "test_accuracy.txt")
    if os.path.exists(test_file):
        with open(test_file) as f:
            results = parse_test_accuracy(f.read())
    results["best_epoch"] = best
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=5)
    parser.add_argument("--checkpoint_dir", required=True)
    parser.add_argument("--exp_name", required=True)
    parser.add_argument("--device", default=None, choices=["cuda", "cpu"],
                        help="passed to the CLI (its default: cuda)")
    parser.add_argument("train_flags", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    flags = default_disk_store([f for f in args.train_flags if f != "--"], args.checkpoint_dir)

    sys.path.insert(0, REPO)
    from acoustic_image_generation_tpu_torch.evaluation.aggregate import aggregate_runs

    per_seed: dict[str, list[float]] = {}
    for seed in range(args.seeds):
        results = run_seed(seed, args, flags)
        print(f"seed {seed}: {results}")
        for k, v in results.items():
            per_seed.setdefault(k, []).append(v)

    out = aggregate_runs(per_seed, os.path.join(args.checkpoint_dir, f"{args.exp_name}_aggregate.json"))
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
