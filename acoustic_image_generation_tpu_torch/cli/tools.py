"""Analysis tools of the port, as subcommands:

    python -m acoustic_image_generation_tpu_torch.cli.tools iou CHECKPOINT [--out_dir D] -- <main flags>
    python -m acoustic_image_generation_tpu_torch.cli.tools auc DIR
    python -m acoustic_image_generation_tpu_torch.cli.tools generate CHECKPOINT OUT_DIR \\
        [--set testing] [--energy] -- <main flags>

Counterparts of the JAX package's ``cli/tools.py`` subcommands of the same
names, with the same files (``intersection_{t}_accuracy.txt``,
``area.txt``, ``{set}_generated.npy``, ``{set}_labels.npy``,
``{set}_energy.npy``). ``<main flags>`` are ``cli.main``'s (``--device``
included); a subcommand's own options come before its positional
arguments. ``generate`` serves from a checkpoint; the JAX package's
``--artifact`` branch (a StableHLO serving artifact) waits for the serving
export (``ROADMAP.md`` Queue 1, item 8), and the other subcommands for
their modules.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _strip(train_flags):
    """Drop the ``--`` separator that ``argparse.REMAINDER`` keeps."""
    return [f for f in train_flags if f != "--"]


def _restored(args, split: str):
    """(config, task, trainer, loader) of a subcommand's main flags, the
    task restored from ``args.checkpoint``."""
    from acoustic_image_generation_tpu_torch.cli.main import build_parser, config_from_args, make_loader, select_task
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    main_args = build_parser().parse_args(_strip(args.train_flags))
    config = config_from_args(main_args)
    task = select_task(config, main_args.device)
    trainer = Trainer(task, config)
    loader = make_loader(config, split)
    if loader is None:
        raise SystemExit(f"no list file for the {split} split")
    trainer.restore(args.checkpoint, trainer.init_state())
    return config, task, trainer, loader


def cmd_iou(args) -> int:
    """Real-vs-generated energy IoU sweep over the test split: all 11
    thresholds from one generator pass, and the AUC."""
    from acoustic_image_generation_tpu_torch.evaluation.localize import run_iou_sweep

    config, task, trainer, loader = _restored(args, "testing")
    res = run_iou_sweep(task, loader, args.out_dir or trainer.run_dir, seed=config.run.seed)
    print(json.dumps({"auc": res["auc"], "fractions": {str(k): v for k, v in res["fractions"].items()}}))
    return 0


def cmd_auc(args) -> int:
    """The AUC of existing ``intersection_{t}_accuracy.txt`` files, written
    to ``area.txt``."""
    from acoustic_image_generation_tpu_torch.evaluation.iou import localization_auc

    fractions = {}
    for t in [round(0.1 * i, 1) for i in range(11)]:
        with open(os.path.join(args.dir, f"intersection_{t}_accuracy.txt")) as f:
            fractions[t] = float(f.read().split()[1])
    auc = localization_auc(fractions)
    with open(os.path.join(args.dir, "area.txt"), "w") as f:
        f.write(f"{auc:6f}")
    print(auc)
    return 0


def cmd_generate(args) -> int:
    """Generated acoustic images of a split, from (MFCC, video) with a
    trained checkpoint: ``{set}_generated.npy`` (N,36,48,C), its labels
    and, with ``--energy``, the ``find_logen`` energy maps. With
    ``--trunk_quant int8`` the trunk is calibrated on the first batch."""
    if args.artifact:
        raise NotImplementedError("--artifact needs the serving export, which is not ported "
                                  "(ROADMAP.md Queue 1, item 8)")
    import torch

    from acoustic_image_generation_tpu_torch.dsp.energy import find_logen
    from acoustic_image_generation_tpu_torch.train.trainer import as_raw, step_generator

    config, task, trainer, loader = _restored(args, args.set)
    outs, energies, labels = [], [], []
    for i, raw_batch in enumerate(loader.batches(0)):
        raw = as_raw(raw_batch)
        trainer._maybe_build_qtrunk(raw)
        with torch.no_grad():
            batch = trainer._prepare(raw)
            gen = task.generate(batch.mfcc, batch.video, generator=step_generator(config.run.seed, i, task.device),
                                qtrunk=trainer.qtrunk)
            energy = find_logen(gen) if args.energy else None
        n = raw_batch.valid * raw_batch.frames
        outs.append(gen[:n].cpu().numpy())
        if energy is not None:
            energies.append(energy[:n].cpu().numpy())
        labels.append(np.repeat(raw_batch.action[: raw_batch.valid], raw_batch.frames))
    if not outs:
        raise SystemExit(f"the {args.set} split has no batches")
    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir, f"{args.set}_generated.npy"), np.concatenate(outs))
    np.save(os.path.join(args.out_dir, f"{args.set}_labels.npy"), np.concatenate(labels))
    if args.energy:
        np.save(os.path.join(args.out_dir, f"{args.set}_energy.npy"), np.concatenate(energies))
    print(f"generated {sum(o.shape[0] for o in outs)} acoustic images -> {args.out_dir}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="aig-torch-tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("iou", help="energy-IoU threshold sweep + AUC")
    s.add_argument("checkpoint")
    s.add_argument("--out_dir", default=None)
    s.add_argument("train_flags", nargs=argparse.REMAINDER)
    s.set_defaults(fn=cmd_iou)

    s = sub.add_parser("auc", help="AUC from intersection_*.txt files")
    s.add_argument("dir")
    s.set_defaults(fn=cmd_auc)

    s = sub.add_parser("generate", help="serving: mfcc+video -> generated acoustic images")
    s.add_argument("checkpoint")
    s.add_argument("out_dir")
    s.add_argument("--set", default="testing", choices=["training", "validation", "testing"])
    s.add_argument("--energy", action="store_true", help="also write inverted spatial energy maps")
    s.add_argument("--artifact", default=None, help="a serving artifact dir: not ported, raises")
    s.add_argument("train_flags", nargs=argparse.REMAINDER)
    s.set_defaults(fn=cmd_generate)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
