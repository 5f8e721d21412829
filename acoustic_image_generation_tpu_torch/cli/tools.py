"""Analysis tools of the port, as subcommands:

    python -m acoustic_image_generation_tpu_torch.cli.tools iou CHECKPOINT [--out_dir D] -- <main flags>
    python -m acoustic_image_generation_tpu_torch.cli.tools auc DIR
    python -m acoustic_image_generation_tpu_torch.cli.tools generate CHECKPOINT OUT_DIR \\
        [--set testing] [--energy] [--artifact DIR] -- <main flags>
    python -m acoustic_image_generation_tpu_torch.cli.tools export-serving CHECKPOINT OUT_DIR \\
        [--energy] [--use_mean] [--spatial_shards N] [--batch poly|N] [--platforms cuda,cpu] -- <main flags>
    python -m acoustic_image_generation_tpu_torch.cli.tools serve ARTIFACT_DIR [--host H] [--port P] [--device cuda]
    python -m acoustic_image_generation_tpu_torch.cli.tools serve-info ARTIFACT_DIR [--json]
    python -m acoustic_image_generation_tpu_torch.cli.tools show CHECKPOINT OUT_DIR [--num_images 4] -- <main flags>
    python -m acoustic_image_generation_tpu_torch.cli.tools show-video CHECKPOINT OUT_DIR [--alpha 0.7] -- <main flags>
    python -m acoustic_image_generation_tpu_torch.cli.tools export-tf1 CHECKPOINT OUT_PATH -- <main flags>
    python -m acoustic_image_generation_tpu_torch.cli.tools extract CHECKPOINT OUT_DIR \\
        [--set testing] [--mean] -- <main flags>
    python -m acoustic_image_generation_tpu_torch.cli.tools knn TRAIN_DIR TEST_DIR [--set testing] [--k 15]
    python -m acoustic_image_generation_tpu_torch.cli.tools retrieve ANCHOR_DIR GALLERY_DIR \\
        [--set testing] [--num_classes 10]
    python -m acoustic_image_generation_tpu_torch.cli.tools aggregate FILE... [--out OUT.json|OUT.xlsx]
    python -m acoustic_image_generation_tpu_torch.cli.tools convert ROOT_RAW_DIR OUT_DIR [--modalities 1 2]
    python -m acoustic_image_generation_tpu_torch.cli.tools reshard LIST_FILE OUT_DIR
    python -m acoustic_image_generation_tpu_torch.cli.tools convert-flickr ROOT_RAW_DIR OUT_DIR [--modalities 1 2]
    python -m acoustic_image_generation_tpu_torch.cli.tools convert-ave ROOT_RAW_DIR OUT_DIR [--modalities 1 2]
    python -m acoustic_image_generation_tpu_torch.cli.tools convert-collected ROOT_RAW_DIR OUT_DIR [--modalities 1 2]

Counterparts of the JAX package's ``cli/tools.py`` subcommands of the same
names, with the same files (``intersection_{t}_accuracy.txt``,
``area.txt``, ``{set}_generated.npy``, ``{set}_labels.npy``,
``{set}_energy.npy``; the TF1 ``OUT_PATH.index`` and data shard;
``{set}_{modality}_{epoch}/`` feature directories, ``{set}_knn_value.txt``,
``{set}_retrieval.txt``; the serving artifact's ``weights.msgpack`` and
``manifest.json``; ``overlay_{i}.png``, ``channels_{i}.png`` and
``I_{n:06d}.png``). ``<main flags>`` are ``cli.main``'s (``--device``
included); ``knn``, ``retrieve`` and ``serve`` take ``--device`` themselves
(``cuda`` by default). A subcommand's own options come before its
positional arguments. ``generate --artifact DIR`` serves from a port
artifact (``core/serving.py``; the checkpoint positional is then ignored);
``export-serving`` writes one for the generation, classification,
embedding, projection and joint recipes; a generation artifact exported
with ``--spatial_shards N`` is served by ``serve`` and ``generate
--artifact`` on the first N CUDA devices, and refused where there are fewer
(the CPU is one device). ``show`` and ``show-video`` render
with matplotlib, which they import when they run. The converters
(``convert``, ``reshard``, ``convert-flickr``, ``convert-ave``,
``convert-collected``; ``data/convert.py``) run on the host in numpy and
print what JAX's print; video frames need Pillow, and ``--modalities 1``
converts audio without it.
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


def _restored(args, split: str | None):
    """(config, task, trainer, loader, state) of a subcommand's main flags,
    the task restored from ``args.checkpoint``; the loader of ``split``
    (None: no loader)."""
    from acoustic_image_generation_tpu_torch.cli.main import build_parser, config_from_args, make_loader, select_task
    from acoustic_image_generation_tpu_torch.train.trainer import Trainer

    main_args = build_parser().parse_args(_strip(args.train_flags))
    config = config_from_args(main_args)
    task = select_task(config, main_args.device)
    trainer = Trainer(task, config)
    loader = None if split is None else make_loader(config, split)
    if split is not None and loader is None:
        raise SystemExit(f"no list file for the {split} split")
    state = trainer.restore(args.checkpoint, trainer.init_state())
    return config, task, trainer, loader, state


def cmd_iou(args) -> int:
    """Real-vs-generated energy IoU sweep over the test split: all 11
    thresholds from one generator pass, and the AUC."""
    from acoustic_image_generation_tpu_torch.evaluation.localize import run_iou_sweep

    config, task, trainer, loader, _ = _restored(args, "testing")
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
    trained checkpoint, or with ``--artifact DIR`` from a serving artifact:
    ``{set}_generated.npy`` (N,36,48,C), its labels and, with ``--energy``,
    the ``find_logen`` energy maps. With ``--trunk_quant int8`` the trunk is
    calibrated on the first batch. Batch ``i``'s noise is
    ``step_generator(seed, i)``'s either way, so the artifact's images are
    the checkpoint's."""
    import torch

    from acoustic_image_generation_tpu_torch.dsp.energy import find_logen
    from acoustic_image_generation_tpu_torch.train.trainer import as_raw, step_generator

    if args.artifact:
        from acoustic_image_generation_tpu_torch.cli.main import build_parser, config_from_args, make_loader
        from acoustic_image_generation_tpu_torch.core.serving import load_artifact
        from acoustic_image_generation_tpu_torch.train.trainer import Trainer

        main_args = build_parser().parse_args(_strip(args.train_flags))
        config = config_from_args(main_args)
        model = load_artifact(args.artifact, device=main_args.device)
        if model.kind != "generation":
            print(f"--artifact points at a {model.kind} artifact; generate needs a generation one")
            return 2
        if args.energy and not model.manifest["energy"]:
            print("artifact was exported without --energy")
            return 2
        trainer, loader = Trainer(model.task, config), make_loader(config, args.set)
        if loader is None:
            raise SystemExit(f"no list file for the {args.set} split")

        def step(raw, i):
            with torch.no_grad():
                batch = trainer._prepare(raw)
            out = model.generate(batch.mfcc, batch.video, generator=step_generator(config.run.seed, i, model.device))
            return out if model.manifest["energy"] else (out, None)
    else:
        config, task, trainer, loader, _ = _restored(args, args.set)

        def step(raw, i):
            trainer._maybe_build_qtrunk(raw)
            with torch.no_grad():
                batch = trainer._prepare(raw)
                gen = task.generate(batch.mfcc, batch.video, generator=step_generator(config.run.seed, i, task.device),
                                    qtrunk=trainer.qtrunk)
                return gen.cpu().numpy(), find_logen(gen).cpu().numpy() if args.energy else None
    outs, energies, labels = [], [], []
    for i, raw_batch in enumerate(loader.batches(0)):
        gen, energy = step(as_raw(raw_batch), i)
        n = raw_batch.valid * raw_batch.frames
        outs.append(gen[:n])
        if args.energy:
            energies.append(energy[:n])
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


def cmd_export_serving(args) -> int:
    """A trained checkpoint as a serving artifact (``core/serving.py``):
    the recipe of the main flags picks the kind (the generator, with its
    calibrated int8 trunk under ``--trunk_quant int8``; DualCamNet; the
    embedding VAEs; the projection or joint model). An export the artifact
    cannot hold (``--energy`` on a 13-channel recipe, ``--fused_qgemm``,
    the plain joint variant, another platform) prints why and exits 2."""
    from acoustic_image_generation_tpu_torch.cli.main import make_loader
    from acoustic_image_generation_tpu_torch.core import serving
    from acoustic_image_generation_tpu_torch.train.classify import ClassificationTask
    from acoustic_image_generation_tpu_torch.train.embed import EmbedTask
    from acoustic_image_generation_tpu_torch.train.generation import GenerationTask
    from acoustic_image_generation_tpu_torch.train.joint import JointTask
    from acoustic_image_generation_tpu_torch.train.project import ProjectTask
    from acoustic_image_generation_tpu_torch.train.trainer import as_raw

    _, task, trainer, _, _ = _restored(args, None)
    kw = dict(batch=args.batch, platforms=tuple(args.platforms.split(",")))
    try:
        if isinstance(task, GenerationTask):
            if task.cfg.trunk_quant == "int8" and not task.cfg.fused_qgemm:
                loader = make_loader(trainer.config, "training")
                first = None if loader is None else next(iter(loader.batches(0)), None)
                if first is None:
                    print("no training batch to calibrate the int8 trunk on")
                    return 2
                trainer._maybe_build_qtrunk(as_raw(first))
            manifest = serving.export_generation(task, args.out_dir, energy=args.energy, qtrunk=trainer.qtrunk,
                                                 spatial_shards=args.spatial_shards,
                                                 external_weights=args.external_weights, **kw)
        elif isinstance(task, ClassificationTask):
            manifest = serving.export_classification(task, args.out_dir, **kw)
        elif isinstance(task, EmbedTask):
            manifest = serving.export_embedding(task, args.out_dir, use_mean=args.use_mean, **kw)
        elif isinstance(task, ProjectTask):
            manifest = serving.export_projection(task, args.out_dir, **kw)
        elif isinstance(task, JointTask):
            manifest = serving.export_joint(task, args.out_dir, **kw)
        else:
            print("export-serving supports the generation, classification, embedding, projection and joint "
                  f"recipes; the flags selected {type(task).__name__}")
            return 2
    except ValueError as e:
        print(f"export-serving: {e}")
        return 2
    print(f"exported {manifest['kind']} artifact: {manifest['weights_bytes']} weight bytes "
          f"(platforms {','.join(manifest['platforms'])}) -> {args.out_dir}")
    return 0


def cmd_serve(args) -> int:
    """Serve an artifact over HTTP (``core/server.py``): npz in and out,
    ``/manifest`` and ``/healthz``, one request at a time."""
    from acoustic_image_generation_tpu_torch.core.server import ArtifactServer

    try:
        server = ArtifactServer(args.artifact_dir, host=args.host, port=args.port,
                                max_body_bytes=args.max_body_mb << 20, device=args.device)
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        print(f"serve: {e}")
        return 2
    print(f"serving {server.model.kind} artifact on http://{server.host}:{server.port} (POST /call, GET /manifest)",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


def cmd_serve_info(args) -> int:
    """An artifact's manifest (kind, signature, platforms, digests, sizes),
    read without loading the weights."""
    path = os.path.join(args.artifact_dir, "manifest.json")
    if not os.path.exists(path):
        print(f"no manifest.json under {args.artifact_dir}")
        return 2
    with open(path) as f:
        manifest = json.load(f)
    if args.json:
        print(json.dumps(manifest, indent=2))
        return 0
    print(f"format:    {manifest.get('format')}")
    print(f"kind:      {manifest.get('kind', 'generation')}")
    print(f"platforms: {','.join(manifest.get('platforms', []))}")
    print(f"batch:     {manifest.get('batch')}")
    for name, shape in manifest.get("inputs", {}).items():
        print(f"input:     {name} {shape}")
    print(f"outputs:   {', '.join(manifest.get('outputs', []))}")
    for k in ("energy", "spatial_shards", "trunk_quant", "num_classes", "num_frames", "mfccmap", "latent_dim",
              "use_mean", "encoder_type", "fusion", "variant"):
        if k in manifest:
            print(f"{k + ':':<11}{manifest[k]}")
    if "model" in manifest:
        print(f"model:     {manifest['model'].get('task')}")
    print(f"weights:   sha256:{manifest.get('weights_sha256', '')[:16]}...")
    print(f"file:      weights.msgpack {manifest.get('weights_bytes', 0):,} bytes")
    return 0


def cmd_show(args) -> int:
    """Energy overlays and channel grids of the test split's first batch
    with a generation checkpoint: ``overlay_{i}.png`` (real, generated,
    union, intersection over the frame) and ``channels_{i}.png``."""
    from acoustic_image_generation_tpu_torch.evaluation.overlay import save_overlay_grid
    from acoustic_image_generation_tpu_torch.evaluation.plots import save_channel_grid
    from acoustic_image_generation_tpu_torch.evaluation.show_video import show_step
    from acoustic_image_generation_tpu_torch.train.trainer import as_raw, step_generator

    config, task, _, loader, _ = _restored(args, "testing")
    first = next(iter(loader.batches(0)), None)
    if first is None:
        print("the testing split has no batches")
        return 2
    out = show_step(task, as_raw(first), generator=step_generator(config.run.seed, 0, task.device))
    os.makedirs(args.out_dir, exist_ok=True)
    n = min(args.num_images, out["real"].shape[0])
    for h in range(n):
        save_overlay_grid(os.path.join(args.out_dir, f"overlay_{h}.png"), out["video"][h], out["real_mask"][h],
                          out["generated_mask"][h])
        save_channel_grid(os.path.join(args.out_dir, f"channels_{h}.png"), out["real"][h], out["generated"][h])
    print(f"wrote {2 * n} images to {args.out_dir}")
    return 0


def cmd_show_video(args) -> int:
    """Per-frame energy overlays over the whole test split, ``I_000001.png``
    on, ready for ``ffmpeg -i I_%06d.png out.mp4``."""
    from acoustic_image_generation_tpu_torch.evaluation.show_video import render_video_overlays

    config, task, _, loader, _ = _restored(args, "testing")
    paths = render_video_overlays(task, loader, args.out_dir, alpha=args.alpha, seed=config.run.seed)
    print(f"wrote {len(paths)} frames to {args.out_dir}")
    return 0


def cmd_export_tf1(args) -> int:
    """A trained checkpoint as a TF1 V2 checkpoint with the reference's
    variable names (``core/tf1_export.py``): the generator and trunk, the
    embedding VAEs or DualCamNet, and ``global_step``; the file restores in
    the reference's TF1 stack and in either package's ``.ckpt`` warm
    start."""
    from acoustic_image_generation_tpu_torch import bridge
    from acoustic_image_generation_tpu_torch.core.tf1_export import SCOPES, export_state

    _, task, _, _, state = _restored(args, None)
    params, stats = bridge.to_flax(task)
    skipped = sorted(set(params) - set(SCOPES))
    if skipped:
        print(f"skipping non-reference model keys: {skipped}")
    print(export_state(params, stats, args.out_path, global_step=state.step))
    return 0


def cmd_extract(args) -> int:
    """Per-second latents of a trained embedding, projection or joint model
    over a split, in the kNN and retrieval layout (``evaluation/export.py``),
    one directory per latent of the task's ``embeddings`` (``acoustic``,
    ``audio``, ``video``; the joint task's ``acoustic_true`` too): ``mean +
    std * eps`` (the batch's noise from a generator seeded with ``(0,
    batch)``), or the means with ``--mean``; on the task's device, batch by
    batch."""
    import torch

    from acoustic_image_generation_tpu_torch.evaluation.export import export_features
    from acoustic_image_generation_tpu_torch.train.trainer import as_raw, step_generator

    config, task, trainer, loader, _ = _restored(args, args.set)
    if not hasattr(task, "embeddings"):
        raise SystemExit("extract needs a task with embeddings (--embedding 1 without --mfcc, or with "
                         "--project 1 or --jointmvae 1)")
    feats: dict[str, list] = {}
    labels, scenario = [], []
    for i, raw_batch in enumerate(loader.batches(0)):
        with torch.no_grad():
            z = task.embeddings(trainer._prepare(as_raw(raw_batch), train=False), use_mean=args.mean,
                                generator=step_generator(0, i, task.device))
        n = raw_batch.valid
        for mod, arr in z.items():
            feats.setdefault(mod, []).append(arr[:n].cpu().numpy())
        labels.append(raw_batch.action[:n])
        scenario.append(raw_batch.location[:n])
    epoch = os.path.basename(args.checkpoint).split("_")[1].split(".")[0]
    for mod, arrs in feats.items():
        export_features(args.out_dir, args.set, mod, epoch, np.concatenate(arrs), np.concatenate(labels),
                        np.concatenate(scenario), config.data.num_classes, config.data.num_locations)
    print(f"exported {sorted(feats)} to {args.out_dir}")
    return 0


def cmd_knn(args) -> int:
    """15-NN accuracy of ``TEST_DIR``'s features against ``TRAIN_DIR``'s
    training features, written to ``{set}_knn_value.txt``."""
    from acoustic_image_generation_tpu_torch.evaluation.export import load_features
    from acoustic_image_generation_tpu_torch.evaluation.knn import knn_accuracy

    train_x, train_y, _ = load_features(args.train_dir, "training")
    test_x, test_y, _ = load_features(args.test_dir, args.set)
    acc = knn_accuracy(train_x, train_y, test_x, test_y, k=args.k, device=args.device)
    with open(os.path.join(args.test_dir, f"{args.set}_knn_value.txt"), "w") as f:
        f.write(f"{acc:6f}\n")
    print(acc)
    return 0


def cmd_retrieve(args) -> int:
    """Cross-modal ranks of ``ANCHOR_DIR``'s features against
    ``GALLERY_DIR``'s, written to ``{set}_retrieval.txt``."""
    from acoustic_image_generation_tpu_torch.evaluation.export import load_features
    from acoustic_image_generation_tpu_torch.evaluation.retrieve import retrieval_ranks

    anchors, a_labels, _ = load_features(args.anchor_dir, args.set)
    gallery, g_labels, _ = load_features(args.gallery_dir, args.set)
    res = retrieval_ranks(anchors, a_labels, gallery, g_labels, args.num_classes, device=args.device)
    ranks = {k: v for k, v in res.items() if k.startswith("rank")}
    with open(os.path.join(args.anchor_dir, f"{args.set}_retrieval.txt"), "w") as f:
        f.write(json.dumps(ranks, indent=2))
    print(json.dumps(ranks))
    return 0


def cmd_aggregate(args) -> int:
    """Trimmed mean +- std over seeds of the values in ``files``: lines of
    ``name value``, or bare values named by their file."""
    from acoustic_image_generation_tpu_torch.evaluation.aggregate import aggregate_runs

    metric_values: dict[str, list[float]] = {}
    for path in args.files:
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if len(parts) >= 2:
                    try:
                        metric_values.setdefault(parts[0], []).append(float(parts[-1]))
                        continue
                    except ValueError:
                        pass
                try:
                    metric_values.setdefault(os.path.basename(path), []).append(float(parts[-1]))
                except ValueError:
                    continue
    print(json.dumps(aggregate_runs(metric_values, args.out), indent=2, sort_keys=True))
    return 0


def cmd_convert(args) -> int:
    """Raw capture directories ``class_*/data_*`` -> shards and list files."""
    import glob as globmod

    from acoustic_image_generation_tpu_torch.data.convert import convert_capture_dir, write_list_files

    all_shards = []
    for raw_dir in sorted(globmod.glob(os.path.join(args.root_raw_dir, "class_*", "data_*"))):
        parts = raw_dir.rstrip("/").split("/")
        classes = int(parts[-2].split("_")[1])
        location = int(parts[-1].split("_")[1])
        shards = convert_capture_dir(raw_dir, args.out_dir, classes=classes, location=location,
                                     modalities=tuple(args.modalities))
        all_shards.extend(shards)
        print(f"{raw_dir}: {len(shards)} shards")
    print(json.dumps(write_list_files(args.out_dir, all_shards)))
    return 0


def cmd_reshard(args) -> int:
    """Rewrite a list's GZIP shards uncompressed."""
    from acoustic_image_generation_tpu_torch.data.convert import reshard

    print(reshard(args.list_file, args.out_dir))
    return 0


def cmd_convert_flickr(args) -> int:
    """FlickrSoundNet raw and its XML boxes -> shards and a test list."""
    from acoustic_image_generation_tpu_torch.data.convert import convert_flickr

    print(json.dumps({"testing": convert_flickr(args.root_raw_dir, args.out_dir, modalities=tuple(args.modalities))}))
    return 0


def cmd_convert_ave(args) -> int:
    """AVE captures with their event windows -> shards and list files."""
    from acoustic_image_generation_tpu_torch.data.convert import convert_ave, write_list_files

    shards = convert_ave(args.root_raw_dir, args.out_dir, modalities=tuple(args.modalities))
    print(json.dumps(write_list_files(args.out_dir, shards)))
    return 0


def cmd_convert_collected(args) -> int:
    """The 2-object collected set -> shards and a test list."""
    from acoustic_image_generation_tpu_torch.data.convert import convert_collected

    print(json.dumps({"testing": convert_collected(args.root_raw_dir, args.out_dir,
                                                   modalities=tuple(args.modalities))}))
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
    s.add_argument("--artifact", default=None,
                   help="serve from an export-serving artifact dir (the checkpoint positional is then ignored)")
    s.add_argument("train_flags", nargs=argparse.REMAINDER)
    s.set_defaults(fn=cmd_generate)

    s = sub.add_parser("export-serving", help="write a trained model as a serving artifact")
    s.add_argument("checkpoint")
    s.add_argument("out_dir")
    s.add_argument("--energy", action="store_true", help="generation: the find_logen energy map as a second output")
    s.add_argument("--use_mean", action="store_true", help="embedding: serve the latent means instead of sampled z")
    s.add_argument("--spatial_shards", type=int, default=1,
                   help="generation: split each request's video rows over N devices (at most 12)")
    s.add_argument("--batch", default="poly", help='"poly" (default, any batch size) or a fixed int')
    s.add_argument("--platforms", default="cuda,cpu", help="comma-separated platforms the artifact serves on")
    s.add_argument("--external_weights", action="store_true",
                   help="accepted for the JAX package's command line: the port's weights always sit beside the "
                        "manifest; refused beside --spatial_shards above 1, as in JAX")
    s.add_argument("train_flags", nargs=argparse.REMAINDER)
    s.set_defaults(fn=cmd_export_serving)

    s = sub.add_parser("serve", help="serve an artifact over HTTP (npz in/out)")
    s.add_argument("artifact_dir")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8321)
    s.add_argument("--max_body_mb", type=int, default=1024,
                   help="reject request bodies, and arrays as their headers declare them, larger than this (413)")
    s.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("serve-info", help="print a serving artifact's manifest")
    s.add_argument("artifact_dir")
    s.add_argument("--json", action="store_true", help="raw manifest JSON")
    s.set_defaults(fn=cmd_serve_info)

    s = sub.add_parser("show", help="energy overlay + channel-grid renders (matplotlib)")
    s.add_argument("checkpoint")
    s.add_argument("out_dir")
    s.add_argument("--num_images", type=int, default=4)
    s.add_argument("train_flags", nargs=argparse.REMAINDER)
    s.set_defaults(fn=cmd_show)

    s = sub.add_parser("show-video", help="per-frame energy-overlay renders over the test split (matplotlib)")
    s.add_argument("checkpoint")
    s.add_argument("out_dir")
    s.add_argument("--alpha", type=float, default=0.7)
    s.add_argument("train_flags", nargs=argparse.REMAINDER)
    s.set_defaults(fn=cmd_show_video)

    s = sub.add_parser("export-tf1", help="export a trained checkpoint as a reference TF1 .ckpt")
    s.add_argument("checkpoint")
    s.add_argument("out_path", help="TF checkpoint path prefix to write")
    s.add_argument("train_flags", nargs=argparse.REMAINDER)
    s.set_defaults(fn=cmd_export_tf1)

    s = sub.add_parser("extract", help="export latents for knn/retrieval")
    s.add_argument("checkpoint")
    s.add_argument("out_dir")
    s.add_argument("--set", default="testing", choices=["training", "validation", "testing"])
    s.add_argument("--mean", action="store_true", help="export latent means instead of sampled z")
    s.add_argument("train_flags", nargs=argparse.REMAINDER)
    s.set_defaults(fn=cmd_extract)

    s = sub.add_parser("knn", help="15-NN accuracy on exported latents")
    s.add_argument("train_dir")
    s.add_argument("test_dir")
    s.add_argument("--set", default="testing")
    s.add_argument("--k", type=int, default=15)
    s.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    s.set_defaults(fn=cmd_knn)

    s = sub.add_parser("retrieve", help="cross-modal rank-k retrieval")
    s.add_argument("anchor_dir")
    s.add_argument("gallery_dir")
    s.add_argument("--set", default="testing")
    s.add_argument("--num_classes", type=int, default=10)
    s.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    s.set_defaults(fn=cmd_retrieve)

    s = sub.add_parser("aggregate", help="multi-seed trimmed mean +- std")
    s.add_argument("files", nargs="+")
    s.add_argument("--out", default=None)
    s.set_defaults(fn=cmd_aggregate)

    s = sub.add_parser("convert", help="raw captures -> TFRecord shards")
    s.add_argument("root_raw_dir")
    s.add_argument("out_dir")
    s.add_argument("--modalities", nargs="*", type=int, default=[1, 2])
    s.set_defaults(fn=cmd_convert)

    s = sub.add_parser("reshard", help="rewrite shards uncompressed for ingest throughput")
    s.add_argument("list_file")
    s.add_argument("out_dir")
    s.set_defaults(fn=cmd_reshard)

    for name, fn, what in (("convert-flickr", cmd_convert_flickr, "FlickrSoundNet raw (+XML boxes)"),
                           ("convert-ave", cmd_convert_ave, "AVE captures (event windows)"),
                           ("convert-collected", cmd_convert_collected, "2-object collected set")):
        s = sub.add_parser(name, help=f"{what} -> TFRecord shards")
        s.add_argument("root_raw_dir")
        s.add_argument("out_dir")
        s.add_argument("--modalities", nargs="*", type=int, default=[1, 2])
        s.set_defaults(fn=fn)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
