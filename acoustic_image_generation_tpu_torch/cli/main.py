"""The experiment command line of the port:

    python -m acoustic_image_generation_tpu_torch.cli.main \\
        --mode train --embedding 1 --mfcc 1 --num_skip_conn 1 \\
        --train_file lists/training.txt --valid_file lists/validation.txt \\
        --batch_size 32 --num_epochs 50 --exp_name acres1 --checkpoint_dir ckpt
    python -m acoustic_image_generation_tpu_torch.cli.main --mode test \\
        --embedding 1 --mfcc 1 --test_file lists/testing.txt \\
        --exp_name acres1 --checkpoint_dir ckpt --restore_checkpoint ckpt/acres1/epoch_12.ckpt

Counterpart of ``acoustic_image_generation_tpu/cli/main.py``: every flag of
its parser with its default, mapped onto the port's ``ExperimentConfig``,
plus ``--device`` (``cuda``, the default, or ``cpu``; without a GPU the
default raises). The run directory, its files and its checkpoints are the
JAX package's, so either package can test or resume the other's runs.

Task dispatch, as JAX's ``select_task``: ``--embedding 1 --mfcc 1`` (the
AAAI'21 generator) runs ``GenerationTask``; ``--embedding 1`` alone the
embedding family's ``EmbedTask`` (its variant from ``--proxy``,
``--fusion``, ``--moddrop``, ``--l2``; 13 acoustic channels with
``--datatype music``); ``--model DualCamNet`` runs ``CorrespondenceTask``
with ``--correspondence 1``, else ``ClassificationTask`` with ``--mfcc 1``
(real images, or the tiled MFCC map with ``--mfccmap 1``), else
``GeneratedClassificationTask`` (DualCamNet on the frozen generator's
images). With ``--embedding 1``, ``--project 1`` runs ``ProjectTask`` (its
wiring from ``--encoder_type`` and ``--fusion``, its alignment from
``--l2``) and ``--jointmvae 1`` ``JointTask`` (``--fusion``,
``--onlyaudiovideo``, ``--moddrop``), both ahead of ``--mfcc``; without
``--embedding``, ``--model UNet`` runs ``ReconstructTask`` on the modality
of ``--encoder_type`` (``Ac``, ``Energy``, ``Audio``, ``Video``).

One flag sets a ``DataConfig`` field that JAX's parser leaves at its
default: ``--normalize_spectrogram 1`` (the embedding task's z-normalized
spectrograms, with the statistics of ``stats2s`` beside ``--train_file``).

Devices, as JAX's ``--num_devices`` (its one process over N devices): every
task trains and tests on N ranks, one process a device
(``parallel/mesh.py``), each rank on its rows of every ``--batch_size``
batch. ``--num_devices N > 1`` starts the N ranks itself (``cuda:0`` to
``cuda:N-1`` over NCCL, or N CPU ranks over gloo with ``--device cpu``; more
than the visible GPUs raise); unset, it takes every visible GPU on
``cuda``, as JAX's ``make_mesh`` takes every device, and one device on the
CPU. Under ``torchrun``
each process is the rank its environment names. Each rank's loader
decodes only its rows: a rank is one process, so the host sharding that
JAX's ``--host_shard 1`` asks of a multi-host run is the port's one layout,
and the flag is accepted for JAX's recipes. As JAX's parser, this one has
no tensor-parallel flag: a configuration that carries
``parallel.tensor_parallel = tp`` lays the N ranks of any task out as its ``(N // tp,
tp)`` grid, each rank's loader decoding its data rank's rows, and an N that
``tp`` does not divide raises before any rank starts.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from acoustic_image_generation_tpu_torch.core.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    ParallelConfig,
    RunConfig,
    classify_config,
    embed_config,
    generation_config,
    joint_config,
    project_config,
    reconstruct_config,
)
from acoustic_image_generation_tpu_torch.parallel import mesh


def _resnet_units(s: str) -> tuple[int, ...]:
    """argparse type for --resnet_units: exactly 4 positive ints."""
    try:
        units = tuple(int(u) for u in s.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(f"not a comma-separated int list: {s!r}")
    if len(units) != 4 or any(u < 1 for u in units):
        raise argparse.ArgumentTypeError(f"--resnet_units needs 4 positive ints (e.g. 3,4,6,3), got {s!r}")
    return units


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="acoustic_image_generation_tpu_torch",
        description="acoustic-image generation on PyTorch and CUDA",
    )
    # mode / model selection
    p.add_argument("--mode", default="train", choices=["train", "test"])
    p.add_argument("--model", default="UNet", choices=["UNet", "DualCamNet"])
    p.add_argument("--encoder_type", default="Video", choices=["Video", "Audio", "Ac", "Energy"])
    p.add_argument("--embedding", type=int, default=0)
    p.add_argument("--mfcc", type=int, default=0)
    p.add_argument("--mfccmap", type=int, default=0)
    p.add_argument("--num_skip_conn", type=int, default=1, choices=[0, 1, 2])
    p.add_argument("--ae", type=int, default=0)
    p.add_argument("--resnet_units", type=_resnet_units, default=(3, 4, 6, 3))
    p.add_argument("--proxy", type=int, default=0)
    p.add_argument("--fusion", type=int, default=0)
    p.add_argument("--moddrop", type=int, default=0)
    p.add_argument("--l2", type=int, default=0)
    p.add_argument("--project", type=int, default=0)
    p.add_argument("--jointmvae", type=int, default=0)
    p.add_argument("--onlyaudiovideo", type=int, default=0)
    p.add_argument("--correspondence", type=int, default=0)
    p.add_argument("--temporal_pooling", type=int, default=0)
    p.add_argument("--num_class", type=int, default=128)
    # data
    p.add_argument("--datatype", default="outdoor", choices=["outdoor", "old", "music"])
    p.add_argument("--train_file", default=None)
    p.add_argument("--valid_file", default=None)
    p.add_argument("--test_file", default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--sample_length", type=int, default=1)
    p.add_argument("--total_length", type=int, default=30)
    p.add_argument("--number_of_crops", type=int, default=30)
    p.add_argument("--buffer_size", type=int, default=100)
    p.add_argument("--block_size", type=int, default=1)
    p.add_argument("--normalize_spectrogram", type=int, default=0,
                   help="embedding task: z-normalize the spectrograms with the statistics of stats2s "
                        "beside --train_file")
    # optimization
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--latent_loss", type=float, default=1e-6)
    p.add_argument("--margin", type=float, default=0.2)
    p.add_argument("--MSE", type=int, default=1)
    p.add_argument("--huber_loss", type=int, default=1)
    p.add_argument("--bce_loss", type=int, default=0)
    # bookkeeping
    p.add_argument("--exp_name", default="exp")
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--tensorboard", default=None)
    p.add_argument("--init_checkpoint", default=None)
    p.add_argument("--acoustic_init_checkpoint", default=None)
    p.add_argument("--audio_init_checkpoint", default=None)
    p.add_argument("--visual_init_checkpoint", default=None)
    p.add_argument("--restore_checkpoint", default=None)
    p.add_argument("--display_freq", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--num_devices", type=int, default=None)
    # the frozen trunk and its feature cache
    p.add_argument("--trunk_bn", default="train", choices=["train", "frozen"])
    p.add_argument("--cache_trunk_features", type=int, default=0)
    p.add_argument("--trunk_quant", default="none", choices=["none", "int8"])
    p.add_argument("--cache_disk_dir", default=None, help="cross-run disk tier for cached trunk features")
    p.add_argument("--cache_features_dtype", default="bf16", choices=["bf16", "f8_e4m3"],
                   help="storage dtype for cached trunk features (f8_e4m3 halves every cache tier's footprint)")
    p.add_argument("--fused_conv", type=int, default=0,
                   help="accepted for the JAX package's recipes; on the card the port always runs the "
                        "generator's 3x3 conv pairs on its conv_chain CUDA kernels")
    p.add_argument("--fused_qgemm", type=int, default=0,
                   help="with --trunk_quant int8: every 1x1 trunk conv on the qgemm_s8 CUDA kernel "
                        "(conv+dequant+residual+ReLU+requant in one kernel)")
    p.add_argument("--host_shard", type=int, default=0,
                   help="accepted for the JAX package's recipes; on more than one rank each rank's loader "
                        "always decodes only its rows")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: cuda (raises without a GPU) or cpu (the kernels' plain versions)")
    return p


def config_from_args(args) -> ExperimentConfig:
    return ExperimentConfig(
        data=DataConfig(
            datatype=args.datatype,
            train_file=args.train_file,
            valid_file=args.valid_file,
            test_file=args.test_file,
            batch_size=args.batch_size,
            sample_length=args.sample_length,
            total_length=args.total_length,
            number_of_crops=args.number_of_crops,
            buffer_size=args.buffer_size,
            block_size=args.block_size,
            normalize_spectrogram=bool(args.normalize_spectrogram),
            correspondence=bool(args.correspondence),
            host_shard=bool(args.host_shard),
        ),
        model=ModelConfig(
            model=args.model,
            encoder_type=args.encoder_type,
            embedding=bool(args.embedding),
            mfcc=bool(args.mfcc),
            mfccmap=bool(args.mfccmap),
            num_skip_conn=args.num_skip_conn,
            ae=bool(args.ae),
            resnet_units=args.resnet_units,
            proxy=bool(args.proxy),
            fusion=bool(args.fusion),
            moddrop=bool(args.moddrop),
            l2=bool(args.l2),
            project=bool(args.project),
            jointmvae=bool(args.jointmvae),
            onlyaudiovideo=bool(args.onlyaudiovideo),
            correspondence=bool(args.correspondence),
            temporal_pooling=bool(args.temporal_pooling),
            num_class=args.num_class,
            trunk_bn=args.trunk_bn,
            cache_trunk_features=bool(args.cache_trunk_features),
            trunk_quant=args.trunk_quant,
            cache_disk_dir=args.cache_disk_dir,
            cache_features_dtype=args.cache_features_dtype,
            fused_conv=bool(args.fused_conv),
            fused_qgemm=bool(args.fused_qgemm),
        ),
        optim=OptimConfig(
            learning_rate=args.learning_rate,
            num_epochs=args.num_epochs,
            latent_loss=args.latent_loss,
            margin=args.margin,
            mse=bool(args.MSE),
            huber=bool(args.huber_loss),
            bce=bool(args.bce_loss),
        ),
        run=RunConfig(
            mode=args.mode,
            exp_name=args.exp_name,
            checkpoint_dir=args.checkpoint_dir,
            tensorboard=args.tensorboard,
            init_checkpoint=args.init_checkpoint,
            acoustic_init_checkpoint=args.acoustic_init_checkpoint,
            audio_init_checkpoint=args.audio_init_checkpoint,
            visual_init_checkpoint=args.visual_init_checkpoint,
            restore_checkpoint=args.restore_checkpoint,
            display_freq=args.display_freq,
            seed=args.seed,
        ),
        parallel=ParallelConfig(compute_dtype=args.compute_dtype, num_devices=args.num_devices),
    )


def task_config(config: ExperimentConfig):
    """``(the task's module and class name, its configuration)``; the
    configuration functions raise for what the port does not run."""
    m = config.model
    train = "acoustic_image_generation_tpu_torch.train."
    if m.embedding and m.project:
        return (train + "project", "ProjectTask"), project_config(config)
    if m.embedding and m.jointmvae:
        return (train + "joint", "JointTask"), joint_config(config)
    if m.embedding and m.mfcc:
        return (train + "generation", "GenerationTask"), generation_config(config)
    if m.embedding:
        return (train + "embed", "EmbedTask"), embed_config(config)
    if m.model == "UNet":
        return (train + "reconstruct", "ReconstructTask"), reconstruct_config(config)
    if config.data.correspondence:
        return (train + "classify", "CorrespondenceTask"), classify_config(config)
    if m.mfcc:
        return (train + "classify", "ClassificationTask"), classify_config(config)
    return (train + "classify", "GeneratedClassificationTask"), classify_config(config, generated=True)


def select_task(config: ExperimentConfig, device: str = "cuda"):
    """The task of the experiment on ``device``, its weights random from
    ``run.seed`` (JAX's trainer initializes from that seed too, with its own
    generator)."""
    import importlib

    (module, name), cfg = task_config(config)
    return getattr(importlib.import_module(module), name)(cfg, device=device).init_params(config.run.seed)


def make_loader(config: ExperimentConfig, split: str):
    """The split's ``AcousticImageDataLoader``, or None without its list.
    On more than one rank it decodes this rank's rows of every batch
    (``shard_index``/``shard_count``): its data rank's, after the
    ``Trainer`` has laid the ranks out as a grid."""
    from acoustic_image_generation_tpu_torch.data.pipeline import AcousticImageDataLoader

    path = {"training": config.data.train_file, "validation": config.data.valid_file,
            "testing": config.data.test_file}[split]
    if path is None:
        return None
    return AcousticImageDataLoader(path, split, config.data.batch_size, sample_length=config.data.sample_length,
                                   datakind=config.data.datatype, seed=config.run.seed,
                                   shard_index=mesh.data_rank(), shard_count=mesh.data_world())


def num_devices(config: ExperimentConfig, device: str) -> int:
    """``parallel.num_devices``, or unset: every visible GPU on ``cuda``,
    else one."""
    if config.parallel.num_devices is not None:
        return config.parallel.num_devices
    if device == "cuda" and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def _rank_main(argv: list) -> int:
    """One rank of ``main``'s N (``mesh.launch`` has set up its group)."""
    args = build_parser().parse_args(argv)
    return run(args, mesh.device())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    env = mesh.from_env()
    if env is not None:  # torchrun: this process is one rank of its group
        rank, world, local_rank = env
        dev = mesh.setup(rank, world, device=args.device, local_rank=local_rank, init_method="env://")
        try:
            return run(args, dev)
        finally:
            mesh.teardown()
    config = config_from_args(args)
    n = num_devices(config, args.device)
    if n > 1:
        task_config(dataclasses.replace(config, parallel=dataclasses.replace(config.parallel, num_devices=n)))
        mesh.launch(_rank_main, n, list(sys.argv[1:] if argv is None else argv), device=args.device)
        return 0
    return run(args, args.device)


def run(args, device) -> int:
    """``main``'s work on ``device``, in one process or as one rank."""
    config = config_from_args(args)
    if mesh.world() > 1:
        config = dataclasses.replace(config, parallel=dataclasses.replace(config.parallel, num_devices=mesh.world()))
    task = select_task(config, device)

    from acoustic_image_generation_tpu_torch.train.trainer import Trainer
    from acoustic_image_generation_tpu_torch.train.warmstart import apply_init_checkpoints

    trainer = Trainer(task, config)
    run = config.run
    if run.mode == "train":
        train_loader = make_loader(config, "training")
        valid_loader = make_loader(config, "validation")
        if train_loader is None or valid_loader is None:
            raise SystemExit("train mode needs --train_file and --valid_file")
        state = None
        if run.restore_checkpoint or run.init_checkpoint or any(
            (run.visual_init_checkpoint, run.acoustic_init_checkpoint, run.audio_init_checkpoint)
        ):
            state = trainer.init_state()
            if run.restore_checkpoint:  # the full resume: parameters, Adam slots, step
                state = trainer.restore(run.restore_checkpoint, state)
            state = apply_init_checkpoints(state, config)
        trainer.fit(train_loader, valid_loader, state=state)
    else:
        test_loader = make_loader(config, "testing")
        if test_loader is None:
            raise SystemExit("test mode needs --test_file")
        ckpt_path = run.init_checkpoint or run.restore_checkpoint
        if not ckpt_path:
            raise SystemExit("test mode needs --init_checkpoint or --restore_checkpoint")
        state = trainer.restore(ckpt_path, trainer.init_state())
        results = trainer.test(state, test_loader)
        if mesh.is_main():
            print(results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
