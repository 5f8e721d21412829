"""The experiment configuration: the counterpart of
``acoustic_image_generation_tpu/core/config.py``.

The same five dataclasses with the same fields and defaults, and the same
JSON form (``to_json``: ``indent=2``, ``sort_keys=True``), so a
``configuration.txt`` written by either package loads in the other.
``generation_config`` builds the port's ``GenerationConfig`` (the fields the
generation task and its train step read) from an ``ExperimentConfig``,
``classify_config`` the classification tasks' ``ClassifyConfig``,
``embed_config`` the embedding task's ``EmbedConfig``, and
``reconstruct_config``, ``project_config`` and ``joint_config`` the
reconstruction, projection and joint tasks' configurations.

Fields the port reads as JAX does: the data fields the loader takes
(``datatype``, ``train_file``/``valid_file``/``test_file``, ``batch_size``,
``sample_length``), the model, optimizer and run fields. Fields it keeps
only to carry them: the TPU-only ``pallas_mfcc`` and ``fused_conv`` (on the
card the port always runs the MFCC frontend and the generator's conv pairs
on its CUDA kernels), and the loader's tuning fields. ``ParallelConfig``'s
``num_devices`` and ``fsdp`` train the generation task on that many ranks
(``parallel/mesh.py``; ``cli/main.py`` starts them). ``tensor_parallel >
1`` raises, and so do the other tasks at more than one device or with
FSDP, each with its reason (``ROADMAP.md`` Queue 1, item 8.1, second half).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any

from acoustic_image_generation_tpu_torch.train.classify import ClassificationTask, ClassifyConfig
from acoustic_image_generation_tpu_torch.train.embed import EmbedConfig, EmbedTask
from acoustic_image_generation_tpu_torch.train.generation import CORRESPONDENCE_ONE_DEVICE, GenerationConfig
from acoustic_image_generation_tpu_torch.train.joint import JointConfig, JointTask
from acoustic_image_generation_tpu_torch.train.project import ProjectConfig, ProjectTask
from acoustic_image_generation_tpu_torch.train.reconstruct import ReconstructConfig, ReconstructTask


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection and input-pipeline options."""

    datatype: str = "outdoor"  # outdoor | old | music
    train_file: str | None = None
    valid_file: str | None = None
    test_file: str | None = None
    batch_size: int = 8
    sample_length: int = 1  # seconds per clip window
    total_length: int = 30
    number_of_crops: int = 30
    buffer_size: int = 100
    block_size: int = 1
    sample_rate: int = 12288
    shuffle_train: bool = True
    normalize_spectrogram: bool = False
    correspondence: bool = False
    correspondence_video: bool = False
    random_pick: bool = False
    build_spectrogram: bool = True
    # modalities: 0 = acoustic images, 1 = audio samples, 2 = video
    modalities: tuple[int, ...] = (0, 1, 2)
    num_io_threads: int = 8
    prefetch_batches: int = 2
    pallas_mfcc: bool = False  # the JAX package's TPU kernel switch; the port's card path always runs mfcc.cu
    stats_dir: str | None = None
    host_shard: bool = False  # JAX's multi-host switch; the port's ranks always decode their own rows only

    @property
    def nr_frames(self) -> int:
        return self.block_size * self.sample_length

    @property
    def num_classes(self) -> int:
        return {"outdoor": 10, "old": 14, "music": 9}[self.datatype]

    @property
    def num_locations(self) -> int:
        return {"outdoor": 61, "old": 3, "music": 11}[self.datatype]

    @property
    def num_channels(self) -> int:
        return {"outdoor": 12, "old": 12, "music": 13}[self.datatype]


@dataclass(frozen=True)
class ModelConfig:
    """Model selection; the generation fields as ``GenerationConfig``
    documents them."""

    model: str = "UNet"  # UNet | DualCamNet
    encoder_type: str = "Video"  # Energy | Video | Ac | Audio
    embedding: bool = False
    mfcc: bool = False
    mfccmap: bool = False
    num_skip_conn: int = 1  # 0 | 1 | 2 skip connections in UNetAcResNet
    ae: bool = False  # deterministic autoencoder instead of VAE
    proxy: bool = False
    fusion: bool = False
    moddrop: bool = False
    l2: bool = False
    project: bool = False
    jointmvae: bool = False
    onlyaudiovideo: bool = False
    correspondence: bool = False
    temporal_pooling: bool = False
    num_class: int = 128
    resnet_units: tuple[int, int, int, int] = (3, 4, 6, 3)
    trunk_bn: str = "train"  # train | frozen
    cache_trunk_features: bool = False
    cache_device_bytes: int = 4 << 30
    cache_eval_bytes: int = 8 << 30
    cache_disk_dir: str | None = None
    cache_disk_bytes: int = 256 << 30
    cache_features_dtype: str = "bf16"  # bf16 | f8_e4m3
    trunk_quant: str = "none"  # none | int8
    fused_conv: bool = False  # the JAX package's TPU kernel switch; the port's card path always runs conv_chain.cu
    fused_qgemm: bool = False


@dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 1e-4
    num_epochs: int = 100
    latent_loss: float = 1e-6
    margin: float = 0.2
    mse: bool = True
    huber: bool = True
    bce: bool = False
    resnet_weight_decay: float = 5e-4
    tf1_adam: bool = True  # False: optax.adam's numerics (train/optim.py::Adam)


@dataclass(frozen=True)
class RunConfig:
    mode: str = "train"  # train | test
    exp_name: str = "exp"
    checkpoint_dir: str = "checkpoints"
    tensorboard: str | None = None
    init_checkpoint: str | None = None
    acoustic_init_checkpoint: str | None = None
    audio_init_checkpoint: str | None = None
    visual_init_checkpoint: str | None = None
    restore_checkpoint: str | None = None
    display_freq: int = 1
    seed: int = 0
    # write the epoch snapshots on a background thread (train/checkpoint.py
    # AsyncCheckpointer): a device copy of the state while a write is out
    async_checkpoint: bool = True


@dataclass(frozen=True)
class ParallelConfig:
    data_axis: str = "data"
    num_devices: int | None = None  # None: every visible device for the tasks that take more, else one
    compute_dtype: str = "float32"  # or "bfloat16"
    fsdp: bool = False
    tensor_parallel: int = 1


@dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    run: RunConfig = field(default_factory=RunConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def save(self, path: str) -> None:
        """Write ``configuration.txt``."""
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "ExperimentConfig":
        return ExperimentConfig(
            data=_build(DataConfig, d.get("data", {})),
            model=_build(ModelConfig, d.get("model", {})),
            optim=_build(OptimConfig, d.get("optim", {})),
            run=_build(RunConfig, d.get("run", {})),
            parallel=_build(ParallelConfig, d.get("parallel", {})),
        )

    @staticmethod
    def load(path: str) -> "ExperimentConfig":
        with open(path) as f:
            return ExperimentConfig.from_dict(json.load(f))


def _build(cls, values: dict):
    """``cls(**values)`` with JSON's lists back as the tuples the tuple
    fields hold."""
    tuples = {f.name for f in dataclasses.fields(cls) if str(f.type).startswith("tuple")}
    return cls(**{k: tuple(v) if k in tuples and isinstance(v, list) else v for k, v in values.items()})


SECOND_HALF = "ROADMAP.md Queue 1, item 8.1, second half"


def refuse_tensor_parallel(config: ExperimentConfig) -> None:
    if config.parallel.tensor_parallel > 1:
        raise NotImplementedError(f"tensor_parallel > 1 is not ported: the port splits a task's batch (num_devices) "
                                  f"and shards its weights (fsdp) only ({SECOND_HALF})")


def parallel(config: ExperimentConfig) -> bool:
    """Whether the experiment asks for more than one device or for FSDP."""
    return (config.parallel.num_devices or 1) > 1 or config.parallel.fsdp


def generation_config(config: ExperimentConfig) -> GenerationConfig:
    """The port's ``GenerationConfig`` of an experiment. Raises for what
    the port does not run: tensor parallelism, and the correspondence
    augmentation on more than one device. ``optim.tf1_adam`` and
    ``parallel`` are the trainer's (``Trainer``)."""
    refuse_tensor_parallel(config)
    if parallel(config) and config.data.correspondence:
        raise NotImplementedError(f"{CORRESPONDENCE_ONE_DEVICE} ({SECOND_HALF})")
    m, o = config.model, config.optim
    return GenerationConfig(
        num_skip_conn=m.num_skip_conn,
        ae=m.ae,
        resnet_units=tuple(m.resnet_units),
        trunk_bn=m.trunk_bn,
        trunk_quant=m.trunk_quant,
        fused_qgemm=m.fused_qgemm,
        correspondence=config.data.correspondence,
        correspondence_video=config.data.correspondence_video,
        datatype=config.data.datatype,
        compute_dtype=config.parallel.compute_dtype,
        learning_rate=o.learning_rate,
        latent_loss=o.latent_loss,
        mse=o.mse,
        huber=o.huber,
        bce=o.bce,
        resnet_weight_decay=o.resnet_weight_decay,
        seed=config.run.seed,
        cache_trunk_features=m.cache_trunk_features,
        cache_device_bytes=m.cache_device_bytes,
        cache_eval_bytes=m.cache_eval_bytes,
        cache_disk_dir=m.cache_disk_dir,
        cache_disk_bytes=m.cache_disk_bytes,
        cache_features_dtype=m.cache_features_dtype,
    )


def classify_config(config: ExperimentConfig, *, generated: bool = False) -> ClassifyConfig:
    """The port's ``ClassifyConfig`` of an experiment (classes and channels
    by ``data.datatype``); ``generated`` adds the frozen generator's
    ``GenerationConfig``. Raises at more than one device (``one_device``)."""
    one_device(config, ClassificationTask)
    gen = generation_config(config)
    d = config.data
    return ClassifyConfig(
        num_classes=d.num_classes,
        num_channels=d.num_channels,
        sample_length=d.sample_length,
        mfccmap=config.model.mfccmap,
        datatype=d.datatype,
        correspondence=d.correspondence,
        correspondence_video=d.correspondence_video,
        compute_dtype=config.parallel.compute_dtype,
        learning_rate=config.optim.learning_rate,
        seed=config.run.seed,
        generation=gen if generated else None,
    )


def embed_config(config: ExperimentConfig) -> EmbedConfig:
    """The port's ``EmbedConfig`` of an experiment: acoustic channels by
    ``data.datatype`` (13 for music), ``model.num_class`` latents, the
    variant flags, and the spectrogram statistics' directory (``data.
    stats_dir``, else ``stats2s`` beside the training list, as JAX's
    ``_load_spec_stats``). Takes more than one device and FSDP; raises for
    what ``generation_config`` refuses (``one_device``)."""
    one_device(config, EmbedTask)
    d, m, o = config.data, config.model, config.optim
    stats_dir = d.stats_dir
    if stats_dir is None and d.train_file:
        stats_dir = os.path.join(os.path.dirname(d.train_file), "stats2s")
    return EmbedConfig(
        num_channels=d.num_channels,
        latent_dim=m.num_class,
        margin=o.margin,
        fusion=m.fusion,
        moddrop=m.moddrop,
        l2=m.l2,
        proxy=m.proxy,
        bce=o.bce,
        normalize_spectrogram=d.normalize_spectrogram,
        stats_dir=stats_dir,
        compute_dtype=config.parallel.compute_dtype,
        learning_rate=o.learning_rate,
        seed=config.run.seed,
    )


def one_device(config: ExperimentConfig, task_class) -> None:
    """Raise, with the task's ``one_device_reason``, when a task that trains
    on one device only (its reason is not None) is asked for more or for
    FSDP; and for what ``generation_config`` refuses."""
    if parallel(config) and task_class.one_device_reason is not None:
        raise NotImplementedError(f"{task_class.one_device_reason} ({SECOND_HALF})")
    generation_config(config)


def _common(config: ExperimentConfig, task_class) -> dict:
    """The fields every task configuration takes, after ``one_device``."""
    one_device(config, task_class)
    return dict(num_channels=config.data.num_channels, compute_dtype=config.parallel.compute_dtype,
                learning_rate=config.optim.learning_rate, seed=config.run.seed)


def reconstruct_config(config: ExperimentConfig) -> ReconstructConfig:
    """The port's ``ReconstructConfig`` of an experiment (``model.
    encoder_type``; 13 acoustic channels for music). Takes more than one
    device and FSDP; raises for what ``generation_config`` refuses
    (``one_device``)."""
    return ReconstructConfig(encoder_type=config.model.encoder_type, **_common(config, ReconstructTask))


def project_config(config: ExperimentConfig) -> ProjectConfig:
    """The port's ``ProjectConfig`` of an experiment (``model.encoder_type``,
    ``fusion``, ``l2``, ``optim.margin``). Raises at more than one device
    (``one_device``)."""
    m = config.model
    return ProjectConfig(encoder_type=m.encoder_type, fusion=m.fusion, l2=m.l2, margin=config.optim.margin,
                         **_common(config, ProjectTask))


def joint_config(config: ExperimentConfig) -> JointConfig:
    """The port's ``JointConfig`` of an experiment (``model.fusion``,
    ``onlyaudiovideo``, ``moddrop``). Raises at more than one device
    (``one_device``)."""
    m = config.model
    return JointConfig(fusion=m.fusion, onlyaudiovideo=m.onlyaudiovideo, moddrop=m.moddrop,
                       **_common(config, JointTask))
