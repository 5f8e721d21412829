"""The port's experiment configuration against the JAX package's: the same
fields and defaults, ``configuration.txt`` read by either package from the
other's, the port's ``GenerationConfig`` built from it, and what the port
refuses to run."""

import dataclasses
import json

import pytest

from acoustic_image_generation_tpu.core import config as jconfig
from acoustic_image_generation_tpu_torch.core import config as pconfig
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import tmp_path  # noqa: F401

SECTIONS = ("DataConfig", "ModelConfig", "OptimConfig", "RunConfig", "ParallelConfig", "ExperimentConfig")


def _custom(mod):
    """A config away from the defaults in every section, tuples included."""
    return mod.ExperimentConfig(
        data=mod.DataConfig(datatype="music", train_file="t.txt", batch_size=64, modalities=(0, 2)),
        model=mod.ModelConfig(embedding=True, mfcc=True, ae=True, resnet_units=(1, 2, 1, 1), trunk_bn="frozen",
                              cache_trunk_features=True, cache_disk_dir="cache", trunk_quant="int8",
                              fused_qgemm=True),
        optim=mod.OptimConfig(learning_rate=3e-4, num_epochs=7, latent_loss=1e-5, bce=True),
        run=mod.RunConfig(mode="test", exp_name="x", seed=5, restore_checkpoint="r.ckpt", async_checkpoint=False),
        parallel=mod.ParallelConfig(compute_dtype="bfloat16"),
    )


@pytest.mark.parametrize("name", SECTIONS)
def test_same_fields_and_defaults(name):
    jcls, pcls = getattr(jconfig, name), getattr(pconfig, name)
    jf = [(f.name, str(f.type)) for f in dataclasses.fields(jcls)]
    pf = [(f.name, str(f.type)) for f in dataclasses.fields(pcls)]
    assert pf == jf
    assert dataclasses.asdict(pcls()) == dataclasses.asdict(jcls())
    if name == "DataConfig":
        for datatype in ("outdoor", "old", "music"):
            j, p = jcls(datatype=datatype), pcls(datatype=datatype)
            assert (p.num_classes, p.num_locations, p.num_channels, p.nr_frames) == \
                (j.num_classes, j.num_locations, j.num_channels, j.nr_frames)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_configuration_txt_loads_in_either_package(tmp_path, writer):
    path = str(tmp_path / "configuration.txt")
    (_custom(jconfig) if writer == "jax" else _custom(pconfig)).save(path)
    with open(path) as f:
        text = f.read()
    assert text == _custom(jconfig).to_json() == _custom(pconfig).to_json()
    assert json.loads(text)["model"]["resnet_units"] == [1, 2, 1, 1]
    port = pconfig.ExperimentConfig.load(path)
    assert port == _custom(pconfig)  # the tuples come back as tuples
    assert port.model.resnet_units == (1, 2, 1, 1) and port.data.modalities == (0, 2)
    assert jconfig.ExperimentConfig.load(path).to_json() == text


def test_generation_config_of_an_experiment():
    cfg = _custom(pconfig)
    gen = pconfig.generation_config(dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, correspondence=False)))
    assert gen == GenerationConfig(
        num_skip_conn=1, ae=True, resnet_units=(1, 2, 1, 1), trunk_bn="frozen", trunk_quant="int8",
        fused_qgemm=True, correspondence=False, correspondence_video=False, datatype="music",
        compute_dtype="bfloat16", learning_rate=3e-4, latent_loss=1e-5,
        mse=True, huber=True, bce=True, resnet_weight_decay=5e-4, seed=5, cache_trunk_features=True,
        cache_device_bytes=4 << 30, cache_eval_bytes=8 << 30, cache_disk_dir="cache", cache_disk_bytes=256 << 30,
        cache_features_dtype="bf16",
    )
    # every GenerationConfig field comes from the experiment
    assert {f.name for f in dataclasses.fields(GenerationConfig)} <= {
        f.name for section in ("data", "model", "optim", "run", "parallel")
        for f in dataclasses.fields(getattr(cfg, section))
    } | {"compute_dtype", "seed", "correspondence"}


@pytest.mark.parametrize("parallel", [dict(num_devices=2), dict(fsdp=True), dict(tensor_parallel=2)])
def test_more_than_one_device_raises(parallel):
    """Every task takes more devices and FSDP (tests/test_torch_parallel*.py), and tensor parallelism, with or
    without the correspondence augmentation (tests/test_torch_tensor_parallel*.py). What still raises are JAX's
    two ValueErrors: fsdp beside it, and devices that do not fill whole model groups."""
    cfg = pconfig.ExperimentConfig(parallel=pconfig.ParallelConfig(**parallel))
    makers = (pconfig.generation_config, pconfig.embed_config, pconfig.reconstruct_config, pconfig.project_config,
              pconfig.joint_config, pconfig.classify_config)
    for make in makers:
        assert make(cfg) == make(pconfig.ExperimentConfig())
    if "tensor_parallel" in parallel:
        # JAX's checks: fsdp excludes it, and the devices must fill whole model groups
        for bad in (dict(parallel, fsdp=True), dict(parallel, num_devices=3)):
            for make in makers:
                with pytest.raises(ValueError, match="mutually exclusive|not a multiple"):
                    make(pconfig.ExperimentConfig(parallel=pconfig.ParallelConfig(**bad)))
        pconfig.generation_config(pconfig.ExperimentConfig(parallel=pconfig.ParallelConfig(**parallel, num_devices=4)))
        for data in (dict(correspondence=True), dict(correspondence=True, correspondence_video=True),
                     dict(correspondence=True, datatype="music")):
            corr = pconfig.ExperimentConfig(data=pconfig.DataConfig(**data), parallel=cfg.parallel)
            one = pconfig.ExperimentConfig(data=pconfig.DataConfig(**data))
            for make in (pconfig.generation_config, pconfig.classify_config):
                assert make(corr) == make(one) and make(corr).correspondence
    pconfig.generation_config(pconfig.ExperimentConfig(parallel=pconfig.ParallelConfig(num_devices=1)))
    # optax's Adam is the trainer's choice (tests/test_torch_optim.py): the task's configuration is the same
    optax = pconfig.ExperimentConfig(optim=pconfig.OptimConfig(tf1_adam=False))
    assert pconfig.generation_config(optax) == pconfig.generation_config(pconfig.ExperimentConfig())
