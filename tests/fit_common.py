"""What the epoch-loop test files share (``tests/test_torch_fit*.py``):
the synthetic shards cut to 2 training windows and 1 validation window,
the experiment configuration of either package at ResNet 1/1/1/1 in f32,
the port's trainer and loaders, and the uninterrupted two-epoch run that
every resume is held against."""

import json

import numpy as np
import pytest

from acoustic_image_generation_tpu_torch.core import config as pconfig
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, write_synthetic_dataset
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train.generation import GenerationTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from torch_tmp import module_dir

LR = 1e-4
STEPS_PER_EPOCH = 2


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    with module_dir(tmp_path_factory, "torch_fit") as tmp:
        full = write_synthetic_dataset(str(tmp / "ds"), num_classes=2, videos_per_class=2, seconds_per_video=2)
        out = {}
        for split, n in (("training", 2), ("validation", 1)):
            with open(full[split]) as f:
                files = f.read().split()[:n]
            out[split] = str(tmp / f"{split}.txt")
            with open(out[split], "w") as f:
                f.write("\n".join(files) + "\n")
        yield out


def _config(mod, tmp, name, epochs=2, **model):
    return mod.ExperimentConfig(
        data=mod.DataConfig(batch_size=1),
        model=mod.ModelConfig(resnet_units=(1, 1, 1, 1), **model),
        optim=mod.OptimConfig(learning_rate=LR, num_epochs=epochs),
        run=mod.RunConfig(checkpoint_dir=str(tmp), exp_name=name, seed=0),
        parallel=mod.ParallelConfig(compute_dtype="float32"),
    )


def _port(tmp, name, epochs=2, weights_seed=0, **model):
    cfg = _config(pconfig, tmp, name, epochs, **model)
    task = GenerationTask(pconfig.generation_config(cfg), device="cpu").init_params(weights_seed)
    return Trainer(task, cfg)


def _loaders(lists):
    return (AcousticImageDataLoader(lists["training"], "training", 1),
            AcousticImageDataLoader(lists["validation"], "validation", 1))


def _records(trainer):
    with open(f"{trainer.run_dir}/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _assert_same_state(a, b):
    """Two port states equal to the bit: step, parameters, statistics and
    Adam slots (their checkpoint state dicts)."""
    want = dict(_leaves(ckpt.state_dict(b)))
    got = dict(_leaves(ckpt.state_dict(a)))
    assert got.keys() == want.keys()
    for key, value in got.items():
        if isinstance(value, dict):
            assert value == want[key] == {}, key
        else:
            np.testing.assert_array_equal(value, want[key], err_msg=key)


@pytest.fixture(scope="module")
def uninterrupted(lists, tmp_path_factory):
    """The VAE run every resume is held against: two epochs from seed-0
    weights."""
    with module_dir(tmp_path_factory, "whole", need_mb=400) as tmp:  # two snapshots of about 155 MB
        trainer = _port(tmp, "whole")
        state = trainer.fit(*_loaders(lists))
        yield trainer, state
