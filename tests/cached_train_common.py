"""What the cached-feature test files share (``tests/test_torch_cached_*.py``):
shards of 4 videos x 2 seconds, their training loader and first batch of
2 one-second clips, and a frozen-trunk trainer at ResNet 1/1/1/1 in f32 on
the CPU."""

import pytest

from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, write_synthetic_dataset
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer

UNITS = (1, 1, 1, 1)
CLIPS = 2
WINDOW = 12 * 14 * 19 * 2048 * 4  # one window's f32 features


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    # 4 videos x 2 seconds = 8 one-second windows
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("cached_ds")), num_classes=2,
                                   videos_per_class=2, seconds_per_video=2, seed=1)


@pytest.fixture(scope="module")
def loader(lists):
    return AcousticImageDataLoader(lists["training"], "training", CLIPS, shuffle=False)


@pytest.fixture(scope="module")
def batch(loader):
    return next(iter(loader.batches(0)))


def trainer(seed=0, **config):
    cfg = GenerationConfig(resnet_units=UNITS, compute_dtype="float32", trunk_bn="frozen", seed=seed, **config)
    return Trainer(GenerationTask(cfg, device="cpu").init_params(seed))


def params(t: Trainer) -> dict:
    return {n: p.detach().clone() for n, p in t.task.named_parameters()}
