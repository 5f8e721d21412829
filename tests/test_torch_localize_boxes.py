"""The port's Flickr-SoundNet box sweep (``evaluation/localize_boxes.py``)
against the JAX package's ``run_box_iou_sweep``, on the CPU, over the
port's box-annotated synthetic shards (``data.synthetic.
write_flickr_dataset``) read by each package's loader with
``include_boxes=True``: 3 one-second windows in batches of 2, one padded,
the same weights (``ae=True``: no sampled noise; the last conv's kernel
scaled so that the energy maps vary, as ``test_torch_localize.py`` does),
with the below-mean source convention of the synthetic data and with the
reference's above-mean one. As ``test_torch_localize.py`` holds the
energy sweep: each frame's IoU within 0.01 (the two f32 generators differ by
rounding, and a pixel at its map's mean may fall on the other side), the
fractions and the AUC within 1/N of the N frames, the same files."""

import os

import jax
import numpy as np
import pytest

from acoustic_image_generation_tpu.core.config import DataConfig, ExperimentConfig, ModelConfig, ParallelConfig
from acoustic_image_generation_tpu.data.pipeline import AcousticImageDataLoader as JaxLoader
from acoustic_image_generation_tpu.evaluation.localize_boxes import run_box_iou_sweep as jax_sweep
from acoustic_image_generation_tpu.parallel import make_mesh
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxTask
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader
from acoustic_image_generation_tpu_torch.data.synthetic import write_flickr_dataset
from acoustic_image_generation_tpu_torch.evaluation.localize_boxes import run_box_iou_sweep
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    with module_dir(tmp_path_factory, "boxes") as tmp:
        lists = write_flickr_dataset(str(tmp / "flickr"), num_videos=2, seconds_per_video=2)
        test_list = str(tmp / "testing.txt")
        with open(lists["testing"]) as f, open(test_list, "w") as g:
            g.write("\n".join(f.read().split()[:3]) + "\n")
        cfg = ExperimentConfig(data=DataConfig(batch_size=2), model=ModelConfig(resnet_units=(1, 1, 1, 1), ae=True),
                               parallel=ParallelConfig(compute_dtype="float32"))
        jloader = JaxLoader(test_list, "testing", 2, include_boxes=True)
        jtr = JaxTrainer(JaxTask(cfg), cfg, mesh=make_mesh(1))
        state = jtr.init_state(next(iter(jloader.batches(0))))
        params = jax.tree_util.tree_map(np.array, jax.device_get(state.params))
        params["generator"]["final"]["kernel"] *= 30.0
        state = state.replace(params=params)
        task = GenerationTask(GenerationConfig(resnet_units=(1, 1, 1, 1), ae=True, compute_dtype="float32"),
                              device="cpu")
        bridge.load_flax(task, *jax.device_get((state.params, state.batch_stats)))
        loader = AcousticImageDataLoader(test_list, "testing", 2, include_boxes=True)
        yield tmp, jtr, state, jloader, task, loader


@pytest.mark.parametrize("invert", [True, False], ids=["below_mean", "above_mean"])
def test_box_sweep_matches_jax(invert, setup):
    tmp, jtr, state, jloader, task, loader = setup
    name = f"invert_{invert}"
    want = jax_sweep(jtr.task, state, jloader, str(tmp / "jax" / name), invert=invert)
    got = run_box_iou_sweep(task, loader, str(tmp / "port" / name), invert=invert)
    assert got["iou"].shape == want["iou"].shape == (36,)
    assert np.isfinite(got["iou"]).all() and 0 < got["iou"].max() <= 1
    np.testing.assert_allclose(got["iou"], want["iou"], rtol=0, atol=0.01)
    for t in want["fractions"]:
        assert abs(got["fractions"][t] - want["fractions"][t]) <= 1 / 36, t
    assert abs(got["auc"] - want["auc"]) <= 1 / 36
    files = sorted(os.listdir(tmp / "jax" / name))
    assert sorted(os.listdir(tmp / "port" / name)) == files and len(files) == 12


def test_box_sweep_needs_the_boxes(setup):
    tmp, _, _, _, task, _ = setup
    plain = AcousticImageDataLoader(str(tmp / "testing.txt"), "testing", 2)
    with pytest.raises(ValueError, match="include_boxes=True"):
        run_box_iou_sweep(task, plain)
