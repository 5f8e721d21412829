"""The device steps of the port's qualitative renders
(``evaluation/show_video.py``) against the JAX package's building blocks
(``preprocess_batch``, ``GenerationTask._forward``, ``energy_mask``,
``find_logen`` and ``jax.image.resize``, which JAX's ``tools show`` and
``render_video_overlays`` compose), in f32 on the CPU on two raw frames at
full size, the same weights and JAX's noise draw; then ``tools show`` and
``tools show-video`` from a checkpoint, and ``save_overlay_video_frames``,
writing JAX's file names.

Tolerances: the preprocessed frames within 1e-6; the generated images
1e-4 absolute and the energy maps, resized or not, 1e-3 relative
(``test_torch_serving.py``); the masks as ``test_torch_localize.py`` holds
them: at most 0.1% of the pixels on the other side, each within the
rounding band around its map's mean.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.core.config import ExperimentConfig, ModelConfig, ParallelConfig
from acoustic_image_generation_tpu.data.preprocess import preprocess_batch as jax_preprocess
from acoustic_image_generation_tpu.dsp.energy import find_logen as jax_find_logen
from acoustic_image_generation_tpu.evaluation.iou import energy_mask as jax_energy_mask
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxTask
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.cli import tools
from acoustic_image_generation_tpu_torch.data import write_synthetic_dataset
from acoustic_image_generation_tpu_torch.dsp.energy import find_logen
from acoustic_image_generation_tpu_torch.evaluation.overlay import save_overlay_video_frames
from acoustic_image_generation_tpu_torch.evaluation.show_video import show_step, video_overlay_step
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from task_parity import with_normals
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import tmp_path  # noqa: F401

UNITS = (1, 1, 1, 1)


def _raw(seed, frames=2):
    rng = np.random.default_rng(seed)
    return dict(
        acoustic=rng.random((1, frames, 36, 48, 12), dtype=np.float32),
        audio=rng.integers(-2**15, 2**15, (1, frames, 1024)).astype(np.int32),
        video=rng.integers(0, 256, (1, frames, 224, 298, 3)).astype(np.uint8),
        action=np.zeros(1, np.int32), location=np.zeros(1, np.int32),
    )


@pytest.fixture(scope="module")
def jax_and_port():
    """JAX's forward pieces on a raw batch, with its draw, and the port task
    on the same weights."""
    jtask = JaxTask(ExperimentConfig(model=ModelConfig(resnet_units=UNITS),
                                     parallel=ParallelConfig(compute_dtype="float32")))
    task = GenerationTask(GenerationConfig(resnet_units=UNITS, compute_dtype="float32"), device="cpu").init_params(0)
    with torch.no_grad():
        task.generator.final.weight.mul_(30.0)  # so that the energy maps vary, as test_torch_localize.py does
    params, stats = bridge.to_flax(task)
    raw = _raw(1)
    flat = {k: jnp.asarray(raw[k][0]) for k in ("acoustic", "audio", "video")}
    zeros = jnp.zeros((2,), jnp.int32)

    def step(p, s, a, au, v):
        batch = jax_preprocess(a, au, v, zeros, zeros, compute_filtered=False)
        out, _ = jtask._forward(p, s, batch, {"latent": jax.random.key(3)}, train=False)
        gen = out.output.astype(jnp.float32)
        emap = jax_find_logen(gen)
        resized = jax.image.resize(emap, (2, 224, 298), method="bilinear")
        return dict(real=batch.acoustic, generated=gen, video=batch.video, real_mask=jax_energy_mask(batch.acoustic),
                    generated_mask=jax_energy_mask(gen), resized=resized)

    want, draws = with_normals(step)(params, stats, flat["acoustic"], flat["audio"], flat["video"])
    assert len(draws) == 1
    return task, raw, want, torch.from_numpy(np.array(draws[0]))


def _masks_agree(got, want, images):
    emap = find_logen(torch.from_numpy(images)).numpy()
    mean = emap.mean(axis=(1, 2), keepdims=True)
    off = got != np.asarray(want)
    assert off.mean() <= 1e-3
    assert (np.abs(emap - mean)[off] <= 1e-6 * np.broadcast_to(mean, emap.shape)[off]).all()


def test_show_step_matches_jax(jax_and_port):
    task, raw, want, eps = jax_and_port
    got = show_step(task, raw, eps=eps)
    for k in ("real", "video"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["generated"], want["generated"], rtol=0, atol=1e-4)
    assert got["real_mask"].dtype == bool and got["generated_mask"].shape == (2, 36, 48)
    _masks_agree(got["real_mask"], want["real_mask"], got["real"])
    _masks_agree(got["generated_mask"], want["generated_mask"], got["generated"])
    assert 0 < got["generated_mask"].mean() < 1


def test_video_overlay_step_matches_jax(jax_and_port):
    task, raw, want, eps = jax_and_port
    video, emap = video_overlay_step(task, raw, eps=eps)
    assert video.shape == (2, 224, 298, 3) and emap.shape == (2, 224, 298) and emap.dtype == torch.float32
    np.testing.assert_allclose(video.numpy(), want["video"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(emap.numpy(), want["resized"], rtol=1e-3, atol=0)


def test_show_and_show_video_tools_write_jax_file_names(tmp_path):
    pytest.importorskip("matplotlib")
    lists = write_synthetic_dataset(str(tmp_path / "ds"), num_classes=2, videos_per_class=1, seconds_per_video=1)
    test_list = str(tmp_path / "testing.txt")
    with open(lists["testing"]) as f, open(test_list, "w") as g:
        g.write(f.read().split()[0] + "\n")
    flags = ["--embedding", "1", "--mfcc", "1", "--resnet_units", "1,1,1,1", "--compute_dtype", "float32",
             "--device", "cpu", "--batch_size", "1", "--test_file", test_list]
    task = GenerationTask(GenerationConfig(resnet_units=UNITS, compute_dtype="float32"), device="cpu").init_params(0)
    path = ckpt.save_checkpoint(str(tmp_path / "run"), 0, Trainer(task).init_state())

    out = tmp_path / "show"
    assert tools.main(["show", "--num_images", "1", path, str(out), "--", *flags]) == 0
    assert sorted(os.listdir(out)) == ["channels_0.png", "overlay_0.png"]
    out = tmp_path / "video"
    assert tools.main(["show-video", path, str(out), "--", *flags]) == 0
    assert sorted(os.listdir(out)) == [f"I_{n:06d}.png" for n in range(1, 13)]
    assert all(os.path.getsize(out / name) > 1000 for name in os.listdir(out))
    # JAX's per-frame mask renders: {prefix}_{i:05d}.png
    frames = np.random.default_rng(4).random((2, 224, 298, 3))
    paths = save_overlay_video_frames(str(tmp_path / "frames"), frames, frames[:, ::7, ::7, 0][:, :36, :42] > 0.5)
    assert [os.path.basename(p) for p in paths] == ["frame_00000.png", "frame_00001.png"]
