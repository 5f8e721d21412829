"""The port's localization metrics and sweep against the JAX package's, on
the CPU. On identical masks the real-vs-generated IoU, the box maps and
the box-weighted IoU are equal to the bit, as are the threshold fractions,
the AUC and the reference's files. A mask holds the pixels above its
energy map's mean, so where the two packages' maps or means differ by one
f32 rounding a pixel at the mean may fall on the other side: the masks of
the same images are held to that band, and the IoU of the same images to
one pixel of the union. The whole sweep over a loader from the same
weights (``ae=True``: no sampled noise), where the two f32 generators also
differ by rounding: each image's IoU within 0.01, the fractions and the AUC
within 1/N of the N images.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.core.config import DataConfig, ExperimentConfig, ModelConfig, ParallelConfig
from acoustic_image_generation_tpu.data.pipeline import AcousticImageDataLoader as JaxLoader
from acoustic_image_generation_tpu.evaluation import iou as jiou
from acoustic_image_generation_tpu.evaluation.localize import run_iou_sweep as jax_sweep
from acoustic_image_generation_tpu.parallel import make_mesh
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxTask
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, write_synthetic_dataset
from acoustic_image_generation_tpu_torch.evaluation import iou
from acoustic_image_generation_tpu_torch.evaluation.localize import run_iou_sweep
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import tmp_path  # noqa: F401


def _images(seed, n=16):
    """Acoustic images with a bright blob on noise, the two kinds of input
    the masks see; and a second set, the same blobs shifted."""
    rng = np.random.default_rng(seed)
    base = rng.random((n, 36, 48, 12)).astype(np.float32) * 0.3
    yy, xx = np.mgrid[:36, :48]
    for i in range(n):
        cy, cx = rng.integers(4, 32), rng.integers(4, 44)
        base[i] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 20.0)[..., None].astype(np.float32)
    shifted = np.roll(base, rng.integers(-3, 4), axis=2) + rng.random(base.shape).astype(np.float32) * 0.05
    return base, shifted.astype(np.float32)


def _boxes(seed, n=16):
    rng = np.random.default_rng(seed)
    x0, y0 = rng.integers(0, 250, (n, 3)), rng.integers(0, 180, (n, 3))
    x1, y1 = x0 + rng.integers(1, 60, (n, 3)), y0 + rng.integers(1, 60, (n, 3))
    x1[:, 2] = np.where(rng.random(n) < 0.5, 0, x1[:, 2])  # some images have two boxes
    return [a.astype(np.int32) for a in (x0, x1, y0, y1)]


def _same_mask(x, invert=False):
    """One mask both packages get from the same image: the channel mean
    against its image mean, in float64 on the host."""
    e = np.asarray(x, np.float64).mean(-1)
    m = e.mean(axis=(1, 2), keepdims=True)
    return e < m if invert else e > m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_energy_masks_agree_with_jax_up_to_rounding_at_the_mean(seed):
    """Same images, each package's ``find_logen`` and mean: a pixel may land
    on the other side only inside the rounding band around its map's mean
    (the maps agree to 4e-7 relative, the means to one f32 rounding)."""
    _, gen = _images(seed)
    emap = iou.find_logen(torch.from_numpy(gen)).numpy()
    mean = emap.mean(axis=(1, 2), keepdims=True)
    for invert in (False, True):
        got = iou.energy_mask(torch.from_numpy(gen), invert=invert).numpy()
        want = np.asarray(jiou.energy_mask(jnp.asarray(gen), invert=invert))
        off = got != want
        assert off.mean() < 1e-3
        assert (np.abs(emap - mean)[off] <= 1e-6 * np.broadcast_to(mean, emap.shape)[off]).all()
        assert got.sum() > 0 and (~got).sum() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iou_functions_equal_jax_on_the_same_masks(seed, monkeypatch):
    """The IoU arithmetic on identical masks (each package's ``energy_mask``
    replaced by the same arrays): equal to the bit, box maps and the
    box-weighted IoU (its bilinear upsampling included) too."""
    monkeypatch.setattr(iou, "energy_mask", lambda x, invert=False: torch.from_numpy(_same_mask(x, invert)))
    monkeypatch.setattr(jiou, "energy_mask", lambda x, invert=False: jnp.asarray(_same_mask(x, invert)))
    for invert in (False, True):
        real, gen = _images(seed)
        got = iou.iou_real_vs_generated(torch.from_numpy(real), torch.from_numpy(gen)).numpy()
        want = np.asarray(jiou.iou_real_vs_generated(jnp.asarray(real), jnp.asarray(gen)))
        assert got.dtype == np.float32 and 0 < got.min() and got.max() <= 1
        np.testing.assert_array_equal(got, want)

        boxes = _boxes(seed)
        box_map = iou.render_box_map(*(torch.from_numpy(b) for b in boxes))
        np.testing.assert_array_equal(box_map.numpy(), np.asarray(jiou.render_box_map(*map(jnp.asarray, boxes))))
        assert set(np.unique(box_map.numpy())) <= {0.0, 0.5, 1.0} and 0.5 in box_map
        got = iou.box_weighted_iou(torch.from_numpy(gen), box_map, invert=invert).numpy()
        want = np.asarray(jiou.box_weighted_iou(jnp.asarray(gen), jnp.asarray(box_map.numpy()), invert=invert))
        np.testing.assert_array_equal(got, want)


def test_iou_on_the_same_images_within_a_pixel():
    """Without the replacement: each image's IoU within one pixel of its
    union of JAX's."""
    real, gen = _images(7)
    got = iou.iou_real_vs_generated(torch.from_numpy(real), torch.from_numpy(gen)).numpy()
    want = np.asarray(jiou.iou_real_vs_generated(jnp.asarray(real), jnp.asarray(gen)))
    union = np.asarray(jnp.sum(jiou.energy_mask(jnp.asarray(real)) | jiou.energy_mask(jnp.asarray(gen)), axis=(1, 2)))
    assert (np.abs(got - want) <= 1.0 / union + 1e-7).all()


def test_bilinear_upsampling_is_jax_resize():
    """The box IoU's 36x48 -> 224x298 upsampling against jax.image.resize,
    edges included: within one f32 rounding, and the > 0.5 masks equal."""
    rng = np.random.default_rng(5)
    for p in (0.1, 0.5, 0.9):
        mask = (rng.random((8, 36, 48)) < p).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(mask), (8, 224, 298), method="bilinear"))
        got = torch.nn.functional.interpolate(torch.from_numpy(mask)[:, None], size=(224, 298), mode="bilinear",
                                              align_corners=False, antialias=False)[:, 0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)
        np.testing.assert_array_equal(got > 0.5, want > 0.5)


def test_fractions_auc_and_files(tmp_path):
    ious = np.random.default_rng(3).random(101).astype(np.float32)
    fractions = iou.threshold_fractions(ious)
    assert fractions == jiou.threshold_fractions(ious)
    assert iou.localization_auc(fractions) == jiou.localization_auc(fractions)
    iou.write_threshold_files(str(tmp_path / "port"), fractions)
    jiou.write_threshold_files(str(tmp_path / "jax"), fractions)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 12
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def test_sweep_matches_jax(tmp_path):
    lists = write_synthetic_dataset(str(tmp_path / "ds"), num_classes=2, videos_per_class=2, seconds_per_video=2)
    test_list = str(tmp_path / "testing.txt")
    with open(lists["testing"]) as f, open(test_list, "w") as g:
        g.write("\n".join(f.read().split()[:3]) + "\n")  # 3 windows in batches of 2: one padded
    cfg = ExperimentConfig(data=DataConfig(batch_size=2), model=ModelConfig(resnet_units=(1, 1, 1, 1), ae=True),
                           parallel=ParallelConfig(compute_dtype="float32"))
    jloader = JaxLoader(test_list, "testing", 2)
    jtr = JaxTrainer(JaxTask(cfg), cfg, mesh=make_mesh(1))
    state = jtr.init_state(next(iter(jloader.batches(0))))
    # at the initial weights the generator's output sits near 0.5 everywhere
    # and its energy map is flat to 1e-6, so its mask would be rounding
    # noise: the last conv's kernel is scaled so that the images vary
    params = jax.tree_util.tree_map(np.array, jax.device_get(state.params))
    params["generator"]["final"]["kernel"] *= 30.0
    state = state.replace(params=params)
    want = jax_sweep(jtr.task, state, jloader, str(tmp_path / "jax"))

    task = GenerationTask(GenerationConfig(resnet_units=(1, 1, 1, 1), ae=True, compute_dtype="float32"), device="cpu")
    bridge.load_flax(task, *jax.device_get((state.params, state.batch_stats)))
    got = run_iou_sweep(task, AcousticImageDataLoader(test_list, "testing", 2), str(tmp_path / "port"))
    assert got["iou"].shape == want["iou"].shape == (36,)
    np.testing.assert_allclose(got["iou"], want["iou"], rtol=0, atol=0.01)
    for t in want["fractions"]:
        assert abs(got["fractions"][t] - want["fractions"][t]) <= 1 / 36, t
    assert abs(got["auc"] - want["auc"]) <= 1 / 36
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
