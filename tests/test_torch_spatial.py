"""Spatially sharded generation serving (``parallel/spatial.py``, a
generation artifact's ``spatial_shards``), in f32 on the CPU, where the
shards' devices are ``["cpu"] * n``:

- the row plan of every layer of the split path (the stem, the max-pool,
  every conv of every unit with its shortcut, ``conv_map``) at ``n`` = 2, 3
  and 8: the shards' output rows tile the layer's height, and each shard is
  fed exactly the window its rows read, so none computes more than its rows
  plus their halo;
- the sharded artifact at ``n`` = 2 and 8 against the unsharded one on the
  same weights and seed, within 5e-5 (JAX's bound for the same comparison,
  ``tests/test_serving.py``), and against JAX's spatially sharded program on
  the 8-device CPU mesh (``task.generate`` jitted over arguments laid out
  with ``_spatial_serving_mesh(n)``'s shardings, the layout JAX's export
  bakes), with JAX's noise draws handed in, within 5e-5;
- the int8 artifact (the unfused trunk) at ``n`` = 2 and 3, equal to the bit
  to the unsharded int8 artifact: the int8 products are exact and every
  other step elementwise, so any halo row out of place would show;
- the refusals: JAX's two (``external_weights`` beside ``n > 1``, fewer
  devices than shards) and the port's (a device of a platform the artifact
  does not list, ``n`` above 12).

Widths: the trunk 1/2/2/1 (with one unit a block no stride-2 identity
shortcut would run), 2 frames a request.
"""

import jax
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.core import serving as jserving
from acoustic_image_generation_tpu.core.config import DataConfig, ExperimentConfig, ModelConfig, ParallelConfig
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxGeneration
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core import serving
from acoustic_image_generation_tpu_torch.models.layers import init_modules
from acoustic_image_generation_tpu_torch.models.resnet import ResNet50, conv_map_rows, trunk_rows
from acoustic_image_generation_tpu_torch.parallel import spatial
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from task_parity import with_normals
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir, tmp_path  # noqa: F401

UNITS = (1, 2, 2, 1)
TOL = 5e-5
FRAMES = 2


def perturbed(task, seed):
    """``task`` with every 1-D tensor (biases, BN parameters and running
    statistics) drawn away from its initial value."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _, t in (*task.named_parameters(), *task.named_buffers()):
            if t.dim() == 1 and t.is_floating_point():
                if bool((t > 0).all()):
                    t.mul_(0.75 + 0.5 * torch.rand(t.shape, generator=g))
                else:
                    t.add_(0.1 * torch.randn(t.shape, generator=g))
    return task


def request(seed, n=FRAMES):
    rng = np.random.default_rng(seed)
    return rng.random((n, 12), dtype=np.float32), rng.random((n, 224, 298, 3), dtype=np.float32)


def layer_names(units):
    names = ["conv1", "pool1"]
    for b, count in enumerate(units, start=1):
        for u in range(1, count + 1):
            unit = f"block{b}_unit_{u}"
            if u == 1:
                names.append(f"{unit}/shortcut")
            elif u == count and b in (2, 3):
                names.append(f"{unit}/subsample")
            names += [f"{unit}/conv1", f"{unit}/conv2", f"{unit}/conv3"]
    return names + ["conv_map"]


@pytest.mark.parametrize("n", [2, 3, 8])
def test_every_layer_computes_its_rows_from_their_window(n):
    # the trunk's heights and windows at narrow widths (the plan depends on
    # the heights alone), against the whole forward
    units = (1, 2, 2, 1)
    resnet = ResNet50(((4, units[0], 1), (8, units[1], 2), (16, units[2], 2), (32, units[3], 1)),
                      trunk_bn_frozen=True)
    init_modules(resnet, n)
    video = torch.rand(1, 224, 298, 3, generator=torch.Generator().manual_seed(n))
    with torch.no_grad():
        want = resnet(video, mode="full")
        with spatial.record() as records:
            got = conv_map_rows([resnet] * n, trunk_rows([resnet] * n, spatial.Rows.split(video, ["cpu"] * n)))
    assert [r["name"] for r in records] == layer_names(units)
    heights = {"conv1": (224, 112), "pool1": (112, 55), "conv_map": (14, 12)}
    for r in records:
        assert r["name"] not in heights or (r["in_height"], r["out_height"]) == heights[r["name"]]
        k, s, (pad_lo, _) = r["kernel"], r["stride"], r["pads"]
        assert r["out_rows"] == spatial.split_rows(r["out_height"], n)
        assert r["out_rows"][0][0] == 0 and r["out_rows"][-1][1] == r["out_height"]
        assert all(a[1] == b[0] for a, b in zip(r["out_rows"], r["out_rows"][1:]))
        for (r0, r1), (lo, hi), fed in zip(r["out_rows"], r["windows"], r["fed"]):
            assert (lo, hi) == (r0 * s - pad_lo, (r1 - 1) * s - pad_lo + k)
            assert fed == hi - lo, f"{r['name']}: fed {fed} rows for a window of {hi - lo}"
    assert got.bounds == spatial.split_rows(12, n)
    if n == 8:
        assert [r1 - r0 for r0, r1 in got.bounds] == [2, 2, 2, 2, 1, 1, 1, 1]
    np.testing.assert_allclose(got.gather("cpu").numpy(), want.numpy(), rtol=0, atol=TOL)


def jax_cfg():
    return ExperimentConfig(data=DataConfig(sample_length=1), model=ModelConfig(resnet_units=UNITS),
                            parallel=ParallelConfig(compute_dtype="float32"))


def jax_sharded(jtask, params, stats, mfcc, video, n):
    """JAX's spatially sharded program and its normal draws:
    ``task.generate`` jitted over arguments laid out as
    ``core/serving.py::export_generation`` lays them out, the video's height
    split over ``n`` devices and everything else replicated, so GSPMD
    partitions the program from them."""
    _, vid_sh, rep = jserving._spatial_serving_mesh(n)
    args = [jax.device_put(a, rep) for a in (params, stats, mfcc)] + [jax.device_put(video, vid_sh)]
    assert args[-1].sharding == vid_sh and len(args[-1].addressable_shards) == n
    out, draws = with_normals(lambda p, s, m, v: jtask.generate(p, s, m, v, jax.random.key(7)))(*args)
    return np.asarray(out), [np.asarray(d) for d in draws]


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    """The f32 task exported unsharded and at n = 2 and 8, loaded on the
    CPU, and its trees in JAX's layout."""
    task = perturbed(GenerationTask(GenerationConfig(resnet_units=UNITS, compute_dtype="float32"),
                                    device="cpu").init_params(0), 1)
    with module_dir(tmp_path_factory, "spatial_f32") as tmp:
        models = {}
        for n in (1, 2, 8):
            manifest = serving.export_generation(task, str(tmp / f"n{n}"), energy=True, spatial_shards=n)
            assert manifest["spatial_shards"] == n
            models[n] = serving.load_artifact(str(tmp / f"n{n}"), device="cpu",
                                              spatial_devices=["cpu"] * n if n > 1 else None)
        yield task, models, bridge.to_flax(task)


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_artifact_matches_the_whole_one(f32, n):
    _, models, _ = f32
    mfcc, video = request(0)
    want, want_energy = models[1].generate(mfcc, video, seed=5)
    with spatial.record() as records:
        got, energy = models[n].generate(mfcc, video, seed=5)
    assert got.shape == (FRAMES, 36, 48, 12) and energy.shape == (FRAMES, 36, 48)
    assert records[-1]["name"] == "conv_map" and len(records[-1]["out_rows"]) == n
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(energy, want_energy, rtol=1e-3, atol=0)
    # the generator's input, gathered from the shards, against the whole ResNet's (its own scale: the random
    # trunk's activations grow with depth)
    v = torch.from_numpy(video)
    with torch.no_grad():
        feat = models[n].service._spatial_feature(v).numpy()
        want_feat = models[1].task.resnet(v, mode="full").numpy()
    assert np.abs(feat - want_feat).max() <= 1e-5 * np.abs(want_feat).max()


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_artifact_matches_jax_sharded_program(f32, n):
    _, models, (params, stats) = f32
    assert len(jax.devices()) >= n
    mfcc, video = request(1)
    want, draws = jax_sharded(JaxGeneration(jax_cfg()), params, stats, mfcc, video, n)
    assert len(draws) == 1 and draws[0].shape == (FRAMES, 150)
    got, _ = models[n].generate(mfcc, video, eps=draws[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_int8_sharded_artifact_is_bit_equal(tmp_path):
    cfg = GenerationConfig(resnet_units=UNITS, compute_dtype="float32", trunk_bn="frozen", trunk_quant="int8")
    task = perturbed(GenerationTask(cfg, device="cpu").init_params(2), 3)
    mfcc, video = request(2)
    qtrunk = task.build_qtrunk(torch.from_numpy(video))
    eps = np.random.default_rng(4).standard_normal((FRAMES, 150)).astype(np.float32)
    outs = {}
    for n in (1, 2, 3):
        serving.export_generation(task, str(tmp_path / f"n{n}"), qtrunk=qtrunk, spatial_shards=n)
        model = serving.load_artifact(str(tmp_path / f"n{n}"), device="cpu",
                                      spatial_devices=["cpu"] * n if n > 1 else None)
        outs[n] = model.generate(mfcc, video, eps=eps)
    for n in (2, 3):
        np.testing.assert_array_equal(outs[n], outs[1])


@pytest.mark.parametrize("case", ["external_weights", "fewer_devices", "cpu_default", "platform", "over_12"])
def test_spatial_rejects(case, tmp_path):
    task = GenerationTask(GenerationConfig(resnet_units=(1, 1, 1, 1), compute_dtype="float32"), device="cpu")
    out = str(tmp_path / "a")
    if case == "external_weights":
        with pytest.raises(ValueError, match="external_weights is incompatible with spatial_shards>1"):
            serving.export_generation(task, out, spatial_shards=2, external_weights=True)
        serving.export_generation(task, out, external_weights=True)  # beside one shard the flag changes nothing
        return
    if case == "over_12":
        with pytest.raises(ValueError, match="exceeds the 12 rows of conv_map's output"):
            serving.export_generation(task, out, spatial_shards=13)
        return
    serving.export_generation(task, out, spatial_shards=2, platforms=("cuda",) if case == "platform" else ("cpu",))
    if case == "fewer_devices":
        with pytest.raises(RuntimeError, match="spatially sharded over 2 devices; runtime has 1"):
            serving.load_artifact(out, spatial_devices=["cpu"])
    elif case == "cpu_default":  # the CPU is one device
        with pytest.raises(RuntimeError, match="spatially sharded over 2 devices; runtime has 1"):
            serving.load_artifact(out, device="cpu")
    else:
        with pytest.raises(RuntimeError, match=r"exported for \['cuda'\], runtime device cpu is 'cpu'"):
            serving.load_artifact(out, spatial_devices=["cpu", "cpu"])
