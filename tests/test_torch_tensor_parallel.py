"""Tensor parallelism (``parallel/mesh.py``: ``tensor_parallel=2``, the
ranks a ``(data, model)`` grid, gloo on the CPU) for the generation task,
against JAX's ``Trainer(tensor_parallel=2)`` on a two- and a four-device
CPU mesh (``(1, 2)`` and ``(2, 2)``: one program, the wide trunk convs
split over its ``model`` axis by ``tp_sharding``) and against the port's
own one process, in f32 at ResNet 1/1/1/1, 2 clips of 2 frames.

Two spawns (``tests/tensor_parallel_ranks.py``), two ranks at ``(1, 2)``
and four at ``(2, 2)``, run every port case while JAX's programs compile
in this process; the same weights (the port's ``init_params(0)`` through
the bridge) and the same noise (a numpy draw, handed to the port as
``eps`` and to JAX in place of its ``jax.random.normal``) go into both.

Tolerances, and why:

- the split steps against JAX's mesh and against the one process, over
  2 steps: ``tests/test_torch_parallel.py``'s trajectory criteria (losses
  1e-5 relative; each trained tensor's update within 2 lr entry by entry,
  99% within lr/4, 10% in L2; frozen tensors bit-frozen; BN running
  averages within 1e-3 of how far they moved). A split conv's output
  channels are the same dot products as one device's; the BN statistics
  over the gathered map and the regularization's partial sums are f32 sums
  in another order;
- ``fused_bn_stats`` at ``(1, 2)`` (``matmul_stats`` on a rank's 128 to
  1024 local columns) against the one process's fused step: the same
  criteria on the losses and running averages;
- the int8 trunk at ``(1, 2)``: bit for bit against the one process's
  (folded from the whole kernels, which the gather gives back exactly;
  calibrated on the same rows), and its step's loss 1e-5 relative;
- the peers of a model group, and the ranks of a data group: bit for bit
  in every replicated tensor (parameters, BN statistics, Adam slots) and
  in the gathered whole state; the peers of a model group also in what each
  computed itself in every step (its loss terms and a digest of its
  replicated gradients and BN statistics, ``Trainer.own_steps``), taken
  before the trainer makes those model rank 0's;
- the collectives alone (a ``Conv2d`` and a ``ConvTransposeTF`` split on
  their output channels, forward and backward) against one process's
  layer: 1e-6 of each tensor's largest entry (the same products; the
  input's gradient a sum of the two ranks' partial sums);
- the cached path (``fit`` over two epochs at ``(2, 2)``, the disk tier on,
  evaluating each epoch over a split whose last batch is a remainder)
  against the one process's ``fit``: the train and eval losses 1e-5
  relative; the peers of a model group take the same tiers;
- the checkpoint written at ``(1, 2)`` and restored at one process: bit for
  bit, and JAX's restore reads it.
"""

import concurrent.futures as cf
import json

import jax
import numpy as np
import pytest
import torch
from optax import MaskedNode, ScaleByAdamState

import parallel_ranks as pr
import tensor_parallel_ranks as tpr
from acoustic_image_generation_tpu.core import rng as jrng
from acoustic_image_generation_tpu.core.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
    ParallelConfig,
    RunConfig,
)
from acoustic_image_generation_tpu.data.pipeline import RawBatch as JaxRawBatch
from acoustic_image_generation_tpu.parallel import make_mesh, tp_sharding
from acoustic_image_generation_tpu.train import checkpoint as jckpt
from acoustic_image_generation_tpu.train.embed import EmbedTask as JaxEmbed
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxTask
from acoustic_image_generation_tpu.train.reconstruct import ReconstructTask as JaxReconstruct
from acoustic_image_generation_tpu.train.trainer import Trainer as JaxTrainer
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core import config as pconfig
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, write_synthetic_dataset
from acoustic_image_generation_tpu_torch.models.layers import Conv2d, ConvTransposeTF
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train.embed import EmbedConfig, EmbedTask
from acoustic_image_generation_tpu_torch.train.reconstruct import ReconstructConfig, ReconstructTask
from acoustic_image_generation_tpu_torch.train.trainer import Trainer, tp_dims
from task_parity import raw_clips as task_clips
from test_torch_parallel import as_jax_batch, check_trajectory, jax_noise, leaves, raw_clips, trained_keys
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir

LR = pr.LR
CLIPS, FRAMES = 2, 2
GRIDS = {"1x2": 2, "2x2": 4}  # ranks of each grid, tensor_parallel=2


def one_config(run_dir="unused", epochs=1) -> pconfig.ExperimentConfig:
    return pconfig.ExperimentConfig(optim=pconfig.OptimConfig(learning_rate=LR, num_epochs=epochs),
                                    run=pconfig.RunConfig(checkpoint_dir=run_dir, exp_name="one"))


def jax_cfg(tmp, n, tp=2, **data):
    return ExperimentConfig(data=DataConfig(batch_size=CLIPS, **data), model=ModelConfig(resnet_units=pr.UNITS),
                            optim=OptimConfig(learning_rate=LR), run=RunConfig(checkpoint_dir=str(tmp),
                                                                               exp_name="jax"),
                            parallel=ParallelConfig(compute_dtype="float32", num_devices=n, tensor_parallel=tp))


def jax_run(tmp, n, spec) -> dict:
    """JAX's Trainer on its ``(n // 2, 2)`` mesh: two steps from the same
    weights and noise, its state placed by ``tp_sharding``."""
    jtr = JaxTrainer(JaxTask(jax_cfg(tmp, n)), jax_cfg(tmp, n))
    state = jtr.init_state(as_jax_batch(spec["raws"][0]))
    template = jax.device_get(state)
    state = jax.device_put(state.replace(params=spec["init"][0], batch_stats=spec["init"][1]), jtr._state_shardings)
    losses = []
    with jax_noise(spec["eps"]):
        for raw in spec["raws"]:
            state, metrics = jtr.train_step(state, as_jax_batch(raw))
            losses.append({k: float(v) for k, v in metrics.items()})
    specs = {k: tuple(v.spec) for k, v in leaves_of(jtr._state_shardings.params)}
    return dict(losses=losses, final=jax.device_get((state.params, state.batch_stats)), specs=specs,
                template=template)


def leaves_of(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves_of(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def jax_shapes(task, cfg, raw) -> dict:
    """JAX's ``TrainState`` shape of ``task`` (nothing computed):
    ``jax.eval_shape`` of its trainer's init on a one-device mesh."""
    jtr = JaxTrainer(task, cfg)
    key = jrng.role_key(jtr.base_key, "init")
    return jax.eval_shape(jtr._init_impl, key, jtr.device_batch(raw))


def one_process(spec, tmp) -> dict:
    """The port's one-process runs of every case, from the same weights
    and noise."""
    out = {}
    trainer = Trainer(pr.task(spec["init"]), one_config())
    state = trainer.init_state()
    losses = []
    for raw in spec["raws"]:
        state, metrics = trainer.train_step(state, raw, eps=spec["eps"])
        losses.append(float(metrics["loss"]))
    out["steps"] = dict(losses=losses, final=bridge.to_flax(trainer.task), task=trainer.task)
    trainer = Trainer(pr.fuse_bn_stats(pr.task(spec["init"])), one_config())
    state = trainer.init_state()
    losses = []
    for raw in spec["raws"]:
        state, metrics = trainer.train_step(state, raw, eps=spec["eps"])
        losses.append(float(metrics["loss"]))
    out["fused"] = dict(losses=losses, final=bridge.to_flax(trainer.task))
    trainer = Trainer(pr.task(spec["init"], trunk_bn="frozen", trunk_quant="int8"), one_config())
    _, metrics = trainer.train_step(trainer.init_state(), spec["raws"][0], eps=spec["eps"])
    out["int8"] = dict(loss=float(metrics["loss"]), qtrunk=bridge.qtrunk_to_tree(trainer.qtrunk))
    task = pr.task(spec["init"], trunk_bn="frozen", cache_trunk_features=True, cache_disk_dir=str(tmp / "one_disk"))
    trainer = Trainer(task, one_config(str(tmp), epochs=2))
    valid = AcousticImageDataLoader(spec["valid_list"], "validation", 2)
    state = trainer.fit(AcousticImageDataLoader(spec["train_list"], "training", 2), valid)
    out["cached"] = dict(metrics=read_metrics(tmp / "one"), eval=trainer.evaluate(state, valid, use_cache=False))
    return out


def read_metrics(run_dir) -> list:
    with open(run_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the two spawns (in a thread), JAX's runs and the one
    process's."""
    with module_dir(tmp_path_factory, "tensor_parallel", need_mb=1500) as tmp:  # checkpoints, feature stores
        lists = write_synthetic_dataset(str(tmp / "ds"), num_classes=1, videos_per_class=1, seconds_per_video=3,
                                        seed=4)
        rng = np.random.default_rng(9)
        layer = lambda shape: (rng.standard_normal(shape).astype(np.float32),
                               rng.standard_normal(16).astype(np.float32))  # 16 output channels each
        spec = dict(init=bridge.to_flax(pr.task()), raws=[raw_clips(100), raw_clips(101)],
                    eps=np.random.default_rng(7).standard_normal((CLIPS * FRAMES, 150)).astype(np.float32),
                    train_list=lists["training"], valid_list=lists["validation"],
                    conv=layer((16, 8, 3, 3)), transpose=layer((8, 16, 3, 3)),
                    conv_x=rng.standard_normal((2, 6, 8, 8)).astype(np.float32),
                    conv_w=rng.standard_normal((2, 6, 8, 16)).astype(np.float32),
                    transpose_w=rng.standard_normal((2, 18, 24, 16)).astype(np.float32))
        runs = {name: dict(spec, run_dir=str(tmp / name)) for name in GRIDS}
        with cf.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(lambda: {
                "1x2": mesh.launch(tpr.generation_cases, 2, runs["1x2"], device="cpu", tmp_dir=str(tmp)),
                "2x2": mesh.launch(tpr.grid_cases, 4, runs["2x2"], device="cpu", tmp_dir=str(tmp))})
            jax_out = {name: jax_run(tmp / ("jax" + name), n, spec) for name, n in GRIDS.items()}
            one = one_process(spec, tmp)
            out = ranks.result()
        yield dict(spec=spec, ranks=out, jax=jax_out, one=one, tmp=tmp)


@pytest.mark.parametrize("grid", GRIDS)
def test_split_steps_match_jax_mesh(world, grid):
    got, want = world["ranks"][grid][0]["steps"], world["jax"][grid]
    for mine, theirs in zip(got["losses"], want["losses"], strict=True):
        assert mine.keys() == theirs.keys()
        for k in theirs:
            np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-5, err_msg=k)
    check_trajectory((got["params"], got["stats"]), want["final"], world["spec"]["init"],
                     trained_keys(world["one"]["steps"]["task"]))


@pytest.mark.parametrize("grid", GRIDS)
def test_split_steps_match_one_process(world, grid):
    got, one = world["ranks"][grid][0]["steps"], world["one"]["steps"]
    np.testing.assert_allclose([m["loss"] for m in got["losses"]], one["losses"], rtol=1e-5)
    check_trajectory((got["params"], got["stats"]), one["final"], world["spec"]["init"], trained_keys(one["task"]))


@pytest.mark.parametrize("grid", GRIDS)
def test_peers_hold_the_same_replicated_state(world, grid):
    """Every rank of the grid: the same replicated tensors bit for bit,
    the same gathered whole state and the same metrics; the grid is JAX's
    device order (rank r at data r // 2, model r % 2)."""
    ranks = [r["steps"] for r in world["ranks"][grid]]
    n = GRIDS[grid]
    assert [r["grid"] for r in ranks] == [(r // 2, r % 2, n // 2, 2) for r in range(n)]
    devices = np.asarray(make_mesh(n, model_parallel=2).devices)
    assert [[d.id for d in row] for row in devices] == [[2 * d, 2 * d + 1] for d in range(n // 2)]
    for r in ranks[1:]:
        assert r["replicated"] == ranks[0]["replicated"] and r["losses"] == ranks[0]["losses"]
        assert len(r["own"]) == len(r["losses"])
        for tree in ("params", "stats"):
            want = dict(leaves(ranks[0][tree]))
            for k, v in leaves(r[tree]):
                np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert_peers_computed_the_same([r["own"] for r in ranks])


def assert_peers_computed_the_same(own: list) -> None:
    """``own[r]``: rank r's ``Trainer.own_steps``. The peers of each model
    group (ranks 2d and 2d + 1) computed the same loss terms and replicated
    gradients and statistics, bit for bit, before the broadcast."""
    assert own[0]
    for d in range(len(own) // 2):
        assert own[2 * d] == own[2 * d + 1], d


def test_split_layout_is_jax_tp_sharding(world):
    """The kernels the port splits are the ones JAX's ``tp_sharding`` puts on
    the ``model`` axis, on the port dim of the same flax axis; each rank
    holds half of every one, and of their bytes."""
    got = world["ranks"]["1x2"]
    specs = world["jax"]["1x2"]["specs"]
    task = world["one"]["steps"]["task"]
    name_of = {id(t): n for n, t in task.named_parameters()}
    split = 0
    for tensor, coll, path, fn in bridge.targets(task):
        if coll != "params":
            continue
        axis = next((i for i, a in enumerate(specs["/".join(path)]) if a is not None), None)
        _, axes = bridge.flax_layout(fn, tuple(tensor.shape))
        name = name_of[id(tensor)]
        for r in (0, 1):
            layout = got[r]["steps"]["split"]
            if axis is None:
                assert name not in layout, name
                continue
            shape, dim = layout[name]
            assert specs["/".join(path)][axis] == "model" and dim == axes[axis], name
            assert shape[dim] * 2 == tensor.shape[dim] and shape[:dim] + shape[dim + 1:] == \
                tuple(tensor.shape[:dim] + tensor.shape[dim + 1:]), name
        split += axis is not None
    assert split == 12  # the 1/1/1/1 trunk's convs of 256 to 2048 outputs
    for r in (0, 1):
        steps = got[r]["steps"]
        assert steps["bytes"] * 2 == steps["whole_bytes"] > 0
        assert steps["slot_bytes"] == steps["whole_slot_bytes"] == 0  # the trunk is frozen: no Adam slots


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["generation", "embedding", "video"])
def test_tp_axis_is_jaxs_rule(kind, n):
    """``mesh.tp_axis`` against ``tp_sharding`` on every leaf of the task's
    JAX ``TrainState`` shape (parameters and Adam moments), and ``tp_dims``
    on the port's tensors of the same flax paths."""
    if kind == "generation":
        cfg = jax_cfg("unused", 1, tp=1)
        jax_task, task = JaxTask(cfg), pr.task()
        raw = as_jax_batch(raw_clips(0))
    else:
        model = ModelConfig(embedding=True) if kind == "embedding" else ModelConfig(model="UNet",
                                                                                   encoder_type="Video")
        cfg = ExperimentConfig(data=DataConfig(batch_size=1, sample_length=1), model=model,
                               parallel=ParallelConfig(num_devices=1))
        jax_task = JaxEmbed(cfg) if kind == "embedding" else JaxReconstruct(cfg)
        task = EmbedTask(EmbedConfig(), device="cpu") if kind == "embedding" else \
            ReconstructTask(ReconstructConfig(encoder_type="Video"), device="cpu")  # uninitialized: shapes only
        clips = task_clips(0, 1, 12 if kind == "embedding" else 1)
        raw = JaxRawBatch(clips["acoustic"], clips["audio"], clips["video"], clips["action"], clips["location"], 1)
    shapes = jax_shapes(jax_task, cfg, raw)
    specs = tp_sharding(shapes, make_mesh(n, model_parallel=n))
    flat_specs = dict(leaves_of(jax.tree_util.tree_map(lambda s: tuple(s.spec), specs.params)))
    flat_shapes = dict(leaves_of(jax.tree_util.tree_map(lambda s: s.shape, shapes.params)))
    for key, spec in flat_specs.items():
        axis = next((i for i, a in enumerate(spec) if a is not None), None)
        assert mesh.tp_axis(flat_shapes[key], n) == axis, key
    # Adam's moments share the parameters' shapes, so the rule splits them the same way
    (adam,) = [s for s in jax.tree_util.tree_leaves(specs.opt_state, is_leaf=lambda s: isinstance(s, ScaleByAdamState))
               if isinstance(s, ScaleByAdamState)]
    for slot in (adam.mu, adam.nu):
        for key, s in leaves_of(slot):
            if not isinstance(s, MaskedNode):  # a frozen subtree's
                assert tuple(s.spec) == flat_specs[key], key
    dims = tp_dims(task, n)
    split = 0
    for tensor, coll, path, fn in bridge.targets(task):
        if coll != "params":
            continue
        spec = flat_specs["/".join(path)]
        axis = next((i for i, a in enumerate(spec) if a is not None), None)
        _, axes = bridge.flax_layout(fn, tuple(tensor.shape))
        assert dims[tensor] == (None if axis is None else axes[axis]), "/".join(path)
        split += axis is not None
        inside = any(tensor is p for m in task.split_modules() for p in m.parameters())
        assert axis is None or inside, "/".join(path)
    assert split == {"generation": 12, "embedding": 11, "video": 13}[kind]


def test_collectives_match_one_process_layers(world):
    """``sum_input_grad`` and ``gather_channels`` around a ``Conv2d`` and a
    ``ConvTransposeTF`` split on their output channels: the output and the
    input's gradient are one process's; the weight's gradient is this
    rank's block of one process's, not summed, and the bias's whole."""
    spec = world["spec"]
    for kind, (layer, dim) in {"conv": (Conv2d(8, 16), 0),
                               "transpose": (ConvTransposeTF(8, 16, (3, 3), (3, 3)), 1)}.items():
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(spec[kind][0]))
            layer.bias.copy_(torch.from_numpy(spec[kind][1]))
        x = torch.from_numpy(spec["conv_x"]).requires_grad_(True)
        y = layer(x)
        torch.sum(y * torch.from_numpy(spec[kind + "_w"])).backward()
        for r in (0, 1):
            got = world["ranks"]["1x2"][r]["collectives"][kind]
            want = dict(y=y.detach().numpy(), dx=x.grad.numpy(),
                        dw=torch.chunk(layer.weight.grad, 2, dim)[r].numpy(), db=layer.bias.grad.numpy())
            for k, v in want.items():
                gap = np.abs(got[k] - v).max() / np.abs(v).max()
                assert gap <= 1e-6, (kind, r, k, float(gap))


def test_fused_bn_stats_split_matches_one_process(world):
    one = world["one"]["fused"]
    for r in (0, 1):
        got = world["ranks"]["1x2"][r]["fused"]
        np.testing.assert_allclose([m["loss"] for m in got["losses"]], one["losses"], rtol=1e-5)
        want = dict(leaves(one["final"][1]))
        init = dict(leaves(world["spec"]["init"][1]))
        for k, v in leaves(got["stats"]):
            assert np.abs(v - want[k]).max() <= 1e-3 * np.abs(want[k] - init[k]).max(), k
    assert world["ranks"]["1x2"][0]["fused"]["replicated"] == world["ranks"]["1x2"][1]["fused"]["replicated"]
    assert_peers_computed_the_same([r["fused"]["own"] for r in world["ranks"]["1x2"]])


def test_int8_trunk_is_whole_on_every_rank(world):
    one = world["one"]["int8"]
    want = dict(leaves(one["qtrunk"]))
    for r in (0, 1):
        got = world["ranks"]["1x2"][r]["int8"]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
        flat = dict(leaves(got["qtrunk"]))
        assert flat.keys() == want.keys()
        for k, v in want.items():
            assert flat[k].shape == v.shape, k  # whole, not a block of the output channels
            np.testing.assert_array_equal(flat[k], v, err_msg=k)
    assert world["ranks"]["1x2"][0]["int8"]["replicated"] == world["ranks"]["1x2"][1]["int8"]["replicated"]
    assert_peers_computed_the_same([r["int8"]["own"] for r in world["ranks"]["1x2"]])


def test_cached_fit_on_the_grid_matches_one_process(world):
    ranks = [r["cached"] for r in world["ranks"]["2x2"]]
    got, want = read_metrics(world["tmp"] / "2x2" / "tp"), world["one"]["cached"]["metrics"]
    assert [m["epoch"] for m in got] == [m["epoch"] for m in want] == [0, 1]
    for mine, theirs in zip(got, want):
        for part in ("train", "valid"):
            assert mine[part].keys() == theirs[part].keys()
            for k in theirs[part]:
                np.testing.assert_allclose(mine[part][k], theirs[part][k], rtol=1e-5, err_msg=(part, k))
    # a data rank's windows: a fill, then its tiers; the peers of a model group take the same ones
    for d in (0, 1):
        a, b = ranks[2 * d], ranks[2 * d + 1]
        assert a["tiers"] == b["tiers"] and a["tiers"][0] == "fill" and a["trunk_runs"] == b["trunk_runs"]
        assert a["disk"] == b["disk"] >= 1
    assert all(r["step"] == 2 and r["replicated"] == ranks[0]["replicated"] for r in ranks)
    assert_peers_computed_the_same([r["own"] for r in ranks])


def test_evaluate_with_a_remainder_batch_on_the_grid(world):
    ranks = world["ranks"]["2x2"]
    assert [r["cached"]["valid"] for r in ranks] == [[1, 1], [1, 1], [1, 0], [1, 0]]
    want = world["one"]["cached"]["eval"]
    for r in ranks:
        got = r["cached"]["eval"]
        assert got.keys() == want.keys() and "mse" in got
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_checkpoint_from_the_split_ranks_restores_at_one_process(world):
    path = f"{world['tmp']}/1x2/tp/epoch_final.ckpt"
    trainer = Trainer(pr.task(), one_config())
    state = trainer.restore(path, trainer.init_state())
    assert state.step == 2
    params, stats = bridge.to_flax(trainer.task)
    want = world["ranks"]["1x2"][0]["steps"]
    for tree, ref in ((params, want["params"]), (stats, want["stats"])):
        ref = dict(leaves(ref))
        for k, v in leaves(tree):
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
    # whole tensors in JAX's file format: JAX's restore reads the same parameters
    restored = jax.device_get(jckpt.restore_checkpoint(path, world["jax"]["1x2"]["template"]))
    jparams = dict(leaves(restored.params))
    for k, v in leaves(params):
        np.testing.assert_array_equal(jparams[k], v, err_msg=k)
    assert int(restored.step) == 2
    assert ckpt.read_state_dict(path)["params"]["resnet"]["block4_unit_1"]["conv3"]["conv"]["kernel"].shape[-1] == 2048
