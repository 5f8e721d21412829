"""The port's int8 frozen trunk (``models/quant.py``, ``ops/qconv.py``,
``bridge.load_qtrunk``) against the JAX package's ``models/quant.py``, on
the CPU, at full video size with one unit per block (``TINY_BLOCKS``);
``tests/test_torch_quant_blocks.py`` does the same with the multi-unit
blocks of ``tests/test_quant.py`` and shares this file's helpers. JAX's
fused path runs its Pallas kernel in interpret mode; the port's runs the
plain version of ``qgemm_s8``.

Tolerances, and why:

- BN folding: 1e-6 relative (XLA's and torch's ``rsqrt`` differ by one ulp
  on about a third of the entries).
- ``quantize_trunk``: the same folded weights round to int8 the same way
  except where a last-ulp difference straddles a rounding tie: int8 weights
  may differ by 1 on at most 1e-4 of the entries (read: 0); ``scale`` and
  ``bias`` within 1e-6 relative.
- the int8 convs (``conv2d_s8``): exact, as XLA's s32 convolution.
- ``trunk_forward`` with JAX's calibrated tree carried across, unfused,
  against JAX's run eagerly (one XLA op at a time): equal. Every division
  is rounded once on both sides (``ops.qgemm.fdiv``; torch's ``127.0 /
  amax`` is a reciprocal and a product, which moved a quarter of the
  scales by an ulp and the features by 1.3e-2 before it was fixed).
- fused, against JAX's fused path (its kernel in interpret mode, under
  jit): XLA fuses the kernel's ``acc * factor' + bias'`` into an FMA, the
  port does not, so a site may round one quantum apart near a tie and the
  difference carries on. JAX's own bound between its fused and unfused
  trunks: relative error under 0.05 and at most 8 quanta of the last site.
  Readings (CPU, one frame): relative 3.7e-3 (one unit per block) and
  3.4e-3 (multi-unit), at most 3 quanta.
- ``calibrate``'s amaxes, against JAX's collect pass run eagerly: equal.
- int8 against the f32 eval trunk: relative error under 0.1, correlation
  over 0.995 (``tests/test_quant.py``), a property of the quantization.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.models import quant as jquant
from acoustic_image_generation_tpu.models.resnet import ResNet50 as JaxResNet50
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.models import quant
from acoustic_image_generation_tpu_torch.models.resnet import ResNet50
from acoustic_image_generation_tpu_torch.ops.qconv import conv2d_s8
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from torch_threads import few_torch_threads  # noqa: F401

TINY_BLOCKS = ((64, 1, 1), (128, 1, 2), (256, 1, 2), (512, 1, 1))
MULTI_BLOCKS = ((64, 2, 1), (128, 2, 2), (256, 1, 2), (512, 1, 1))
BLOCKS = {"tiny": TINY_BLOCKS, "multi": MULTI_BLOCKS}
FRAMES = 1


def _randomize_stats(stats, rng):
    """Running BN statistics away from (0, 1), so folding is exercised."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict):
            out[k] = _randomize_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@functools.cache
def _jax(name):
    """JAX's trunk variables, its quantized tree before and after
    calibration, and its int8 features unfused and fused, on one video."""
    blocks = BLOCKS[name]
    rng = np.random.default_rng(len(name))
    video = rng.uniform(0, 1, (FRAMES, 224, 298, 3)).astype(np.float32)
    model = JaxResNet50(blocks=blocks, trunk_bn_frozen=True, freeze_trunk=True)
    variables = jax.jit(lambda v: model.init({"params": jax.random.PRNGKey(0)}, v, train=False))(video)
    params = jax.device_get(variables["params"])
    stats = _randomize_stats(jax.device_get(variables["batch_stats"]), rng)
    raw = jax.device_get(jax.jit(jquant.quantize_trunk)(params, stats))
    # calibrate's collect pass, run eagerly (calibrate jits it, and XLA then
    # fuses its epilogues into FMAs)
    _, observed = jquant.trunk_forward(raw, jnp.asarray(video), blocks, collect=True)
    qt = {**raw, "act": {k: np.float32(v) for k, v in observed.items()}}
    # unfused eagerly, one XLA op at a time, as tests/test_quant.py runs it;
    # the fused path under jit (its interpret-mode kernel is slow eagerly)
    feats = {
        False: np.asarray(jquant.trunk_forward(qt, jnp.asarray(video), blocks, out_dtype=jnp.float32)[0]),
        True: np.asarray(jax.jit(lambda q, v: jquant.trunk_forward(
            q, v, blocks, out_dtype=jnp.float32, fused_gemm=True)[0])(qt, video)),
    }
    return video, params, stats, raw, qt, feats


def _port_resnet(name):
    video, params, stats, *_ = _jax(name)
    holder = torch.nn.Module()
    holder.resnet = ResNet50(BLOCKS[name], trunk_bn_frozen=True, freeze_trunk=True, device="cpu")
    bridge.load_flax(holder, {"resnet": params}, {"resnet": stats})
    return holder.resnet, torch.from_numpy(video)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_fold_conv_bn_matches_jax():
    resnet, _ = _port_resnet("tiny")
    _, params, stats, *_ = _jax("tiny")
    for path, conv in resnet.named_modules():
        if not isinstance(conv, type(resnet.conv1)) or path == "conv_map":
            continue
        p, s = params, stats
        for k in path.split("."):
            p, s = p[k], s[k]
        want_k, want_b = jquant.fold_conv_bn(p, s)
        got_k, got_b = quant.fold_conv_bn(conv)
        np.testing.assert_allclose(got_k.permute(2, 3, 1, 0).numpy(), np.asarray(want_k), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6, atol=1e-7)


def test_quantize_trunk_matches_jax():
    resnet, _ = _port_resnet("tiny")
    raw = _jax("tiny")[3]
    got = dict(_leaves(bridge.qtrunk_to_tree(quant.quantize_trunk(resnet))))
    want = dict(_leaves(raw))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k[-1] == "w":
            diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (k, diff.max(), (diff > 0).mean())
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg="/".join(k))


def test_load_qtrunk_round_trip_is_the_identity():
    qt_tree = _jax("tiny")[4]
    qt = bridge.load_qtrunk(quant.QuantTrunk(TINY_BLOCKS), qt_tree)
    back = dict(_leaves(bridge.qtrunk_to_tree(qt)))
    want = dict(_leaves(qt_tree))
    assert back.keys() == want.keys()
    for k, w in want.items():
        assert back[k].dtype == w.dtype and back[k].shape == w.shape, k
        np.testing.assert_array_equal(back[k], w, err_msg="/".join(k))
    with pytest.raises(KeyError):
        bridge.load_qtrunk(quant.QuantTrunk(MULTI_BLOCKS), qt_tree)


@pytest.mark.parametrize(
    "stride,pads,kernel,cin",
    [(2, ((3, 3), (3, 3)), (7, 7), 3), (1, ((1, 1), (1, 1)), (3, 3), 64),
     (2, ((1, 1), (1, 1)), (3, 3), 32), (2, ((0, 0), (0, 0)), (1, 1), 48)],
    ids=["stem_7x7_s2_fixed", "3x3_s1_same", "3x3_s2_fixed", "1x1_s2_same"],
)
def test_conv2d_s8_is_exact(stride, pads, kernel, cin):
    rng = np.random.default_rng(7)
    x = rng.integers(-127, 128, (2, 19, 23, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (*kernel, cin, 24)).astype(np.int8)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), pads,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32,
    )
    w_ok = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 0, 1, 2).reshape(24, -1)))
    got = conv2d_s8(torch.from_numpy(x), w_ok, kernel, stride, pads)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def check_calibrate(name):
    _, _, _, raw, qt_tree, _ = _jax(name)
    _, video = _port_resnet(name)
    qt = quant.calibrate(bridge.load_qtrunk(quant.QuantTrunk(BLOCKS[name]), raw), video)
    for i, site in enumerate(qt.sites):
        assert qt.act[i].numpy() == qt_tree["act"][site], site


def check_trunk_forward(name, fused):
    video, *_, qt_tree, feats = _jax(name)
    qt = bridge.load_qtrunk(quant.QuantTrunk(BLOCKS[name]), qt_tree)
    got, observed = quant.trunk_forward(qt, torch.from_numpy(video), out_dtype=torch.float32, fused_gemm=fused)
    assert observed == {}
    want = feats[fused]
    assert got.shape == want.shape == (FRAMES, 14, 19, 2048)
    got, want = got.numpy().ravel(), want.ravel()
    if not fused:
        np.testing.assert_array_equal(got, want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    quantum = qt_tree["act"][f"block4_unit_{BLOCKS[name][3][1]}/out"] / 127.0
    assert rel < 0.05, rel
    assert np.abs(got - want).max() <= 8 * quantum + 1e-6, np.abs(got - want).max() / quantum


def test_calibrate_matches_jax():
    check_calibrate("tiny")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_trunk_forward_matches_jax(fused):
    check_trunk_forward("tiny", fused)


def test_int8_trunk_tracks_the_f32_trunk():
    resnet, video = _port_resnet("tiny")
    with torch.no_grad():
        ref = resnet(video, mode="trunk").numpy().ravel()
        qt = quant.calibrate(quant.quantize_trunk(resnet), video)
        feat = quant.trunk_forward(qt, video, out_dtype=torch.float32, fused_gemm=True)[0].numpy().ravel()
    rel = np.linalg.norm(feat - ref) / np.linalg.norm(ref)
    assert rel < 0.1, rel
    assert np.corrcoef(ref, feat)[0, 1] > 0.995


def test_int8_config_checks():
    units = (1, 1, 1, 1)
    with pytest.raises(ValueError, match="trunk_bn"):
        GenerationTask(GenerationConfig(resnet_units=units, trunk_quant="int8"), device="cpu")
    with pytest.raises(ValueError, match="trunk_quant"):
        GenerationTask(GenerationConfig(resnet_units=units, trunk_bn="frozen", trunk_quant="int4"), device="cpu")
    # the correspondence augmentation is the trainer's: the task takes the flag
    task = GenerationTask(GenerationConfig(resnet_units=units, correspondence=True), device="cpu")
    assert task.cfg.correspondence
