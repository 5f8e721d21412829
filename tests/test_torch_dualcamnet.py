"""The port's DualCamNet, clip logits, cross-entropy and accuracy against
the JAX package's, on the CPU, with flax's weights through ``bridge.py``.

Tolerances, and why:

- f32 logits: 1e-5 of the largest logit (the same convs and products,
  summed in another order; read 1.2e-6);
- bf16 logits: 1e-2 of the largest logit, two and a half bf16 roundings
  (both frameworks round each layer's output to bf16, at different points
  of their sums; read up to 1.8e-3);
- the temporal conv on an impulse: 1e-7 absolute (one product each);
- cross-entropy 1e-6 relative (f32 log-softmax); accuracy and the clip
  means exact up to f32 rounding.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.losses import classify as jclassify
from acoustic_image_generation_tpu.models.dualcamnet import DualCamNet as JaxDualCamNet
from acoustic_image_generation_tpu.models.dualcamnet import clip_logits as jax_clip_logits
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.losses import classify
from acoustic_image_generation_tpu_torch.models.dualcamnet import DualCamNet, clip_logits
from acoustic_image_generation_tpu_torch.train.classify import ClassificationTask, ClassifyConfig
from torch_threads import few_torch_threads  # noqa: F401


def _flax(num_frames, x, dtype=jnp.float32, num_classes=10, seed=0):
    model = JaxDualCamNet(num_classes=num_classes, num_frames=num_frames, dtype=dtype)
    variables = jax.jit(model.init)(jax.random.key(seed), jnp.asarray(x))
    return model, variables


def _port(params, num_frames, dtype="float32"):
    task = ClassificationTask(ClassifyConfig(sample_length=num_frames // 12, compute_dtype=dtype), device="cpu")
    bridge.load_flax(task, {"dualcamnet": params}, {})
    return task


@pytest.mark.parametrize("num_frames", [12, 24])
def test_logits_match_flax_in_f32(num_frames):
    x = np.random.default_rng(num_frames).random((2 * num_frames, 36, 48, 12)).astype(np.float32)
    model, variables = _flax(num_frames, x, seed=num_frames)
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    task = _port(variables["params"], num_frames)
    got = task.dualcamnet(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2 * num_frames, 10) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # the bridge gives flax's tree back, the temporal kernel (12, 1, 1, C, C) included
    back, stats = bridge.to_flax(task)
    assert stats == {}
    for name, leaves in variables["params"].items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(back["dualcamnet"][name][leaf], np.asarray(value))
    assert task.dualcamnet.conv1.weight.shape == (12, 12, 12, 1)


def test_logits_match_flax_in_bf16():
    x = np.random.default_rng(1).random((24, 36, 48, 12)).astype(np.float32)
    model, variables = _flax(12, x, dtype=jnp.bfloat16, seed=1)
    want = np.asarray(model.apply(variables, jnp.asarray(x)).astype(jnp.float32))
    task = _port(variables["params"], 12, "bfloat16")
    got = task.dualcamnet(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in task.parameters())
    assert np.abs(got.detach().float().numpy() - want).max() <= 1e-2 * np.abs(want).max()


def test_temporal_conv_pads_five_frames_before_and_six_after():
    """An impulse at frame 0 through a kernel whose taps differ: XLA's SAME
    for the even 12-tap kernel pads 5 before and 6 after, so output frame t
    reads tap 5 + (0 - t) of the input's frame 0; the mirrored padding (6
    before) would read tap 6 - t and fail."""
    frames, c = 12, 2
    x = np.zeros((frames, 3, 4, c), np.float32)
    x[0] = 1.0
    kernel = np.zeros((12, 1, 1, c, c), np.float32)
    kernel[:, 0, 0, 0, 0] = np.arange(1, 13)  # tap k weighs k + 1
    conv = fnn.Conv(c, (12, 1, 1), padding="SAME")
    want = np.asarray(conv.apply({"params": {"kernel": kernel, "bias": np.zeros(c, np.float32)}},
                                 jnp.asarray(x.reshape(1, frames, 3, 4, c))))[0]
    port = DualCamNet(num_frames=frames, channels=c)
    with torch.no_grad():
        port.conv1.weight.copy_(torch.from_numpy(bridge._dhwio_to_oihw(kernel)))
        port.conv1.bias.zero_()
        got = port.conv1(torch.from_numpy(x).reshape(1, frames, 12, c)).reshape(frames, 3, 4, c).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    # frame t reads tap 5 - t: weights 6, 5, ..., 1 for t = 0..5, then nothing
    np.testing.assert_array_equal(got[:, 0, 0, 0], [6, 5, 4, 3, 2, 1, 0, 0, 0, 0, 0, 0])


def test_clip_logits_cross_entropy_and_accuracy_match_jax():
    rng = np.random.default_rng(3)
    frame_logits = rng.standard_normal((5 * 12, 10)).astype(np.float32) * 4
    labels = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 5)]
    got = clip_logits(torch.from_numpy(frame_logits), 12)
    want = np.asarray(jax_clip_logits(jnp.asarray(frame_logits), 12))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    lt = torch.from_numpy(labels)
    np.testing.assert_allclose(float(classify.softmax_cross_entropy(lt, got)),
                               float(jclassify.softmax_cross_entropy(labels, want)), rtol=1e-6)
    # a tie for the maximum goes to the first index on both sides
    tied = want.copy()
    tied[0, :] = 0.0
    assert float(classify.accuracy(torch.from_numpy(tied), lt)) == float(jclassify.accuracy(tied, labels))
    assert float(classify.accuracy(got, lt)) == float(jclassify.accuracy(want, labels))
    np.testing.assert_array_equal(classify.correct(got, lt).numpy(),
                                  (want.argmax(1) == labels.argmax(1)).astype(np.float32))


def test_init_is_a_truncated_normal_of_stddev_001():
    model = DualCamNet()
    g = torch.Generator().manual_seed(0)
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    w = model.full1.weight.detach()
    assert float(w.abs().max()) <= 0.02
    assert abs(float(w.std()) - 0.01 * 0.8796) < 5e-4  # the truncation's stddev, not rescaled
    assert float(model.conv2.bias.detach().abs().max()) == 0.0
