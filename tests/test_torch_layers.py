"""The port's TF-shape shims, a ``ConvConvPool`` block and the parameter
bridge against the JAX package, in f32 on the CPU.

Tolerance 1e-5: the same f32 convolutions, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.core.config import ExperimentConfig, ParallelConfig
from acoustic_image_generation_tpu.models.blocks import ConvConvPool as JaxConvConvPool
from acoustic_image_generation_tpu.ops import tf_compat as jtf
from acoustic_image_generation_tpu.train.generation import GenerationTask as JaxTask
from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.models.blocks import ConvConvPool
from acoustic_image_generation_tpu_torch.ops import tf_compat as ttf
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from torch_threads import few_torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def test_conv_transpose_tf_upsamples_12x16_to_36x48():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 16, 8)).astype(np.float32)
    k = rng.standard_normal((2, 2, 8, 5)).astype(np.float32)  # HWIO
    b = rng.standard_normal((5,)).astype(np.float32)
    want = np.asarray(jtf.conv_transpose_tf(jnp.asarray(x), jnp.asarray(k), (3, 3))) + b
    got = ttf.conv_transpose_tf(
        torch.from_numpy(x), torch.from_numpy(k.transpose(2, 3, 0, 1)), (3, 3),
        bias=torch.from_numpy(b),
    )
    assert got.shape == (2, 36, 48, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("k,stride,size", [(3, 1, (9, 11)), (3, 2, (55, 74)), (7, 2, (23, 30)), (1, 2, (9, 10)), (4, 2, (10, 13))])
def test_conv2d_same_fixed_pad(k, stride, size):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, *size, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)  # HWIO
    want = np.asarray(jtf.conv2d_same_fixed_pad(jnp.asarray(x), jnp.asarray(w), stride))
    got = ttf.conv2d_same_fixed_pad(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1)), stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_conv_conv_pool_stride3_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 36, 48, 6)).astype(np.float32)
    block = JaxConvConvPool((16, 16), pool=True, pool_strides=(3, 3))
    variables = block.init(jax.random.key(0), jnp.asarray(x))
    conv, pool = block.apply(variables, jnp.asarray(x))

    holder = torch.nn.Module()
    holder.block = ConvConvPool(6, (16, 16), pool=True, pool_strides=(3, 3), device="cpu")
    bridge.load_flax(holder, {"block": jax.device_get(variables["params"])}, {})
    got_conv, got_pool = holder.block(torch.from_numpy(x))
    assert got_pool.shape == (2, 12, 16, 16)
    np.testing.assert_allclose(got_conv.detach().numpy(), np.asarray(conv), **TOL)
    np.testing.assert_allclose(got_pool.detach().numpy(), np.asarray(pool), **TOL)


def _flagship_tree():
    """The flagship (ResNet50 3/4/6/3 + 1-skip VAE) variable tree, as zeros
    of the shapes ``GenerationTask.init_variables`` gives, without running it."""
    from acoustic_image_generation_tpu.data.preprocess import Batch

    task = JaxTask(ExperimentConfig(parallel=ParallelConfig(compute_dtype="float32")))
    batch = Batch(
        acoustic=jnp.zeros((1, 36, 48, 12)), audio=jnp.zeros((1, 1024)),
        mfcc=jnp.zeros((1, 12)), video=jnp.zeros((1, 224, 298, 3)),
        action=jnp.zeros((1,), jnp.int32), location=jnp.zeros((1,), jnp.int32),
        filtered_mfcc=jnp.zeros((1, 12)),
    )
    shapes = jax.eval_shape(task.init_variables, jax.random.key(0), batch)
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def test_bridge_maps_every_flagship_leaf():
    params, stats = _flagship_tree()
    task = GenerationTask(GenerationConfig(compute_dtype="float32"), device="cpu")
    bridge.load_flax(task, params, stats)
    n_leaves = len(jax.tree.leaves(params)) + len(jax.tree.leaves(stats))
    n_tensors = len(list(task.parameters())) + len(list(task.buffers()))
    assert len(bridge.targets(task)) == n_leaves == n_tensors

    # the stride-2 unit's fixed-pad conv2 keeps its kernel under its scope
    assert "kernel" in params["resnet"]["block3_unit_6"]["conv2"]
    del params["resnet"]["block3_unit_5"]["conv2"]["conv"]["kernel"]
    with pytest.raises(KeyError, match="no flax params leaf"):
        bridge.load_flax(task, params, stats)
    params, stats = _flagship_tree()
    params["generator"]["extra"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="no port tensor"):
        bridge.load_flax(task, params, stats)
