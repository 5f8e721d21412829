"""The port's MFCC frontend and energy map against the JAX package.

The port's plain ``mfcc_from_frames`` (what the kernel wrapper runs on the
CPU) is held against the JAX ``mfcc_from_frames``, the Pallas kernel in
interpret mode and the NumPy oracle, on int16-range frames at a ragged
count. Tolerance rtol=atol=2e-3, as the Pallas kernel's own test states.
The serving preprocessing is held against JAX's (MFCC at the same
tolerance, video exactly, acoustic min-max at 1e-6). ``find_logen`` is
held against JAX and its NumPy oracle at rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.data.preprocess import preprocess_batch as jax_preprocess
from acoustic_image_generation_tpu.dsp.energy import find_logen as jax_find_logen
from acoustic_image_generation_tpu.dsp.mfcc import mfcc_from_frames as jax_mfcc
from acoustic_image_generation_tpu.ops.pallas_mfcc import mfcc_pallas
from acoustic_image_generation_tpu_torch.data.preprocess import preprocess_batch
from acoustic_image_generation_tpu_torch.dsp import energy, mfcc
from acoustic_image_generation_tpu_torch.ops.mfcc_kernel import mfcc as mfcc_wrapper

TOL = dict(rtol=2e-3, atol=2e-3)


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-(2**15), 2**15, (*shape, 1024)).astype(np.float32)


@pytest.mark.parametrize("shape", [(40,), (3, 7)], ids=["40", "3x7"])
def test_mfcc_matches_jax_pallas_and_oracle(shape):
    frames = _frames(shape, 3)
    got = mfcc.mfcc_from_frames(torch.from_numpy(frames)).numpy()
    assert got.shape == (*shape, 12) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jax_mfcc(jnp.asarray(frames))), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(mfcc_pallas(jnp.asarray(frames), interpret=True)), **TOL
    )
    oracle = mfcc.mfcc_numpy_oracle(frames.reshape(-1, 1024)).reshape(*shape, 12)
    np.testing.assert_allclose(got, oracle, **TOL)


def test_wrapper_takes_plain_version_on_cpu():
    frames = torch.from_numpy(_frames((5,), 4))
    before = mfcc_wrapper.launches
    np.testing.assert_array_equal(mfcc_wrapper(frames).numpy(), mfcc.mfcc_from_frames(frames).numpy())
    assert mfcc_wrapper.launches == before
    with pytest.raises(TypeError):
        mfcc_wrapper(frames.double())
    with pytest.raises(ValueError):
        mfcc_wrapper(frames[:, :512])


def test_preprocess_matches_jax():
    rng = np.random.default_rng(5)
    audio = rng.integers(-(2**15), 2**15, (3, 1024)).astype(np.int32)
    video = rng.integers(0, 256, (3, 4, 5, 3)).astype(np.uint8)
    acoustic = rng.standard_normal((3, 36, 48, 12)).astype(np.float32)
    zeros = jnp.zeros((3,), jnp.int32)
    want = jax_preprocess(
        jnp.asarray(acoustic), jnp.asarray(audio), jnp.asarray(video), zeros, zeros,
        compute_filtered=False,
    )
    batch = preprocess_batch(
        torch.from_numpy(audio), torch.from_numpy(video), torch.from_numpy(acoustic)
    )
    np.testing.assert_allclose(batch.mfcc.numpy(), np.asarray(want.mfcc), **TOL)
    np.testing.assert_array_equal(batch.video.numpy(), np.asarray(want.video))
    np.testing.assert_allclose(batch.acoustic.numpy(), np.asarray(want.acoustic), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(batch.audio.numpy(), np.asarray(want.audio))
    with pytest.raises(NotImplementedError):
        preprocess_batch(torch.from_numpy(audio), torch.from_numpy(video), compute_filtered=True)


def test_find_logen_matches_jax_and_oracle():
    rng = np.random.default_rng(6)
    img = rng.random((2, 36, 48, 12)).astype(np.float32)
    got = energy.find_logen(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 36, 48) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jax_find_logen(jnp.asarray(img))), rtol=1e-5)
    np.testing.assert_allclose(got[0], energy.find_logen_numpy_oracle(img[0]), rtol=1e-5)
