"""The port's MFCC frontend and energy map against the JAX package.

The port's plain ``mfcc_from_frames`` (what the kernel wrapper runs on the
CPU) is held against the JAX ``mfcc_from_frames``, the Pallas kernel in
interpret mode and the NumPy oracle, on int16-range frames at a ragged
count. Tolerance rtol=atol=2e-3, as the Pallas kernel's own test states.
The serving preprocessing is held against JAX's (MFCC at the same
tolerance, video exactly, acoustic min-max at 1e-6). ``find_logen`` is
held against JAX and its NumPy oracle at rtol 1e-5.

The CUDA kernel's FFT schedule is modelled in numpy on the kernel's own
tables (``mfcc_model``): its spectrum against numpy's float64 rfft to 1e-12
of the peak, its MFCCs against the oracle and the plain version at the same
tolerance, and its error against a float64 witness at most twice the plain
version's, on noise and on a loud tone over a quiet floor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from acoustic_image_generation_tpu.data.preprocess import normalize_mfcc as jax_normalize_mfcc
from acoustic_image_generation_tpu.data.preprocess import preprocess_batch as jax_preprocess
from acoustic_image_generation_tpu.dsp.energy import find_logen as jax_find_logen
from acoustic_image_generation_tpu.dsp.mfcc import mfcc_from_frames as jax_mfcc
from acoustic_image_generation_tpu.ops.pallas_mfcc import mfcc_pallas
from acoustic_image_generation_tpu_torch.data.preprocess import preprocess_batch
from acoustic_image_generation_tpu_torch.dsp import energy, fft, mfcc
from acoustic_image_generation_tpu_torch.dsp import mel as mel_mod
from acoustic_image_generation_tpu_torch.ops import mfcc_kernel
from acoustic_image_generation_tpu_torch.ops.mfcc_kernel import mfcc as mfcc_wrapper
from fft_model import complex_table, real_split, stockham
from torch_threads import few_torch_threads  # noqa: F401

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
    # the low-pass branch: one mfcc call over the raw and filtered audio
    # gives the raw half unchanged; the filtered MFCC within twice JAX's own
    # gap to a float64 witness (scipy's sosfiltfilt, then JAX's MFCC): the
    # upper mel bands of 125 Hz low-passed audio hold rounding noise, so
    # both f32 paths sit up to 1e-2 from the witness on the [0, 1] scale
    both = preprocess_batch(torch.from_numpy(audio), torch.from_numpy(video), torch.from_numpy(acoustic),
                            compute_filtered=True)
    torch.testing.assert_close(both.mfcc, batch.mfcc, rtol=0, atol=0)
    want_f = jax_preprocess(
        jnp.asarray(acoustic), jnp.asarray(audio), jnp.asarray(video), zeros, zeros, compute_filtered=True,
    )
    sos = sps.butter(10, 125 / (0.5 * 12288), btype="low", output="sos")
    witness = np.asarray(jax_normalize_mfcc(jax_mfcc(jnp.asarray(
        sps.sosfiltfilt(sos, audio.astype(np.float64)).astype(np.float32)))))
    jax_gap = np.abs(np.asarray(want_f.filtered_mfcc) - witness).max()
    assert np.abs(both.filtered_mfcc.numpy() - witness).max() <= 2 * jax_gap
    assert np.abs(both.filtered_mfcc.numpy() - np.asarray(want_f.filtered_mfcc)).max() <= 2 * jax_gap
    assert batch.filtered_mfcc is None
    skip = preprocess_batch(torch.from_numpy(audio), None, compute_filtered=True, compute_mfcc=False)
    assert skip.mfcc is None and skip.video is None
    torch.testing.assert_close(skip.filtered_mfcc, both.filtered_mfcc, rtol=0, atol=0)


def test_find_logen_matches_jax_and_oracle():
    rng = np.random.default_rng(6)
    img = rng.random((2, 36, 48, 12)).astype(np.float32)
    got = energy.find_logen(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 36, 48) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jax_find_logen(jnp.asarray(img))), rtol=1e-5)
    np.testing.assert_allclose(got[0], energy.find_logen_numpy_oracle(img[0]), rtol=1e-5)


# ``csrc/mfcc.cu`` runs only on a card. Its schedule is modelled in numpy
# on its own tables, with the Stockham passes of ``fft_model.py``.


def _tone_frames(n, seed):
    """A loud tone over a quiet floor: in each frame a sine of amplitude
    20000 at a random frequency (20-400 cycles a frame) and phase, plus
    integer noise in [-1, 1], rounded to integers."""
    rng = np.random.default_rng(seed)
    t = np.arange(1024)
    cycles = rng.uniform(20, 400, (n, 1))
    phase = rng.uniform(0, 2 * np.pi, (n, 1))
    x = 20000 * np.sin(2 * np.pi * cycles * t / 1024 + phase) + rng.integers(-1, 2, (n, 1024))
    return np.round(x).astype(np.float32)


def mfcc_model(frames, tables):
    """``csrc/mfcc.cu`` on (N, 1024) frames, in float64 as the kernel
    computes: window, the (even, odd) pairs through the passes, the split
    (bins 0..511), power, each band's span summed in two halves, log of the
    floored bands, DCT; rounded once to float32, non-finite to 0."""
    tw, split_a, split_b = (complex_table(tables[k]) for k in ("twiddles", "split_a", "split_b"))
    xw = frames.astype(np.float64) * tables["window"]
    X = real_split(stockham(xw[:, 0::2] + 1j * xw[:, 1::2], fft.MFCC_RADICES, tw), split_a, split_b)
    power = X.real * X.real + X.imag * X.imag
    bands = np.empty((frames.shape[0], len(tables["mel_spans"])))
    for band, (first, count, offset) in enumerate(tables["mel_spans"]):
        half = (count + 1) // 2
        w = tables["mel_weights"][offset:offset + count]
        p = power[:, first:first + count]
        bands[:, band] = p[:, :half] @ w[:half] + p[:, half:] @ w[half:]
    logmel = np.log(np.where(np.isnan(bands), bands, np.maximum(bands, 1e-3)))
    coeffs = (logmel @ tables["dct"]).astype(np.float32)
    return np.where(np.isfinite(coeffs), coeffs, np.float32(0))


def test_mel_spans_rebuild_the_filterbank():
    filt = mel_mod.create_filters()
    spans, weights = fft.mel_spans(filt)
    assert spans.shape == (24, 3) and spans.dtype == np.int32 and weights.shape == (942,)
    dense = np.zeros_like(filt)
    for band, (first, count, offset) in enumerate(spans):
        dense[first:first + count, band] = weights[offset:offset + count]
    np.testing.assert_array_equal(dense, filt)
    assert (np.count_nonzero(filt, axis=1) <= 2).all()  # a bin lies in at most two bands
    with pytest.raises(ValueError, match="contiguous"):
        fft.mel_spans(np.array([[1.0], [0.0], [1.0]]))


def test_kernel_tables():
    t = mfcc_kernel.kernel_tables()
    assert list(t) == ["twiddles", "split_a", "split_b", "window", "mel_spans", "mel_weights", "dct"]
    assert {k: a.shape for k, a in t.items()} == {
        "twiddles": (512, 2), "split_a": (512, 2), "split_b": (512, 2), "window": (1024,),
        "mel_spans": (24, 3), "mel_weights": (942,), "dct": (24, 12)}
    assert all(a.flags.c_contiguous and a.dtype == (np.int32 if k == "mel_spans" else np.float64)
               for k, a in t.items())
    np.testing.assert_array_equal(t["window"], mel_mod.constants().window)
    np.testing.assert_array_equal(t["dct"], mel_mod.constants().dct_lifter)


@pytest.mark.parametrize("n", [96, 5])
def test_kernel_model_matches_oracle_and_plain(n):
    """The kernel's schedule on its tables, on int16 noise: its power
    spectrum within 1e-12 of the float64 rfft's peak, its MFCCs within
    TOL of the numpy oracle and of the plain version."""
    frames = _frames((n,), 10)
    tables = mfcc_kernel.kernel_tables()
    xw = frames.astype(np.float64) * tables["window"]
    z = stockham(xw[:, 0::2] + 1j * xw[:, 1::2], fft.MFCC_RADICES, complex_table(tables["twiddles"]))
    X = real_split(z, complex_table(tables["split_a"]), complex_table(tables["split_b"]))
    want = np.fft.rfft(xw, axis=-1)[:, :512]
    assert np.abs(X - want).max() <= 1e-12 * np.abs(want).max()
    got = mfcc_model(frames, tables)
    assert got.shape == (n, 12) and got.dtype == np.float32
    np.testing.assert_allclose(got, mfcc.mfcc_numpy_oracle(frames), **TOL)
    np.testing.assert_allclose(got, mfcc.mfcc_from_frames(torch.from_numpy(frames)).numpy(), **TOL)


@pytest.mark.parametrize("inputs", ["noise", "tone"])
def test_kernel_model_against_float64_witness(inputs):
    """Against the float64 numpy oracle, the kernel's largest error is at
    most twice the plain version's on the same frames. On a loud tone over
    a quiet floor the low-energy bands magnify rounding through the log: an
    FFT in float32 misses this bound there, the kernel's float64 does not."""
    frames = _frames((96,), 11) if inputs == "noise" else _tone_frames(96, 11)
    witness = mfcc.mfcc_numpy_oracle(frames)
    plain = np.abs(mfcc.mfcc_from_frames(torch.from_numpy(frames)).numpy() - witness).max()
    kernel = np.abs(mfcc_model(frames, mfcc_kernel.kernel_tables()) - witness).max()
    assert kernel <= 2 * plain, (kernel, plain)
