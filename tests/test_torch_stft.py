"""The port's STFT magnitude frontend and frame resize against the JAX
package, on the CPU.

Tolerances, and why: the plain version and JAX's ``stft_magnitude`` are the
same two f32 GEMMs (JAX at ``Precision.HIGHEST``) summed in another order,
so they agree within 1e-5 of the peak magnitude (f32 roundings over 246
products of int16-range samples); against the float64 numpy oracle the
same. The resize is one bilinear interpolation on both sides: 1e-6
relative to the values (3.8e-6 on magnitudes up to 50 when first read).
The ``torch.stft`` yardstick in f64 agrees with the oracle within 1e-6 of
the peak (the oracle rounds its output to f32).

The CUDA kernel runs only on a card; its FFT schedule (``dsp.fft``) is
modelled in numpy on the kernel's own tables (``fft_model.stockham``, also
used by ``test_torch_mfcc.py``): against numpy's FFT in float64 to 1e-12 of
the peak, and as a whole kernel against the oracle and the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from acoustic_image_generation_tpu.dsp import spectrogram as jspec
from acoustic_image_generation_tpu.ops.pallas_stft import stft_pallas
from acoustic_image_generation_tpu_torch.dsp import fft, mfcc
from acoustic_image_generation_tpu_torch.dsp import spectrogram as spec
from acoustic_image_generation_tpu_torch.ops import build
from acoustic_image_generation_tpu_torch.ops import stft as stft_mod
from fft_model import complex_table, real_split, stockham
from torch_threads import few_torch_threads  # noqa: F401

PEAK_TOL = 1e-5  # max abs error over the peak magnitude


def _audio(seed, seconds=3):
    rng = np.random.default_rng(seed)
    return rng.integers(-(2**15), 2**15, (seconds, spec.SAMPLES_PER_SECOND)).astype(np.float32)


def _peak_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def test_constants_match_jax():
    assert (spec.FRAME_LENGTH, spec.FRAME_STEP, spec.FFT_LENGTH) == (
        jspec.FRAME_LENGTH, jspec.FRAME_STEP, jspec.FFT_LENGTH)
    assert (spec.NUM_FRAMES, spec.NUM_BINS) == (99, 257)
    np.testing.assert_array_equal(spec.hann_periodic(), jspec.hann_periodic())
    for got, want in zip(spec._dft_bases(), jspec._dft_bases()):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_cached_tables_are_private_copies():
    """The tensors cached per device are copies of the cached numpy tables,
    not views: on the CPU a view would let one in-place op on a basis change
    every later call in the process."""
    cpu = torch.device("cpu")
    cached = [(spec.device_bases(cpu), spec._dft_bases()),
              (mfcc.device_constants(cpu), mfcc.frontend_constants()),
              (build.device_tables(stft_mod.kernel_tables, cpu)[0], tuple(stft_mod.kernel_tables().values()))]
    for tensors, arrays in cached:
        assert len(tensors) == len(arrays)
        for t, a in zip(tensors, arrays):
            assert not np.shares_memory(t.numpy(), a)
            np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("reference", ["stft_magnitude", "stft_pallas_interpret", "numpy_oracle"])
def test_plain_stft_matches_jax(reference):
    x = _audio(0)
    got = spec.stft_magnitude(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 99, 257) and got.dtype == np.float32
    if reference == "stft_magnitude":
        want = jax.jit(jspec.stft_magnitude)(jnp.asarray(x))
    elif reference == "stft_pallas_interpret":
        want = stft_pallas(jnp.asarray(x), interpret=True)
    else:
        want = jspec.stft_magnitude_numpy_oracle(x.astype(np.float64))
    assert _peak_err(got, want) < PEAK_TOL


def test_stft_leading_axes():
    # (2, 2, S) input through the plain version, against both numpy oracles
    x = _audio(1, 4).reshape(2, 2, -1)
    got = spec.stft_magnitude(torch.from_numpy(x)).numpy()
    want = spec.stft_magnitude_numpy_oracle(x.astype(np.float64))
    np.testing.assert_array_equal(want, jspec.stft_magnitude_numpy_oracle(x.astype(np.float64)))
    assert got.shape == (2, 2, 99, 257)
    assert _peak_err(got, want) < PEAK_TOL


def test_resize_matches_jax_image_resize():
    rng = np.random.default_rng(2)
    s = (rng.random((3, 99, 257)) * 50).astype(np.float32)
    got = spec.resize_frames(torch.from_numpy(s)).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(s), (3, 193, 257), method="bilinear"))
    assert got.shape == (3, 193, 257)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_torch_stft_yardstick_computes_the_same_magnitudes():
    """``chip_smoke.py``'s library yardstick: torch centres the 246-sample
    window in the 512-sample frame, and a 133-sample pad puts it back on
    TF's frames."""
    x = _audio(3, 2).astype(np.float64)
    xt = torch.from_numpy(x)
    got = torch.stft(F.pad(xt, (133, 133)), n_fft=512, hop_length=122, win_length=246,
                     window=torch.hann_window(246, periodic=True, dtype=torch.float64),
                     center=False, return_complex=True).abs().transpose(-1, -2)
    want = jspec.stft_magnitude_numpy_oracle(x)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-6  # the oracle's f32 output


def test_wrapper_runs_the_plain_version_on_the_cpu_and_checks_its_input():
    x = torch.from_numpy(_audio(4, 2))
    launches = stft_mod.stft.launches
    np.testing.assert_array_equal(stft_mod.stft(x).numpy(), spec.stft_magnitude(x).numpy())
    assert stft_mod.stft.launches == launches
    assert stft_mod.stft(x.reshape(1, 2, -1)).shape == (1, 2, 99, 257)
    with pytest.raises(ValueError, match="cpu or cuda"):
        stft_mod.stft(x.to("meta"))
    with pytest.raises(ValueError, match="float32"):
        stft_mod.stft(x.double())
    with pytest.raises(ValueError, match="12288"):
        stft_mod.stft(x[:, :1024].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        stft_mod.stft(torch.stack([x, x], dim=-1)[..., 0])


def test_geometry_keywords_default_to_the_kernels_geometry():
    """``stft_magnitude``'s geometry keywords default to the 246/122/512
    geometry: the same bits as the bases in closed form. The kernel's
    wrapper takes that geometry and refuses any other (the TUT loader's
    440/219/512 among them) before it launches."""
    x = torch.from_numpy((np.random.default_rng(3).standard_normal((3, 12288)) * 3000).astype(np.float32))
    got = spec.stft_magnitude(x)
    assert torch.equal(got, spec.stft_magnitude(x, frame_length=246, frame_step=122, fft_length=512))
    n = np.arange(246)[:, None] * np.arange(257)[None, :] * (2.0 * np.pi / 512)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(246) / 246)
    cos_b = torch.from_numpy((np.cos(n) * window[:, None]).astype(np.float32))
    sin_b = torch.from_numpy((-np.sin(n) * window[:, None]).astype(np.float32))
    frames = x.unfold(-1, 246, 122)
    assert torch.equal(got, torch.sqrt((frames @ cos_b) ** 2 + (frames @ sin_b) ** 2))
    assert torch.equal(stft_mod.stft(x), got)
    assert torch.equal(stft_mod.stft(x, frame_length=246, frame_step=122, fft_length=512), got)
    launches = stft_mod.stft.launches
    for geometry in (dict(frame_length=440, frame_step=219, fft_length=512), dict(frame_length=246, frame_step=123),
                     dict(fft_length=1024)):
        with pytest.raises(ValueError, match="246/122/512 geometry only"):
            stft_mod.stft(x, **geometry)
    assert stft_mod.stft.launches == launches


GROUP, SPAN = 9, 1224  # csrc/stft.cu: frames a block, floats of a block's sample span


def stft_model(x, tables):
    """``csrc/stft.cu`` on (S, 12288) audio, in float64: per block of
    GROUP frames the span from the 16-byte boundary below its first frame,
    each frame's windowed (even, odd) pairs zero-padded to 256 points, the
    passes, the split, the magnitude; rounded once to float32."""
    tw, split_a, split_b = (complex_table(tables[k]) for k in ("twiddles", "split_a", "split_b"))
    window = tables["window"]
    x = x.astype(np.float64)
    out = np.empty((x.shape[0], spec.NUM_FRAMES, spec.NUM_BINS))
    for f0 in range(0, spec.NUM_FRAMES, GROUP):
        s0 = (f0 * spec.FRAME_STEP) & ~3
        assert s0 + SPAN <= spec.SAMPLES_PER_SECOND
        span = x[:, s0:s0 + SPAN]
        for f in range(f0, f0 + GROUP):
            frame = span[:, f * spec.FRAME_STEP - s0:][:, :spec.FRAME_LENGTH] * window
            assert frame.shape[1] == spec.FRAME_LENGTH
            z = np.zeros((x.shape[0], spec.FFT_LENGTH // 2), complex)
            z[:, :spec.FRAME_LENGTH // 2] = frame[:, 0::2] + 1j * frame[:, 1::2]
            X = real_split(stockham(z, fft.STFT_RADICES, tw), split_a, split_b)
            out[:, f] = np.sqrt(X.real * X.real + X.imag * X.imag)
    return out.astype(np.float32)


@pytest.mark.parametrize("n, radices", [(256, fft.STFT_RADICES), (512, fft.MFCC_RADICES)], ids=["stft", "mfcc"])
def test_fft_schedule_matches_numpy_fft_in_float64(n, radices):
    rng = np.random.default_rng(7)
    z = rng.standard_normal((5, n)) + 1j * rng.standard_normal((5, n))
    want = np.fft.fft(z, axis=-1)
    got = stockham(z, radices, fft.twiddles(n))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("n", [512, 1024])
def test_real_split_matches_numpy_rfft_in_float64(n):
    rng = np.random.default_rng(8)
    x = rng.integers(-(2**15), 2**15, (4, n)).astype(np.float64)
    radices = fft.STFT_RADICES if n == 512 else fft.MFCC_RADICES
    z = stockham(x[:, 0::2] + 1j * x[:, 1::2], radices, fft.twiddles(n // 2))
    got = real_split(z, *fft.real_split(n))
    want = np.fft.rfft(x, axis=-1)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_kernel_tables():
    t = stft_mod.kernel_tables()
    assert list(t) == ["twiddles", "split_a", "split_b", "window"]  # the kernel's argument order
    assert {k: a.shape for k, a in t.items()} == {
        "twiddles": (256, 2), "split_a": (257, 2), "split_b": (257, 2), "window": (246,)}
    assert all(a.dtype == np.float64 and a.flags.c_contiguous for a in t.values())
    np.testing.assert_array_equal(t["window"], spec.hann_periodic())
    np.testing.assert_array_equal(complex_table(t["twiddles"]), fft.twiddles(256))


def test_kernel_model_matches_oracles():
    """The kernel's schedule on its tables: within the float32 rounding of
    its output (half an ulp of the peak) of the float64 rfft, and within
    PEAK_TOL of the numpy oracle and of the plain version."""
    x = _audio(9, 2)
    tables = stft_mod.kernel_tables()
    got = stft_model(x, tables)
    frames = np.lib.stride_tricks.sliding_window_view(x.astype(np.float64), spec.FRAME_LENGTH, axis=-1)
    exact = np.abs(np.fft.rfft(frames[:, ::spec.FRAME_STEP] * spec.hann_periodic(), spec.FFT_LENGTH, axis=-1))
    assert got.shape == exact.shape == (2, 99, 257)
    # float32 output rounding: half an ulp of each magnitude
    assert np.abs(got - exact).max() <= 2**-24 * np.abs(exact).max() * (1 + 1e-9)
    assert _peak_err(got, spec.stft_magnitude_numpy_oracle(x.astype(np.float64))) < PEAK_TOL
    assert _peak_err(got, spec.stft_magnitude(torch.from_numpy(x)).numpy()) < PEAK_TOL
