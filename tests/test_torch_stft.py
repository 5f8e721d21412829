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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from acoustic_image_generation_tpu.dsp import spectrogram as jspec
from acoustic_image_generation_tpu.ops.pallas_stft import stft_pallas
from acoustic_image_generation_tpu_torch.dsp import spectrogram as spec
from acoustic_image_generation_tpu_torch.ops import stft as stft_mod

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
