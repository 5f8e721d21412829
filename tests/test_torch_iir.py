"""The port's Butterworth design and zero-phase low-pass against the JAX
package's ``dsp/iir.py`` and SciPy, on the CPU.

Tolerances, and why:

- the design half is the same float64 numpy code: the (b, a) and sos
  coefficients, ``lfilter_zi``, the sections' ``zi`` and ``filtfilt_numpy``
  are equal to the bit;
- the plain ``filtfilt`` is ``filtfilt_jax``'s float32 biquad cascade with
  every operation rounded on its own (XLA may fuse a multiply and an add):
  against SciPy's float64 ``sosfiltfilt`` it is held to twice JAX's own gap
  (8.2e-5 of the peak over 16 int16-range frames, seed 0, when first
  measured; the port read 9.0e-5), and to JAX itself within that same
  twice-JAX's-gap (read: 1.9e-5 of the peak);
- the CUDA kernel cannot run here: a float32 numpy model of its loops
  (``_kernel_model``: the three forward loops over the odd extension, the
  backward loops that keep the middle samples) is bit-equal to the plain
  version, as ``chip_smoke.py`` holds the kernel itself on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from acoustic_image_generation_tpu.dsp import iir as jiir
from acoustic_image_generation_tpu_torch.dsp import iir
from acoustic_image_generation_tpu_torch.ops import sosfilt
from torch_threads import few_torch_threads  # noqa: F401

WN = 125 / (0.5 * 12288)


def _audio(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(-(2**15), 2**15, (*shape, 1024)).astype(np.float32)


def test_design_equals_jax_to_the_bit():
    for got, want in zip(iir.butter_lowpass(10, WN), jiir.butter_lowpass(10, WN)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(iir.butter_lowpass_sos(10, WN), jiir.butter_lowpass_sos(10, WN))
    b, a = iir._default_ba(12288, 125.0, 10)
    np.testing.assert_array_equal(iir.lfilter_zi(b, a), jiir.lfilter_zi(b, a))
    for got, want in zip(iir._default_sos(12288, 125.0, 10), jiir._default_sos(12288, 125.0, 10)):
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    # and SciPy's design, as the JAX package's tests hold it
    np.testing.assert_allclose(iir.butter_lowpass_sos(10, WN), sps.butter(10, WN, output="sos"),
                               rtol=1e-9, atol=1e-12)
    assert iir.padlen() == 33


def test_filtfilt_numpy_equals_jax():
    x = np.random.default_rng(1).normal(size=(3, 1024)) * 100
    got = iir.filtfilt_numpy(x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jiir.filtfilt_numpy(x))


@pytest.mark.parametrize("lead", [(16,), (2, 8)], ids=["frames", "clips_frames"])
def test_plain_filtfilt_against_jax_and_float64(lead):
    x = _audio(0, lead)
    got = iir.filtfilt(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    want = np.asarray(jiir.filtfilt_jax(jnp.asarray(x)))
    sos, _ = jiir._default_sos(12288, 125.0, 10)
    witness = sps.sosfiltfilt(sos, x.astype(np.float64), axis=-1)
    peak = np.abs(witness).max()
    jax_gap = np.abs(want - witness).max() / peak
    assert jax_gap < 1e-4  # JAX's own float32 cascade
    assert np.abs(got - witness).max() / peak <= 2 * jax_gap
    assert np.abs(got - want).max() / peak <= 2 * jax_gap


def _kernel_model(x: np.ndarray) -> np.ndarray:
    """csrc/sosfilt.cu's loops for one row, in float32 numpy scalars (each
    operation rounded on its own, as __fmul_rn/__fadd_rn/__fsub_rn)."""
    f = np.float32
    sos, zi = sosfilt.kernel_tables().values()
    pad, t_len = iir.padlen(), x.shape[0]
    z0, z1 = [f(0)] * 5, [f(0)] * 5

    def reset(x0):
        for k in range(5):
            z0[k], z1[k] = f(zi[k, 0] * x0), f(zi[k, 1] * x0)

    def step(cur):
        for k in range(5):
            b0, b1, b2, _, a1, a2 = sos[k]
            y = f(f(b0 * cur) + z0[k])
            z0[k] = f(f(f(b1 * cur) + z1[k]) - f(a1 * y))
            z1[k] = f(f(b2 * cur) - f(a2 * y))
            cur = y
        return cur

    work = np.empty(t_len + 2 * pad, np.float32)
    two_first, two_last = f(2 * x[0]), f(2 * x[-1])
    reset(f(two_first - x[pad]))
    for t in range(pad):
        work[t] = step(f(two_first - x[pad - t]))
    for t in range(t_len):
        work[pad + t] = step(x[t])
    for t in range(pad):
        work[pad + t_len + t] = step(f(two_last - x[t_len - 2 - t]))
    out = np.empty(t_len, np.float32)
    reset(work[-1])
    for t in range(t_len + 2 * pad - 1, pad + t_len - 1, -1):
        step(work[t])
    for t in range(t_len - 1, -1, -1):
        out[t] = step(work[pad + t])
    return out


def test_kernel_model_is_bit_equal_to_the_plain_version():
    x = _audio(2, (2,))[:, :96]  # a short row: the model is a Python loop
    want = iir.filtfilt(torch.from_numpy(np.ascontiguousarray(x))).numpy()
    for row in range(2):
        np.testing.assert_array_equal(_kernel_model(x[row]), want[row])


def test_wrapper_runs_the_plain_version_on_the_cpu_and_checks_its_input():
    x = torch.from_numpy(_audio(3, (2, 3)))
    launches = sosfilt.filtfilt.launches
    torch.testing.assert_close(sosfilt.filtfilt(x), iir.filtfilt(x), rtol=0, atol=0)
    assert sosfilt.filtfilt.launches == launches
    tables = sosfilt.kernel_tables()
    assert list(tables) == ["sos", "zi"]
    sos, zi = jiir._default_sos(12288, 125.0, 10)
    np.testing.assert_array_equal(tables["sos"], np.asarray(jnp.asarray(sos, jnp.float32)))
    np.testing.assert_array_equal(tables["zi"], np.asarray(jnp.asarray(zi, jnp.float32)))
    with pytest.raises(ValueError, match="float32"):
        sosfilt.filtfilt(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        sosfilt.filtfilt(x.transpose(0, 1))
    with pytest.raises(ValueError, match="T >"):
        sosfilt.filtfilt(x[..., :34].contiguous())
    with pytest.raises(ValueError, match="cpu or cuda"):
        sosfilt.filtfilt(x.to("meta"))
