"""The port's TUT loader (``data/tut.py``) and the spectrogram's geometry
keywords (``dsp/spectrogram.py``) against the JAX package's.

What is held, and how: records byte for byte; ``TUTDataLoader`` batches
exactly, for the same seed and epoch, in training (random crops, shuffled)
and inference (equispaced crops), from a directory and from a list file,
with and without the global z-normalization; the TUT-geometry
(440/219/512) spectrogram within 1e-5 of the peak of JAX's (both are f32
DFT products, summed in another order; ``test_torch_stft.py`` holds the
default geometry at the same limit, and there the default of the geometry
keywords and the ``stft`` kernel's wrapper refusing any other geometry).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.data import tut as jtut
from acoustic_image_generation_tpu.dsp import spectrogram as jspec
from acoustic_image_generation_tpu_torch.data import tfrecord
from acoustic_image_generation_tpu_torch.data import tut
from acoustic_image_generation_tpu_torch.dsp import spectrogram as spec
from torch_threads import few_torch_threads  # noqa: F401

PEAK_TOL = 1e-5
SAMPLE_RATE = tut.SAMPLE_RATE


def _peak_err(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two shards of 5 TUT records (10 s each, 15 classes) and a list file
    naming them; the global statistics of ``normalize=True``."""
    root = tmp_path_factory.mktemp("torch_tut")
    rng = np.random.default_rng(0)
    paths = []
    for s in range(2):
        records = [jtut.encode_tut_record(rng.standard_normal(10 * SAMPLE_RATE).astype(np.float32),
                                          int(rng.integers(15))) for _ in range(5 - 2 * s)]
        paths.append(str(root / "shards" / f"tut_{s}.tfrecord"))
        os.makedirs(os.path.dirname(paths[-1]), exist_ok=True)
        tfrecord.write_records(paths[-1], records)
    (root / "list.txt").write_text("\n".join(paths) + "\n")
    (root / "stats").mkdir()
    np.save(root / "stats" / "global_mean.npy", np.float32(0.25))
    np.save(root / "stats" / "global_std_dev.npy", np.float32(1.5))
    yield root
    shutil.rmtree(root, ignore_errors=True)


def test_constants_match_jax():
    for name in ("SAMPLE_RATE", "MIN_LENGTH", "FRAME_LENGTH", "FRAME_STEP", "FFT_LENGTH"):
        assert getattr(tut, name) == getattr(jtut, name), name
    assert tut.spectrogram_params() == jtut.spectrogram_params() == dict(frame_length=440, frame_step=219,
                                                                         fft_length=512)


def test_records_match_jax():
    rng = np.random.default_rng(1)
    for label in (0, 14, 2**40):
        audio = rng.standard_normal(441).astype(np.float32)
        payload = tut.encode_tut_record(audio, label)
        assert payload == jtut.encode_tut_record(audio, label)
        for decode in (tut.decode_tut_record, jtut.decode_tut_record):
            got, got_label = decode(payload)
            np.testing.assert_array_equal(got, audio)
            assert got_label == label


@pytest.mark.parametrize("mode,source,normalize", [
    ("training", "dir", False), ("training", "list", True), ("inference", "dir", False),
    ("inference", "list", True)])
def test_loader_batches_match_jax(shards, mode, source, normalize):
    src = str(shards / "shards") if source == "dir" else str(shards / "list.txt")
    kw = dict(sample_rate=SAMPLE_RATE, normalize=normalize, stats_dir=str(shards / "stats"), seed=3)
    got_loader = tut.TUTDataLoader(src, mode, 4, **kw)
    want_loader = jtut.TUTDataLoader(src, mode, 4, **kw)
    assert (got_loader.num_samples, got_loader.total_batches) == (want_loader.num_samples,
                                                                 want_loader.total_batches)
    assert got_loader.num_samples == 8 * 5  # 5 crops a record in either mode
    for epoch in (0, 1):
        got, want = list(got_loader.batches(epoch)), list(want_loader.batches(epoch))
        assert len(got) == len(want) == got_loader.total_batches
        for (a, la), (b, lb) in zip(got, want):
            assert a.dtype == b.dtype and a.shape == (4, 2 * SAMPLE_RATE)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)
    if mode == "training":
        assert not np.array_equal(next(got_loader.batches(0))[0], next(got_loader.batches(1))[0])


def test_tut_spectrogram_matches_jax():
    x = (np.random.default_rng(2).standard_normal((2, 4, 2 * 22050)) * 3000).astype(np.float32)
    got = spec.stft_magnitude(torch.from_numpy(x), **tut.spectrogram_params()).numpy()
    want = np.asarray(jax.jit(lambda w: jspec.stft_magnitude(w, **jtut.spectrogram_params()))(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 4, 200, 257) and got.dtype == np.float32
    assert _peak_err(got, want) < PEAK_TOL
    oracle = spec.stft_magnitude_numpy_oracle(x.astype(np.float64), **tut.spectrogram_params())
    np.testing.assert_array_equal(oracle, jspec.stft_magnitude_numpy_oracle(x.astype(np.float64),
                                                                              **jtut.spectrogram_params()))
    assert _peak_err(got, oracle) < PEAK_TOL
    for got_b, want_b in zip(spec._dft_bases(440, 512), jspec._dft_bases(440, 512)):
        np.testing.assert_array_equal(got_b, want_b)
