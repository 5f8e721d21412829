"""The port's host input path against the JAX package's: the TFRecord and
proto codecs, the shards each package writes, the window plan, and the
loader's batches and window ids, bit for bit (no tolerance anywhere: these
are byte and integer codecs and copies of decoded arrays).
"""

import gzip
import io

import numpy as np
import pytest

from acoustic_image_generation_tpu.data import proto as jproto
from acoustic_image_generation_tpu.data import tfrecord as jtfrecord
from acoustic_image_generation_tpu.data.pipeline import AcousticImageDataLoader as JaxLoader
from acoustic_image_generation_tpu.data.schema import decode_record as jax_decode
from acoustic_image_generation_tpu.data.synthetic import write_synthetic_dataset as jax_write
from acoustic_image_generation_tpu.data.windowing import plan_windows as jax_plan
from acoustic_image_generation_tpu_torch.data import AcousticImageDataLoader, native, proto, tfrecord
from acoustic_image_generation_tpu_torch.data.schema import decode_record
from acoustic_image_generation_tpu_torch.data.synthetic import write_flickr_dataset, write_synthetic_dataset
from acoustic_image_generation_tpu_torch.data.windowing import plan_windows
from torch_threads import few_torch_threads  # noqa: F401

FIELDS = ("acoustic", "audio", "video", "action", "location", "window_ids")


@pytest.fixture(scope="module")
def port_lists(tmp_path_factory):
    # 4 videos x 2 seconds = 8 one-second windows
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("port_ds")), num_classes=2,
                                   videos_per_class=2, seconds_per_video=2, seed=3)


@pytest.fixture(scope="module")
def jax_lists(tmp_path_factory):
    return jax_write(str(tmp_path_factory.mktemp("jax_ds")), num_classes=2, videos_per_class=1,
                     seconds_per_video=2, seed=3)


def _files(list_path):
    with open(list_path) as f:
        return [line.strip() for line in f if line.strip()]


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.valid == w.valid
        for k in FIELDS:
            a, b = getattr(g, k), getattr(w, k)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("n", [0, 1, 7, 4095, 65535, 65536, 4096 * 37 + 5, 1 << 20])
def test_crc32c_matches_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tfrecord.masked_crc32c(data) == jtfrecord.masked_crc32c(data)
    assert tfrecord.crc32c(data) == jtfrecord.crc32c(data)
    assert tfrecord.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


@pytest.mark.parametrize("compression", ["GZIP", None])
def test_tfrecord_round_trip_both_ways(tmp_path, compression):
    rng = np.random.default_rng(1)
    records = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (0, 5, 70000)]
    port_path, jax_path = str(tmp_path / "port.tfrecord"), str(tmp_path / "jax.tfrecord")
    tfrecord.write_records(port_path, records, compression=compression)
    jtfrecord.write_records(jax_path, records, compression=compression)
    for path in (port_path, jax_path):
        assert tfrecord.detect_compression(path) == compression
        assert tfrecord.read_records(path, verify_crc=True) == records
        assert jtfrecord.read_records(path, verify_crc=True) == records
    # a flipped payload byte fails the port's CRC check
    buf = io.BytesIO()
    tfrecord.write_record(buf, records[2])
    raw = bytearray(buf.getvalue())
    raw[20] ^= 1
    with pytest.raises(IOError, match="crc"):
        list(tfrecord.iter_records(io.BytesIO(bytes(raw)), verify_crc=True))


def test_proto_codec_matches_jax():
    def build(mod):
        ex = mod.SequenceExample()
        ex.context["classes"] = mod.int64_feature(3)
        ex.context["neg"] = mod.int64_list_feature([-1, 2**40, 0])
        ex.context["f"] = mod.Feature(float_list=[0.5, -2.25])
        ex.feature_lists["audio/data"] = [mod.bytes_feature(bytes(range(i, i + 9))) for i in range(3)]
        return ex

    payload = build(proto).encode()
    assert payload == build(jproto).encode()
    for mod in (proto, jproto):
        back = mod.SequenceExample.decode(payload)
        assert back.context["neg"].int64_list == [-1, 2**40, 0]
        assert back.context["f"].float_list == [0.5, -2.25]
        assert back.feature_lists["audio/data"][2].bytes_list == [bytes(range(2, 11))]


def test_example_codec_matches_jax():
    """The plain ``tf.train.Example`` (the TUT shards' records)."""
    def build(mod):
        return mod.Example(features={"a": mod.int64_feature(-3), "b": mod.Feature(float_list=[0.5, 2.0]),
                                     "c": mod.bytes_feature(b"\x00\xff" * 5)})

    payload = build(proto).encode()
    assert payload == build(jproto).encode()
    assert proto.Example.decode(payload) == build(proto)
    back = jproto.Example.decode(payload)
    assert back.features["a"].int64_list == [-3] and back.features["c"].bytes_list == [b"\x00\xff" * 5]


def test_shards_decode_the_same_through_either_package(port_lists, jax_lists):
    """The port's shards through JAX's decoder and JAX's through the port's:
    equal arrays; and the same seed writes the same arrays."""
    port_files, jax_files = _files(port_lists["training"]), _files(jax_lists["training"])
    for path in port_files[:2] + jax_files:
        (payload,) = tfrecord.read_records(path, verify_crc=True)
        got, want = decode_record(payload), jax_decode(payload)
        for k in ("acoustic", "audio", "video"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
        assert (got.action, got.location, got.extras) == (want.action, want.location, want.extras)
    # class 0, video 1: the first two seconds of both writers, same seed
    for p, j in zip(port_files[:2], jax_files[:2]):
        a, b = decode_record(tfrecord.read_records(p)[0]), decode_record(tfrecord.read_records(j)[0])
        for k in ("acoustic", "audio", "video"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


def test_flickr_shards_carry_boxes(tmp_path):
    lists = write_flickr_dataset(str(tmp_path), num_videos=1, seconds_per_video=1)
    (payload,) = tfrecord.read_records(_files(lists["testing"])[0])
    got, want = decode_record(payload), jax_decode(payload)
    assert set(got.extras) == {"xmin", "xmax", "ymin", "ymax", "typescene"}
    for k in got.extras:
        np.testing.assert_array_equal(got.extras[k], want.extras[k])
    assert not got.acoustic.any()


@pytest.mark.parametrize("mode,length", [("training", 1), ("training", 2), ("validation", 2), ("testing", 1)])
def test_plan_windows_matches_jax(port_lists, mode, length):
    got, want = plan_windows(port_lists["training"], mode, length), jax_plan(port_lists["training"], mode, length)
    assert got.windows == want.windows and got.num_samples == want.num_samples
    assert got.total_batches(3) == want.total_batches(3)


def test_loader_matches_jax_over_two_shuffled_epochs(port_lists):
    """Batches of 3 over 8 windows, shuffled from the seed, with the padded
    remainder batch (2 valid rows, a repeated id): equal arrays and ids."""
    kw = dict(shuffle=True, drop_remainder=False, seed=5)
    port = AcousticImageDataLoader(port_lists["training"], "training", 3, **kw)
    ref = JaxLoader(port_lists["training"], "training", 3, **kw)
    for epoch in (0, 1):
        got, want = list(port.batches(epoch)), list(ref.batches(epoch))
        assert_batches_equal(got, want)
        assert [b.valid for b in got] == [3, 3, 2]
        assert got[-1].window_ids[2] == got[-1].window_ids[1]
        assert sorted(int(w) for b in got for w in b.window_ids[:b.valid]) == list(range(8))
    assert [int(w) for w in got[0].window_ids] != [int(w) for w in list(port.batches(0))[0].window_ids]
    assert port.decoder == ("native" if native.available() else "python")
    assert port.num_windows == 8 and port.total_batches == ref.total_batches


def test_native_and_python_decoders_agree(port_lists):
    if not native.available():
        pytest.fail(f"the ingest library did not build: {native.build_error()}")
    nat = AcousticImageDataLoader(port_lists["training"], "testing", 3, use_native=True)
    py = AcousticImageDataLoader(port_lists["training"], "testing", 3, use_native=False)
    assert (nat.decoder, py.decoder) == ("native", "python")
    assert_batches_equal(list(nat.batches(0)), list(py.batches(0)))
    assert native.library_path().parent.name == "aig_torch_ingest"


def test_use_native_true_raises_without_the_library(port_lists, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "build_error", lambda: "no g++")
    with pytest.raises(RuntimeError, match="no g\\+\\+"):
        AcousticImageDataLoader(port_lists["training"], "training", 3, use_native=True)
    assert AcousticImageDataLoader(port_lists["training"], "training", 3).decoder == "python"
    with pytest.raises(ValueError, match="extras"):
        AcousticImageDataLoader(port_lists["training"], "training", 3, use_native=True, include_boxes=True)


def test_host_shards_tile_the_global_batch(port_lists):
    """shard_count=2: each shard decodes its half of every global batch, as
    JAX's loader does; together they are the unsharded batch."""
    kw = dict(shuffle=True, drop_remainder=False, seed=2)
    whole = list(AcousticImageDataLoader(port_lists["training"], "training", 6, **kw).batches(0))
    halves = []
    for i in range(2):
        got = list(AcousticImageDataLoader(port_lists["training"], "training", 6, shard_index=i, shard_count=2,
                                           **kw).batches(0))
        assert_batches_equal(got, list(JaxLoader(port_lists["training"], "training", 6, shard_index=i,
                                                 shard_count=2, **kw).batches(0)))
        halves.append(got)
    # second global batch: 2 real windows, both on shard 0; shard 1 pads
    assert [b.valid for b in halves[0]] == [3, 2] and [b.valid for b in halves[1]] == [3, 0]
    np.testing.assert_array_equal(np.concatenate([halves[0][0].video, halves[1][0].video]), whole[0].video)
    np.testing.assert_array_equal(np.concatenate([halves[0][0].window_ids, halves[1][0].window_ids]),
                                  whole[0].window_ids)


def test_decoded_window_cache_respects_its_budget(port_lists):
    plain = AcousticImageDataLoader(port_lists["training"], "testing", 4)
    one = plain._decode_window_by_index(0)
    per_window = sum(a.nbytes for a in (one.acoustic, one.audio, one.video))
    cached = AcousticImageDataLoader(port_lists["training"], "testing", 4, cache_windows=True,
                                     cache_bytes=int(2.5 * per_window))
    first = list(cached.batches(0))
    assert len(cached._window_cache) == 2 and cached._cache_bytes == 2 * per_window
    assert_batches_equal(list(cached.batches(1)), first)
    assert_batches_equal(first, list(plain.batches(0)))
    assert len(cached._window_cache) == 2


def test_gzip_shards_are_whole_stream_compressed(port_lists):
    path = _files(port_lists["training"])[0]
    with open(path, "rb") as f:
        raw = gzip.decompress(f.read())
    assert list(tfrecord.iter_records(io.BytesIO(raw), verify_crc=True)) == tfrecord.read_records(path)
