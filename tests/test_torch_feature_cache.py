"""The port's frozen-trunk feature cache against the JAX package's, tier by
tier, on the same calls: the host tier's budget and counters, the disk
store (each package reads the other's, bit for bit), the device pool's
slots and padding, the float8 rounding and the fingerprints. Everything is
exact: these are copies and integer bookkeeping, and the f8 cast is held
to JAX's bit for bit.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from acoustic_image_generation_tpu.train import feature_cache as jfc
from acoustic_image_generation_tpu_torch.train import feature_cache as fc
from torch_threads import few_torch_threads  # noqa: F401

SHAPE = (2, 3, 4)  # a window's features, small: (frames, ...)
NP_DTYPES = {torch.bfloat16: ml_dtypes.bfloat16, torch.float8_e4m3fn: ml_dtypes.float8_e4m3fn,
             torch.float32: np.float32}


def to_np(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as the ml_dtypes array of the same bits."""
    bits = fc.as_bytes(t).contiguous()
    if t.dtype == torch.bfloat16:
        bits = bits.view(torch.int16)
    return bits.numpy().view(NP_DTYPES[t.dtype])


def rows(n, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(SHAPE, generator=g) * 4).to(dtype) for _ in range(n)]


def bits(t: torch.Tensor) -> torch.Tensor:
    t = fc.as_bytes(t)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def test_host_tier_budget_hits_and_misses_match_jax():
    r = rows(4)
    per = fc.nbytes(r[0])
    port, ref = fc.TrunkFeatureCache(max_bytes=2 * per), jfc.TrunkFeatureCache(max_bytes=2 * per)
    calls = [("put", 0), ("put", 1), ("put", 2), ("get", 0), ("get", 2), ("put", 1), ("get", 1), ("get", 3)]
    for op, wid in calls:
        if op == "put":
            assert port.put(wid, r[wid]) == ref.put(wid, to_np(r[wid])), (op, wid)
        else:
            got, want = port.get(wid), ref.get(wid)
            assert (got is None) == (want is None), (op, wid)
            if got is not None:
                np.testing.assert_array_equal(to_np(got).view(np.int16), want.view(np.int16))
    assert (port.hits, port.misses, len(port), port.nbytes) == (ref.hits, ref.misses, len(ref), ref.nbytes)
    assert (2 in port, 0 in port) == (2 in ref, 0 in ref) == (False, True)


def test_gather_batch_pads_with_the_last_valid_row():
    r = rows(3)
    port, ref = fc.TrunkFeatureCache(), jfc.TrunkFeatureCache()
    for i, t in enumerate(r):
        port.put(10 + i, t)
        ref.put(10 + i, to_np(t))
    ids, valid = [12, 10, 11, 11], 3
    got, want = fc.gather_batch(port, ids, valid), jfc.gather_batch(ref, ids, valid)
    assert got.shape == (4 * SHAPE[0],) + SHAPE[1:]
    np.testing.assert_array_equal(to_np(got).view(np.int16), want.view(np.int16))
    assert fc.gather_batch(port, [10, 99], 2) is None and jfc.gather_batch(ref, [10, 99], 2) is None
    f8 = fc.TrunkFeatureCache()
    f8.put(0, fc.to_float8_e4m3fn(r[0]))
    assert fc.gather_batch(f8, [0, 0], 1).dtype == torch.float8_e4m3fn


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn, torch.float32])
def test_disk_store_reads_the_other_packages_rows(tmp_path, dtype):
    """A store JAX's DiskFeatureStore wrote reads back bit-equal through the
    port's, and the reverse; both write the same manifest."""
    r = [fc.to_float8_e4m3fn(t.float()) if dtype == torch.float8_e4m3fn else t.to(dtype)
         for t in rows(3, torch.float32, seed=1)]
    ref = jfc.DiskFeatureStore(str(tmp_path), "from_jax")
    for i, t in enumerate(r):
        assert ref.put(i, to_np(t))
    port = fc.DiskFeatureStore(str(tmp_path), "from_jax")
    assert len(port) == 3 and port.nbytes == ref.nbytes and port.meta == ref.meta
    for i, t in enumerate(r):
        assert bits_equal(port.get(i), t)
    mine = fc.DiskFeatureStore(str(tmp_path), "from_port")
    for i, t in enumerate(r):
        assert mine.put(i, t)
    back = jfc.DiskFeatureStore(str(tmp_path), "from_port")
    assert back.meta == {"dtype": np.dtype(NP_DTYPES[dtype]).name, "shape": list(SHAPE)}
    for i, t in enumerate(r):
        got = back.get(i)
        assert got.dtype == NP_DTYPES[dtype]
        np.testing.assert_array_equal(got.view(np.uint8), to_np(t).view(np.uint8))


def test_disk_store_budget_reopen_and_geometry(tmp_path):
    r = rows(6)
    per = fc.nbytes(r[0])
    store = fc.DiskFeatureStore(str(tmp_path), "abc123", max_bytes=3 * per)
    assert store.get(0) is None
    assert store.put(0, r[0]) and store.put(0, r[0])  # idempotent
    assert store.put(1, r[1]) and store.put(2, r[2])
    assert not store.put(3, r[3])  # budget
    assert not store.put(4, r[4][:1])  # another shape refused
    assert not store.put(5, r[5].float())  # another dtype refused
    again = fc.DiskFeatureStore(str(tmp_path), "abc123", max_bytes=3 * per)
    assert len(again) == 3 and again.nbytes == 3 * per
    assert bits_equal(again.get(2), r[2]) and not again.put(5, r[5])
    assert fc.DiskFeatureStore(str(tmp_path), "def456").get(0) is None
    assert not list(tmp_path.glob("*/*.tmp*"))  # atomic writes leave no temporaries


def test_host_tier_writes_through_to_disk(tmp_path):
    r = rows(2)
    disk = fc.DiskFeatureStore(str(tmp_path), "fp")
    cache = fc.TrunkFeatureCache(max_bytes=0, disk=disk)
    assert cache.put(7, r[0])  # on disk despite a RAM budget of 0
    assert 7 in cache and 7 in disk and len(cache) == 0
    assert bits_equal(cache.get(7), r[0])
    assert cache.put(8, r[1], ram=False) and 8 in disk
    warm = fc.TrunkFeatureCache(max_bytes=1 << 20, disk=disk)
    assert bits_equal(warm.get(8), r[1]) and len(warm) == 1  # promoted into RAM
    assert (warm.hits, warm.misses) == (1, 0)


def test_device_pool_matches_jax():
    """``lookup_partial``, ``put_batch``'s capacity and the padded rows on
    the same calls as JAX's DeviceFeatureCache (both on the CPU here)."""
    frames = SHAPE[0]
    feat = torch.cat(rows(4, seed=2))  # a batch of 4 windows
    per = fc.nbytes(feat) // 4
    port, ref = fc.DeviceFeatureCache(3 * per), jfc.DeviceFeatureCache(3 * per)
    assert port.lookup_partial([1], 1) is None and ref.lookup_partial([1], 1) is None
    ids = [5, 6, 7, 8]
    port.put_batch(ids, 4, feat, frames)
    ref.put_batch(np.asarray(ids), 4, jnp.asarray(to_np(feat)), frames)
    assert port.slots == ref.slots == {5: 0, 6: 1, 7: 2} and port.resident == 3
    assert port.buf.shape == ref.buf.shape == (3, frames) + SHAPE[1:]
    for ids, valid in (([7, 5, 6, 6], 3), ([8, 5, 9, 9], 3), ([6, 8, 6, 6], 2)):
        slots, missing = port.lookup_partial(ids, valid)
        want_slots, want_missing = ref.lookup_partial(ids, valid)
        assert slots == list(want_slots) and missing == want_missing
    got = port.gather([2, 0, 0])
    np.testing.assert_array_equal(to_np(got).view(np.int16),
                                  np.asarray(ref.buf[jnp.asarray([2, 0, 0])]).reshape(got.shape).view(np.int16))
    # the mixed tier: rows 1 and 2 replaced from the host
    host = torch.stack(rows(2, seed=3))
    mixed = port.gather([2, 0, 0], rows=([1, 2], host)).reshape(3, frames, *SHAPE[1:])
    assert bits_equal(mixed[0], feat[4:6]) and bits_equal(mixed[1], host[0]) and bits_equal(mixed[2], host[1])
    # a full pool takes no more windows; an empty budget makes no pool
    port.put_batch([9], 1, feat[:frames], frames)
    assert 9 not in port.slots
    empty = fc.DeviceFeatureCache(per - 1)
    empty.put_batch([1], 1, feat[:frames], frames)
    assert empty.buf is None and empty.lookup_partial([1], 1) is None


def test_device_pool_holds_float8():
    feat = fc.to_float8_e4m3fn(torch.cat(rows(2, torch.float32, seed=4)))
    pool = fc.DeviceFeatureCache(1 << 20)
    pool.put_batch([3, 4], 2, feat, SHAPE[0])
    assert pool.buf.dtype == torch.float8_e4m3fn
    assert bits_equal(pool.gather([1, 0]), torch.cat([feat[SHAPE[0]:], feat[:SHAPE[0]]]))


def test_f8_rounding_matches_jax_bit_for_bit():
    """Every bfloat16 bit pattern (ties, subnormals, values past 448,
    infinities, NaNs) and f32 values around the edges, cast as JAX casts
    them: ``jnp.asarray(x, jnp.bfloat16).astype(jnp.float8_e4m3fn)``."""
    every = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    want = np.asarray(jnp.asarray(to_np(every)).astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = fc.to_float8_e4m3fn(every).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)
    edges = torch.tensor([448, 463.99, 464, 464.01, 480, 1e30, float("inf"), -464.01, 2**-9, 2**-10,
                          3 * 2**-10, 2**-6, 1.0625, 1.1875, -0.0, float("nan")], dtype=torch.float32)
    want = np.asarray(jnp.asarray(edges.numpy()).astype(jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(fc.to_float8_e4m3fn(edges).view(torch.uint8).numpy(), want)
    # torch's own cast saturates where JAX's gives NaN: the reason for the fix-up
    assert torch.tensor([480.0]).to(torch.float8_e4m3fn).float().item() == 448.0
    assert torch.isnan(fc.to_float8_e4m3fn(torch.tensor([480.0])).float()).all()


def test_fingerprints_change_with_one_tensor():
    g = torch.Generator().manual_seed(5)
    tree = {"b.weight": torch.randn(3, 4, generator=g).bfloat16(), "a.running_var": torch.rand(4, generator=g),
            "q.act": torch.tensor(2.0)}
    fp = fc.tree_fingerprint(tree)
    assert fp == fc.tree_fingerprint(dict(reversed(list(tree.items()))))  # name order, not insertion order
    changed = dict(tree, **{"b.weight": tree["b.weight"].clone()})
    changed["b.weight"][1, 2] = changed["b.weight"][1, 2] + 1
    assert fc.tree_fingerprint(changed) != fp
    assert fc.tree_fingerprint(dict(tree, **{"a.running_var": tree["a.running_var"].double()})) != fp
    assert fc.tree_fingerprint(tree, {"x": torch.zeros(1)}) != fp

    class Loader:
        class plan:
            windows = [["a/x.tfrecord"], ["a/y.tfrecord", "b/z.tfrecord"]]

    assert fc.windows_fingerprint(Loader) == jfc.windows_fingerprint(Loader)
    before = fc.windows_fingerprint(Loader)
    Loader.plan.windows = Loader.plan.windows[::-1]
    assert fc.windows_fingerprint(Loader) != before
