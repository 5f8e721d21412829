"""The port's artifact server and client (``core/server.py``,
``core/client.py``) on the CPU, on ``127.0.0.1`` with a free port: the
round trip through ``ArtifactClient`` equal to the bit to the loaded
model's own answers (a DualCamNet artifact and a tiny generation artifact
with its energy map), the probes, 404, 413 for a body over the server's
limit and for a small compressed body whose ``.npy`` header declares a huge
array, 400 for each bad-request type (an empty body, a body that is no zip
archive, a missing array, a vector seed, a wrong shape), 500 for a fault in
the model, with no traceback in the answer; the server built on an already
loaded model."""

import io
import json
import urllib.error
import urllib.request
import zipfile

import numpy as np
import pytest

from acoustic_image_generation_tpu_torch.core import serving
from acoustic_image_generation_tpu_torch.core.client import ArtifactClient
from acoustic_image_generation_tpu_torch.core.server import ArtifactServer, declared_bytes
from acoustic_image_generation_tpu_torch.train.classify import ClassificationTask, ClassifyConfig
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from torch_threads import few_torch_threads  # noqa: F401
from torch_tmp import module_dir


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A DualCamNet artifact behind a server started from its directory,
    and a generation artifact behind one started from the loaded model."""
    with module_dir(tmp_path_factory, "served") as tmp:
        cls_dir, gen_dir = tmp / "cls", tmp / "gen"
        serving.export_classification(ClassificationTask(ClassifyConfig(compute_dtype="float32"), device="cpu")
                                      .init_params(0), str(cls_dir))
        serving.export_generation(GenerationTask(GenerationConfig(resnet_units=(1, 1, 1, 1),
                                                                  compute_dtype="float32"),
                                                 device="cpu").init_params(1), str(gen_dir), energy=True)
        cls = ArtifactServer(str(cls_dir), device="cpu")
        gen = ArtifactServer(serving.load_artifact(str(gen_dir), device="cpu"))
        for server in (cls, gen):
            server.start()
        yield cls, gen
        for server in (cls, gen):
            server.shutdown()


def _url(server, path=""):
    return f"http://{server.host}:{server.port}{path}"


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _post(server, body: bytes):
    """(status, parsed JSON body) of a POST /call."""
    req = urllib.request.Request(_url(server, "/call"), data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _frames(seed, n):
    rng = np.random.default_rng(seed)
    return rng.random((n, 36, 48, 12), dtype=np.float32)


def test_round_trip_equals_the_loaded_model(served):
    cls, gen = served
    client = ArtifactClient(_url(cls))
    assert client.kind == "classification" and client.manifest == cls.model.manifest and client.healthy()
    x = _frames(0, 24)
    got = client.classify(x)
    assert got.shape == (2, 10) and got.dtype == np.float32
    np.testing.assert_array_equal(got, cls.model.classify(x))

    client = ArtifactClient(_url(gen))
    rng = np.random.default_rng(1)
    mfcc, video = rng.random((2, 12), dtype=np.float32), rng.random((2, 224, 298, 3), dtype=np.float32)
    images, energy = client.generate(mfcc, video, seed=7)
    want_images, want_energy = gen.model.generate(mfcc, video, seed=7)
    np.testing.assert_array_equal(images, want_images)
    np.testing.assert_array_equal(energy, want_energy)


def test_probes_and_404(served):
    cls, _ = served
    with urllib.request.urlopen(_url(cls, "/healthz")) as r:
        assert json.load(r) == {"ok": True, "kind": "classification"}
    with urllib.request.urlopen(_url(cls, "/manifest")) as r:
        assert json.load(r) == cls.model.manifest
    for method, path in (("GET", "/nope"), ("POST", "/predict")):
        req = urllib.request.Request(_url(cls, path), data=b"" if method == "POST" else None, method=method)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 404


def _declaring(shape, dtype="<f4") -> bytes:
    """A compressed npz whose one ``.npy`` entry declares ``shape`` in its
    header and holds a few kilobytes of zeros."""
    npy = io.BytesIO()
    np.lib.format.write_array_header_1_0(npy, {"descr": dtype, "fortran_order": False, "shape": shape})
    npy.write(bytes(4096))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("inputs.npy", npy.getvalue())
    return buf.getvalue()


def test_413_for_the_body_and_for_declared_arrays(served):
    cls, _ = served
    body = _declaring((10**6, 36, 48, 12))
    assert len(body) < 1000 and declared_bytes(body) == 10**6 * 36 * 48 * 12 * 4
    code, answer = _post(cls, body)
    assert code == 413 and "exceed" in answer["error"]
    # a body over the limit, sent whole by the client: the server drains it before answering 413; and an
    # uncompressed body under the limit whose arrays, once loaded, would take more than the limit
    small = ArtifactServer(cls.model, max_body_bytes=1000)
    small.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            ArtifactClient(_url(small)).classify(_frames(2, 12))
        assert e.value.code == 413 and "exceeds 1000" in json.loads(e.value.read())["error"]
        code, answer = _post(small, _declaring((1000,)))
        assert code == 413 and "arrays of 4000 bytes exceed 1000" in answer["error"]
    finally:
        small.shutdown()


@pytest.mark.parametrize("case", ["EOFError", "BadZipFile", "KeyError", "TypeError", "ValueError"])
def test_400_for_bad_requests(case, served):
    cls, gen = served
    server, body = {
        "EOFError": (cls, b""),
        "BadZipFile": (cls, b"not an npz archive" * 10),
        "KeyError": (cls, _npz(acoustic=_frames(3, 12))),
        "TypeError": (gen, _npz(mfcc=np.zeros((1, 12), np.float32), video=np.zeros((1, 224, 298, 3), np.float32),
                                seed=np.arange(3))),
        "ValueError": (cls, _npz(inputs=_frames(4, 13))),
    }[case]
    code, answer = _post(server, body)
    assert code == 400 and answer["error"].startswith(case), answer


def test_500_for_a_fault_in_the_model(served, monkeypatch):
    cls, _ = served

    def fault(inputs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(cls.model, "classify", fault)
    code, answer = _post(cls, _npz(inputs=_frames(5, 12)))
    assert code == 500 and answer == {"error": "internal server error"}
