"""HTTP server for serving artifacts (``core/serving.py``).

Counterpart of ``acoustic_image_generation_tpu/core/server.py``, with the
same protocol (stdlib ``http.server``, numpy ``.npz`` bodies):

  ``GET  /healthz``   -> ``{"ok": true, "kind": ...}`` once the model is
                         loaded (readiness probe).
  ``GET  /manifest``  -> the artifact's manifest.json.
  ``POST /call``      -> an ``.npz`` body whose arrays are named as the
                         kind's inputs (``mfcc`` + ``video`` for generation,
                         ``inputs`` for classification, ``acoustic`` +
                         ``audio`` + ``video`` for embedding, ``audio`` +
                         ``video`` for projection and joint; an optional
                         scalar ``seed``); the response is an ``.npz`` of the
                         outputs, named as in the manifest.

Requests run one at a time behind one lock: one model on one card. Two
rules beyond JAX's server:

- A bad request (an empty or corrupt body, a missing array, a wrong type,
  shape or kind: ``EOFError``, ``zipfile.BadZipFile``, ``KeyError``,
  ``TypeError``, ``ValueError``) gets 400 with its message; any other
  failure is the server's, 500, with no detail in the body (the traceback
  goes to the server's stderr).
- Before anything is decompressed, each ``.npy`` entry's shape and dtype
  are read from its header, and a request whose arrays would take more than
  ``max_body_bytes`` once loaded gets 413: the size an uncompressed body
  (``np.savez``, as ``ArtifactClient`` writes it) of the largest accepted
  length holds. A body longer than ``max_body_bytes`` gets 413 from its
  Content-Length; it is read in chunks and thrown away first, so that a
  client still sending it meets the answer and not a reset connection. A
  body that is not a zip archive never reaches ``np.load``, which would
  allocate a bare ``.npy`` body's declared array before reading it.

``ArtifactServer`` takes an artifact directory or an already loaded
``ServingModel``, so that a process keeps one copy of the weights on the
card.
"""

from __future__ import annotations

import io
import json
import sys
import threading
import traceback
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

BAD_REQUEST = (EOFError, zipfile.BadZipFile, KeyError, TypeError, ValueError)


class TooLarge(Exception):
    """The request's arrays would exceed the server's cap."""


def declared_bytes(body: bytes) -> int:
    """The bytes the arrays of an ``.npz`` body would take once loaded, from
    each ``.npy`` entry's header (read through the zip stream, so at most a
    few hundred bytes of each entry are inflated)."""
    total = 0
    with zipfile.ZipFile(io.BytesIO(body)) as z:
        for info in z.infolist():
            with z.open(info) as f:
                version = np.lib.format.read_magic(f)
                if version == (1, 0):
                    shape, _, dtype = np.lib.format.read_array_header_1_0(f)
                else:
                    shape, _, dtype = np.lib.format.read_array_header_2_0(f)
            total += int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    return total


def _call_model(model, arrays: dict) -> dict:
    """Dispatch a request's arrays onto the loaded ``ServingModel`` by kind."""
    kind = model.kind
    seed = int(arrays.get("seed", 0))
    if kind == "generation":
        out = model.generate(arrays["mfcc"], arrays["video"], seed=seed)
        if model.manifest.get("energy"):
            gen, energy = out
            return {"generated": gen, "energy": energy}
        return {"generated": out}
    if kind == "classification":
        return {"clip_logits": model.classify(arrays["inputs"])}
    if kind == "embedding":
        z = model.embed(arrays["acoustic"], arrays["audio"], arrays["video"], seed=seed)
        return {f"z_{k}": v for k, v in z.items()}
    return {"generated": model.project(arrays["audio"], arrays["video"], seed=seed)}


class ArtifactServer:
    """HTTP server around one serving model: an artifact directory (loaded
    onto ``device``) or a loaded ``ServingModel``. ``port=0`` binds a free
    port (read it back from ``.port``); ``serve_forever`` blocks,
    ``start()``/``shutdown()`` run it on a daemon thread."""

    def __init__(self, artifact, host: str = "127.0.0.1", port: int = 0, max_body_bytes: int = 1 << 30,
                 device=None):
        if isinstance(artifact, str):
            from acoustic_image_generation_tpu_torch.core.serving import load_artifact

            artifact = load_artifact(artifact, device=device)
        self.model = artifact
        self._lock = threading.Lock()
        self.max_body_bytes = int(max_body_bytes)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, message: str) -> None:
                self._send(code, json.dumps({"error": message}).encode(), "application/json")

            def do_GET(self):
                if self.path == "/healthz":
                    return self._send(200, json.dumps({"ok": True, "kind": server.model.kind}).encode(),
                                      "application/json")
                if self.path == "/manifest":
                    return self._send(200, json.dumps(server.model.manifest).encode(), "application/json")
                return self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path != "/call":
                    return self._send(404, b"not found", "text/plain")
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    return self._error(400, "bad Content-Length")
                if n > server.max_body_bytes:
                    left = n
                    while left > 0:  # drained 1 MiB at a time, so that the client reads the 413
                        chunk = self.rfile.read(min(left, 1 << 20))
                        if not chunk:
                            break
                        left -= len(chunk)
                    self.close_connection = True
                    return self._error(413, f"body {n} exceeds {server.max_body_bytes}")
                try:
                    body = self.rfile.read(n)
                    if not body:
                        raise EOFError("empty request body")
                    declared = declared_bytes(body)
                    if declared > server.max_body_bytes:
                        raise TooLarge(f"arrays of {declared} bytes exceed {server.max_body_bytes}")
                    with np.load(io.BytesIO(body), allow_pickle=False) as npz:
                        arrays = {k: npz[k] for k in npz.files}
                    with server._lock:
                        outputs = _call_model(server.model, arrays)
                    buf = io.BytesIO()
                    np.savez(buf, **outputs)
                except TooLarge as e:
                    return self._error(413, str(e))
                except BAD_REQUEST as e:
                    return self._error(400, f"{type(e).__name__}: {e}")
                except Exception:  # noqa: BLE001 - the server's fault: 500, logged here, no detail sent
                    traceback.print_exc(file=sys.stderr)
                    return self._error(500, "internal server error")
                return self._send(200, buf.getvalue(), "application/octet-stream")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
