"""HTTP client for ``tools serve`` (``core/server.py``).

Counterpart of ``acoustic_image_generation_tpu/core/client.py``: the same
methods as a loaded ``ServingModel``, over npz-over-HTTP, on ``urllib`` and
numpy only::

    model = ArtifactClient("http://127.0.0.1:8321")
    gen, energy = model.generate(mfcc, video, seed=7)   # generation
    logits      = model.classify(frames)                # classification
    latents     = model.embed(acoustic, audio, video)   # embedding
    gen         = model.project(audio, video)           # projection, joint

A server's 4xx and 5xx answers raise ``urllib.error.HTTPError``.
"""

from __future__ import annotations

import io
import json
import urllib.request

import numpy as np


class ArtifactClient:
    """Remote handle to one served artifact; ``manifest`` (and ``kind``) are
    fetched once, which also checks the endpoint."""

    def __init__(self, base_url: str, timeout: float = 300.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        with urllib.request.urlopen(f"{self.base_url}/manifest", timeout=timeout) as r:
            self.manifest = json.load(r)

    @property
    def kind(self) -> str:
        return self.manifest.get("kind", "generation")

    def healthy(self) -> bool:
        try:
            with urllib.request.urlopen(f"{self.base_url}/healthz", timeout=self.timeout) as r:
                return bool(json.load(r).get("ok"))
        except OSError:
            return False

    def _call(self, **arrays) -> dict:
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        req = urllib.request.Request(f"{self.base_url}/call", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            with np.load(io.BytesIO(r.read()), allow_pickle=False) as npz:
                return {k: npz[k] for k in npz.files}

    def generate(self, mfcc, video, seed: int = 0):
        out = self._call(mfcc=np.asarray(mfcc, np.float32), video=np.asarray(video, np.float32),
                         seed=np.int32(seed))
        if "energy" in out:
            return out["generated"], out["energy"]
        return out["generated"]

    def classify(self, inputs):
        return self._call(inputs=np.asarray(inputs, np.float32))["clip_logits"]

    def embed(self, acoustic, audio, video, seed: int = 0):
        out = self._call(acoustic=np.asarray(acoustic, np.float32), audio=np.asarray(audio, np.float32),
                         video=np.asarray(video, np.float32), seed=np.int32(seed))
        return {k[len("z_"):]: v for k, v in out.items()}

    def project(self, audio, video, seed: int = 0):
        return self._call(audio=np.asarray(audio, np.float32), video=np.asarray(video, np.float32),
                          seed=np.int32(seed))["generated"]
