"""Serving artifacts: a trained model's weights and what a server needs to
rebuild and run it, in one directory, without the trainer, the experiment
configuration or the checkpoint.

Counterpart of ``acoustic_image_generation_tpu/core/serving.py``. JAX's
artifact holds a StableHLO program (``module.stablehlo``), which the port
cannot run; the port's artifact is the form JAX calls external weights,
with the model rebuilt from its description instead of a program:

  ``weights.msgpack``  the trees in JAX's layout (``params``,
                       ``batch_stats``; ``qtrunk`` for the int8 trunk,
                       ``spec_stats`` for an embedding model that normalizes
                       its spectrograms), flax's MessagePack
                       (``core/msgpack.py``)
  ``manifest.json``    JAX's keys for the kind (signature, batch, channels,
                       ``weights_sha256``), plus ``format``
                       (``aig-serving-torch-v1``), ``platforms``,
                       ``external_weights``, ``weights_bytes``, the file's
                       ``external_weights_sha256`` and ``model``: the task's
                       class and configuration

``weights_sha256`` is JAX's ``_params_digest`` of the same trees (leaves in
sorted-key order, each its dtype name, shape and bytes), so the same
weights give the same digest in both packages. Five kinds, as JAX's:

    export_generation(task, out_dir, energy=True)   -> model.generate(mfcc, video, seed)
    export_classification(task, out_dir)            -> model.classify(inputs)
    export_embedding(task, out_dir, use_mean=False) -> model.embed(acoustic, audio, video, seed)
    export_projection(task, out_dir)                -> model.project(audio, video, seed)
    export_joint(task, out_dir)                     -> model.project(audio, video, seed)

    model = load_artifact(out_dir)                  # on cuda; device="cpu" for the CPU

``load_artifact`` checks the format and the file's digest, rebuilds the
task, loads the weights once onto its device (``bridge.load_flax``,
``bridge.load_qtrunk``) and serves through ``serving.py``'s services, so an
artifact runs the same modules and kernels as the in-process path. The
noise of a request is drawn from a ``torch.Generator`` seeded with its
``seed`` (JAX: ``jax.random.key(seed)``); ``eps=`` hands in given noise.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from collections.abc import Mapping

import numpy as np
import torch

from acoustic_image_generation_tpu_torch import FRAMES_PER_SECOND, bridge, resolve_device
from acoustic_image_generation_tpu_torch.core import msgpack
from acoustic_image_generation_tpu_torch.core.config import _build
from acoustic_image_generation_tpu_torch.models.quant import QuantTrunk
from acoustic_image_generation_tpu_torch.serving import (
    ClassificationService,
    EmbeddingService,
    GenerationService,
    ProjectionService,
)
from acoustic_image_generation_tpu_torch.train import classify
from acoustic_image_generation_tpu_torch.train.embed import EmbedConfig, EmbedTask
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask
from acoustic_image_generation_tpu_torch.train.joint import JointConfig, JointTask
from acoustic_image_generation_tpu_torch.train.project import ProjectConfig, ProjectTask

FORMAT = "aig-serving-torch-v1"
JAX_FORMAT = "aig-serving-v1"
PLATFORMS = ("cuda", "cpu")
WEIGHTS = "weights.msgpack"
MANIFEST = "manifest.json"

# the task classes an artifact may name, with their configuration classes
_TASKS = {
    "GenerationTask": (GenerationTask, GenerationConfig),
    "ClassificationTask": (classify.ClassificationTask, classify.ClassifyConfig),
    "GeneratedClassificationTask": (classify.GeneratedClassificationTask, classify.ClassifyConfig),
    "CorrespondenceTask": (classify.CorrespondenceTask, classify.ClassifyConfig),
    "EmbedTask": (EmbedTask, EmbedConfig),
    "ProjectTask": (ProjectTask, ProjectConfig),
    "JointTask": (JointTask, JointConfig),
}


def params_digest(*trees) -> str:
    """JAX's ``_params_digest``: SHA-256 over every leaf of ``trees`` (None
    holds none), in ``jax.tree_util``'s order (dict keys sorted at every
    level), each as its dtype name, its shape and its C-order bytes
    (``tobytes``; a 0-dim leaf stays 0-dim)."""
    h = hashlib.sha256()

    def walk(node):
        if node is None:
            return
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(node[k])
            return
        arr = np.asarray(node.detach().cpu().numpy() if isinstance(node, torch.Tensor) else node)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))  # tobytes()'s bytes, uncopied

    for tree in trees:
        walk(tree)
    return h.hexdigest()


def _batch(batch) -> int | str:
    if batch == "poly":
        return "poly"
    if int(batch) < 1:
        raise ValueError(f"batch must be 'poly' or a positive int, got {batch!r}")
    return int(batch)


def _platforms(platforms) -> list[str]:
    names = [p.strip() for p in platforms if p.strip()]
    unknown = sorted(set(names) - set(PLATFORMS))
    if unknown or not names:
        raise ValueError(f"the port serves on {', '.join(PLATFORMS)}; got platforms {names}")
    return names


def _model(task) -> dict:
    """The manifest's description of ``task``: its class and configuration.
    An embedding model's statistics travel in the weights instead of its
    ``stats_dir``."""
    name = type(task).__name__
    if name not in _TASKS:
        raise ValueError(f"no serving artifact for {name}")
    config = dataclasses.asdict(task.cfg)
    if isinstance(task, EmbedTask):
        config["stats_dir"] = None
    return {"task": name, "config": config}


def _write(out_dir: str, kind_manifest: dict, weights: dict, platforms) -> dict:
    """Write ``weights.msgpack`` and ``manifest.json`` (the kind's keys, then
    the format's); returns the manifest."""
    platforms = _platforms(platforms)
    os.makedirs(out_dir, exist_ok=True)
    h, size = hashlib.sha256(), 0
    with open(os.path.join(out_dir, WEIGHTS), "wb") as f:
        for part in msgpack.pack(weights):
            h.update(part)
            size += len(part)
            f.write(part)
    manifest = {
        "format": FORMAT,
        **kind_manifest,
        "platforms": platforms,
        "external_weights": True,
        "weights_bytes": size,
        "external_weights_sha256": h.hexdigest(),
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def export_generation(task: GenerationTask, out_dir: str, *, energy: bool = False, qtrunk: QuantTrunk | None = None,
                      batch: int | str = "poly", platforms=PLATFORMS, spatial_shards: int = 1) -> dict:
    """``task.generate`` (and, with ``energy``, ``find_logen`` of its output)
    around ``task``'s weights as they stand; ``qtrunk`` the calibrated int8
    trunk of a task with ``trunk_quant="int8"``, served unfused. Returns the
    manifest."""
    channels = 13 if task.cfg.datatype == "music" else 12  # JAX's data.num_channels
    if energy and channels != 12:
        raise ValueError("energy inversion is defined for 12-channel MFCC images")
    if spatial_shards > 1:
        raise NotImplementedError("spatial_shards > 1 (a request's image rows split over devices) is not ported: "
                                  "the port splits the training batch of the generation, embedding and reconstruction "
                                  "tasks only (ROADMAP.md Queue 1, item 8.1, second half)")
    int8 = task.cfg.trunk_quant == "int8"
    if int8 and task.cfg.fused_qgemm:
        raise ValueError(
            "export with fused_qgemm is unsupported: an artifact serves the same numbers on every platform it "
            "lists, and the qgemm_s8 kernel runs only on CUDA, one int8 quantum away from the unfused trunk that "
            "the CPU runs; export without --fused_qgemm (the artifact serves the unfused int8 trunk)")
    if int8 != (qtrunk is not None):
        raise ValueError("an int8 task exports with its calibrated qtrunk, and only an int8 task takes one")
    params, batch_stats = bridge.to_flax(task)
    weights = {"params": params, "batch_stats": batch_stats}
    qtree = None
    if qtrunk is not None:
        weights["qtrunk"] = qtree = bridge.qtrunk_to_tree(qtrunk)
    return _write(out_dir, {
        "kind": "generation",
        "batch": _batch(batch),
        "channels": channels,
        "energy": bool(energy),
        "spatial_shards": 1,
        "trunk_quant": "int8" if int8 else "none",
        "inputs": {"mfcc": ["b", 12], "video": ["b", 224, 298, 3], "seed": []},
        "outputs": ["generated", "energy"] if energy else ["generated"],
        "weights_sha256": params_digest(params, batch_stats, qtree),
        "model": _model(task),
    }, weights, platforms)


def export_classification(task: classify.ClassificationTask, out_dir: str, *, batch: int | str = "poly",
                          platforms=PLATFORMS) -> dict:
    """DualCamNet's clip logits from per-frame acoustic images (or MFCC
    vectors with ``mfccmap``). The digest covers the parameters, as JAX's."""
    params, batch_stats = bridge.to_flax(task)
    cfg, frames = task.cfg, task.num_frames
    spec = ["b*F", 12] if cfg.mfccmap else ["b*F", 36, 48, cfg.num_channels]
    return _write(out_dir, {
        "kind": "classification",
        "batch": _batch(batch),
        "channels": cfg.num_channels,
        "num_frames": frames,
        "num_classes": cfg.num_classes,
        "mfccmap": bool(cfg.mfccmap),
        "inputs": {"mfcc" if cfg.mfccmap else "acoustic": spec},
        "outputs": ["clip_logits"],
        "weights_sha256": params_digest(params),
        "model": _model(task),
    }, {"params": params, "batch_stats": batch_stats}, platforms)


def export_embedding(task: EmbedTask, out_dir: str, *, use_mean: bool = False, batch: int | str = "poly",
                     platforms=PLATFORMS) -> dict:
    """The three aligned per-second latents from one second of each
    modality (the spectrogram frontend, the ``stft`` kernel, included);
    ``use_mean`` serves the means."""
    params, batch_stats = bridge.to_flax(task)
    c = task.cfg.num_channels
    weights = {"params": params, "batch_stats": batch_stats}
    if task.spec_stats is not None:
        weights["spec_stats"] = {k: t.detach().cpu().numpy() for k, t in zip(("mean", "std"), task.spec_stats)}
    return _write(out_dir, {
        "kind": "embedding",
        "batch": _batch(batch),
        "channels": c,
        "latent_dim": task.cfg.latent_dim,
        "use_mean": bool(use_mean),
        "inputs": {"acoustic": ["b*12", 36, 48, c], "audio": ["b*12", 1024], "video": ["b*12", 224, 298, 3],
                   "seed": []},
        "outputs": ["z_acoustic", "z_audio", "z_video"],
        "weights_sha256": params_digest(params, batch_stats),
        "model": _model(task),
    }, weights, platforms)


def export_projection(task: ProjectTask, out_dir: str, *, batch: int | str = "poly", platforms=PLATFORMS) -> dict:
    """Acoustic images from one second of audio and video: the frozen
    encoders' latents translated by the associators and decoded by the
    acoustic VAE (``ProjectTask.project``)."""
    return _from_audio_video(task, out_dir, "projection",
                             {"encoder_type": task.cfg.encoder_type, "fusion": bool(task.cfg.fusion)}, batch, platforms)


def export_joint(task: JointTask, out_dir: str, *, batch: int | str = "poly", platforms=PLATFORMS) -> dict:
    """Acoustic images from one second of audio and video through the joint
    associator's acoustic map and the acoustic stage 2
    (``JointTask.project``): ``onlyaudiovideo`` or ``fusion``; the plain
    variant reads real acoustic features and raises."""
    if not (task.cfg.onlyaudiovideo or task.cfg.fusion):
        raise ValueError("joint serving needs --onlyaudiovideo or --fusion (the plain jointmvae associator "
                         "consumes real acoustic features)")
    variant = "onlyaudiovideo" if task.cfg.onlyaudiovideo else "fusion"
    return _from_audio_video(task, out_dir, "joint", {"variant": variant}, batch, platforms)


def _from_audio_video(task, out_dir: str, kind: str, extra: dict, batch, platforms) -> dict:
    params, batch_stats = bridge.to_flax(task)
    return _write(out_dir, {
        "kind": kind,
        "batch": _batch(batch),
        "channels": task.cfg.num_channels,
        **extra,
        "inputs": {"audio": ["b*12", 1024], "video": ["b*12", 224, 298, 3], "seed": []},
        "outputs": ["generated"],
        "weights_sha256": params_digest(params, batch_stats),
        "model": _model(task),
    }, {"params": params, "batch_stats": batch_stats}, platforms)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ServingModel:
    """A loaded serving artifact: its task on one device behind the service
    of its kind; ``generate``, ``classify``, ``embed`` or ``project``, numpy
    arrays out (a tensor's input may already sit on the device). Here only
    the manifest's checks, the kind and a fixed batch; the services check
    the shapes, whole clips and whole seconds, as they do in process."""

    def __init__(self, manifest: dict, task, qtrunk: QuantTrunk | None = None):
        self.manifest = manifest
        self.task = task
        self.device = task.device
        kind = self.kind
        if kind == "generation":
            self.service = GenerationService(task, qtrunk)
        elif kind == "classification":
            self.service = ClassificationService(task)
        elif kind == "embedding":
            self.service = EmbeddingService(task)
        elif kind in ("projection", "joint"):
            self.service = ProjectionService(task)
        else:
            raise ValueError(f"unknown artifact kind {kind!r}")

    @property
    def kind(self) -> str:
        return self.manifest.get("kind", "generation")

    def _check_batch(self, rows: int, per_item: int = 1) -> None:
        """A fixed-batch artifact takes its batch of items, ``per_item``
        leading rows each, and nothing else."""
        fixed = self.manifest["batch"]
        if fixed != "poly" and rows != fixed * per_item:
            raise ValueError(f"artifact was exported at fixed batch {fixed} ({fixed * per_item} rows), got {rows}")

    def generate(self, mfcc, video, seed: int = 0, *, eps=None, generator=None):
        """``mfcc`` (N,12) and ``video`` (N,224,298,3) float32, model-ready ->
        ``generated`` (N,36,48,C) float32, and ``energy`` (N,36,48) when the
        artifact was exported with it. ``eps`` (N,150) or ``generator``
        replace the draw from ``seed``."""
        if self.kind != "generation":
            raise ValueError(f"{self.kind} artifact has no generate()")
        self._check_batch(mfcc.shape[0])
        energy = self.manifest["energy"]
        gen, emap = self.service.generate(_f32(mfcc), _f32(video), seed, eps=eps, generator=generator,
                                          energy=energy)
        return (_numpy(gen), _numpy(emap)) if energy else _numpy(gen)

    def classify(self, inputs):
        """Per-frame acoustic images (N*F,36,48,C), or MFCC vectors (N*F,12)
        for ``mfccmap`` artifacts -> clip logits (N, num_classes)."""
        if self.kind != "classification":
            raise ValueError(f"{self.kind} artifact has no classify()")
        self._check_batch(inputs.shape[0], self.manifest["num_frames"])
        return _numpy(self.service(_f32(inputs)))

    def embed(self, acoustic, audio, video, seed: int = 0, *, eps=None):
        """One second per 12 rows of each modality -> ``{"acoustic",
        "audio", "video"}`` latents (N, latent_dim); ``eps`` (N, latent_dim)
        replaces the draw from ``seed``."""
        if self.kind != "embedding":
            raise ValueError(f"{self.kind} artifact has no embed()")
        self._check_batch(acoustic.shape[0], FRAMES_PER_SECOND)
        z = self.service(_f32(acoustic), _f32(audio), _f32(video), seed, use_mean=self.manifest["use_mean"],
                         eps=eps)
        return dict(zip(("acoustic", "audio", "video"), map(_numpy, z)))

    def project(self, audio, video, seed: int = 0, *, eps=None):
        """One second per 12 rows (audio (N*12,1024), video (N*12,224,298,3))
        -> generated acoustic images (N,36,48,C), for projection and joint
        artifacts; ``eps`` (N,150) replaces the draw from ``seed``."""
        if self.kind not in ("projection", "joint"):
            raise ValueError(f"{self.kind} artifact has no project()")
        self._check_batch(audio.shape[0], FRAMES_PER_SECOND)
        return _numpy(self.service(_f32(audio), _f32(video), seed, eps=eps))


def _f32(x):
    """float32 numpy or tensor, as JAX's ``np.asarray(x, np.float32)``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return np.ascontiguousarray(x, dtype=np.float32)


def _rebuild(model: dict, device):
    """The task an artifact's ``model`` entry describes, on ``device``."""
    name = model.get("task")
    if name not in _TASKS:
        raise ValueError(f"artifact names an unknown task {name!r}")
    cls, config_cls = _TASKS[name]
    values = dict(model["config"])
    if config_cls is classify.ClassifyConfig and values.get("generation") is not None:
        values["generation"] = _build(GenerationConfig, values["generation"])
    if config_cls is EmbedConfig:
        values["normalize_spectrogram"] = False  # the statistics come with the weights
    return cls(_build(config_cls, values), device=device)


def load_artifact(art_dir: str, device: str | torch.device | None = None) -> ServingModel:
    """Load an artifact directory written by one of the ``export_*``
    functions onto ``device`` (``cuda`` unless given): the format, the
    platform and the weights file's digest (which covers its size) are
    checked first."""
    with open(os.path.join(art_dir, MANIFEST)) as f:
        manifest = json.load(f)
    fmt = manifest.get("format")
    if fmt == JAX_FORMAT:
        raise ValueError(
            f"{art_dir} is a JAX serving artifact ({JAX_FORMAT}): it holds a StableHLO program "
            "(module.stablehlo), which the port does not run; export the checkpoint with the port's "
            "tools export-serving")
    if fmt != FORMAT:
        raise ValueError(f"unsupported serving artifact format {fmt!r}")
    dev = resolve_device(device)
    if dev.type not in manifest.get("platforms", []):
        raise RuntimeError(f"artifact exported for {manifest.get('platforms')}, runtime is {dev.type!r}")
    if manifest.get("spatial_shards", 1) > 1:
        raise NotImplementedError("spatially sharded artifacts are not ported: the port splits the training "
                                  "batch only (ROADMAP.md Queue 1, item 8.1, second half)")
    with open(os.path.join(art_dir, WEIGHTS), "rb") as f:
        blob = f.read()
    digest = hashlib.sha256(blob).hexdigest()
    if digest != manifest.get("external_weights_sha256"):
        raise ValueError(f"{WEIGHTS} digest mismatch vs manifest.json ({digest[:12]}... != "
                         f"{str(manifest.get('external_weights_sha256'))[:12]}...): weights and manifest do not "
                         "belong to the same export")
    weights = msgpack.msgpack_restore(blob)
    task = _rebuild(manifest["model"], dev)
    bridge.load_flax(task, weights["params"], weights["batch_stats"])
    if "spec_stats" in weights:
        task.spec_stats = tuple(torch.from_numpy(np.array(weights["spec_stats"][k])).to(dev, torch.float32)
                                for k in ("mean", "std"))
    qtrunk = None
    if "qtrunk" in weights:
        qtrunk = bridge.load_qtrunk(QuantTrunk(task.resnet.blocks, device=dev), weights["qtrunk"])
    del blob, weights
    return ServingModel(manifest, task, qtrunk)
