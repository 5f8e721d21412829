"""The port package's own rules: it imports no JAX, flax, msgpack or
matplotlib and nothing of the JAX package, and its entry points refuse to
run without a device they can use.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from acoustic_image_generation_tpu_torch import resolve_device
from acoustic_image_generation_tpu_torch.models.quant import QuantTrunk
from acoustic_image_generation_tpu_torch.ops import qgemm
from acoustic_image_generation_tpu_torch.serving import EmbeddingService, GenerationService
from acoustic_image_generation_tpu_torch.train.embed import EmbedConfig, EmbedTask
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask, no_tf32
from acoustic_image_generation_tpu_torch.train.trainer import Trainer
from torch_threads import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import acoustic_image_generation_tpu_torch as port
        for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            importlib.import_module(m.name)
        import chip_smoke
        needed = ["acoustic_image_generation_tpu_torch.data." + m for m in
                  ("tfrecord", "proto", "schema", "windowing", "native", "pipeline", "synthetic")]
        needed.append("acoustic_image_generation_tpu_torch.train.feature_cache")
        needed += ["acoustic_image_generation_tpu_torch." + m for m in
                   ("core.config", "core.msgpack", "train.checkpoint", "train.warmstart", "evaluation.iou",
                    "evaluation.localize", "utils.tb_events", "utils.logger", "cli.main", "cli.tools",
                    "core.tf1_format", "core.tf1_import", "core.tf1_export", "data.stats", "evaluation.distance",
                    "evaluation.knn", "evaluation.retrieve", "evaluation.export", "evaluation.aggregate",
                    "utils.xlsx", "models.associators", "train.reconstruct", "train.project", "train.joint",
                    "parallel.mesh", "data.convert", "data.listing", "data.tut", "utils.profiling")]
        assert all(m in sys.modules for m in needed), [m for m in needed if m not in sys.modules]
        bad = sorted(
            m for m in sys.modules
            if m.startswith("jax") or m.startswith("flax") or m.startswith("ml_dtypes")
            or m.split(".")[0] in ("msgpack", "matplotlib", "optax", "tensorflow")
            or m == "acoustic_image_generation_tpu"
            or m.startswith("acoustic_image_generation_tpu.")
        )
        print(len([m for m in sys.modules if m.startswith(port.__name__)]), bad)
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 72  # every module of the package, subpackages included
    assert bad == "[]"


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationTask(GenerationConfig(resnet_units=(1, 1, 1, 1)))
    int8 = GenerationConfig(resnet_units=(1, 1, 1, 1), trunk_bn="frozen", trunk_quant="int8", fused_qgemm=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationTask(int8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationTask(int8, device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    # the service runs where its task runs: an int8 task on the CPU serves there
    service = GenerationService(GenerationTask(int8, device="cpu"))
    assert service.device == torch.device("cpu") and service.qtrunk is None
    with pytest.raises(ValueError, match="trunk_quant"):
        GenerationService(GenerationTask(GenerationConfig(resnet_units=(1, 1, 1, 1)), device="cpu"),
                          qtrunk=QuantTrunk(((64, 1, 1), (128, 1, 2), (256, 1, 2), (512, 1, 1))))
    # the embedding family: the task, its service and its trainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbedTask()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbedTask(EmbedConfig(compute_dtype="float32"), device="cuda")
    embed = EmbedTask(EmbedConfig(compute_dtype="float32"), device="cpu")
    assert EmbeddingService(embed).device == torch.device("cpu")
    assert Trainer(embed).device == torch.device("cpu") and not embed.reads_mfcc
    # the cached-feature trainer
    cached = GenerationConfig(resnet_units=(1, 1, 1, 1), trunk_bn="frozen", cache_trunk_features=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(GenerationTask(cached))
    trainer = Trainer(GenerationTask(cached, device="cpu"))
    assert trainer.device == torch.device("cpu") and trainer.feature_cache is not None


def test_qgemm_s8_runs_its_plain_version_on_the_cpu_only():
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-127, 128, (40, 64), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (32, 64), generator=g, dtype=torch.int8)
    res = torch.randint(-127, 128, (40, 32), generator=g, dtype=torch.int8)
    factor, bias = torch.rand(32, generator=g) * 1e-3, torch.randn(32, generator=g)
    args = (x, w, factor, bias, torch.tensor(9.0))
    kw = dict(relu=True, residual=res, residual_amax=torch.tensor(2.0))
    launches = qgemm.qgemm_s8.launches
    assert torch.equal(qgemm.qgemm_s8(*args, **kw), qgemm.qgemm_s8_reference(*args, **kw))
    assert qgemm.qgemm_s8.launches == launches
    meta = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in args]
    with pytest.raises(ValueError, match="cpu or cuda"):
        qgemm.qgemm_s8(*meta, relu=True)
    with pytest.raises(ValueError, match="cpu or cuda"):
        qgemm.qgemm_s8(x, w.to("meta"), factor, bias, torch.tensor(9.0), relu=True)


def test_service_checks_requests():
    task = GenerationTask(
        GenerationConfig(resnet_units=(1, 1, 1, 1), compute_dtype="float32"), device="cpu"
    ).init_params(0)
    service = GenerationService(task)
    audio = torch.zeros((2, 1024), dtype=torch.int32)
    video = torch.zeros((2, 224, 298, 3), dtype=torch.uint8)
    with pytest.raises(TypeError):
        service(audio.float(), video, 0)
    with pytest.raises(ValueError):
        service(audio[:, :512], video, 0)
    with pytest.raises(ValueError):
        service(audio[:1], video, 0)


def test_no_tf32_scope_restores_the_global_flags(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(ZeroDivisionError):
        with no_tf32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
            1 / 0
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
