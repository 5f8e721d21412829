"""The port package's own rules: it imports no JAX and nothing of the JAX
package, and its entry points refuse to run without a device they can use.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from acoustic_image_generation_tpu_torch import resolve_device
from acoustic_image_generation_tpu_torch.serving import GenerationService
from acoustic_image_generation_tpu_torch.train.generation import GenerationConfig, GenerationTask, no_tf32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import acoustic_image_generation_tpu_torch as port
        for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            importlib.import_module(m.name)
        import chip_smoke
        bad = sorted(
            m for m in sys.modules
            if m.startswith("jax") or m.startswith("flax")
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
    assert int(count) > 15
    assert bad == "[]"


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationTask(GenerationConfig(resnet_units=(1, 1, 1, 1)))
    assert resolve_device("cpu") == torch.device("cpu")


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
