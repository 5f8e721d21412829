"""Temporary directories that the port's tests delete when done with them.

pytest keeps the base temp directories of its last runs, every test's
``tmp_path`` in them; the port's tests write checkpoints of hundreds of MB,
so what they left filled the disk over a few runs. Here each directory is
pytest's own (under ``tmp_path_factory``, so ``--basetemp`` and xdist's
worker directories apply) and is removed at teardown:

- ``tmp_path``, a function's directory: a test module that imports it
  (``from torch_tmp import tmp_path  # noqa: F401``) gets it in place of
  pytest's ``tmp_path`` for its tests and fixtures;
- ``module_dir(tmp_path_factory, name, need_mb)``, a module fixture's
  directory, as a context manager around the fixture's ``yield``.

``need_disk`` fails a fixture that writes more than 100 MB with the free
and needed space in its message when the disk cannot hold it.
"""

import contextlib
import shutil

import pytest


def need_disk(path, need_mb: int, what: str) -> None:
    """Fail unless the disk under ``path`` has ``need_mb`` MB free."""
    free = shutil.disk_usage(path).free
    if free < need_mb * 2**20:
        pytest.fail(f"{what} writes about {need_mb} MB under {path}, and the disk has {free / 2**20:.0f} MB free "
                    f"({need_mb * 2**20} bytes needed, {free} free)")


@contextlib.contextmanager
def module_dir(tmp_path_factory, name: str, need_mb: int = 0):
    """A new directory under pytest's base temp directory, removed when the
    block ends; with ``need_mb``, first checked to have that much disk
    free."""
    path = tmp_path_factory.mktemp(name)
    try:
        if need_mb:
            need_disk(path, need_mb, name)
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed at the test's teardown."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)
