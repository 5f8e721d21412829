"""The port's int8 frozen trunk against the JAX package's with the
multi-unit blocks of ``tests/test_quant.py``: stride-1 identity residuals
(unit 2 of block 1) and the strided identity subsample (the last unit of a
multi-unit strided block), the branches a full ResNet50 spends most units
in. The checks and their tolerances are those of
``tests/test_torch_quant.py``, which holds the one-unit-per-block trunk;
kept in a file of their own so that each file's JAX reference is built in
one process of its own.
"""

import pytest

from test_torch_quant import check_calibrate, check_trunk_forward
from torch_threads import few_torch_threads  # noqa: F401


def test_calibrate_matches_jax():
    check_calibrate("multi")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_trunk_forward_matches_jax(fused):
    check_trunk_forward("multi", fused)
