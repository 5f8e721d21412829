"""Launch plans and argument checks of the trunk's two Hopper GEMM kernels
(``ops/gemm_plan.py``; ``csrc/matmul_stats.cu``, ``csrc/qgemm_s8.cu``),
which run only on the card: the host-side logic around them, on the CPU.

Every (M, N) the full-width trunk gives the kernels is planned, at a
request's 96 frames and a train step's 768: the 36 1x1 convs of one trunk
forward (each unit's conv1 and conv3, and the first unit's projection
shortcut), which run on ``qgemm_s8`` in the int8 trunk and on
``matmul_stats`` in the ``fused_bn_stats`` train-mode trunk. A plan must fit
a block's shared memory on an H100 (232,448 bytes), cover N with tiles
that are not empty, read x once for N <= 256, and put about one block on
each SM.
"""

import pytest
import torch

from acoustic_image_generation_tpu_torch.models.resnet import RESNET50_BLOCKS
from acoustic_image_generation_tpu_torch.ops import conv_stats, gemm_plan, qgemm
from torch_threads import few_torch_threads  # noqa: F401

SMS = 132  # H100 SXM
KERNELS = ("matmul_stats", "qgemm_s8")


def trunk_convs():
    """(rows per frame, K, N) of the trunk's 36 1x1 stride-1 convs."""
    out = []
    h, w, in_ch = 55, 74, 64  # after the stem and its max-pool
    for base, units, block_stride in RESNET50_BLOCKS:
        for u in range(1, units + 1):
            s = block_stride if u == units else 1
            ho, wo = -(-h // s), -(-w // s)
            if base * 4 != in_ch:
                out.append((ho * wo, in_ch, base * 4))
            out.append((h * w, in_ch, base))
            out.append((ho * wo, base, base * 4))
            h, w, in_ch = ho, wo, base * 4
    return out


def test_trunk_convs_are_the_36_launches():
    convs = trunk_convs()
    assert len(convs) == 36
    assert len({(k, n) for _, k, n in convs}) == 15
    assert {k for _, k, _ in convs} | {n for _, _, n in convs} == {64, 128, 256, 512, 1024, 2048}


@pytest.mark.parametrize("frames", [96, 768])
@pytest.mark.parametrize("kernel", KERNELS)
def test_plan_fits_and_covers_every_trunk_launch(kernel, frames):
    for rows, k, n in trunk_convs():
        m = frames * rows
        p = gemm_plan.plan(kernel, m, k, n, SMS)
        what = f"{kernel} ({m},{k})@({k},{n}): {p}"
        assert p.bn in gemm_plan.TILE_NS, what
        assert p.smem_bytes <= gemm_plan.SMEM_PER_BLOCK, what
        assert p.smem_bytes == gemm_plan.smem_bytes(kernel, p.bn, p.panel), what
        assert p.stages >= 3, what
        # the resident weight panel (qgemm_s8 only) holds all of the tile's K
        if p.panel:
            assert kernel == "qgemm_s8" and -(-k // 128) * p.bn * 128 <= gemm_plan.PANEL_BYTES, what
        else:
            assert kernel == "matmul_stats" or k * p.bn > gemm_plan.PANEL_BYTES, what
        # the N tiles cover N, and none is empty
        assert p.bn * p.n_tiles >= n > p.bn * (p.n_tiles - 1), what
        assert p.n_tiles == -(-n // 256), what  # x read ceil(N/256) times
        assert p.m_tiles * gemm_plan.BM >= m > (p.m_tiles - 1) * gemm_plan.BM, what
        # a persistent grid of at most one block per SM, every block with a row tile
        assert 1 <= p.blocks_m <= p.m_tiles, what
        assert SMS - p.n_tiles < p.blocks_m * p.n_tiles <= SMS, what


def test_n_tile_and_stages():
    assert gemm_plan.n_tile(64) == (64, 1)
    assert gemm_plan.n_tile(128) == (128, 1)
    assert gemm_plan.n_tile(256) == (256, 1)
    assert gemm_plan.n_tile(2048) == (256, 8)
    assert gemm_plan.n_tile(16) == (64, 1)
    assert gemm_plan.n_tile(320) == (256, 2)  # two tiles of 160 columns: 256 wide each
    assert gemm_plan.n_tile(400) == (256, 2)
    assert gemm_plan.n_tile(200) == (256, 1)
    with pytest.raises(ValueError):
        gemm_plan.n_tile(0)
    # every N tile's ring holds 192 KB of stages; beside a panel, 128 KB of x
    for bn in gemm_plan.TILE_NS:
        assert gemm_plan.stages(bn) * (gemm_plan.STAGE_A + bn * 128) == 192 * 1024
        assert gemm_plan.stages(bn, panel=True) * gemm_plan.STAGE_A == 128 * 1024
    assert gemm_plan.use_panel("qgemm_s8", 256, 256) and not gemm_plan.use_panel("qgemm_s8", 256, 272)
    assert gemm_plan.use_panel("qgemm_s8", 64, 1024) and not gemm_plan.use_panel("matmul_stats", 64, 64)


def test_smem_bytes_are_the_kernels():
    """The numbers the kernels compute for themselves (their ``smem_bytes``),
    written out; a launch whose plan disagrees is refused on the card."""
    want = {("matmul_stats", False): {64: 218112, 128: 222208, 256: 230400},
            ("qgemm_s8", False): {64: 208384, 128: 208896, 256: 209920},
            ("qgemm_s8", True): {64: 208384, 128: 208896, 256: 209920}}
    for (kernel, panel), by_bn in want.items():
        for bn, smem in by_bn.items():
            assert gemm_plan.smem_bytes(kernel, bn, panel) == smem, (kernel, bn, panel)


def test_small_and_narrow_plans():
    p = gemm_plan.plan("qgemm_s8", 100, 64, 48, SMS)
    assert (p.bn, p.n_tiles, p.m_tiles, p.blocks_m, p.panel) == (64, 1, 1, 1, True)
    p = gemm_plan.plan("matmul_stats", 10**6, 64, 2048, 8)  # fewer SMs than N tiles: one block a tile
    assert (p.n_tiles, p.blocks_m, p.panel) == (8, 1, False)
    with pytest.raises(ValueError):
        gemm_plan.plan("qgemm_s8", 0, 64, 64, SMS)


def test_qgemm_kernel_argument_checks():
    """What the CUDA wrapper refuses before a launch, checked on CPU tensors
    (the check reads only shapes and addresses)."""
    x = torch.zeros((40, 64), dtype=torch.int8)
    w = torch.zeros((32, 64), dtype=torch.int8)
    qgemm.check_kernel_args(x, w)
    qgemm.check_kernel_args(x, w, torch.zeros((40, 32), dtype=torch.int8))
    with pytest.raises(ValueError, match="multiples of 16"):
        qgemm.check_kernel_args(torch.zeros((40, 40), dtype=torch.int8), torch.zeros((32, 40), dtype=torch.int8))
    with pytest.raises(ValueError, match="multiples of 16"):
        qgemm.check_kernel_args(x, torch.zeros((24, 64), dtype=torch.int8))
    with pytest.raises(ValueError, match="aligned"):
        qgemm.check_kernel_args(x, torch.zeros((33 * 64,), dtype=torch.int8)[1:2049].reshape(32, 64))
    with pytest.raises(ValueError, match="aligned"):
        qgemm.check_kernel_args(x.t().contiguous().t(), w)


def test_matmul_stats_kernel_argument_checks():
    bf16 = torch.bfloat16
    x = torch.zeros((40, 64), dtype=bf16)
    conv_stats.check_kernel_args(x, torch.zeros((64, 24)))
    conv_stats.check_kernel_args(torch.zeros((40, 63)), torch.zeros((63, 5)))  # the f32 kernel takes any K, N
    with pytest.raises(ValueError, match="multiples of 8"):
        conv_stats.check_kernel_args(x, torch.zeros((64, 20)))
    with pytest.raises(ValueError, match="multiples of 8"):
        conv_stats.check_kernel_args(torch.zeros((40, 60), dtype=bf16), torch.zeros((60, 24)))
    with pytest.raises(ValueError, match="multiples of 8"):  # 16-byte alignment of x
        shifted = torch.zeros((41 * 64,), dtype=bf16)[1:-63].reshape(40, 64)
        conv_stats.check_kernel_args(shifted, torch.zeros((64, 24)))
    with pytest.raises(ValueError, match="contiguous"):
        conv_stats.check_kernel_args(torch.zeros((64, 40), dtype=bf16).t(), torch.zeros((64, 24)))
