"""Launch plans of the trunk's two Hopper GEMM kernels, ``csrc/matmul_stats.cu``
(bf16) and ``csrc/qgemm_s8.cu`` (s8), computed on the host.

Both kernels tile the output in 128 rows (two ``wgmma`` warpgroups of 64)
by one N tile of ``bn`` = 64, 128 or 256 columns, and stage K through a
ring of 128-byte rows: 64 bf16 or 128 s8 values of K per stage, so a stage
holds ``128 * 128`` bytes of x and ``bn * 128`` bytes of w for either
kernel. The grid is persistent in M: ``blocks_m`` blocks per N tile, each
walking every ``blocks_m``-th row tile, about one block per SM in all.
Where a block's whole (bn, K) slice of the s8 weights fits in 64 KB
(``panel``), ``qgemm_s8`` loads it once and its ring carries x alone.

The kernels compute their shared-memory size and the panel rule from the
same formulas (``smem_bytes`` and ``use_panel`` in each ``.cu``) and
refuse a launch whose plan disagrees, so a change on one side cannot pass
unnoticed.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

SMEM_PER_BLOCK = 232_448  # bytes of shared memory a block may use on an H100
BM = 128  # rows of a tile
TILE_NS = (64, 128, 256)  # the N tiles the kernels are built for
WARPS = 8
STAGE_A = BM * 128  # bytes of x per stage
SLACK = 1024  # alignment of the ring to a 1024-byte boundary
STAGE_K = {"matmul_stats": 64, "qgemm_s8": 128}  # K values per stage: 128 bytes
PANEL_BYTES = 64 * 1024  # qgemm_s8's resident weight panel
PANEL_STAGES = 8
# per kernel: the warps' epilogue buffers, as a function of bn
EPILOGUE_BYTES = {
    # y staging (16 rows x 128 bytes a warp) + the warps' column partials (2 x bn f32 each)
    "matmul_stats": lambda bn: WARPS * 16 * 128 + WARPS * 2 * bn * 4,
    # int8 staging (16 rows x 80 bytes a warp) + the tile's folded factor and bias
    "qgemm_s8": lambda bn: WARPS * 16 * 80 + 2 * bn * 4,
}


@dataclass(frozen=True)
class GemmPlan:
    bn: int  # columns of an N tile
    n_tiles: int  # N tiles: the grid's second dimension
    stages: int  # ring stages
    panel: bool  # the weights resident in shared memory, the ring x alone
    m_tiles: int  # 128-row tiles
    blocks_m: int  # blocks per N tile: the grid's first dimension
    smem_bytes: int  # dynamic shared memory of a block


def n_tile(n: int) -> tuple[int, int]:
    """``(bn, n_tiles)``: the fewest tiles of at most 256 columns that cover
    ``n``, each the smallest of ``TILE_NS`` that holds an equal share."""
    if n <= 0:
        raise ValueError(f"no N tile for N={n}")
    n_tiles = -(-n // TILE_NS[-1])
    share = -(-n // n_tiles)
    return next(bn for bn in TILE_NS if bn >= share), n_tiles


def stages(bn: int, panel: bool = False) -> int:
    """Ring depth: 192 KB of stages at every N tile without a panel; 128 KB
    of x stages beside the 64 KB panel."""
    return PANEL_STAGES if panel else {256: 4, 128: 6, 64: 8}[bn]


def use_panel(kernel: str, bn: int, k: int) -> bool:
    return kernel == "qgemm_s8" and -(-k // STAGE_K[kernel]) * bn * 128 <= PANEL_BYTES


def smem_bytes(kernel: str, bn: int, panel: bool = False) -> int:
    ring = stages(bn, panel) * (STAGE_A + (0 if panel else bn * 128)) + (PANEL_BYTES if panel else 0)
    return ring + EPILOGUE_BYTES[kernel](bn) + SLACK


@functools.lru_cache(maxsize=256)
def plan(kernel: str, m: int, k: int, n: int, sms: int) -> GemmPlan:
    """The launch of ``kernel`` ("matmul_stats" or "qgemm_s8") for an
    (M, K) @ (K, N) product on a card with ``sms`` SMs."""
    if m <= 0 or k <= 0 or sms <= 0:
        raise ValueError(f"no plan for M={m}, K={k} on {sms} SMs")
    bn, n_tiles = n_tile(n)
    panel = use_panel(kernel, bn, k)
    m_tiles = -(-m // BM)
    blocks_m = max(1, min(m_tiles, sms // n_tiles))
    return GemmPlan(bn, n_tiles, stages(bn, panel), panel, m_tiles, blocks_m, smem_bytes(kernel, bn, panel))
