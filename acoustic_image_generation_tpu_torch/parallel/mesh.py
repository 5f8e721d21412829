"""Data parallelism over ``torch.distributed``: one process per device.

Counterpart of ``acoustic_image_generation_tpu/parallel/mesh.py``. JAX runs
a step as one program over a ``data`` mesh of every device (GSPMD): the
batch's leading axis is split over the devices, and XLA inserts the
collectives. PyTorch's idiom is one process per device, so here each rank
holds its own rows and the collectives are written out where a computation
couples rows: the train-mode BN statistics (``models/layers.py``,
``ops/conv_stats.py``), the int8 calibration's amaxes (``models/quant.py``),
the gradients (``DistributedDataParallel``, or FSDP2's reduce-scatter), the
reported metrics and the eval sums (``train/trainer.py``).

- ``setup``/``teardown``: the process group of this process (NCCL for
  ``cuda`` devices, gloo for the CPU or for ranks that share a device), or
  one the caller already initialized; ``from_env`` reads ``torchrun``'s
  ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``.
- ``launch``: run a function in ``world`` new processes (start method
  ``spawn``), rank ``r`` on ``cuda:r``, on one shared device, or on the CPU,
  rendezvous through a ``FileStore``; returns every rank's result.
- ``shard_rows``: rank ``r`` owns the contiguous rows ``[r*B/N,
  (r+1)*B/N)`` of a global batch of ``B`` rows, the contract of the
  loader's ``shard_index``/``shard_count`` (``data/pipeline.py``); on more
  than one rank every loader decodes its rank's rows only.
- ``all_reduce_sum`` (differentiable: its backward all-reduces the
  gradient, as JAX's transpose of a ``psum`` does) and ``all_reduce_``.
- ``all_gather_rows`` (differentiable): every rank's rows in rank order, the
  global batch of a loss term that couples rows (the embedding family's
  triplet mining and NCA, the projection's triplet, the music
  correspondence shuffle). Every rank then computes the same global term;
  the backward sums the ranks' gradients and keeps this rank's rows (a
  reduce-scatter, the transpose of JAX's all-gather), so that DDP's average
  of the ranks' gradients is the term's gradient, as it is for the BN
  moments that ``all_reduce_sum`` sums.
- ``fsdp_axis``: JAX's ``fsdp_sharding`` rule on a flax shape; ``full`` and
  ``copy_full_``: a sharded parameter (an FSDP2 ``DTensor``) gathered whole,
  or set from a whole tensor, with plain collectives.

With no group (``world() == 1``) every helper is the identity and the
modules take their one-device paths, so one device computes what it
computed before. ``tp_sharding`` (``tensor_parallel > 1``) and
``spatial_sharding`` (``spatial_shards > 1``) are not ported: they raise
where they are asked for (``ROADMAP.md`` Queue 1, items 8.1.2 and 8.1.3).
"""

from __future__ import annotations

import math
import os
import pickle
import shutil
import tempfile

import torch
import torch.distributed as dist

# torch.distributed's default group is process-wide; this keeps what it does not: the rank's device, and
# whether setup made the group (and so destroys it)
_STATE = {"owned": False, "device": None}


def active() -> bool:
    """Whether this process is a rank of a group, even of one."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def device() -> torch.device | None:
    """This rank's device, as ``setup`` chose it; None without ``setup``."""
    return _STATE["device"]


def is_main() -> bool:
    """Rank 0: the one that writes files."""
    return rank() == 0


def setup(rank_: int, world_: int, *, device="cuda", local_rank: int | None = None, store=None,
          init_method: str | None = None) -> torch.device:
    """Join (or adopt) the process group of ``world_`` ranks as ``rank_``;
    returns this rank's device: ``cuda:{local_rank}`` for ``device="cuda"``,
    else ``device`` as given (``"cpu"``, or one ``"cuda:i"`` shared by every
    rank, over gloo). Without ``store`` or ``init_method`` the group must
    exist already (``torchrun`` with ``init_method="env://"`` is the usual
    way to make one)."""
    local = rank_ if local_rank is None else local_rank
    dev = torch.device(f"cuda:{local}" if device == "cuda" else device)
    if dev.type == "cuda":
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank_} wants {dev}, but {torch.cuda.device_count()} CUDA devices are visible")
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        # NCCL between CUDA devices; gloo on the CPU and between ranks that share one device, which NCCL refuses
        backend = "nccl" if device == "cuda" else "gloo"
        kw = {} if init_method == "env://" else dict(rank=rank_, world_size=world_)
        dist.init_process_group(backend, store=store, init_method=init_method, **kw)
        _STATE["owned"] = True
    if (dist.get_rank(), dist.get_world_size()) != (rank_, world_):
        raise RuntimeError(f"the process group is rank {dist.get_rank()} of {dist.get_world_size()}, "
                           f"not {rank_} of {world_}")
    _STATE["device"] = dev
    return dev


def teardown() -> None:
    """Leave the group (destroyed if ``setup`` made it); back to one
    process."""
    if _STATE["owned"] and dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(owned=False, device=None)


def from_env() -> tuple[int, int, int] | None:
    """``(rank, world, local_rank)`` from ``torchrun``'s environment, or
    None outside it."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    r, w = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return r, w, int(os.environ.get("LOCAL_RANK", r))


# ------------------------------------------------------------------ launch


def _rank_main(r: int, fn, args, world_: int, device: str, store_path: str, out_dir: str) -> None:
    if device == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world_))
    setup(r, world_, device=device, store=dist.FileStore(store_path, world_))
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        teardown()
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(out, f)


def launch(fn, world_: int, *args, device: str = "cuda", tmp_dir: str | None = None):
    """Run ``fn(*args)`` on ``world_`` new ranks (start method ``spawn``;
    ``fn`` must be importable) and return their results, rank 0's first.
    ``device``: ``"cuda"`` puts rank ``r`` on ``cuda:r`` over NCCL (more
    ranks than visible devices raise), ``"cuda:i"`` every rank on that one
    device over gloo, ``"cpu"`` the CPU over gloo. Rendezvous through a
    ``FileStore`` in a fresh directory under ``tmp_dir`` (no ports). A
    failure in any rank ends the others and raises here."""
    import torch.multiprocessing as mp

    if device == "cuda" and world_ > torch.cuda.device_count():
        raise RuntimeError(f"{world_} ranks need {world_} CUDA devices; {torch.cuda.device_count()} are visible")
    work = tempfile.mkdtemp(prefix="aig_ranks_", dir=tmp_dir)
    try:
        mp.start_processes(_rank_main, args=(fn, args, world_, device, os.path.join(work, "store"), work),
                           nprocs=world_, join=True, start_method="spawn")
        out = []
        for r in range(world_):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -------------------------------------------------------------------- rows


def row_range(rows: int, rank_: int | None = None, world_: int | None = None) -> tuple[int, int]:
    """``[lo, hi)`` of rank ``rank_``'s contiguous share of ``rows``."""
    r = rank() if rank_ is None else rank_
    n = world() if world_ is None else world_
    if rows % n:
        raise ValueError(f"{rows} rows do not split over {n} ranks")
    per = rows // n
    return r * per, (r + 1) * per


def shard_rows(x, rank_: int | None = None, world_: int | None = None):
    """This rank's contiguous rows of ``x`` (numpy array or tensor, leading
    axis)."""
    lo, hi = row_range(x.shape[0], rank_, world_)
    return x[lo:hi]


# ------------------------------------------------------------- collectives


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, as a new tensor; differentiable
    (the gradient is summed over the ranks too). The identity with one
    process."""
    if world() == 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllReduceSum.apply(t)
    out = t.clone()
    dist.all_reduce(out)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        t = t.contiguous()
        out = t.new_empty((world() * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t)
        return out

    @staticmethod
    def backward(ctx, g):
        # the sum over the ranks, cut to this rank's rows: a reduce-scatter, written as an all-reduce (gloo has
        # no reduce-scatter; the rows are a loss term's latents, kilobytes)
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return shard_rows(g)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` (equal counts), in rank order: the global
    batch, the inverse of ``shard_rows``. Differentiable: the gradient of
    the gathered rows is summed over the ranks and cut to this rank's rows.
    The identity with one process."""
    return t if world() == 1 else _AllGatherRows.apply(t)


def global_moments(total: torch.Tensor, total_sq: torch.Tensor, count: int):
    """Mean and biased variance over every rank's rows from this rank's f32
    per-channel ``total`` and ``total_sq`` over ``count`` rows: the three are
    summed over the ranks in one all-reduce (differentiable), then flax's
    fast variance ``max(E[x^2] - E[x]^2, 0)``."""
    c = total.shape[0]
    stats = torch.cat([total, total_sq, total.new_full((1,), float(count))])
    stats = all_reduce_sum(stats)
    mean = stats[:c] / stats[2 * c]
    return mean, torch.clamp_min(stats[c:2 * c] / stats[2 * c] - mean * mean, 0.0)


def all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In place: ``t`` summed (``"sum"``), averaged (``"mean"``) or maxed
    (``"max"``) over the ranks; returns ``t``."""
    if world() == 1:
        return t
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
    if op == "mean":
        t.div_(world())
    return t


def barrier() -> None:
    if world() > 1:
        dist.barrier()


# -------------------------------------------------------------------- FSDP


def fsdp_axis(shape, n: int, *, min_size: int = 1 << 18, min_shard_rows: int = 8) -> int | None:
    """The axis JAX's ``fsdp_sharding`` shards a leaf of flax ``shape`` on
    over ``n`` devices, or None (replicated): a leaf of at least
    ``min_size`` entries and two or more axes, the trailing (output) axis
    first, then the one before it, each only if it divides by ``n`` into
    at least ``min_shard_rows`` rows a device."""
    shape = tuple(shape)
    size = math.prod(shape) if shape else 0
    if size >= min_size and len(shape) >= 2:
        for i in (len(shape) - 1, len(shape) - 2):
            if shape[i] % n == 0 and shape[i] // n >= min_shard_rows:
                return i
    return None


def is_sharded(t) -> bool:
    """Whether ``t`` is a sharded parameter (FSDP2 keeps them as
    ``DTensor``s between steps)."""
    if world() == 1:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """The rank's shard of a sharded parameter (in place edits reach it),
    or ``t`` itself."""
    return t.to_local() if is_sharded(t) else t


def shard_dim(t) -> int:
    (placement,) = t.placements
    return placement.dim


def full(t: torch.Tensor, like=None) -> torch.Tensor:
    """A sharded parameter gathered whole, or ``t`` itself when it is not
    sharded. ``like``: ``t`` is the local shard of a tensor laid out as the
    sharded parameter ``like`` (an Adam slot). Every rank must call (one
    ``all_gather_into_tensor``); the shards are even, since the FSDP rule
    shards only axes that divide."""
    ref = t if like is None else like
    if not is_sharded(ref):
        return t
    dim = shard_dim(ref)
    part = local(t).detach().movedim(dim, 0).contiguous()
    out = torch.empty((world() * part.shape[0], *part.shape[1:]), dtype=part.dtype, device=part.device)
    dist.all_gather_into_tensor(out, part)
    return out.movedim(0, dim)


def local_rows_of(whole: torch.Tensor, like) -> torch.Tensor:
    """The rank's shard of a whole tensor, laid out as the sharded ``like``."""
    if not is_sharded(like):
        return whole
    return torch.chunk(whole, world(), shard_dim(like))[rank()]


def copy_full_(t: torch.Tensor, whole: torch.Tensor) -> None:
    """Set ``t`` (sharded or not) from the whole tensor ``whole``."""
    with torch.no_grad():
        local(t).copy_(local_rows_of(whole, t))
