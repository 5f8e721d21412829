"""Data and tensor parallelism over ``torch.distributed``: one process per
device.

Counterpart of ``acoustic_image_generation_tpu/parallel/mesh.py``. JAX runs
a step as one program over a mesh of every device (GSPMD): the batch's
leading axis is split over the ``data`` axis, and XLA inserts the
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
- ``make_grid(tp)``: the ``(data, model)`` grid of JAX's ``make_mesh(N,
  model_parallel=tp)``, the model axis the minor one: rank ``r`` of ``N``
  sits at data index ``r // tp`` and model index ``r % tp``. One process
  group per data group (the ranks of one model index) and one per model
  group (the ranks of one data index), every rank creating every group in
  the same order. ``data_rank``/``data_world`` and
  ``model_rank``/``model_world`` read it; with ``tp == 1`` (no grid) they
  are ``rank()``/``world()`` and ``0``/``1``.
- ``shard_rows``: data rank ``d`` owns the contiguous rows ``[d*B/D,
  (d+1)*B/D)`` of a global batch of ``B`` rows, the contract of the
  loader's ``shard_index``/``shard_count`` (``data/pipeline.py``); on more
  than one data rank every loader decodes its rank's rows only, and the
  ranks of one model group decode the same rows.
- ``all_reduce_sum`` (differentiable: its backward all-reduces the
  gradient, as JAX's transpose of a ``psum`` does) and ``all_reduce_``,
  over the data group.
- ``all_gather_rows`` (differentiable): every data rank's rows in rank
  order, the global batch of a loss term that couples rows (the embedding
  family's triplet mining and NCA, the projection's triplet, the music
  correspondence shuffle). Every rank then computes the same global term;
  the backward sums the ranks' gradients and keeps this rank's rows (a
  reduce-scatter, the transpose of JAX's all-gather), so that DDP's average
  of the ranks' gradients is the term's gradient, as it is for the BN
  moments that ``all_reduce_sum`` sums.
- ``fsdp_axis``: JAX's ``fsdp_sharding`` rule on a flax shape; ``full`` and
  ``copy_full_``: a sharded parameter (an FSDP2 ``DTensor``, or a tensor
  split over the model group) gathered whole, or set from a whole tensor,
  with plain collectives.
- Tensor parallelism (``tensor_parallel = tp > 1``): ``tp_axis`` is JAX's
  ``tp_sharding`` rule on a flax shape (the output axis of a 4-D kernel of
  at least 256 channels that ``tp`` divides); ``split_`` keeps the model
  rank's block of such a parameter (marked, so that ``tp_dim``, ``full``,
  ``local_rows_of`` and ``whole_shape`` know it). A split conv runs as
  Megatron's column-parallel layer with two differentiable collectives over
  the model group: ``sum_input_grad`` (forward the identity, backward the
  sum of the peers' partial input gradients, each from its slice of the
  output channels) on the input and on the whole bias before the local
  conv (which adds the bias's slice), and ``gather_channels``
  (forward an all-gather of the peers' output channels into the whole last
  axis, backward this rank's slice of the gradient, not summed: what
  follows runs replicated on every peer) after it. ``model_sum`` (forward
  a sum over the model group, backward the identity) adds up a replicated
  term's partial sums over split tensors (the L2 terms); ``broadcast_model_``
  makes the peers' replicated gradients, statistics and metrics model rank
  0's, bit for bit.

With no group (``world() == 1``) every helper is the identity and the
modules take their one-device paths, so one device computes what it
computed before. Ranks that share a card over gloo run the collectives of
the grid on host copies of CUDA tensors. JAX's ``spatial_sharding`` (a
request's image rows split over devices, for serving) is one process over a
list of devices, not ranks: ``parallel/spatial.py``.
"""

from __future__ import annotations

import math
import os
import pickle
import shutil
import tempfile

import torch
import torch.distributed as dist

# torch.distributed's default group is process-wide; this keeps what it does not: the rank's device, whether
# setup made the group (and so destroys it), the grid's tp and this rank's data and model groups
_STATE = {"owned": False, "device": None, "tp": 1, "groups": None}


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


# -------------------------------------------------------------------- grid


def make_grid(tp: int) -> None:
    """Lay this process group out as JAX's ``(data = N // tp, model = tp)``
    mesh: rank ``r`` at ``(r // tp, r % tp)``. Every rank must call it with
    the same ``tp`` (each ``dist.new_group`` is collective); a second call
    with the same ``tp`` does nothing, and ``tp == 1`` makes no group."""
    n = world()
    if tp < 1 or n % tp:
        raise ValueError(f"{n} ranks do not split into model groups of tensor_parallel={tp}")
    if tp == _STATE["tp"]:
        return
    if _STATE["tp"] != 1:
        raise RuntimeError(f"the grid already has tensor_parallel={_STATE['tp']}, not {tp}")
    r = rank()
    groups = {}
    for m in range(tp):  # the data groups: the ranks of one model index
        ranks = list(range(m, n, tp))
        group = dist.new_group(ranks)
        if r % tp == m:
            groups["data"] = group
    for d in range(n // tp):  # the model groups: the ranks of one data index
        ranks = list(range(d * tp, (d + 1) * tp))
        group = dist.new_group(ranks)
        if r // tp == d:
            groups.update(model=group, model_ranks=ranks)
    _STATE.update(tp=tp, groups=groups)


def model_world() -> int:
    """The grid's ``tp``: the ranks of a model group."""
    return _STATE["tp"]


def model_rank() -> int:
    return rank() % model_world()


def data_world() -> int:
    """The ranks of a data group: the ways the batch is split."""
    return world() // model_world()


def data_rank() -> int:
    return rank() // model_world()


def data_group():
    """The process group of this rank's data group (None: the default
    group, without a grid)."""
    return None if _STATE["groups"] is None else _STATE["groups"]["data"]


def model_group():
    return _STATE["groups"]["model"]


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
    _STATE.update(owned=False, device=None, tp=1, groups=None)


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
    """``[lo, hi)`` of data rank ``rank_``'s contiguous share of ``rows``
    (this rank's data rank and data world by default)."""
    r = data_rank() if rank_ is None else rank_
    n = data_world() if world_ is None else world_
    if rows % n:
        raise ValueError(f"{rows} rows do not split over {n} ranks")
    per = rows // n
    return r * per, (r + 1) * per


def shard_rows(x, rank_: int | None = None, world_: int | None = None):
    """This data rank's contiguous rows of ``x`` (numpy array or tensor,
    leading axis)."""
    lo, hi = row_range(x.shape[0], rank_, world_)
    return x[lo:hi]


# ------------------------------------------------------------- collectives


def _on_host(t: torch.Tensor, group) -> bool:
    """Whether a collective of ``group`` on ``t`` runs on a host copy: a
    CUDA tensor of gloo ranks (which share a card)."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over ``group``; returns ``t``."""
    if _on_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(t: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group`` concatenated on the first axis,
    in group order."""
    t = t.contiguous()
    if _on_host(t, group):
        host = t.cpu()
        out = host.new_empty((n * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, host, group=group)
        return out.to(t.device)
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _all_reduce(t.clone(), data_group())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), data_group())


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the data ranks, as a new tensor;
    differentiable (the gradient is summed over them too). The identity with
    one data rank."""
    if data_world() == 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllReduceSum.apply(t)
    return _all_reduce(t.clone(), data_group())


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _all_gather(t, data_world(), data_group())

    @staticmethod
    def backward(ctx, g):
        # the sum over the ranks, cut to this rank's rows: a reduce-scatter, written as an all-reduce (gloo has
        # no reduce-scatter; the rows are a loss term's latents, kilobytes)
        return shard_rows(_all_reduce(g.contiguous().clone(), data_group()))


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of ``t`` (equal counts), in rank order: the
    global batch, the inverse of ``shard_rows``. Differentiable: the
    gradient of the gathered rows is summed over the data ranks and cut to
    this rank's rows. The identity with one data rank."""
    return t if data_world() == 1 else _AllGatherRows.apply(t)


def global_moments(total: torch.Tensor, total_sq: torch.Tensor, count: int):
    """Mean and biased variance over every data rank's rows from this
    rank's f32 per-channel ``total`` and ``total_sq`` over ``count`` rows:
    the three are summed over the data ranks in one all-reduce
    (differentiable), then flax's fast variance ``max(E[x^2] - E[x]^2,
    0)``."""
    c = total.shape[0]
    stats = torch.cat([total, total_sq, total.new_full((1,), float(count))])
    stats = all_reduce_sum(stats)
    mean = stats[:c] / stats[2 * c]
    return mean, torch.clamp_min(stats[c:2 * c] / stats[2 * c] - mean * mean, 0.0)


def all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In place: ``t`` summed (``"sum"``), averaged (``"mean"``) or maxed
    (``"max"``) over the data ranks (the ranks of a model group hold the
    same rows, so the same values); returns ``t``."""
    if data_world() == 1:
        return t
    _all_reduce(t, data_group(), dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
    if op == "mean":
        t.div_(data_world())
    return t


def barrier() -> None:
    if world() > 1:
        dist.barrier()


# ------------------------------------------------------ tensor parallelism


def tp_axis(shape, n: int, *, min_channels: int = 256) -> int | None:
    """The flax axis JAX's ``tp_sharding`` splits a leaf of ``shape`` on
    over ``n`` model ranks, or None (replicated): the trailing (output)
    axis of a 4-D kernel of at least ``min_channels`` channels that ``n``
    divides."""
    shape = tuple(shape)
    if len(shape) == 4 and shape[-1] >= min_channels and shape[-1] % n == 0:
        return 3
    return None


def tp_dim(t) -> int | None:
    """The port dim a parameter is split on over the model group (``split_``),
    or None."""
    return getattr(t, "_aig_tp_dim", None)


def split_(p: torch.nn.Parameter, dim: int) -> None:
    """Keep this model rank's block of ``p`` along ``dim`` (its memory
    format kept) and mark ``p`` as split there."""
    with torch.no_grad():
        fmt = torch.channels_last if p.dim() == 4 and p.is_contiguous(memory_format=torch.channels_last) \
            else torch.contiguous_format
        p.data = torch.chunk(p.data, model_world(), dim)[model_rank()].contiguous(memory_format=fmt)
    p._aig_tp_dim = dim


def whole_shape(t) -> tuple:
    """The shape of ``t`` gathered whole (``full``)."""
    d = tp_dim(t)
    shape = list(t.shape)
    if d is not None:
        shape[d] *= model_world()
    return tuple(shape)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        n = model_world()
        parts = _all_gather(t, n, model_group()).view(n, *t.shape)
        return parts.movedim(0, -2).reshape(*t.shape[:-1], n * t.shape[-1])

    @staticmethod
    def backward(ctx, g):
        # what follows the gather runs replicated on every peer: the gradient is whole already, not summed
        c = g.shape[-1] // model_world()
        return g.narrow(-1, model_rank() * c, c).contiguous()


def gather_channels(t: torch.Tensor) -> torch.Tensor:
    """The model group's output channels of a split layer, concatenated on
    the last (channel) axis in model-rank order: the whole map, the same on
    every peer. Differentiable: the gradient is this rank's channels of the
    incoming one."""
    return t if model_world() == 1 else _GatherChannels.apply(t)


class _SumInputGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        # each peer's input gradient comes from its slice of the output channels: their sum is the whole one
        return _all_reduce(g.contiguous().clone(), model_group())


def sum_input_grad(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, whose gradient is summed over the model group: the
    input of a split layer (its activation, or its whole bias, of which each
    peer uses its slice)."""
    if model_world() == 1 or not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _SumInputGrad.apply(t)


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _all_reduce(t.clone(), model_group())

    @staticmethod
    def backward(ctx, g):
        return g


def model_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of the peers' ``t`` (partial sums of a replicated term over
    their split tensors); its gradient reaches each peer's partial as it is,
    since every peer holds the same term."""
    return t if model_world() == 1 else _ModelSum.apply(t)


def broadcast_model_(tensors: list[torch.Tensor]) -> None:
    """Set the peers' ``tensors`` (replicated f32 gradients, statistics,
    metrics) to model rank 0's, in one broadcast over the model group: a
    kernel whose sums depend on the order of atomics would let replicated
    tensors drift apart bit by bit."""
    if model_world() == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    group, src = model_group(), _STATE["groups"]["model_ranks"][0]
    if _on_host(flat, group):
        host = flat.cpu()
        dist.broadcast(host, src, group=group)
        flat.copy_(host)
    else:
        dist.broadcast(flat, src, group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


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


def is_split(t) -> bool:
    """Whether ``t`` is an FSDP shard or split over the model group."""
    return is_sharded(t) or tp_dim(t) is not None


def full(t: torch.Tensor, like=None) -> torch.Tensor:
    """A sharded parameter (FSDP's, or split over the model group) gathered
    whole, or ``t`` itself when it is neither. ``like``: ``t`` is the local
    shard of a tensor laid out as the sharded parameter ``like`` (an Adam
    slot). Every rank of the group must call (one
    ``all_gather_into_tensor``); the shards are even, since both rules
    split only axes that divide."""
    ref = t if like is None else like
    d = tp_dim(ref)
    if d is not None:
        part = t.detach().movedim(d, 0)
        return _all_gather(part, model_world(), model_group()).movedim(0, d)
    if not is_sharded(ref):
        return t
    dim = shard_dim(ref)
    part = local(t).detach().movedim(dim, 0).contiguous()
    out = torch.empty((world() * part.shape[0], *part.shape[1:]), dtype=part.dtype, device=part.device)
    dist.all_gather_into_tensor(out, part)
    return out.movedim(0, dim)


def local_rows_of(whole: torch.Tensor, like) -> torch.Tensor:
    """The rank's shard of a whole tensor, laid out as the sharded (or
    split) ``like``."""
    d = tp_dim(like)
    if d is not None:
        return torch.chunk(whole, model_world(), d)[model_rank()]
    if not is_sharded(like):
        return whole
    return torch.chunk(whole, world(), shard_dim(like))[rank()]


def copy_full_(t: torch.Tensor, whole: torch.Tensor) -> None:
    """Set ``t`` (sharded or not) from the whole tensor ``whole``."""
    with torch.no_grad():
        local(t).copy_(local_rows_of(whole, t))
