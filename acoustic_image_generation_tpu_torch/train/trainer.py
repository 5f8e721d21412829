"""The train step, evaluation, epoch loop, test and checkpoints, for the
generation, embedding, classification, reconstruction, projection and
joint tasks.

Counterpart of ``acoustic_image_generation_tpu/train/trainer.py::Trainer``
(``__init__``, ``init_state``, ``_prepare``, ``_step_core``, the cached
step variants, ``_eval_step_impl``, ``evaluate`` and
``_maybe_build_qtrunk``, ``fit``, ``test``, ``save``, ``restore`` and
``_log_media``): raw clips -> device preprocessing -> train-mode
forward and loss -> backward -> Adam on the trainable parameters. JAX
runs it as one jitted program; here it runs eagerly on the task's device and
updates the state in place, the BN running averages of train-mode BNs
included. A task whose ``reads_mfcc`` is false (``EmbedTask``,
``ClassificationTask`` on real images) gets batches without the MFCC
frontend, one whose ``reads_video`` is false gets none of the video (JAX's
jit drops both as dead code).

With ``correspondence`` in the task's config the batch is doubled after
preprocessing (``data/preprocess.py``): the low-pass branch runs (the
``filtfilt`` kernel, then ``mfcc``), and the second half is the silence map
(``correspondence_augment``), the zeroed video (``correspondence_video``)
or, for the music data, the shuffled pairs (``correspondence_shuffle``,
permutations from the step's data generator; an eval batch keeps its
halves in order and pairs real clips only). The eval mask then covers the
valid prefix of each half. A task's losses may be per frame (generation;
reconstruction of acoustic, energy and video frames), per second
(embedding, projection, joint; reconstruction of spectrograms) or per clip
(classification): the mask scales by the rows per clip.

``fit`` is JAX's epoch loop: ``configuration.txt``, ``metrics.jsonl``, the
best tracker's ``model.txt``, a snapshot every 10 epochs and at every best
(``epoch_{N}.ckpt`` in JAX's file format, ``train/checkpoint.py``, written
on a background thread unless ``run.async_checkpoint`` is off), epochs
numbered on from ``state.step`` on a resume, and on any exception in an
epoch the crash checkpoint ``epoch_interrupted_{N}.ckpt`` with its
``.meta.json`` (the batch it stopped at), from which ``restore`` + ``fit``
resume mid-epoch: the loader replays the epoch's seeded order and skips the
consumed batches, and the step noise is keyed on ``state.step``, so the
resumed run is the uninterrupted one (bit for bit on the CPU). A fault
inside the optimizer's in-place update leaves no consistent state, and then
no crash checkpoint is written (``checkpoint.TornStateError``). The
trainer reads the step's settings from the task's config; ``config`` (an
``ExperimentConfig``) carries the run's: its directory
(``run.checkpoint_dir/run.exp_name``), epochs, snapshots and logging.

A batch is a ``data.pipeline.RawBatch`` or a dict of its arrays
(``acoustic``, ``audio``, ``video``, optionally ``action``, ``location``,
``valid`` and ``window_ids``).

``fit`` keeps the best epoch by the task's ``eval_metric``, the lowest
(``eval_mode = "min"``, the default) or the highest (``"max"``: the
classification tasks' accuracy).

With ``trunk_quant="int8"`` the trainer folds, quantizes and calibrates the
trunk once, from the normalized frames of the first batch it sees (train
or eval), and every later step runs the int8 trunk (``Trainer.qtrunk``).

With ``cache_trunk_features=True``, ``trunk_bn="frozen"`` and batches that
carry ``window_ids``, a step takes the trunk's features from the first tier
that holds all of them (``train/feature_cache.py``): the device pool; the
pool plus host rows (the mixed tier); the host tier, backed by the disk
tier. Where some windows are in no tier, the trunk runs on those rows only
and the rest come from the tiers (the partial tier); where none is, it
runs once on the batch (the fill). What the trunk computed is stored. The
step then runs ``conv_map``, the generator forward and backward and TF1
Adam on them: the cached step. ``trunk_runs`` counts the trunk forwards the
trainer ran, ``last_tier`` names the tier of the last cached step.

On more than one rank (``parallel/mesh.py``: ``mesh.launch``, ``torchrun``,
or ``cli/main.py --num_devices N``) every task trains as JAX's does over its
``data`` mesh, one process a device: each rank is handed its own rows of
every global batch (the loader's ``shard_index``/``shard_count``); the task
is wrapped in ``DistributedDataParallel`` (``broadcast_buffers=False``: the
train-mode BN statistics are all-reduced in the layers, so the running
averages agree already) or, with ``parallel.fsdp``, the modules it trains
(``trained_modules``) are sharded by FSDP2 as JAX's ``fsdp_sharding``
places them (``fsdp_dims``; the tensors JAX keeps whole stay whole, their
gradients averaged here); the step's noise is the task's draw for the
global batch (``global_noise``: a tensor, or a dict of them), of which each
rank keeps its rows of every per-row draw (the joint task's moddrop flag,
one draw for the batch, is kept whole: the task's ``shared_draws``), and
the generator goes on from there, the same on every rank (the embedding
task's moddrop draws); the reported metrics and ``evaluate``'s sums are
all-reduced; only rank 0 writes files (a barrier follows each write); the
feature cache keeps each rank's tiers over the windows of its rows, keyed
by global window ids (a window that moves to another rank after a
reshuffle misses there: the partial tier runs the trunk on such rows
alone). The correspondence augmentation doubles each rank's rows (every
loss over the doubled batch is a mean over equal rows, every train-mode BN
sums order-free global moments); the music shuffle pairs clips of the
global batch: both permutations are drawn at the global clip count from
the same generator state on every rank, the rows the shuffle reads are
gathered (``mesh.all_gather_rows``), and each rank keeps its clips of the
shuffled batch (in eval, its clips of each half, whose valid prefix the
mask counts). With one process nothing of this runs.

With ``parallel.tensor_parallel = tp > 1`` (every task, with or without
the correspondence augmentation) the ``N`` ranks form JAX's ``(data = N //
tp, model = tp)`` grid (``mesh.make_grid``): rank ``r`` at data index ``r //
tp`` and model index ``r % tp``. The task is built whole on every rank (the
same seed, or ``bridge.load_flax``); the trainer then keeps, of every
kernel JAX's ``tp_sharding`` splits (``tp_dims``: a 4-D kernel of at least
256 output channels that ``tp`` divides, trained or frozen, all inside the
task's ``split_modules``: the generation trunk, the video VAE, the audio
VAE's head), the model rank's block of output channels (``mesh.split_``),
so that the Adam slots of a trained one hold that block too (a frozen one
has none), and gives model rank 0's replicated tensors to its peers. A
task without such kernels (DualCamNet's, the ``Ac``, ``Energy`` and
``Audio`` reconstructions) only has its grid decide which ranks share
rows. The split convs run as column-parallel layers
(``models/layers.py``, ``models/resnet.py``); everything else runs
replicated on the peers of a model group, which hold the same rows and
draw the same noise: the rows, the noise, the BN statistics, the row
gathers, the metrics and the eval sums are the data group's, and DDP
averages the gradients over the data group only (none when it has one
rank). After the backward the replicated trained tensors' gradients, the
BN running averages and the reported metrics are made model rank 0's
(``mesh.broadcast_model_``), so that no kernel whose sums depend on the
order of atomics (``conv_chain``'s dW, cuDNN's nondeterministic f32
transposed convs) lets the peers drift apart. That broadcast, which GSPMD
does not do, moves every replicated gradient (4 bytes an entry), the f32
buffers and the metrics over the model group each step. ``own_steps``, when set to a
list, receives what this rank computed in each step before that
broadcast (its loss terms and a digest of its replicated gradients and
statistics), so that a check can hold the peers' own results against
each other.
Checkpoints gather every split tensor and slot whole over the model group
(every rank takes part; rank 0 writes JAX's file), and a restore keeps the
rank's block. No crash checkpoint is written under tensor parallelism, as
under FSDP: the gather needs every peer, and a failing rank may never get
there. The feature cache's decisions depend only on the rows, the same on
the peers of a model group, so they hit and miss together (a trunk run on
one peer alone would hang in its gathers); every peer writes the disk
tier's files, the same bytes, through its atomic replace. The
correspondence augmentation cuts and gathers over the data group as well:
the peers of a model group double the same rows and draw the music
shuffle's permutations at the data group's clip count from the same
generator. ``core/config.py::check_tensor_parallel`` holds JAX's checks:
``fsdp`` with ``tensor_parallel > 1`` raises ``ValueError``, as does a
``num_devices`` that ``tp`` does not divide.

RNG: the noise of step ``s`` (the VAE noise; the embedding task's shared
``eps`` and moddrop draws) comes from one ``torch.Generator`` seeded from
``(seed, s)`` (``step_generator``), the counterpart of
``core/rng.py::train_step_rngs``; ``evaluate``'s batch ``i`` draws from
``eval_generator`` seeded from ``(seed, "latent", i)``, the counterpart of
``fold_in(role_key(base_key, "latent"), i)``; the music shuffle's
permutations come from ``data_generator`` (a CPU generator seeded from
``(seed, "data", s)``, or ``(seed, "data", "eval", i)`` in ``evaluate``).
The two frameworks draw different numbers from the same seed, so tests
inject the noise instead (``eps``, ``moddrop``).
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
import weakref
from datetime import datetime

import numpy as np
import torch

from acoustic_image_generation_tpu_torch import bridge
from acoustic_image_generation_tpu_torch.core.config import ExperimentConfig, check_tensor_parallel
from acoustic_image_generation_tpu_torch.data import preprocess
from acoustic_image_generation_tpu_torch.data.preprocess import Batch, normalize_video, preprocess_batch
from acoustic_image_generation_tpu_torch.parallel import mesh
from acoustic_image_generation_tpu_torch.train import checkpoint as ckpt
from acoustic_image_generation_tpu_torch.train import feature_cache as fc
from acoustic_image_generation_tpu_torch.train.generation import GenerationTask, no_tf32
from acoustic_image_generation_tpu_torch.train.optim import Adam, TF1Adam
from acoustic_image_generation_tpu_torch.train.state import TrainState

RAW_KEYS = ("acoustic", "audio", "video", "action", "location", "valid", "window_ids")
_LATENT = int.from_bytes(b"latent", "little")
_DATA = int.from_bytes(b"data", "little")
_EVAL = int.from_bytes(b"eval", "little")


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one train step, seeded from ``(seed, step)``."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(s)


def eval_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of ``evaluate``'s batch ``index``, seeded from
    ``(seed, "latent", index)``."""
    s = int(np.random.SeedSequence([seed, _LATENT, index]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(s)


def data_generator(seed: int, *index: int) -> torch.Generator:
    """The CPU generator of the correspondence shuffle: train step ``s`` is
    ``(seed, "data", s)``, eval batch ``i`` ``(seed, "data", "eval", i)``."""
    s = int(np.random.SeedSequence([seed, _DATA, *index]).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator().manual_seed(s)


def _port_dims(task: torch.nn.Module, rule, trained_only: bool) -> dict:
    """The port dim of each parameter of ``task`` (the trained ones with
    ``trained_only``) on which ``rule`` (flax shape -> flax axis or None)
    puts it, mapped through its layout (``bridge.flax_layout``), or None.
    Keyed by the tensor; a tensor split already is read at its whole
    shape."""
    out = {}
    for tensor, coll, path, fn in bridge.targets(task):
        if coll != "params" or (trained_only and not tensor.requires_grad):
            continue
        shape, axes = bridge.flax_layout(fn, mesh.whole_shape(tensor))
        axis = rule(shape)
        if axis is not None and axes[axis] is None:
            raise ValueError(f"{'/'.join(path)}: JAX's rule takes flax axis {axis}, which is not one axis of the "
                             f"port's layout {tuple(tensor.shape)}")
        out[tensor] = None if axis is None else axes[axis]
    return out


def fsdp_dims(task: torch.nn.Module, world: int) -> dict:
    """The port dim each trained tensor of ``task`` is sharded on over
    ``world`` ranks, or None (kept whole): JAX's ``fsdp_sharding`` rule
    (``mesh.fsdp_axis``) on the tensor's flax shape."""
    return _port_dims(task, lambda shape: mesh.fsdp_axis(shape, world), trained_only=True)


def tp_dims(task: torch.nn.Module, tp: int) -> dict:
    """The port dim each parameter of ``task`` is split on over ``tp``
    model ranks, or None (kept whole): JAX's ``tp_sharding`` rule
    (``mesh.tp_axis``) on the tensor's flax shape."""
    return _port_dims(task, lambda shape: mesh.tp_axis(shape, tp), trained_only=False)


def as_raw(batch) -> dict:
    """A ``RawBatch`` or a dict -> the dict of its arrays the steps read."""
    if isinstance(batch, dict):
        return batch
    return {k: getattr(batch, k) for k in RAW_KEYS if getattr(batch, k, None) is not None}


def _rows(raw: dict) -> int:
    """The frames of a batch of clips: the rows of its VAE noise."""
    return raw["audio"].shape[0] * raw["audio"].shape[1]


def _as_tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else torch.as_tensor(a)


def prepare(raw: dict, device, *, compute_mfcc: bool = True, compute_video: bool = True,
            compute_filtered: bool = False) -> Batch:
    """(B, F, ...) clips -> (B*F, ...) frames on ``device`` -> device
    preprocessing with the acoustic image. ``raw``: ``acoustic``
    (B,F,36,48,12) float32, ``audio`` (B,F,1024) int32, ``video``
    (B,F,224,298,3) uint8 BGR, and optionally ``action`` and ``location``
    (B,) int, repeated per frame; as numpy arrays or tensors. Without
    ``compute_video`` the video is neither uploaded nor normalized."""
    flat = {}
    for key in ("acoustic", "audio", "video"):
        if key == "video" and not compute_video:
            continue
        t = _as_tensor(raw[key])
        flat[key] = t.reshape(-1, *t.shape[2:]).to(device, non_blocking=True)
    frames = flat["audio"].shape[0] // raw["audio"].shape[0]
    for key in ("action", "location"):
        if key in raw:
            flat[key] = _as_tensor(raw[key]).repeat_interleave(frames).to(device)
    return preprocess_batch(flat["audio"], flat.get("video"), flat["acoustic"], flat.get("action"),
                            flat.get("location"), compute_mfcc=compute_mfcc, compute_filtered=compute_filtered)


class Trainer:
    def __init__(self, task: torch.nn.Module, config: ExperimentConfig | None = None):
        self.task = task
        self.cfg = cfg = task.cfg
        self.config = config if config is not None else ExperimentConfig()
        self.run_dir = os.path.join(self.config.run.checkpoint_dir, self.config.run.exp_name)
        self.device = task.device
        self._resume_meta = None  # a crash checkpoint's position, set by restore, read by fit
        self.qtrunk = None  # the int8 trunk of a generation task, built from the first batch
        self.trunk_runs = 0  # trunk forwards run by the steps and evaluations
        self.last_tier = None  # device | mixed | host | partial | fill: the last cached step's source
        self.feature_cache = None
        self.device_cache = None
        self._feat_store_dtype = None
        if (getattr(cfg, "cache_trunk_features", False) and isinstance(task, GenerationTask)
                and cfg.trunk_bn == "frozen" and not cfg.correspondence):
            if cfg.cache_features_dtype not in ("bf16", "f8_e4m3"):
                raise ValueError(f"cache_features_dtype must be 'bf16' or 'f8_e4m3', got "
                                 f"{cfg.cache_features_dtype!r}")
            # None: store what the trunk produces (its compute dtype), exact
            self._feat_store_dtype = torch.float8_e4m3fn if cfg.cache_features_dtype == "f8_e4m3" else None
            self.feature_cache = fc.TrunkFeatureCache()
            # window ids are loader-local: one host cache per eval loader
            self._eval_caches = weakref.WeakKeyDictionary()
            if cfg.cache_device_bytes > 0:
                self.device_cache = fc.DeviceFeatureCache(cfg.cache_device_bytes)
        self._loss = task.loss  # the train forward and objective; DistributedDataParallel's wrapper on > 1 rank
        self._sharded = []  # FSDP2 modules
        self._whole = []  # trained tensors FSDP keeps whole: gradients averaged in _step_core
        self._corr = getattr(cfg, "correspondence", False)
        self._music = getattr(cfg, "datatype", "outdoor") == "music"
        self._replicated = []  # under tensor parallelism: the trained tensors kept whole, then the BN statistics
        self._stats = []
        self.own_steps = None  # a list: each step's own loss terms and digest, before broadcast_model_
        tp = self.config.parallel.tensor_parallel
        check_tensor_parallel(self.config)
        if tp > 1:
            mesh.make_grid(tp)
            self._split()
        if mesh.active():
            self._distribute()

    def _split(self) -> None:
        """Tensor parallelism: keep the model rank's block of every kernel
        ``tp_dims`` splits, and take model rank 0's replicated tensors. A
        kernel split already (a frozen module that an earlier trainer's
        task shares with this one) keeps its block."""
        task = self.task
        inside = {id(p) for m in task.split_modules() for p in m.parameters()}
        for p, dim in tp_dims(task, mesh.model_world()).items():
            if dim is None or mesh.tp_dim(p) == dim:
                continue
            if id(p) not in inside:
                raise NotImplementedError(f"JAX splits a kernel of shape {tuple(p.shape)} outside "
                                          f"{type(task).__name__}.split_modules()")
            mesh.split_(p, dim)
        with torch.no_grad():
            whole = [t for t in (*task.parameters(), *task.buffers()) if mesh.tp_dim(t) is None]
            for dtype in sorted({t.dtype for t in whole}, key=str):  # the same order on every rank
                mesh.broadcast_model_([t for t in whole if t.dtype == dtype])
        self._replicated = [p for p in task.parameters() if p.requires_grad and mesh.tp_dim(p) is None]
        self._stats = [b for b in task.buffers() if b.dtype == torch.float32]

    def _distribute(self) -> None:
        """A rank of a group (of one, too): wrap the task in DDP, or shard
        the modules it trains with FSDP2 (``parallel.fsdp``)."""
        task = self.task
        if not self.config.parallel.fsdp:
            if mesh.model_world() == 1 or mesh.data_world() > 1:  # gradients averaged over the data group
                self._loss = torch.nn.parallel.DistributedDataParallel(task, process_group=mesh.data_group(),
                                                                       broadcast_buffers=False)
            return
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        with torch.no_grad():  # every rank starts from rank 0's state, as DDP's construction does
            for t in (*task.parameters(), *task.buffers()):
                torch.distributed.broadcast(t.data, 0)
        dims = fsdp_dims(task, mesh.world())
        for module in task.trained_modules():
            for p in module.parameters():  # FSDP2 shards contiguous tensors only (the convs are channels-last)
                p.data = p.data.contiguous()
            whole = [p for p in module.parameters() if dims[p] is None]
            # the L2 terms read kernels again after the forward: keep them gathered until backward
            fully_shard(module, shard_placement_fn=lambda p: Shard(dims[p]), reshard_after_forward=False,
                        ignored_params=set(whole) or None)
            self._sharded.append(module)
            self._whole += whole

    def _reshard(self) -> None:
        """Put FSDP's modules back to their shards after a forward without
        backward (an evaluation), where the optimizer and checkpoints find
        them."""
        for module in self._sharded:
            module.reshard()

    def _rank_noise(self, eps, generator, rows: int, train: bool = True):
        """More than one rank: ``(eps, generator)`` for this rank's batch of
        ``rows`` frames (before the correspondence augmentation doubles
        them). The noise of the global batch (given, or the task's
        ``global_noise`` from ``generator``, as one device draws it; a tensor
        or a dict of them), each per-row draw cut to the rank's rows
        (``_rank_rows``), the task's ``shared_draws`` kept whole; the
        generator goes on past that draw, in the same state on every
        rank."""
        if eps is None:
            eps = self.task.global_noise(rows * mesh.data_world() * (2 if self._corr else 1), generator,
                                         train=train)
        else:
            generator = None
        if eps is None:
            return None, generator
        if isinstance(eps, dict):
            shared = getattr(self.task, "shared_draws", ())
            return {k: v if k in shared else self._rank_rows(v, train) for k, v in eps.items()}, generator
        return self._rank_rows(eps, train), generator

    def _rank_rows(self, x, train: bool = True):
        """This rank's rows of ``x``, whose rows are the global batch's as
        ``_prepare`` lays them out on one device: contiguous; with the
        correspondence augmentation, the rank's rows of each half, as
        ``_prepare`` doubles each rank's rows, except the music shuffle's
        train batch, whose shuffled order is cut contiguous."""
        if not self._corr or (self._music and train):
            return mesh.shard_rows(x)
        half = x.shape[0] // 2
        return torch.cat([mesh.shard_rows(x[:half]), mesh.shard_rows(x[half:])])

    def _average_whole_grads(self) -> None:
        """FSDP: average the gradients of the tensors it keeps whole (its
        reduce-scatter covers the sharded ones), as DDP does: divided by the
        ranks, then summed in one all-reduce."""
        grads = [p.grad for p in self._whole if p.grad is not None]
        if not grads:
            return
        flat = mesh.all_reduce_(torch.cat([g.reshape(-1) for g in grads]).div_(mesh.world()))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def init_state(self) -> TrainState:
        """Step 0 and Adam over the task's trainable parameters (those that
        require grad; the frozen ones get no slots): TF1's numerics, or
        ``optax.adam``'s with ``optim.tf1_adam=False``, as JAX's trainer
        picks. The parameters are the task's as they stand: ``init_params``
        or ``bridge.load_flax``."""
        trainable = [p for p in self.task.parameters() if p.requires_grad]
        adam = TF1Adam if self.config.optim.tf1_adam else Adam
        return TrainState(step=0, task=self.task, optimizer=adam(trainable, self.cfg.learning_rate))

    def _prepare(self, raw: dict, *, generator: torch.Generator | None = None, train: bool = True) -> Batch:
        """``prepare`` on the task's device, with the MFCC frontend and the
        video if the task reads them, then the correspondence augmentation
        when the config asks for it (the music shuffle's permutations from
        ``generator``; ``train=False`` keeps the halves in order and pairs
        only the batch's valid clips). On more than one rank the music
        shuffle covers the global batch: its rows are gathered, and the rank
        keeps its rows of the shuffled batch (``_rank_rows``)."""
        music = self._corr and self._music
        batch = prepare(raw, self.device, compute_mfcc=self.task.reads_mfcc,
                        compute_video=getattr(self.task, "reads_video", True),
                        compute_filtered=self._corr and not music)
        if not self._corr:
            return batch
        if music:
            clips = raw["audio"].shape[0]
            if generator is None:
                raise ValueError("the music correspondence shuffle draws permutations: pass a generator")
            valid = None if train else int(raw.get("valid", clips))
            frames = batch.audio.shape[0] // clips
            if mesh.data_world() > 1:  # a clip's partner is drawn from the global batch
                with torch.no_grad():
                    batch = Batch(*[None if x is None else mesh.all_gather_rows(x) for x in batch])
                clips *= mesh.data_world()
                if valid is not None:  # the valid clips are a prefix of the global batch
                    valid = int(mesh.all_reduce_(torch.tensor(valid, device=self.device)))
            perms = preprocess.shuffle_permutations(clips, generator, valid_clips=valid, final_shuffle=train)
            batch = preprocess.correspondence_shuffle(batch, *perms, frames=frames)
            if mesh.data_world() > 1:
                batch = Batch(*[None if x is None else self._rank_rows(x, train) for x in batch])
            return batch
        if self.cfg.correspondence_video:
            return preprocess.correspondence_augment_no_video(batch)
        return preprocess.correspondence_augment(batch)

    def _cached_raw(self, raw: dict) -> dict:
        """The batch for a step on cached features: the trunk does not run,
        so a (B, F, 1, 1, 3) dummy replaces the video (JAX's ``_cached_raw``;
        bytes instead of the 154 MB upload)."""
        n, f = raw["video"].shape[:2]
        return dict(raw, video=torch.zeros((n, f, 1, 1, 3), dtype=torch.uint8))

    def _maybe_build_qtrunk(self, raw: dict) -> None:
        """With ``trunk_quant="int8"``, once: fold, quantize and calibrate the
        frozen trunk on the normalized frames of ``raw``."""
        if getattr(self.cfg, "trunk_quant", "none") != "int8" or self.qtrunk is not None:
            return
        video = _as_tensor(raw["video"])
        video = video.reshape(-1, *video.shape[2:]).to(self.device)
        self.qtrunk = self.task.build_qtrunk(normalize_video(video))

    def _noise(self, step: int, eps):
        """``(eps, None)`` when the noise is given (a tensor, or a dict of
        them for the tasks with several draws), else ``(None, the step's
        generator)``."""
        if eps is None:
            return None, step_generator(self.cfg.seed, step, self.device)
        as_tensor = lambda e: torch.as_tensor(np.array(e, np.float32), device=self.device)
        if isinstance(eps, dict):
            return {k: as_tensor(v) for k, v in eps.items()}, None
        return as_tensor(eps), None

    def train_step(self, state: TrainState, raw, *, eps=None, moddrop=None) -> tuple[TrainState, dict]:
        """One step: prepare, loss and grads, Adam, BN statistics
        updated. ``raw``: a ``RawBatch`` or a dict; with the feature cache on
        and ``window_ids`` given, the step runs on cached trunk features.
        ``eps`` replaces the step's noise: (frames, 150) for the generation
        task, (seconds, latent_dim) for the embedding task, (samples,
        latent) for the reconstruction task, a dict of the draws for the
        projection and joint tasks; ``moddrop`` replaces the moddrop draws
        (the embedding task's keep flags of video, audio and acoustic, the
        joint task's one flag). Returns the state (updated in place, step advanced)
        and the loss terms as detached f32 scalars."""
        raw = as_raw(raw)
        self._maybe_build_qtrunk(raw)
        if self.feature_cache is not None and raw.get("window_ids") is not None:
            return self._step_core(state, self._cached_raw(raw), eps=eps,
                                   trunk_feat=self._train_features(raw))
        if isinstance(self.task, GenerationTask):
            self.trunk_runs += 1
        return self._step_core(state, raw, eps=eps, moddrop=moddrop)

    def _step_core(self, state, raw: dict, *, eps=None, moddrop=None, trunk_feat=None):
        """Shared body of the full and cached steps; ``trunk_feat`` (cached
        features, in the storage dtype) bypasses the trunk."""
        eps, generator = self._noise(state.step, eps)
        if mesh.data_world() > 1:
            eps, generator = self._rank_noise(eps, generator, _rows(raw))
        with no_tf32():
            batch = self._prepare(raw, generator=data_generator(self.cfg.seed, state.step))
            kw = {}
            if trunk_feat is not None:
                kw["trunk_feat"] = trunk_feat.to(self.task.dtype)  # f8 storage back to the compute dtype
            total, metrics = self._loss(batch, eps=eps, generator=generator, qtrunk=self.qtrunk,
                                        moddrop=moddrop, **kw)
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            self._average_whole_grads()
            replicated = [p.grad for p in self._replicated if p.grad is not None] + self._stats
            if self.own_steps is not None:
                self.own_steps.append(self._own(metrics, replicated))
            mesh.broadcast_model_(replicated)
            state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh.world() > 1:  # each term is a mean over equal rows: the global mean is the data ranks' mean
            values = torch.stack([v.float() for v in metrics.values()])
            mesh.broadcast_model_([values])
            metrics = dict(zip(metrics, mesh.all_reduce_(values, "mean").unbind()))
        return state, metrics

    @staticmethod
    def _own(metrics: dict, tensors: list) -> dict:
        """What this rank computed: its loss terms (over its rows) and a
        digest of ``tensors`` (its replicated gradients and statistics)."""
        h = hashlib.sha1()
        for t in tensors:
            h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
        return dict(metrics={k: float(v) for k, v in metrics.items()}, digest=h.hexdigest())

    def _trunk_features(self, raw: dict) -> torch.Tensor:
        """(B, F, 224, 298, 3) uint8 -> (B*F, 14, 19, 2048) frozen-trunk
        features on the device, rounded to the storage dtype: the one point
        where every tier's rows are produced."""
        video = _as_tensor(raw["video"])
        video = video.reshape(-1, *video.shape[2:]).to(self.device, non_blocking=True)
        with torch.no_grad():
            feat = self.task.trunk_features(normalize_video(video), self.qtrunk)
        self.trunk_runs += 1
        if self._feat_store_dtype is not None:
            feat = fc.to_float8_e4m3fn(feat)
        return feat

    def _train_features(self, raw: dict) -> torch.Tensor:
        """The batch's trunk features from the first tier that holds all of
        them; else from the tiers and one trunk run on the rows they lack
        (``_partial_features``), or one on the whole batch when they hold
        none of it (then stored: into the device pool while it has room, the
        host tier after)."""
        ids = [int(w) for w in raw["window_ids"]]
        valid = int(raw.get("valid", len(ids)))
        pool = self.device_cache
        if pool is not None:
            res = pool.lookup_partial(ids, valid)
            if res is not None:
                slots, missing = res
                if not missing:
                    self.last_tier = "device"
                    return pool.gather(slots)
                host_rows = []
                for _, wid in missing:
                    f = self.feature_cache.get(wid)
                    if f is None:
                        host_rows = None
                        break
                    host_rows.append(f)
                if host_rows is not None:
                    # only the missing rows cross PCIe, scattered in exactly
                    # (JAX pads their count to a power of two for its jit)
                    self.last_tier = "mixed"
                    stacked = torch.stack([fc.as_bytes(r) for r in host_rows]).view(host_rows[0].dtype)
                    return pool.gather(slots, rows=([i for i, _ in missing], stacked))
        feat = fc.gather_batch(self.feature_cache, ids, valid)
        if feat is not None:
            self.last_tier = "host"
            return feat.to(self.device, non_blocking=True)
        frames = raw["video"].shape[1]
        held = {}  # row -> its cached (frames, 14, 19, 2048) features
        for i, wid in enumerate(ids[:valid]):
            if pool is not None and wid in pool.slots:
                held[i] = pool.buf[pool.slots[wid]]
            elif wid in self.feature_cache:
                f = self.feature_cache.get(wid)
                if f is not None:
                    held[i] = f
        if held:
            return self._partial_features(raw, ids, valid, frames, held)
        self.last_tier = "fill"
        feat = self._trunk_features(raw)
        if pool is not None:
            pool.put_batch(ids, valid, feat, frames)
        self._persist_host_rows(self.feature_cache, ids, valid, frames, feat,
                                skip=pool.slots if pool is not None else ())
        return feat

    def _partial_features(self, raw: dict, ids: list, valid: int, frames: int, held: dict) -> torch.Tensor:
        """The partial tier: the tiers hold the rows of ``held`` and no tier
        the other valid rows (on more than one rank, windows a reshuffle
        moved here from another rank's cache). The trunk runs on those rows
        alone, which are stored as a fill's are; the batch is put together
        on the device, padded rows repeating the last valid one."""
        todo = [i for i in range(valid) if i not in held]
        video = _as_tensor(raw["video"])[torch.tensor(todo)]
        new = self._trunk_features({"video": video})
        pool = self.device_cache
        new_ids = [ids[i] for i in todo]
        if pool is not None:
            pool.put_batch(new_ids, len(todo), new, frames)
        self._persist_host_rows(self.feature_cache, new_ids, len(todo), frames, new,
                                skip=pool.slots if pool is not None else ())
        rows = dict(held)
        rows.update(zip(todo, fc.as_bytes(new).view(len(todo), frames, *new.shape[1:])))
        order = [rows[min(i, valid - 1)] for i in range(len(ids))]
        self.last_tier = "partial"
        return torch.cat([fc.as_bytes(r).to(self.device, non_blocking=True) for r in order]).view(new.dtype)

    def _persist_host_rows(self, cache, ids, valid: int, frames: int, feat, skip=()) -> None:
        """Store a freshly computed batch of features into a host-tier
        cache, one contiguous row per window; ``skip`` holds the ids resident
        in the device pool, which go to the disk tier only. One copy from
        the device per batch, and a clone per row (a view would pin the
        whole batch). Stops at the cache's byte budget."""
        host = None
        for i in range(valid):
            wid = ids[i]
            ram = wid not in skip
            if (not ram or wid in cache) and (cache.disk is None or wid in cache.disk):
                continue
            if host is None:
                host = feat.cpu()
            if not cache.put(wid, host[i * frames:(i + 1) * frames].clone(), ram=ram):
                break

    def attach_disk(self, loader, epoch: int = 0) -> None:
        """Attach the cross-run disk tier (``cache_disk_dir``) to the
        training cache, as JAX's ``fit`` does before its first epoch
        (``epoch``); with the int8 trunk, calibrate it first on that epoch's
        first batch (its scales are part of the features' identity)."""
        if not getattr(self.cfg, "cache_disk_dir", None) or self.feature_cache is None:
            return
        if self.qtrunk is None and self.cfg.trunk_quant == "int8":
            batches = loader.batches(epoch)
            first = next(batches, None)
            batches.close()
            if first is not None:
                self._maybe_build_qtrunk(as_raw(first))
        self._attach_disk(loader, self.feature_cache)

    def _attach_disk(self, loader, cache) -> None:
        """Attach a disk store to a host cache, keyed by a digest of the
        features' producer (the frozen backbone, or the calibrated int8
        trunk), the loader's window table and the storage dtype. Idempotent;
        does nothing until the int8 trunk is calibrated."""
        root = getattr(self.cfg, "cache_disk_dir", None)
        if not root or cache is None or cache.disk is not None:
            return
        if self.cfg.trunk_quant == "int8" and self.qtrunk is None:
            return
        if self.qtrunk is not None:
            producer = fc.tree_fingerprint(dict(self.qtrunk.named_buffers()))
        else:  # split kernels gathered whole: the same store on every rank
            producer = fc.tree_fingerprint({k: mesh.full(t) for k, t in self.task.trunk_state().items()})
        key = producer + fc.windows_fingerprint(loader) + self.cfg.cache_features_dtype
        fp = hashlib.blake2b(key.encode(), digest_size=20).hexdigest()
        cache.attach_disk(fc.DiskFeatureStore(root, fp, max_bytes=self.cfg.cache_disk_bytes))

    def eval_step(self, state: TrainState, raw, *, eps=None) -> tuple[dict, torch.Tensor]:
        """Eval of one batch through the trunk the steps use: the task's
        ``eval_losses`` (per frame for generation, per second for the
        embedding task, per clip for classification) summed over the rows of
        the first ``raw["valid"]`` clips (all clips when absent; a padded
        remainder batch) in each half of the batch (two with the
        correspondence augmentation). Returns ``({name: f32 sum}, rows
        counted)``. The music correspondence's pairing draws from ``(seed,
        "data", "eval", step)``."""
        raw = as_raw(raw)
        self._maybe_build_qtrunk(raw)
        eps, generator = self._noise(state.step, eps)
        self.trunk_runs += 1
        return self._eval_sums(raw, eps, generator, shuffle=data_generator(self.cfg.seed, _EVAL, state.step))

    def _eval_sums(self, raw: dict, eps, generator, trunk_feat=None, shuffle=None) -> tuple[dict, torch.Tensor]:
        """The masked loss sums of one eval batch: the rows of the valid
        clips of each half (JAX's ``_eval_step_impl``). Padded rows are
        selected out, not multiplied by 0: their zero acoustic frames
        normalize to NaN (JAX's jitted mask multiply comes out the same)."""
        if mesh.data_world() > 1:
            eps, generator = self._rank_noise(eps, generator, _rows(raw), train=False)
        with torch.no_grad():
            batch = self._prepare(raw, generator=shuffle, train=False)
            if trunk_feat is not None:
                trunk_feat = trunk_feat.to(self.task.dtype)
            losses, _ = self.task.eval_losses(batch, eps=eps, generator=generator, qtrunk=self.qtrunk,
                                              trunk_feat=trunk_feat)
        self._reshard()
        n_total = next(iter(losses.values())).shape[0]
        clips = raw["audio"].shape[0]
        valid = int(raw.get("valid", clips))
        halves = 2 if self._corr else 1
        per_clip = n_total // (clips * halves)
        keep = torch.arange(n_total, device=self.device) % (n_total // halves) < valid * per_clip
        sums = {k: torch.sum(torch.where(keep, v, 0.0)) for k, v in losses.items()}
        return sums, torch.sum(keep.float())

    def _eval_features(self, raw: dict, cache) -> torch.Tensor:
        """An eval batch's trunk features: from the loader's host cache, or
        one trunk run, then stored there (the device pool is kept for
        training windows)."""
        ids = [int(w) for w in raw["window_ids"]]
        valid = int(raw.get("valid", len(ids)))
        feat = fc.gather_batch(cache, ids, valid)
        if feat is not None:
            return feat.to(self.device, non_blocking=True)
        feat = self._trunk_features(raw)
        self._persist_host_rows(cache, ids, valid, raw["video"].shape[1], feat)
        return feat

    def evaluate(self, state: TrainState, loader, epoch: int = 0, *, use_cache: bool = True) -> dict:
        """Size-weighted mean eval losses over one pass of ``loader``: each
        loss summed over the valid frames of every batch, divided by their
        count. With the feature cache on, each eval loader gets its own host
        cache (budget ``cache_eval_bytes``), so repeated evaluations run the
        trunk once; ``use_cache=False`` skips it (a one-shot evaluation). The
        sums stay on the device until the end."""
        sums: dict = {}
        count = None
        cache = None
        if use_cache and self.feature_cache is not None and self.cfg.cache_eval_bytes > 0:
            cache = self._eval_caches.get(loader)
            if cache is None:
                cache = self._eval_caches[loader] = fc.TrunkFeatureCache(self.cfg.cache_eval_bytes)
        for i, raw_batch in enumerate(loader.batches(epoch)):
            raw = as_raw(raw_batch)
            self._maybe_build_qtrunk(raw)
            if i == 0 and cache is not None:
                self._attach_disk(loader, cache)
            generator = eval_generator(self.cfg.seed, i, self.device)
            if cache is not None and raw.get("window_ids") is not None:
                feat = self._eval_features(raw, cache)
                batch_sums, n = self._eval_sums(self._cached_raw(raw), None, generator, trunk_feat=feat)
            else:
                self.trunk_runs += 1
                batch_sums, n = self._eval_sums(raw, None, generator, shuffle=data_generator(self.cfg.seed, _EVAL, i))
            for k, v in batch_sums.items():
                sums[k] = v if k not in sums else sums[k] + v
            count = n if count is None else count + n
        if count is None:
            return {}
        if mesh.data_world() > 1:  # every data rank's valid rows: the one-device sums
            totals = mesh.all_reduce_(torch.stack([*sums.values(), count]))
            sums, count = dict(zip(sums, totals[:-1])), totals[-1]
        count = max(float(count), 1.0)
        return {k: float(v) / count for k, v in sums.items()}

    # ---------------------------------------------------------------- loops

    def fit(self, train_loader, valid_loader, *, state: TrainState | None = None) -> TrainState:
        """The epoch loop (JAX's ``Trainer.fit``): ``run.num_epochs`` epochs
        of ``train_step`` over ``train_loader``, each followed by
        ``evaluate`` on ``valid_loader`` (riding its eval cache when the
        feature cache is on), a ``metrics.jsonl`` record, the best tracker
        and the snapshots. ``state=None`` starts from ``init_state()``: the
        task's parameters as they stand. A restored ``state`` continues the
        epoch numbering from its step, or, after ``restore`` of a crash
        checkpoint, from the batch the crash stopped at."""
        cfg = self.config
        main = mesh.is_main()  # the one rank that writes files
        if main:
            os.makedirs(self.run_dir, exist_ok=True)
            cfg.save(os.path.join(self.run_dir, "configuration.txt"))
        metrics_log = ckpt.MetricsWriter(self.run_dir) if main else None
        media_logger = None
        if cfg.run.tensorboard and main:
            from acoustic_image_generation_tpu_torch.utils.logger import Logger

            media_logger = Logger(os.path.join(cfg.run.tensorboard, cfg.run.exp_name))
        tracker = ckpt.BestTracker(self.run_dir, cfg.run.exp_name, mode=getattr(self.task, "eval_mode", "min"),
                                   write=main)
        mesh.barrier()

        start_epoch = skip_steps = 0
        if state is None:
            state = self.init_state()
        else:
            resume_meta, self._resume_meta = self._resume_meta, None
            if resume_meta is not None:
                # the crash checkpoint's exact position: replay the epoch's
                # seeded order and skip the batches already consumed
                start_epoch = int(resume_meta["epoch"])
                skip_steps = int(resume_meta["step_in_epoch"])
            else:
                steps_per_epoch = max(train_loader.num_windows // train_loader.batch_size, 1)
                start_epoch = state.step // steps_per_epoch
        self.attach_disk(train_loader, start_epoch)

        saver = ckpt.AsyncCheckpointer() if cfg.run.async_checkpoint else None
        try:
            for epoch in range(start_epoch, start_epoch + cfg.optim.num_epochs):
                t0 = time.perf_counter()
                skip_target, step0 = skip_steps, state.step
                metrics = None
                try:
                    for raw_batch in train_loader.batches(epoch):
                        if skip_steps:
                            # the int8 trunk calibrates on the epoch's first batch, as JAX's does
                            self._maybe_build_qtrunk(as_raw(raw_batch))
                            skip_steps -= 1
                            continue
                        state, metrics = self.train_step(state, raw_batch)
                    last_metrics = {k: float(v) for k, v in metrics.items()} if metrics else {}
                except BaseException:
                    # batches consumed: skipped ones, then one per step taken
                    self._crash_checkpoint(state, epoch, skip_target - skip_steps + state.step - step0)
                    raise
                dt = time.perf_counter() - t0
                n_steps = state.step - step0
                val = self.evaluate(state, valid_loader, epoch)
                val_loss = val[self.task.eval_metric]
                clips_per_sec = n_steps * train_loader.batch_size / max(dt, 1e-9)
                if main:
                    metrics_log.write({"epoch": epoch, "train": last_metrics, "valid": val, "steps": n_steps,
                                       "seconds": dt, "clips_per_sec": clips_per_sec})
                    print(f"{datetime.now()}: {cfg.run.exp_name} - Epoch: {epoch}\t"
                          f"Validation_{self.task.eval_metric}_Loss: {val_loss:6f}\t"
                          f"({clips_per_sec:.1f} clips/s)", flush=True)
                if cfg.run.tensorboard:  # every rank runs the forward (FSDP gathers); rank 0 logs
                    if media_logger is not None:
                        media_logger.log_scalars({f"valid/{k}": v for k, v in val.items()}, epoch)
                    self._log_media(media_logger, valid_loader, epoch)
                is_best = tracker.update(epoch, val_loss)  # the same on every rank: val is all-reduced
                mesh.barrier()
                if epoch % 10 == 0 or is_best:
                    if saver is not None:
                        saver.save(self.run_dir, epoch, state, write=main)
                    else:
                        ckpt.save_checkpoint(self.run_dir, epoch, state, write=main)
                    mesh.barrier()
        finally:
            unwinding = sys.exc_info()[1] is not None
            try:
                if saver is not None:
                    saver.close()
            except Exception as e:
                # a background write's error must not replace the exception
                # being raised (the crash checkpoint's, say)
                if not unwinding:
                    raise
                print(f"WARNING: background checkpoint write failed: {e!r}", file=sys.stderr)
            finally:
                if media_logger is not None:
                    media_logger.close()
        mesh.barrier()
        return state

    def _crash_checkpoint(self, state: TrainState, epoch: int, step_in_epoch: int) -> None:
        """Write ``epoch_interrupted_{epoch}.ckpt`` and its position, unless
        the fault tore the state inside the optimizer's update. On more than
        one rank, rank 0 writes its replica under DDP; under FSDP or tensor
        parallelism none is written, since gathering the shards needs every
        rank in a collective, and a failing rank may never get there."""
        if self._sharded or mesh.model_world() > 1:
            print("no crash checkpoint written: sharded or split tensors gather only with every rank",
                  file=sys.stderr)
            return
        if not mesh.is_main():
            return
        try:
            path = ckpt.save_checkpoint(self.run_dir, f"interrupted_{epoch}", state)
        except ckpt.TornStateError as e:
            print(f"no crash checkpoint written: {e}", file=sys.stderr)
            return
        ckpt.save_resume_meta(path, epoch=epoch, step_in_epoch=step_in_epoch)
        print(f"crash checkpoint {path}: epoch {epoch}, {step_in_epoch} batches consumed", file=sys.stderr)

    def _log_media(self, logger, valid_loader, epoch: int) -> None:
        """Reconstruction panels of the first validation clip's first frame:
        the generated and the real acoustic image (channel means, jet) and
        the video frame. Nothing for a task whose eval output is not an
        image (the classification tasks' logits, the embedding task's three
        VAE outputs)."""
        batches = valid_loader.batches(epoch)
        raw_batch = next(batches, None)
        batches.close()
        if raw_batch is None:
            return
        raw = as_raw(raw_batch)
        eps, generator = None, eval_generator(self.cfg.seed, 0, self.device)
        if mesh.data_world() > 1:
            eps, generator = self._rank_noise(None, generator, _rows(raw), train=False)
        with torch.no_grad():
            batch = self._prepare(raw, generator=data_generator(self.cfg.seed, _EVAL, 0), train=False)
            _, aux = self.task.eval_losses(batch, eps=eps, generator=generator)
        self._reshard()
        if logger is None or not isinstance(aux, torch.Tensor):  # a rank that only took part in FSDP's gathers
            return
        aux = aux.cpu().numpy()
        if aux.ndim != 4:
            return
        logger.log_image("valid/generated", aux[0].mean(-1), epoch, cmap="jet")
        real = batch.acoustic.cpu().numpy()
        if real.shape[1:3] == aux.shape[1:3]:
            logger.log_image("valid/real", real[0].mean(-1), epoch, cmap="jet")
        logger.log_image("valid/video", batch.video[0].float().cpu().numpy(), epoch)

    def test(self, state: TrainState, test_loader, epoch: int | None = None) -> dict:
        """``evaluate`` without the eval cache (one pass), written to
        ``test_accuracy{_epoch}.txt``."""
        results = self.evaluate(state, test_loader, use_cache=False)
        if mesh.is_main():
            os.makedirs(self.run_dir, exist_ok=True)
            suffix = f"_{epoch}" if epoch is not None else ""
            with open(os.path.join(self.run_dir, f"test_accuracy{suffix}.txt"), "w") as f:
                parts = " - ".join(f"{k}: {v:6f}" for k, v in sorted(results.items()))
                f.write(f"{datetime.now()}: {self.config.run.exp_name} - {parts}\n")
        mesh.barrier()
        return results

    # ---------------------------------------------------------------- io

    def save(self, name, state: TrainState) -> str:
        """Write ``epoch_{name}.ckpt`` (rank 0; every rank gathers FSDP's
        shards)."""
        path = ckpt.save_checkpoint(self.run_dir, name, state, write=mesh.is_main())
        mesh.barrier()
        return path

    def restore(self, path: str, template_state: TrainState) -> TrainState:
        """Restore a checkpoint into ``template_state`` (in place). A crash
        checkpoint's ``.meta.json`` position is kept for the next ``fit``."""
        self._resume_meta = ckpt.load_resume_meta(path)
        return ckpt.restore_checkpoint(path, template_state)
