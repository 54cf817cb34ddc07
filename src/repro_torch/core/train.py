"""Contrastive trainer for the RGCN encoder (paper §3.3, §4) and the
packed, micro-batched embedding with a content-hash cache.  Counterpart of
``repro/core/train.py``.

Training (``ContrastiveTrainer.fit``) mirrors the JAX package's compiled
engine (``_fit_scan``) step for step: an 80/20 train/validation split and
the whole epoch's batch selections drawn up front from one numpy stream
(so the indices equal JAX's), every step's batch packed by ``plan_epoch``
and uploaded once per same-bucket segment, AdamW with cosine annealing
from lr 7e-4, tau = 0.05.  Each step's random draws (augmentation
strategies and masks, feature noise, dropout) come from a
``torch.Generator`` on the device seeded from ``(seed, step)`` alone — the
counterpart of ``fold_in(base_key, step)`` — so a resumed fit replays the
same draws and resume is exact.  Metrics stay on the device and cross to
the host once every ``log_every`` steps; a step itself makes no host sync
(edge endpoints are validated on the host arrays before upload).  There
is no ``jit``/``scan``: PyTorch runs eagerly, one step per loop turn.

The fault protocol follows JAX's scan engine: its chunk boundaries (every
``scan_chunk`` steps inside each same-bucket segment) are the points where
``fit(fault_hook=, watchdog=)`` may raise
:class:`~repro_torch.distributed.fault.DeviceLost`, after checkpointing,
and ``fit_resilient`` resumes from that checkpoint at the next width.

Data parallelism (JAX: ``mesh_rules``, the fit's arrays on a data mesh) runs
one process a rank over a :class:`~repro_torch.distributed.group.Group`
(``ContrastiveTrainer(group=)``): each rank uploads only its range of whole
graphs of a step's packed batch (``distributed/sharding.shard_batch``),
slices the step's draws, made at the whole batch's shape from the same
``(seed, step)`` generator, encodes and projects its graphs, gathers both
views' projections from every rank and computes the one InfoNCE of the
whole batch; its partial gradients are summed in rank order before the
clip, the compression and AdamW, so every rank applies the same update
and the fit does not depend on the width beyond the order of its sums.
Rank 0 writes the checkpoints (width-independent) and every rank restores
them; at a chunk boundary the ranks agree on a DeviceLost, so all raise at
the same boundary or none does.  Without a group the fit is the one-card
fit.

Inference (``embed`` / ``embed_stream``) turns kernel graphs into the
256-d kernel embeddings z_k (paper §3.4): graphs are packed into size
buckets, uploaded to the trainer's device and encoded by
``core/rgcn.encode_packed``; identical graphs (same content hash) are
encoded once.

Host staging is JAX's one-ahead pipeline (:class:`_OneAhead`,
``GCLTrainConfig.prefetch`` / ``prefetch_depth``): while the card runs the
fit's chunk i (``scan_chunk`` steps) or embed micro-batch i, one worker
thread packs and uploads i + 1 (``utils/device.HostStager``: pinned
memory, a copy stream, an event the compute stream waits on).  Items are
staged in order and the step's draws and collectives stay on the calling
thread, so trajectories and embeddings are bit-equal to inline staging.

The dense path is the pre-packing baseline the JAX package keeps for
parity tests and its batching benchmark: ``prepad`` / ``embed_dense`` pad
every graph to the program's largest (``core/graphs.pad_batch``) and
encode batches of 64 through ``core/rgcn.encode``, and ``dense_loss`` is
the InfoNCE over two dense augmented views (JAX ``_loss``); its draws come
from ``draw_step`` like the packed loss's.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import rgcn as rgcn_mod
from repro_torch.core.augment import (
    COMBOS, EDGE_DROP_RATE, NODE_DROP_RATE, augment_view,
    augment_view_packed,
)
from repro_torch.core.batching import (
    MAX_EDGES_PER_MICROBATCH, MAX_NODES_PER_MICROBATCH, bucket_key,
    bucket_size, graph_content_hash, pack_graphs, plan_epoch,
    plan_microbatches, stream_bins,
)
from repro_torch.core.contrastive import info_nce
from repro_torch.core.graphs import KernelGraph, pad_batch
from repro_torch.core.rgcn import EncodeDraws, RGCNConfig, RGCNEncoder
from repro_torch.distributed.fault import DeviceLost, Watchdog
from repro_torch.distributed.sharding import (
    ShardRange, shard_batch, shard_ranges,
)
from repro_torch.kernels import check_endpoints
from repro_torch.launch.mesh import widths
from repro_torch.config import TrainConfig
from repro_torch.optim.adamw import TrainState, adamw_init, apply_gradients
from repro_torch.sampling.store import flatten_tree, unflatten_tree
from repro_torch.utils.device import HostStager, resolve_device, take

#: fixed metric layout of a training step (one (6,) device tensor per step;
#: checkpoints store one column per key)
METRIC_KEYS = ("loss", "nce_acc", "pos_sim", "neg_sim", "lr", "grad_norm")


class FitInterrupted(RuntimeError):
    """Raised by ``fit(interrupt_after=k)`` right after the checkpoint at
    step k — the hook the tests use to simulate a killed training job
    without killing the process."""


class _OneAhead:
    """One-worker host->device staging pipeline (JAX ``_OneAhead``).

    Wraps an iterable of work items and a ``stage`` callable (host pack +
    upload); iterating yields ``(item, staged)`` pairs, item i + 1 being
    staged on one worker thread (``stage-prefetch``) while the caller
    consumes item i.  ``depth=k`` keeps up to k staged items ahead of the
    consumer; the one worker stages strictly in submission order, so the
    staged tensors and their order equal inline staging's.  The worker
    also advances the item iterator.  ``enabled=False`` stages inline (and
    then ``wait_s == stage_s``).  ``stage_s`` is the worker's seconds
    staging, ``wait_s`` the consumer's seconds waiting for a stage;
    ``overlap_fraction = max(0, 1 - wait_s / stage_s)``.

    A stage (or the item iterator) that raises re-raises in the consumer
    at that item; nothing is skipped or retried.  Use it as a context
    manager: leaving the ``with`` block (an exception in the consumer, a
    ``break``) calls :meth:`close`, which cancels the queued stages, waits
    for the one in flight and drops it, so no worker outlives the loop.
    """

    def __init__(self, stage, items, *, enabled: bool = True, depth: int = 1):
        self._stage = stage
        self._items = items
        self.enabled = bool(enabled)
        self.depth = max(1, int(depth))
        self.stage_s = 0.0
        self.wait_s = 0.0
        self._pool: Optional[ThreadPoolExecutor] = None

    def _timed_stage(self, item):
        t = time.perf_counter()
        try:
            return self._stage(item)
        finally:
            self.stage_s += time.perf_counter() - t

    @property
    def overlap_fraction(self) -> float:
        if self.stage_s <= 0.0:
            return 0.0
        return max(0.0, 1.0 - self.wait_s / self.stage_s)

    def __enter__(self) -> "_OneAhead":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Cancel the stages not yet started, wait for the one running and
        drop every staged item; the worker thread has ended on return."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __iter__(self):
        it = iter(self._items)
        if not self.enabled:
            for item in it:   # inline staging: all staging time is wait time
                staged = self._timed_stage(item)
                self.wait_s = self.stage_s
                yield item, staged
            return

        def task():
            try:
                item = next(it)
            except StopIteration:
                return None
            return item, self._timed_stage(item)

        self._pool = pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="stage-prefetch")
        try:
            q = deque(pool.submit(task) for _ in range(self.depth))
            while True:
                t = time.perf_counter()
                res = q.popleft().result()
                self.wait_s += time.perf_counter() - t
                if res is None:
                    return
                q.append(pool.submit(task))     # refill the window
                yield res
        finally:
            self.close()


def _prefetch_stats(pipe: _OneAhead) -> dict:
    """JAX's four staging keys of a fit's info and of ``embed_stats``."""
    return {"prefetch": pipe.enabled, "prefetch_stage_s": pipe.stage_s,
            "prefetch_wait_s": pipe.wait_s,
            "prefetch_overlap": pipe.overlap_fraction}


@dataclass(frozen=True)
class GCLTrainConfig:
    steps: int = 120
    batch_size: int = 16
    tau: float = 0.05
    val_fraction: float = 0.2
    log_every: int = 50
    seed: int = 0
    #: steps between fault boundaries (JAX: the scan chunk length); the
    #: effective length is min(scan_chunk, next_pow2(steps)), and chunks
    #: restart at each same-bucket segment of the epoch plan
    scan_chunk: int = 32
    #: snapshot (params, moments, history, cursor) every N steps (0 = off)
    checkpoint_every: int = 0
    #: the validation draws' generator is seeded from (seed, -1,
    #: eval_fold): deterministic and disjoint from the per-step (seed,
    #: step) streams (JAX: ``fold_in(PRNGKey(seed), eval_fold)``)
    eval_fold: int = 123
    #: one-ahead staging (:class:`_OneAhead`): a worker thread packs and
    #: uploads the fit's chunk i + 1 / embed micro-batch i + 1 while the
    #: card runs i; bit-equal to ``prefetch=False``
    prefetch: bool = True
    #: staged items kept ahead of the consumer (one worker, order kept)
    prefetch_depth: int = 1
    opt: TrainConfig = field(
        default_factory=lambda: TrainConfig(
            learning_rate=7e-4, weight_decay=0.01, warmup_steps=20,
            total_steps=120, schedule="cosine", grad_clip=1.0,
        )
    )


# ---------------------------------------------------------------------------
# Draws: every random number of a step, made up front from one generator
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ViewDraws:
    """The draws of one augmented view (JAX: one of ``r1``/``r2`` and
    ``rp1``/``rp2`` in ``packed_loss`` / ``_loss``).  combo (G,) int64 in
    [0, 6); node_keep (P,) / edge_keep (Q,) bool for a packed batch, (B, N)
    / (B, E) for a dense one (G = B); ``enc`` the encoder's noise and
    dropout draws (``None`` in eval mode); proj_keep (G, proj_hidden) bool
    (``None`` in eval mode)."""
    combo: torch.Tensor
    node_keep: torch.Tensor
    edge_keep: torch.Tensor
    enc: Optional[EncodeDraws] = None
    proj_keep: Optional[torch.Tensor] = None

    def to(self, device) -> "ViewDraws":
        mv = lambda t: None if t is None else t.to(device)  # noqa: E731
        enc = None if self.enc is None else EncodeDraws(
            noise=mv(self.enc.noise), noise_gate=mv(self.enc.noise_gate),
            dropout=tuple(mv(k) for k in self.enc.dropout))
        return ViewDraws(mv(self.combo), mv(self.node_keep),
                         mv(self.edge_keep), enc, mv(self.proj_keep))


def draw_seed(seed: int, *stream: int) -> int:
    """A 63-bit generator seed from (seed, stream...) — (seed, step) for
    training steps, (seed, -1, eval_fold) for validation."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFF]
                                + [int(x) & 0xFFFFFFFF for x in stream])
    lo, hi = (int(x) for x in ss.generate_state(2, np.uint32))
    return (lo | (hi << 32)) >> 1


def draw_view(gen: torch.Generator, batch: dict, rc: RGCNConfig, *,
              train: bool = True) -> ViewDraws:
    """All draws of one view, in a fixed order, on the generator's device,
    shaped for the batch: packed (``graph_mask`` present) or dense."""
    dev = gen.device
    nodes = tuple(batch["node_mask"].shape)       # (P,) or (B, N)
    edges = tuple(batch["edge_mask"].shape)       # (Q,) or (B, E)
    G = batch["graph_mask"].shape[0] if "graph_mask" in batch else nodes[0]
    combo = torch.randint(0, len(COMBOS), (G,), generator=gen, device=dev)
    node_keep = torch.rand(nodes, generator=gen, device=dev) \
        < 1 - NODE_DROP_RATE
    edge_keep = torch.rand(edges, generator=gen, device=dev) \
        < 1 - EDGE_DROP_RATE
    if not train:
        return ViewDraws(combo, node_keep, edge_keep)
    noise = torch.randn(*nodes, rc.dims[0], generator=gen, device=dev,
                        dtype=rc.policy.compute)
    dropout = tuple(
        torch.rand(*nodes, d, generator=gen, device=dev) < 1 - rc.dropout
        for d in rc.dims[1:-1])
    proj_keep = torch.rand(G, rc.proj_hidden, generator=gen,
                           device=dev) < 1 - rc.dropout
    return ViewDraws(combo, node_keep, edge_keep,
                     EncodeDraws(noise=noise, dropout=dropout), proj_keep)


def draw_step(gen: torch.Generator, batch: dict, rc: RGCNConfig, *,
              train: bool = True) -> tuple:
    """(view 1, view 2) draws of one training (or validation) step."""
    return (draw_view(gen, batch, rc, train=train),
            draw_view(gen, batch, rc, train=train))


def _take(t, span: tuple, n: int):
    """Rows [lo, hi) of ``t`` in a tensor of ``n`` rows, the rest zero (the
    padding rows of a rank's batch); ``t`` itself when that is all of it."""
    if t is None:
        return None
    lo, hi = span
    if (lo, hi, n) == (0, t.shape[0], t.shape[0]):
        return t
    out = t.new_zeros((n,) + tuple(t.shape[1:]))
    out[:hi - lo] = t[lo:hi]
    return out


def shard_draws(vd: ViewDraws, r: ShardRange) -> ViewDraws:
    """A rank's rows of one view's draws, made at the whole batch's shape:
    its graphs', nodes' and edges' rows, laid out as its own batch."""
    node = lambda t: _take(t, r.nodes, r.P)               # noqa: E731
    graph = lambda t: _take(t, r.graphs, r.n_graphs)      # noqa: E731
    enc = None if vd.enc is None else EncodeDraws(
        noise=node(vd.enc.noise), noise_gate=vd.enc.noise_gate,
        dropout=tuple(node(k) for k in vd.enc.dropout))
    return ViewDraws(graph(vd.combo), node(vd.node_keep),
                     _take(vd.edge_keep, r.edges, r.Q), enc,
                     graph(vd.proj_keep))


# ---------------------------------------------------------------------------
# Loss and step
# ---------------------------------------------------------------------------

def packed_loss(enc: RGCNEncoder, rc: RGCNConfig, tau: float, batch: dict,
                draws: tuple, *, train: bool = True, gather=None):
    """Packed-batch InfoNCE over two augmented views (JAX ``packed_loss``).

    ``train=True``: the views' strategy draws, feature noise on the graphs
    whose strategy holds it, dropout on.  ``train=False`` (validation): the
    views' augmentations only — no feature noise, no dropout.
    ``gather`` maps each view's projected rows to the whole batch's (a
    rank's share, see :func:`sharded_loss`)."""
    zs = []
    for vd in draws:
        view, use_noise = augment_view_packed(batch, vd.combo, vd.node_keep,
                                              vd.edge_keep)
        if train:
            ed = dataclasses.replace(vd.enc, noise_gate=use_noise)
            z = rgcn_mod.encode_packed(enc, rc, view, draws=ed, train=True,
                                       edges_checked=True)
            zs.append(rgcn_mod.project(enc, rc, z, keep=vd.proj_keep,
                                       train=True))
        else:
            z = rgcn_mod.encode_packed(enc, rc, view, edges_checked=True)
            zs.append(rgcn_mod.project(enc, rc, z))
        if gather is not None:
            zs[-1] = gather(zs[-1])
    return info_nce(zs[0], zs[1], tau)


def sharded_loss(enc: RGCNEncoder, rc: RGCNConfig, tau: float,
                 batch: Optional[dict], draws: tuple, shard: tuple, *,
                 train: bool = True):
    """The whole batch's InfoNCE from one rank's share: ``shard`` is
    (group, the rank's first graph, the batch's graphs), ``batch`` and
    ``draws`` the rank's (``None`` for a rank that holds no graph, which
    still joins both gathers).  Every rank gets the same loss."""
    group, lo, total = shard

    def gather(p):
        return group.gather_rows(p, lo, total)

    if batch is not None:
        return packed_loss(enc, rc, tau, batch, draws, train=train,
                           gather=gather)
    empty = torch.zeros(0, rc.proj_out, device=enc.embed_instr.device)
    return info_nce(gather(empty), gather(empty), tau)


def dense_loss(enc: RGCNEncoder, rc: RGCNConfig, tau: float, batch: dict,
               max_warps: int, draws: tuple):
    """Dense-batch InfoNCE over two augmented views in training mode (JAX
    ``ContrastiveTrainer._loss``): each view's strategy draws, feature
    noise on the graphs whose strategy holds it, dropout on.  ``batch`` is
    ``pad_batch``'s arrays as tensors; its endpoints are checked once here
    (one host sync on the card)."""
    check_endpoints(batch["edge_src"], batch["edge_dst"],
                    batch["node_mask"].shape[1], "dense_loss")
    zs = []
    for vd in draws:
        view, use_noise = augment_view(batch, vd.combo, vd.node_keep,
                                       vd.edge_keep)
        ed = dataclasses.replace(vd.enc, noise_gate=use_noise)
        z = rgcn_mod.encode(enc, rc, view, max_warps, draws=ed, train=True,
                            edges_checked=True)
        zs.append(rgcn_mod.project(enc, rc, z, keep=vd.proj_keep,
                                   train=True))
    return info_nce(zs[0], zs[1], tau)


def train_step(enc: RGCNEncoder, rc: RGCNConfig, tau: float,
               opt: TrainConfig, batch: dict, draws: tuple,
               state: TrainState, shard: Optional[tuple] = None):
    """One optimizer step, in place on ``enc`` (``state.params`` is
    ``dict(enc.named_parameters())``) and the state's moments: the scaled
    loss is differentiated, ``apply_gradients`` compresses (with
    ``opt.grad_compress``) and unscales.  ``batch``'s edges must have been
    validated (``check_endpoints``).  Returns (the new state, the step's
    metrics as one (len(METRIC_KEYS),) float32 tensor on the device: no
    host sync).  With ``shard`` (see :func:`sharded_loss`), ``batch`` and
    ``draws`` are a rank's share and the ranks' partial gradients are
    summed in rank order first."""
    params = state.params
    if shard is None:
        loss, m = packed_loss(enc, rc, tau, batch, draws, train=True)
        grads = torch.autograd.grad(loss * rc.policy.loss_scale,
                                    list(params.values()))
    else:
        loss, m = sharded_loss(enc, rc, tau, batch, draws, shard)
        leaves = list(params.values())
        parts = (torch.autograd.grad(loss * rc.policy.loss_scale, leaves)
                 if loss.requires_grad else
                 [torch.zeros_like(p) for p in leaves])
        total = shard[0].sum_in_rank_order(
            torch.cat([g.reshape(-1) for g in parts]))
        grads = [g.view_as(p) for g, p in zip(
            torch.split(total, [p.numel() for p in leaves]), leaves)]
    state, om = apply_gradients(state, dict(zip(params, grads)), opt)
    with torch.no_grad():      # metrics must not keep the step's graph
        lr = torch.full((), om["lr"], dtype=torch.float32,
                        device=loss.device)
        return state, torch.stack([loss, m["nce_acc"], m["pos_sim"],
                                   m["neg_sim"], lr, om["grad_norm"]])


def _params_fingerprint(params: RGCNEncoder) -> str:
    """Cheap content fingerprint of the encoder (the embedding cache is only
    valid for the params it was computed with): a prefix of every
    parameter's bytes, in name order."""
    h = hashlib.blake2b(digest_size=8)
    for name, leaf in sorted(params.state_dict().items()):
        h.update(name.encode())
        h.update(leaf.detach().cpu().numpy().tobytes()[:4096])
    return h.hexdigest()


class ContrastiveTrainer:
    """``group``: fit data-parallel over the ranks of a
    :class:`~repro_torch.distributed.group.Group`, this process being one
    rank on ``device`` (see the module docstring); inference is unchanged."""

    def __init__(self, rc: RGCNConfig,
                 tc: Optional[GCLTrainConfig] = None, *, device=None,
                 group=None):
        self.rc = rc
        self.tc = tc or GCLTrainConfig()
        self.device = resolve_device(device)
        self.group = group
        self._stager = HostStager(self.device)
        self._embed_cache: dict[str, np.ndarray] = {}
        self._embed_cache_fp: Optional[str] = None
        self._encoder: Optional[RGCNEncoder] = None
        self._encoder_src: Optional[int] = None
        # LRU-evicted above this many entries (hits move to the tail)
        self.embed_cache_max = 65536
        self.embed_stats: dict = {}

    # -- training -----------------------------------------------------------
    @property
    def opt(self) -> TrainConfig:
        """Optimizer config with the precision policy's loss scale threaded
        through; a conflicting explicit ``opt.loss_scale`` is refused."""
        if self.tc.opt.loss_scale == self.rc.policy.loss_scale:
            return self.tc.opt
        if self.tc.opt.loss_scale != 1.0:
            raise ValueError(
                f"conflicting loss scales: TrainConfig.loss_scale="
                f"{self.tc.opt.loss_scale} vs policy.loss_scale="
                f"{self.rc.policy.loss_scale}; set it on the precision "
                f"policy (RGCNConfig.policy) only")
        return dataclasses.replace(self.tc.opt,
                                   loss_scale=self.rc.policy.loss_scale)

    def split(self, n: int):
        """(train indices, validation indices, (steps, bs) selections) for
        ``n`` graphs — the JAX package's draws from the same numpy stream,
        so the indices are equal."""
        tc = self.tc
        rng_np = np.random.default_rng(tc.seed)
        perm = rng_np.permutation(n)
        n_val = max(1, int(n * tc.val_fraction)) if n >= 5 else 0
        train_idx = perm[n_val:] if n_val else perm
        val_idx = perm[:n_val]
        bs = min(tc.batch_size, len(train_idx))
        selections = np.stack([
            train_idx[rng_np.choice(len(train_idx), size=bs,
                                    replace=len(train_idx) < bs)]
            for _ in range(tc.steps)
        ]) if tc.steps else np.zeros((0, bs), np.int64)
        return train_idx, val_idx, selections

    def _stage(self, packed: dict):
        """Host arrays -> a :class:`~repro_torch.utils.device.Staged` batch
        on the trainer's device (callable from the staging thread), edges
        validated on the host first (no per-kernel range check, no host
        sync on the device side)."""
        check_endpoints(packed["edge_src"], packed["edge_dst"],
                        packed["node_mask"].shape[-1], "staged batch")
        return self._stager.put(packed)

    def _upload(self, packed: dict) -> dict:
        """Host arrays -> device tensors, staged inline (``_stage`` then
        ``take`` on this thread)."""
        return take(self._stage(packed))

    def fit(self, graphs: list[KernelGraph], verbose=False, *,
            checkpoint_dir: Optional[str] = None, resume: bool = True,
            interrupt_after: Optional[int] = None,
            fault_hook: Optional[callable] = None,
            watchdog: Optional[Watchdog] = None):
        """Train on an 80/20 split of the graphs; returns (encoder on the
        trainer's device, info).

        ``checkpoint_dir`` enables the resume protocol: snapshots every
        ``tc.checkpoint_every`` steps; when the directory already holds one
        and ``resume`` is True, training continues from its cursor.
        ``interrupt_after=k`` raises :class:`FitInterrupted` right after the
        checkpoint at step k.

        Fault protocol: ``fault_hook(done)`` runs at every chunk boundary
        (JAX's scan chunks: ``tc.scan_chunk`` steps inside each segment,
        counted from the segment's start, so a resumed fit meets the same
        boundaries) and may raise
        :class:`~repro_torch.distributed.fault.DeviceLost`; a ``watchdog``
        brackets each chunk with ``step_start`` / ``step_end`` (the card
        synchronized before the end) and a fired straggler SLO becomes
        DeviceLost at the same boundary.  Either way the fit checkpoints
        at the boundary first, so :func:`fit_resilient` resumes from it."""
        tc, rc = self.tc, self.rc
        _, val_idx, selections = self.split(len(graphs))
        enc = rgcn_mod.init_rgcn(tc.seed, rc).to(self.device)
        caps = dict(max_nodes_per_graph=MAX_NODES_PER_MICROBATCH,
                    max_edges_per_graph=MAX_EDGES_PER_MICROBATCH)
        info = self._fit_steps(graphs, selections, enc, caps, verbose,
                               checkpoint_dir=checkpoint_dir, resume=resume,
                               interrupt_after=interrupt_after,
                               fault_hook=fault_hook, watchdog=watchdog)
        trunc_nodes = info["trunc_nodes"]
        if len(val_idx):
            packed, vmeta = pack_graphs([graphs[i] for i in val_idx], **caps)
            trunc_nodes += int(vmeta.trunc_nodes.sum())
            loss, m = self.eval_loss(enc, packed if self.group else
                                     self._upload(packed))
            info["val_loss"], info["val_acc"] = loss, m["nce_acc"]
            info["host_syncs"] += 1
        if trunc_nodes:
            warnings.warn(
                f"training packed {trunc_nodes} node(s) over the per-graph "
                f"budget; graphs were truncated (see batching caps)",
                stacklevel=2)
        info["trunc_nodes"] = trunc_nodes
        return enc, info

    def eval_loss(self, enc: RGCNEncoder, batch: dict):
        """Validation InfoNCE in eval mode: augmentations drawn from the
        seed-derived generator, no dropout, no feature noise.  Returns
        (loss, metrics) as floats (one host sync).  With a group, ``batch``
        is the whole packed batch on the host, and each rank encodes its
        share."""
        gen = torch.Generator(device=self.device).manual_seed(
            draw_seed(self.tc.seed, -1, self.tc.eval_fold))
        with torch.no_grad():
            draws = draw_step(gen, batch, self.rc, train=False)
            if self.group is None:
                loss, m = packed_loss(enc, self.rc, self.tc.tau, batch,
                                      draws, train=False)
            else:
                local, draws, shard = self._shard(self._stage_shard(batch),
                                                  draws)
                loss, m = sharded_loss(enc, self.rc, self.tc.tau, local,
                                       draws, shard, train=False)
            vals = torch.stack([loss, *m.values()]).cpu().tolist()
        return vals[0], dict(zip(m, vals[1:]))

    def _stage_shard(self, packed: dict):
        """(the whole batch's host arrays, this rank's ShardRange, its
        staged share or None) of a packed batch: the host side of a rank's
        step, callable from the staging thread."""
        g = self.group
        r = shard_ranges(packed, g.rank, g.size)
        local = (self._stage(shard_batch(packed, g.rank, g.size))
                 if r.n_graphs else None)
        return packed, r, local

    def _shard(self, staged, draws: tuple):
        """(this rank's batch on the device or None, its draws, the shard)
        from ``_stage_shard``'s triple and the whole batch's draws."""
        packed, r, local = staged
        return (None if local is None else take(local),
                tuple(shard_draws(d, r) for d in draws),
                (self.group, r.graphs[0], packed["graph_mask"].shape[0]))

    def _agree(self, lost: Optional[DeviceLost]) -> Optional[DeviceLost]:
        """Every rank's verdict at a chunk boundary: a DeviceLost (the
        lowest losing rank's message) on every rank when any rank lost a
        participant, else None on every rank."""
        g = self.group
        flag = g.flag_max(g.size - g.rank if lost is not None else 0,
                          self.device)
        if not flag:
            return None
        src = g.size - flag
        return DeviceLost(g.broadcast_text(
            str(lost) if g.rank == src else "", src, self.device))

    def _fit_steps(self, graphs, selections, enc, caps, verbose, *,
                   checkpoint_dir, resume, interrupt_after, fault_hook=None,
                   watchdog=None) -> dict:
        tc, rc, opt, group = self.tc, self.rc, self.opt, self.group
        lead = group is None or group.rank == 0     # writes the checkpoints
        plan = plan_epoch(graphs, selections, **caps)
        steps = plan.n_steps
        chunk_len = min(tc.scan_chunk, bucket_size(max(steps, 1), 1))
        wd_fired0 = watchdog.fired if watchdog is not None else 0
        state = adamw_init(dict(enc.named_parameters()), opt)
        mgr = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
        start, history = 0, []
        if mgr is not None and resume and mgr.latest_step() is not None:
            state, start, history = self._restore_fit(mgr, state)

        host_syncs = saves = 0
        run = coll_bytes = 0
        last_save = start
        pending: list[torch.Tensor] = []
        t0 = time.perf_counter()

        def flush():
            """Pull the buffered per-step metrics to the host in one sync."""
            nonlocal host_syncs
            if not pending:
                return
            host_syncs += 1
            # lint: allow[R1] the batched log readback: one sync a log_every steps
            for row in torch.stack(pending).cpu().tolist():
                history.append(dict(zip(METRIC_KEYS, row)))
            pending.clear()
            if verbose:
                m = history[-1]
                print(f"  step {len(history) - 1:4d} loss={m['loss']:.4f} "
                      f"acc={m['nce_acc']:.3f} lr={m['lr']:.2e} "
                      f"({time.perf_counter() - t0:.1f}s)")

        def save(done):
            nonlocal last_save, saves
            if lead:
                self._save_fit(mgr, state, history, done)
            last_save, saves = done, saves + 1

        def settle():
            """Rank 0's checkpoints are on disk when every rank returns."""
            if lead:
                mgr.wait()
            if group is not None:
                group.barrier(self.device)

        def chunk_descs():
            """(segment, lo, hi) of each chunk still to run: ``chunk_len``
            steps inside each same-bucket segment, counted from its start
            (JAX's scan chunks); chunks that end at or before the resume
            cursor are skipped."""
            for seg in plan.segments:
                for lo in range(seg.start, seg.stop, chunk_len):
                    hi = min(lo + chunk_len, seg.stop)
                    if hi > start:
                        yield seg, lo, hi

        def stage_chunk(desc):
            """Host side of one chunk, on the staging thread: the segment's
            rows of the chunk's steps from the cursor on (a resume cursor
            may fall inside a chunk), staged as one (steps, ...) batch, or
            with a group this rank's share of each step's batch."""
            seg, lo, hi = desc
            r0, r1 = max(lo, start) - seg.start, hi - seg.start
            rows = {k: v[r0:r1] for k, v in seg.batches.items()}
            if group is None:
                return self._stage(rows)
            return [self._stage_shard({k: v[j] for k, v in rows.items()})
                    for j in range(r1 - r0)]

        gen = torch.Generator(device=self.device)
        pipe = _OneAhead(stage_chunk, chunk_descs(), enabled=tc.prefetch,
                         depth=tc.prefetch_depth)
        with pipe:
            for (_, lo, hi), staged in pipe:
                if watchdog is not None:
                    watchdog.step_start()
                first = max(lo, start)
                chunk = take(staged) if group is None else None
                for step in range(first, hi):
                    gen.manual_seed(draw_seed(tc.seed, step))
                    if group is None:
                        batch = {k: v[step - first] for k, v in chunk.items()}
                        draws = draw_step(gen, batch, rc)
                        state, metrics = train_step(enc, rc, tc.tau, opt,
                                                    batch, draws, state)
                    else:
                        mine = staged[step - first]
                        b0 = group.bytes
                        batch, draws, shard = self._shard(
                            mine, draw_step(gen, mine[0], rc))
                        state, metrics = train_step(enc, rc, tc.tau, opt,
                                                    batch, draws, state,
                                                    shard)
                        coll_bytes += group.bytes - b0
                    run += 1
                    pending.append(metrics)
                    done = step + 1
                    if done % tc.log_every == 0 or done == steps:
                        flush()
                    due = (mgr is not None and tc.checkpoint_every > 0
                           and done - last_save >= tc.checkpoint_every)
                    interrupt = (interrupt_after is not None
                                 and done >= interrupt_after)
                    if due or (interrupt and mgr is not None):
                        flush()
                        save(done)
                    if interrupt:
                        if mgr is not None:
                            settle()
                        raise FitInterrupted(
                            f"fit interrupted at step {done} "
                            f"(interrupt_after={interrupt_after})")
                # chunk boundary: a lost or straggling participant surfaces
                # here, never mid-chunk, after the boundary is checkpointed
                lost = None
                if watchdog is not None:
                    if self.device.type == "cuda":
                        # lint: allow[R1] the watchdog times a chunk on the host clock
                        torch.cuda.synchronize(self.device)
                    watchdog.step_end()
                if fault_hook is not None:
                    try:
                        fault_hook(done)
                    except DeviceLost as e:
                        lost = e
                if (lost is None and watchdog is not None
                        and watchdog.fired > wd_fired0):
                    lost = DeviceLost(
                        f"chunk ending at step {done} exceeded the "
                        f"watchdog SLO (straggling participant)")
                if group is not None:
                    lost = self._agree(lost)
                if lost is not None:
                    flush()
                    if mgr is not None:
                        if done > last_save:
                            save(done)
                        settle()
                    raise lost
        flush()
        if mgr is not None:
            settle()
        return {
            "history": history,
            "bucket_keys": list(plan.bucket_keys),
            "trunc_nodes": plan.trunc_nodes,
            "engine": "eager",
            "host_syncs": host_syncs,
            "resumed_from": start,
            "checkpoint_saves": saves,
            "chunk_len": chunk_len,
            "fit_s": time.perf_counter() - t0,
            **_prefetch_stats(pipe),
            "data_shards": 1 if group is None else group.size,
            #: bytes the step collectives carried, a step (0 on one card)
            "collective_bytes": coll_bytes / max(run, 1),
        }

    # -- resume protocol -----------------------------------------------------
    def _save_fit(self, mgr: CheckpointManager, state: TrainState, history,
                  cursor: int) -> None:
        def nest(d):      # 'layers.0.basis' -> {"layers": [{"basis": .}]}
            return unflatten_tree({k.replace(".", "/"): v.detach()
                                   for k, v in d.items()})

        mgr.save(cursor, {
            "state": {
                "step": np.int64(state.step),
                "params": nest(state.params),
                "mu": nest(state.mu),
                "nu": nest(state.nu),
                **({"compress_err": nest(state.compress_err)}
                   if state.compress_err is not None else {}),
            },
            "seed": np.int64(self.tc.seed),
            "history": {k: np.asarray([h[k] for h in history], np.float32)
                        for k in METRIC_KEYS},
            "cursor": np.int64(cursor),
        })

    def _restore_fit(self, mgr: CheckpointManager, state: TrainState):
        """Load the latest snapshot into ``state``'s tensors (the encoder's
        parameters, the moments, the compression residual); returns
        (state at the snapshot's step, cursor, history).  Refuses a
        checkpoint of another seed (the epoch plan would not replay)."""
        tree, _ = mgr.restore_tree()
        if int(tree["seed"]) != self.tc.seed:
            raise ValueError(
                f"checkpoint in {mgr.directory} was written with a "
                f"different seed; pass resume=False to refit")
        sd = tree["state"]
        with torch.no_grad():
            for name in ("params", "mu", "nu", "compress_err"):
                tgt = getattr(state, name)
                if tgt is None:
                    continue
                flat = flatten_tree(sd[name])
                for k, t in tgt.items():
                    t.copy_(torch.from_numpy(flat[k.replace(".", "/")]))
        cursor = int(tree["cursor"])
        hist = tree["history"]
        history = [{k: float(hist[k][i]) for k in METRIC_KEYS}
                   for i in range(cursor)]
        return state._replace(step=int(sd["step"])), cursor, history

    # -- inference ----------------------------------------------------------
    def _embed_setup(self, params: RGCNEncoder, n_cap: int, e_cap: int
                     ) -> RGCNEncoder:
        """The content cache is valid only for the (params, truncation caps)
        it was built with; a device copy of the encoder is made once per
        params object (the caller's module stays where it is)."""
        fp = f"{_params_fingerprint(params)}:{n_cap}:{e_cap}"
        if fp != self._embed_cache_fp:
            self._embed_cache.clear()
            self._embed_cache_fp = fp
            self._encoder = None
        if self._encoder is None or self._encoder_src != id(params):
            self._encoder = copy.deepcopy(params).to(self.device).eval()
            self._encoder_src = id(params)
        return self._encoder

    def _stage_bin(self, bin_graphs, n_cap, e_cap):
        """Pack + stage one micro-batch (on the staging thread).  Per-graph
        caps truncate a single graph larger than the budget (with
        accounting) instead of letting it blow the bucket.  Returns (the
        staged batch, PackMeta, bucket key)."""
        packed, meta = pack_graphs(
            bin_graphs,
            pad_graphs_to=bucket_size(len(bin_graphs), 8),
            max_nodes_per_graph=n_cap, max_edges_per_graph=e_cap,
        )
        return self._stage(packed), meta, bucket_key(packed)

    @staticmethod
    def prepad(graphs: list[KernelGraph], pad_to=None):
        """(dense batch arrays, max_warps) for ``graphs``: ``pad_batch``
        with the optional (max_nodes, max_edges, max_warps) shapes."""
        return pad_batch(graphs, *(pad_to or (None, None, None)))

    def embed_dense(self, params: RGCNEncoder, graphs: list[KernelGraph],
                    batch_size=64, pad_shapes=None) -> np.ndarray:
        """The dense embed path, the pre-packing baseline: the whole list
        is padded once to its largest graph (``prepad``), then encoded in
        batches of ``batch_size`` graphs on the trainer's device through
        ``core/rgcn.encode`` (K6 per layer on the card).  No content
        cache: every graph is encoded."""
        full, max_warps = self.prepad(graphs, pad_shapes)
        if next(params.parameters()).device == self.device:
            enc = params
        else:
            enc = copy.deepcopy(params).to(self.device)
        outs = []
        for i in range(0, len(graphs), batch_size):
            batch = self._upload({k: v[i:i + batch_size]
                                  for k, v in full.items()})
            with torch.inference_mode():
                z = rgcn_mod.encode(enc, self.rc, batch, max_warps,
                                    edges_checked=True)
            outs.append(z.float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    def _encode(self, enc: RGCNEncoder, staged) -> np.ndarray:
        """One staged micro-batch's embeddings, read back to the host (the
        staging thread packs the next micro-batch meanwhile)."""
        with torch.inference_mode():
            z = rgcn_mod.encode_packed(enc, self.rc, take(staged),
                                       edges_checked=True)
        return z.float().cpu().numpy()

    def _embed_finish(self, label, hashes, stats):
        """Assemble rows from the cache, warn on truncation, LRU-evict,
        publish ``self.embed_stats``."""
        if stats["trunc_nodes"] or stats["trunc_edges"]:
            warnings.warn(
                f"{label} truncated {stats['trunc_nodes']} node(s) / "
                f"{stats['trunc_edges']} edge(s) over the micro-batch "
                f"budget; embeddings for the affected graphs are computed "
                f"on truncated graphs",
                stacklevel=3,
            )
        out = np.stack([self._embed_cache[h] for h in hashes]) if hashes \
            else np.zeros((0, self.rc.dims[-1]), np.float32)
        while len(self._embed_cache) > self.embed_cache_max:
            self._embed_cache.pop(next(iter(self._embed_cache)))
        self.embed_stats = {"graphs": len(hashes), **stats}
        return out

    def embed(self, params: RGCNEncoder, graphs: list[KernelGraph],
              batch_size=64, max_nodes=None, max_edges=None) -> np.ndarray:
        """256-d kernel embeddings for all graphs.  Micro-batched pass over
        size buckets with a content-hash cache: repeated kernel invocations
        (identical traces) are encoded once.  Stats land in
        ``self.embed_stats``."""
        n_cap = max_nodes or MAX_NODES_PER_MICROBATCH
        e_cap = max_edges or MAX_EDGES_PER_MICROBATCH
        enc = self._embed_setup(params, n_cap, e_cap)

        n = len(graphs)
        hashes = [graph_content_hash(g) for g in graphs]
        todo: list[int] = []
        scheduled: set[str] = set()
        for i, hsh in enumerate(hashes):
            if hsh in self._embed_cache:
                self._embed_cache[hsh] = self._embed_cache.pop(hsh)
            elif hsh not in scheduled:
                scheduled.add(hsh)
                todo.append(i)

        bucket_keys = set()
        trunc_nodes = trunc_edges = 0
        bins = plan_microbatches(
            [graphs[i] for i in todo],
            max_nodes=n_cap, max_edges=e_cap, max_graphs=batch_size,
        )

        def stage(bin_idx):
            sel = [todo[j] for j in bin_idx]
            return sel, self._stage_bin([graphs[i] for i in sel], n_cap,
                                        e_cap)

        pipe = _OneAhead(stage, bins, enabled=self.tc.prefetch,
                         depth=self.tc.prefetch_depth)
        with pipe:
            for _, (sel, (staged, meta, bkey)) in pipe:
                z = self._encode(enc, staged)
                trunc_nodes += int(meta.trunc_nodes.sum())
                trunc_edges += int(meta.trunc_edges.sum())
                bucket_keys.add(bkey)
                for k, i in enumerate(sel):
                    self._embed_cache[hashes[i]] = z[k]

        return self._embed_finish("embed", hashes, {
            "cache_hits": n - len(todo),
            "encoded": len(todo),
            "microbatches": len(bins),
            "bucket_keys": sorted(bucket_keys),
            "trunc_nodes": trunc_nodes,
            "trunc_edges": trunc_edges,
            **_prefetch_stats(pipe),
        })

    def embed_stream(self, params: RGCNEncoder, graphs, batch_size=64,
                     max_nodes=None, max_edges=None) -> np.ndarray:
        """Streaming-iterator variant of ``embed``: consumes any iterable of
        KernelGraphs holding at most one micro-batch of graphs resident
        (arrival order, no global size sort)."""
        n_cap = max_nodes or MAX_NODES_PER_MICROBATCH
        e_cap = max_edges or MAX_EDGES_PER_MICROBATCH
        enc = self._embed_setup(params, n_cap, e_cap)

        order: list[str] = []
        scheduled: set[str] = set()
        cache_hits = 0

        def pending():
            nonlocal cache_hits
            for g in graphs:
                h = graph_content_hash(g)
                order.append(h)
                if h in self._embed_cache:
                    self._embed_cache[h] = self._embed_cache.pop(h)
                    cache_hits += 1
                    continue
                if h in scheduled:
                    cache_hits += 1
                    continue
                scheduled.add(h)
                yield (h, g)

        bucket_keys = set()
        trunc_nodes = trunc_edges = 0
        stream_stats: dict = {}

        def stage(bin_items):
            return self._stage_bin([g for _, g in bin_items], n_cap, e_cap)

        # JAX's default depth 1: at most two micro-batches staged at once
        pipe = _OneAhead(
            stage,
            stream_bins(
                pending(), lambda hg: (hg[1].n_nodes, hg[1].n_edges),
                max_nodes=n_cap, max_edges=e_cap, max_graphs=batch_size,
                stats=stream_stats),
            enabled=self.tc.prefetch)
        with pipe:
            for bin_items, (staged, meta, bkey) in pipe:
                z = self._encode(enc, staged)
                trunc_nodes += int(meta.trunc_nodes.sum())
                trunc_edges += int(meta.trunc_edges.sum())
                bucket_keys.add(bkey)
                for k, (h, _) in enumerate(bin_items):
                    self._embed_cache[h] = z[k]

        return self._embed_finish("embed_stream", order, {
            "cache_hits": cache_hits,
            "encoded": len(scheduled),
            "microbatches": stream_stats.pop("bins", 0),
            "bucket_keys": sorted(bucket_keys),
            "trunc_nodes": trunc_nodes,
            "trunc_edges": trunc_edges,
            "streaming": True,
            **_prefetch_stats(pipe),
            **stream_stats,
        })


def fit_resilient(rc: RGCNConfig, tc: GCLTrainConfig,
                  graphs: list[KernelGraph], *, checkpoint_dir: str,
                  device_counts: Optional[list] = None,
                  fault_hook: Optional[callable] = None,
                  watchdog: Optional[Watchdog] = None,
                  verbose: bool = False, device=None, group=None):
    """Degrade-don't-abort driver, counterpart of JAX's ``fit_resilient``.

    Fits at width ``device_counts[0]``; when the fit raises
    :class:`~repro_torch.distributed.fault.DeviceLost` from a chunk
    boundary (after checkpointing), the next width resumes from that
    checkpoint instead of aborting.  Returns ``(encoder, info)`` from the
    fit that finished, with ``info["degradations"]`` recording each shrink
    and ``info["data_shards"]`` the width that finished.  Raises DeviceLost
    when every width failed, ValueError without a ``checkpoint_dir``.

    A width n is the first n ranks of ``group`` (a
    :class:`~repro_torch.distributed.group.Group`; this process is one
    rank on ``device``), and ``device_counts`` defaults to halving widths
    from the group's size down to 1.  Every rank of the job calls this
    with the same arguments: the subgroup of each width is made up front
    (``torch.distributed.new_group``, which every rank calls), and a rank
    outside the width a shrink leaves returns ``(None, info)`` with the
    degradations so far and, as ``data_shards``, that width.  Without a group the fit
    is one rank, the one card: widths above 1 raise ValueError.  JAX's
    ``mesh_axes`` names the axes of the mesh a width builds; a width here
    is ranks, so it has no counterpart.
    """
    if not checkpoint_dir:
        raise ValueError("fit_resilient requires a checkpoint_dir — "
                         "degradation resumes from checkpoints")
    dev = resolve_device(device)
    allowed = range(1, 2) if group is None else widths(dev.type, group)
    size = len(allowed)
    if device_counts is None:
        n, device_counts = size, []
        while n >= 1:
            device_counts.append(n)
            n //= 2
    wide = [n for n in device_counts if n not in allowed]
    if wide:
        raise ValueError(
            f"fit_resilient: widths {wide} are outside 1..{size} (the ranks "
            f"of the group; without one, the one card): a data-parallel "
            f"width runs over the ranks of a group (group=, ROADMAP A9b)")
    subgroups = ({n: group.subgroup(n) for n in sorted(set(device_counts))}
                 if group is not None else {})
    degradations: list[dict] = []
    last: Optional[DeviceLost] = None
    for i, ndev in enumerate(device_counts):
        sub = subgroups.get(ndev)
        if group is not None and sub is None:      # outside this width
            return None, {"degradations": degradations, "data_shards": ndev}
        trainer = ContrastiveTrainer(rc, tc, device=dev, group=sub)
        try:
            enc, info = trainer.fit(
                graphs, verbose, checkpoint_dir=checkpoint_dir, resume=True,
                fault_hook=fault_hook, watchdog=watchdog)
            info["degradations"] = degradations
            info["data_shards"] = ndev
            return enc, info
        except DeviceLost as e:
            last = e
            nxt = device_counts[i + 1] if i + 1 < len(device_counts) else None
            degradations.append({"from_devices": ndev, "to_devices": nxt,
                                 "error": str(e)})
            if verbose:
                print(f"[fit_resilient] {e} — degrading "
                      f"{ndev} -> {nxt} devices", flush=True)
    raise DeviceLost(
        f"training failed at every mesh width {device_counts} "
        f"(last: {last})") from last
