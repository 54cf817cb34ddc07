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

Inference (``embed`` / ``embed_stream``) turns kernel graphs into the
256-d kernel embeddings z_k (paper §3.4): graphs are packed into size
buckets, uploaded to the trainer's device and encoded by
``core/rgcn.encode_packed``; identical graphs (same content hash) are
encoded once.  Host-side staging runs inline (the JAX package's one-ahead
prefetch thread is not ported).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import time
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import rgcn as rgcn_mod
from repro_torch.core.augment import (
    COMBOS, EDGE_DROP_RATE, NODE_DROP_RATE, augment_view_packed,
)
from repro_torch.core.batching import (
    MAX_EDGES_PER_MICROBATCH, MAX_NODES_PER_MICROBATCH, bucket_key,
    bucket_size, graph_content_hash, pack_graphs, plan_epoch,
    plan_microbatches, stream_bins,
)
from repro_torch.core.contrastive import info_nce
from repro_torch.core.graphs import KernelGraph
from repro_torch.core.rgcn import EncodeDraws, RGCNConfig, RGCNEncoder
from repro_torch.kernels import check_endpoints
from repro_torch.optim.adamw import TrainConfig, adamw_init, adamw_update
from repro_torch.sampling.store import flatten_tree, unflatten_tree
from repro_torch.utils.device import resolve_device

#: fixed metric layout of a training step (one (6,) device tensor per step;
#: checkpoints store one column per key)
METRIC_KEYS = ("loss", "nce_acc", "pos_sim", "neg_sim", "lr", "grad_norm")
#: the validation draws' generator is seeded from (seed, -1, EVAL_STREAM):
#: deterministic and disjoint from the per-step (seed, step) streams
EVAL_STREAM = 123


class FitInterrupted(RuntimeError):
    """Raised by ``fit(interrupt_after=k)`` right after the checkpoint at
    step k — the hook the tests use to simulate a killed training job
    without killing the process."""


@dataclass(frozen=True)
class GCLTrainConfig:
    steps: int = 120
    batch_size: int = 16
    tau: float = 0.05
    val_fraction: float = 0.2
    log_every: int = 50
    seed: int = 0
    #: snapshot (params, moments, history, cursor) every N steps (0 = off)
    checkpoint_every: int = 0
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
    ``rp1``/``rp2`` in ``packed_loss``).  combo (G,) int64 in [0, 6);
    node_keep (P,) / edge_keep (Q,) bool; ``enc`` the encoder's noise and
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
    training steps, (seed, -1, EVAL_STREAM) for validation."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFF]
                                + [int(x) & 0xFFFFFFFF for x in stream])
    lo, hi = (int(x) for x in ss.generate_state(2, np.uint32))
    return (lo | (hi << 32)) >> 1


def draw_view(gen: torch.Generator, batch: dict, rc: RGCNConfig, *,
              train: bool = True) -> ViewDraws:
    """All draws of one view, in a fixed order, on the generator's device."""
    dev = gen.device
    P = batch["node_mask"].shape[0]
    Q = batch["edge_mask"].shape[0]
    G = batch["graph_mask"].shape[0]
    combo = torch.randint(0, len(COMBOS), (G,), generator=gen, device=dev)
    node_keep = torch.rand(P, generator=gen, device=dev) < 1 - NODE_DROP_RATE
    edge_keep = torch.rand(Q, generator=gen, device=dev) < 1 - EDGE_DROP_RATE
    if not train:
        return ViewDraws(combo, node_keep, edge_keep)
    noise = torch.randn(P, rc.dims[0], generator=gen, device=dev,
                        dtype=rc.policy.compute)
    dropout = tuple(
        torch.rand(P, d, generator=gen, device=dev) < 1 - rc.dropout
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


# ---------------------------------------------------------------------------
# Loss and step
# ---------------------------------------------------------------------------

def packed_loss(enc: RGCNEncoder, rc: RGCNConfig, tau: float, batch: dict,
                draws: tuple, *, train: bool = True):
    """Packed-batch InfoNCE over two augmented views (JAX ``packed_loss``).

    ``train=True``: the views' strategy draws, feature noise on the graphs
    whose strategy holds it, dropout on.  ``train=False`` (validation): the
    views' augmentations only — no feature noise, no dropout."""
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
    return info_nce(zs[0], zs[1], tau)


def train_step(enc: RGCNEncoder, rc: RGCNConfig, tau: float,
               opt: TrainConfig, batch: dict, draws: tuple, mu: dict,
               nu: dict, step: int) -> torch.Tensor:
    """One optimizer step in place on ``enc`` / ``mu`` / ``nu``: the scaled
    loss is differentiated, AdamW unscales.  ``batch``'s edges must have
    been validated (``check_endpoints``).  Returns the step's metrics as
    one (len(METRIC_KEYS),) float32 tensor on the device (no host sync)."""
    params = dict(enc.named_parameters())
    loss, m = packed_loss(enc, rc, tau, batch, draws, train=True)
    grads = torch.autograd.grad(loss * rc.policy.loss_scale,
                                list(params.values()))
    om = adamw_update(params, dict(zip(params, grads)), mu, nu, step, opt)
    with torch.no_grad():      # metrics must not keep the step's graph
        lr = torch.full((), om["lr"], dtype=torch.float32,
                        device=loss.device)
        return torch.stack([loss, m["nce_acc"], m["pos_sim"], m["neg_sim"],
                            lr, om["grad_norm"]])


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
    def __init__(self, rc: RGCNConfig,
                 tc: Optional[GCLTrainConfig] = None, *, device=None):
        self.rc = rc
        self.tc = tc or GCLTrainConfig()
        self.device = resolve_device(device)
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

    def _upload(self, packed: dict) -> dict:
        """Host arrays -> device tensors, edges validated on the host first
        (no per-kernel range check, no host sync on the device side)."""
        check_endpoints(packed["edge_src"], packed["edge_dst"],
                        packed["node_mask"].shape[-1], "staged batch")
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in packed.items()}

    def fit(self, graphs: list[KernelGraph], verbose=False, *,
            checkpoint_dir: Optional[str] = None, resume: bool = True,
            interrupt_after: Optional[int] = None):
        """Train on an 80/20 split of the graphs; returns (encoder on the
        trainer's device, info).

        ``checkpoint_dir`` enables the resume protocol: snapshots every
        ``tc.checkpoint_every`` steps; when the directory already holds one
        and ``resume`` is True, training continues from its cursor.
        ``interrupt_after=k`` raises :class:`FitInterrupted` right after the
        checkpoint at step k."""
        tc, rc = self.tc, self.rc
        _, val_idx, selections = self.split(len(graphs))
        enc = rgcn_mod.init_rgcn(tc.seed, rc).to(self.device)
        caps = dict(max_nodes_per_graph=MAX_NODES_PER_MICROBATCH,
                    max_edges_per_graph=MAX_EDGES_PER_MICROBATCH)
        info = self._fit_steps(graphs, selections, enc, caps, verbose,
                               checkpoint_dir=checkpoint_dir, resume=resume,
                               interrupt_after=interrupt_after)
        trunc_nodes = info["trunc_nodes"]
        if len(val_idx):
            packed, vmeta = pack_graphs([graphs[i] for i in val_idx], **caps)
            trunc_nodes += int(vmeta.trunc_nodes.sum())
            loss, m = self.eval_loss(enc, self._upload(packed))
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
        (loss, metrics) as floats (one host sync)."""
        gen = torch.Generator(device=self.device).manual_seed(
            draw_seed(self.tc.seed, -1, EVAL_STREAM))
        with torch.no_grad():
            draws = draw_step(gen, batch, self.rc, train=False)
            loss, m = packed_loss(enc, self.rc, self.tc.tau, batch, draws,
                                  train=False)
            vals = torch.stack([loss, *m.values()]).cpu().tolist()
        return vals[0], dict(zip(m, vals[1:]))

    def _fit_steps(self, graphs, selections, enc, caps, verbose, *,
                   checkpoint_dir, resume, interrupt_after) -> dict:
        tc, rc, opt = self.tc, self.rc, self.opt
        plan = plan_epoch(graphs, selections, **caps)
        steps = plan.n_steps
        params = dict(enc.named_parameters())
        mu, nu = adamw_init(params)
        mgr = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
        start, history = 0, []
        if mgr is not None and resume and mgr.latest_step() is not None:
            start, history = self._restore_fit(mgr, enc, mu, nu)

        host_syncs = saves = 0
        last_save = start
        pending: list[torch.Tensor] = []
        t0 = time.perf_counter()

        def flush():
            """Pull the buffered per-step metrics to the host in one sync."""
            nonlocal host_syncs
            if not pending:
                return
            host_syncs += 1
            for row in torch.stack(pending).cpu().tolist():
                history.append(dict(zip(METRIC_KEYS, row)))
            pending.clear()
            if verbose:
                m = history[-1]
                print(f"  step {len(history) - 1:4d} loss={m['loss']:.4f} "
                      f"acc={m['nce_acc']:.3f} lr={m['lr']:.2e} "
                      f"({time.perf_counter() - t0:.1f}s)")

        gen = torch.Generator(device=self.device)
        for seg in plan.segments:
            if seg.stop <= start:
                continue
            dev_seg = self._upload(seg.batches)
            for step in range(max(seg.start, start), seg.stop):
                row = step - seg.start
                batch = {k: v[row] for k, v in dev_seg.items()}
                gen.manual_seed(draw_seed(tc.seed, step))
                draws = draw_step(gen, batch, rc)
                pending.append(train_step(enc, rc, tc.tau, opt, batch,
                                          draws, mu, nu, step))
                done = step + 1
                if done % tc.log_every == 0 or done == steps:
                    flush()
                due = (mgr is not None and tc.checkpoint_every > 0
                       and done - last_save >= tc.checkpoint_every)
                interrupt = (interrupt_after is not None
                             and done >= interrupt_after)
                if due or (interrupt and mgr is not None):
                    flush()
                    self._save_fit(mgr, enc, mu, nu, history, done)
                    last_save, saves = done, saves + 1
                if interrupt:
                    if mgr is not None:
                        mgr.wait()
                    raise FitInterrupted(
                        f"fit interrupted at step {done} "
                        f"(interrupt_after={interrupt_after})")
        flush()
        if mgr is not None:
            mgr.wait()
        return {
            "history": history,
            "bucket_keys": list(plan.bucket_keys),
            "trunc_nodes": plan.trunc_nodes,
            "engine": "eager",
            "host_syncs": host_syncs,
            "resumed_from": start,
            "checkpoint_saves": saves,
            "fit_s": time.perf_counter() - t0,
        }

    # -- resume protocol -----------------------------------------------------
    def _save_fit(self, mgr: CheckpointManager, enc, mu, nu, history,
                  cursor: int) -> None:
        def nest(d):      # 'layers.0.basis' -> {"layers": [{"basis": .}]}
            return unflatten_tree({k.replace(".", "/"): v.detach().cpu().numpy()
                                   for k, v in d.items()})

        mgr.save(cursor, {
            "state": {
                "step": np.int64(cursor),
                "params": nest(dict(enc.named_parameters())),
                "mu": nest(mu),
                "nu": nest(nu),
            },
            "seed": np.int64(self.tc.seed),
            "history": {k: np.asarray([h[k] for h in history], np.float32)
                        for k in METRIC_KEYS},
            "cursor": np.int64(cursor),
        })

    def _restore_fit(self, mgr: CheckpointManager, enc, mu, nu):
        """Load the latest snapshot into ``enc`` / ``mu`` / ``nu``; returns
        (cursor, history).  Refuses a checkpoint of another seed (the
        epoch plan would not replay)."""
        tree, _ = mgr.restore_tree()
        if int(tree["seed"]) != self.tc.seed:
            raise ValueError(
                f"checkpoint in {mgr.directory} was written with a "
                f"different seed; pass resume=False to refit")
        sd = tree["state"]
        with torch.no_grad():
            for name, tgt in (("params", dict(enc.named_parameters())),
                              ("mu", mu), ("nu", nu)):
                flat = flatten_tree(sd[name])
                for k, t in tgt.items():
                    t.copy_(torch.from_numpy(flat[k.replace(".", "/")]))
        cursor = int(tree["cursor"])
        hist = tree["history"]
        history = [{k: float(hist[k][i]) for k in METRIC_KEYS}
                   for i in range(cursor)]
        return cursor, history

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
        """Pack + upload one micro-batch.  Per-graph caps truncate a single
        graph larger than the budget (with accounting) instead of letting
        it blow the bucket.  Returns (device batch, PackMeta, bucket key)."""
        packed, meta = pack_graphs(
            bin_graphs,
            pad_graphs_to=bucket_size(len(bin_graphs), 8),
            max_nodes_per_graph=n_cap, max_edges_per_graph=e_cap,
        )
        return self._upload(packed), meta, bucket_key(packed)

    def _encode(self, enc: RGCNEncoder, batch: dict) -> np.ndarray:
        with torch.inference_mode():
            z = rgcn_mod.encode_packed(enc, self.rc, batch,
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
        for bin_idx in bins:
            sel = [todo[j] for j in bin_idx]
            batch, meta, bkey = self._stage_bin(
                [graphs[i] for i in sel], n_cap, e_cap)
            z = self._encode(enc, batch)
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
        for bin_items in stream_bins(
                pending(), lambda hg: (hg[1].n_nodes, hg[1].n_edges),
                max_nodes=n_cap, max_edges=e_cap, max_graphs=batch_size,
                stats=stream_stats):
            batch, meta, bkey = self._stage_bin(
                [g for _, g in bin_items], n_cap, e_cap)
            z = self._encode(enc, batch)
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
            **stream_stats,
        })
