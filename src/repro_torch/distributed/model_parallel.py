"""LM training over the ranks of a (data, model) mesh: what GSPMD does for
JAX's sharded step, written out for one process a rank.

Each parameter leaf (and its AdamW moments and error-feedback residual)
is stored as the block that JAX's ``spec_for`` gives this rank
(``distributed/sharding.py``), the batch is split over the data axes, and
the step runs on each rank's rows:

- **Gathers by spec.**  Just before the block that reads it, a leaf is
  rebuilt from the ranks' blocks (:class:`_Gather`, an autograd function
  built from ``all_reduce`` of a zero-filled buffer with each rank's
  slot written, as ``Group.gather`` is: bit-exact, no float addition);
  the block drops it when it is done (what autograd saved for the
  backward stays).  A stacked leaf is gathered one block at a time,
  inside the block's rematerialised region under ``cfg.remat`` (JAX's
  default, as GSPMD's gathers sit inside the checkpointed scan body): the
  backward's recompute gathers the block's leaves again and reruns its
  forward sums, and no gathered leaf outlives its block.
- **The tensor-parallel region** (Megatron's f and g).  Where ``spec_for``
  put the model axis on ``heads`` and the local heads are a multiple of
  the GQA group G, attention runs on each model rank's heads: ``wq`` /
  ``bq`` / ``wo`` are gathered over the data axes only and keep the rank's
  ``heads`` slice, ``wk`` / ``wv`` / ``bk`` / ``bv`` are gathered whole
  and cut to the kv heads those q heads read, K7 / K7b run on that
  (B_local, S, K / m, G, hd) shape, and ``wo``'s rows give a partial
  output.  Likewise the dense FFN where the model axis is on ``ffn``
  (``w1`` / ``w3`` columns, ``w2`` rows), the MoE experts where it is on
  their ``ffn`` (routing and dispatch whole on every model rank, the
  three ``bmm`` on the rank's ``ffn`` slice, the combined output a
  partial; the gates enter through ``copy_in``), and the SSM mixer where
  it is on ``d_inner`` and ``ssm_heads`` divides by m (``in_z`` /
  ``in_x`` / ``conv_x`` / ``norm`` / ``out`` on the rank's ``d_inner``,
  ``in_dt`` / ``A_log`` / ``D_skip`` / ``dt_bias`` on its heads, K8 / K8b
  on (B_local, S, nh / m, hp); ``B`` and ``C``, shared by every head, are
  computed whole and enter through ``copy_in``; the gated norm's sum of
  squares is summed over the model ranks both ways, ``all_sum``).
  ``copy_in`` is the identity forward and sums the input's gradient over
  the model ranks in rank order; ``sum_out`` sums the partial outputs
  over the model ranks in rank order and is the identity backward.
- **The vocabulary** (JAX keeps the logits split over ``vocab``).  A model
  rank holds the columns of its vocabulary range, ceil(V / m) wide (the
  last ranks fewer where m does not divide V, as GSPMD pads them):
  "split" where the spec puts the model axis on ``vocab`` (the table is
  gathered over the data axes only), "take" where it cannot (an uneven
  vocabulary: the table is gathered whole and cut).  The embedding looks
  up the rows of its range (zero elsewhere) and sums them over the model
  ranks; the loss takes the max of the logits over the model ranks
  (``model_max``), the sum of exps and the gold logit summed in rank
  order, and differentiates each rank's own columns.  Every other model
  placement (the embed dim of ``wk`` / ``wv`` and the norms, the SSM's
  ``B`` / ``C`` and the router, or a layer whose split does not hold)
  is stored sharded and gathered whole before use; so is everything
  without the split.
- **The gradient rule.**  Each rank differentiates its own share of the
  loss (``lm_loss(mp=)``: the cross-entropy over the global label count,
  the MoE expert fractions over every data rank's rows), so the whole
  loss is the sum of the data ranks' shares.  In the backward of a
  gather, a leaf's gradient is summed over the data ranks in rank order;
  a leaf the model axis slices in compute keeps its own slice's sum; a
  leaf computed whole on every model rank takes its own rank's gradient,
  which equals the other model ranks' bit for bit (their inputs are the
  same bits: every sum across ranks is taken in rank order); a leaf
  gathered whole and cut to a kv slice rebuilds each data rank's whole
  gradient from the model ranks' slices before the sum.  Then each rank
  keeps its own block.

So the step computes what the one-card step computes, up to the order of
its sums.  Clipping reads the global norm: each rank sums the squares of
the elements it owns (an element held by several ranks is counted by the
one at coordinate 0 of the axes its spec leaves out), and the sums are
added over the mesh in rank order.  AdamW and the error-feedback
compression work on the blocks, element by element; the compression's
per-leaf scale is the MAX of the blocks' amax over the mesh.

With ``tcfg.microbatch`` n > 1 (``launch/steps.make_sharded_train_step``)
each data rank takes its rows of each of JAX's n micro-batches of the
global batch (``ShardPlan.local_batch(microbatch=n)``), and each
micro-batch runs this step's forward and backward, its label count and
expert fractions its own.

``ShardPlan.collective_bytes`` counts, from the specs and this schedule
(remat's re-gathers and the micro-batches included), the bytes every
collective of one step carries on a rank: it equals the groups'
``Group.bytes`` after a step, and the dry run's collective term reads it
(``launch/roofline.collective_bytes``).

**Serving** (``ModelParallel(serving=True)``, the steps of
``launch/steps.make_sharded_prefill_step`` / ``make_sharded_decode_step``)
runs the same placements forward only, under JAX's activation specs:
a batch field's rows by its spec (``serve_batch``: the data axes where
they divide the batch, else every rank the whole batch), the decode
state by JAX's ``decode_state_shardings`` (``state_specs``), each leaf a
rank's ceil-wise block (``decode_state`` allocates only it): an
attention cache's positions [lo, hi) over the model ranks (its
``SeqSpan``), an SSM cache's heads and ``d_inner`` columns.  The
attention's ``wk`` / ``wv`` stay whole: prefill projects the prompt rows
of the rank's span through them for its cache block (``splice``), and a
decode step's softmax over a cache split by position merges the ranks'
partial max, sum and P·V (``models/attention.py``).  An SSM cache whose
split does not hold is gathered whole before use (``state_whole``) and
the rank keeps its block (``state_keep``).  The logits stay split over
``vocab`` (``vocab_slice``); ``argmax`` is the greedy token of the
split logits.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.config import FFN_DENSE, FFN_MOE, MIXER_ATTN, ModelConfig
from repro_torch.distributed.sharding import (
    axis_part, block_shape, ceil_block_shape, ceil_region, ceil_unshard,
    check_spec, mesh_coords, param_specs, region, shard_leaf, spec_axes,
    spec_for, unshard,
)
from repro_torch.models import transformer as tf
from repro_torch.models.frontends import text_len
from repro_torch.models.layers import dtype_of
from repro_torch.models.specs import BATCH_AXES
from repro_torch.optim.adamw import tree_leaves

#: the attention / dense-FFN leaves a model rank slices in compute, and
#: the logical dim it slices: "split" leaves keep the rank's model block
#: of that dim, "take" leaves are gathered whole and cut to the kv heads
#: the rank's q heads read
ATTN_SPLIT = {"wq": "heads", "bq": "heads", "wo": "heads"}
ATTN_TAKE = {"wk": "kv_heads", "wv": "kv_heads", "bk": "kv_heads",
             "bv": "kv_heads"}
MLP_SPLIT = {"w1": "ffn", "w3": "ffn", "w2": "ffn"}
#: the MoE experts' products, on their ``ffn`` dim (the router stays whole)
MOE_SPLIT = {"w1": "ffn", "w3": "ffn", "w2": "ffn"}
#: the SSM leaves of a rank's heads (in_B / in_C / conv_B / conv_C whole)
SSM_SPLIT = {"in_z": "d_inner", "in_x": "d_inner", "conv_x": "d_inner",
             "norm": "d_inner", "out": "d_inner", "in_dt": "ssm_heads",
             "A_log": "ssm_heads", "D_skip": "ssm_heads",
             "dt_bias": "ssm_heads"}
#: the embedding table and the untied head, on ``vocab``
VOCAB_SPLIT = {"tokens": "vocab", "lm_head": "vocab"}


class LeafPlan(NamedTuple):
    """One parameter leaf: its '/'-path, whole shape, logical names and
    spec; whether it leads with the stacked ``blocks`` dim; how a rank
    uses it ("whole", "split" or "take") and the dim of one block's leaf
    that "split" / "take" cut."""
    path: tuple
    shape: tuple
    names: tuple
    spec: tuple
    stacked: bool
    mode: str = "whole"
    dim: Optional[int] = None

    @property
    def key(self) -> str:
        return "/".join(self.path)

    @property
    def piece_shape(self) -> tuple:
        """One block's (or the unstacked leaf's) whole shape."""
        return self.shape[1:] if self.stacked else self.shape

    @property
    def piece_spec(self) -> tuple:
        return self.spec[1:] if self.stacked else self.spec


class SeqSpan(NamedTuple):
    """A serving rank's positions [lo, hi) of every attention layer's KV
    cache, whether the model axis splits the positions (JAX's
    ``cache_seq``; else every model rank holds them all), and the caches'
    whole length (JAX's ``decode_split`` reads its condition on it)."""
    lo: int
    hi: int
    split: bool
    max_seq: int


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


class ShardPlan:
    """Where every leaf of ``cfg``'s params lives on ``rules.mesh`` and how
    the sharded step uses it.  Built from shapes alone (``meta``
    tensors): the dry run plans a 256-rank mesh without a group."""

    def __init__(self, cfg: ModelConfig, rules):
        if rules.seq_shard:
            raise ValueError("seq_shard: the port does not split the "
                             "activations' seq dim over the model axis yet "
                             "(sequence parallelism, ROADMAP A19)")
        self.cfg, self.rules, self.mesh = cfg, rules, rules.mesh
        self.model_size = rules.model_size
        self.data_size = rules.fsdp_size
        self.size = self.mesh.size
        if self.data_size * self.model_size != self.size:
            raise ValueError(f"mesh {tuple(self.mesh.shape)}: the batch axes "
                             f"{rules.batch_axes} and the model axis do not "
                             f"cover it")
        axes = tf.params_axes(cfg)
        aparams = tf.init_params(cfg, None, device="meta")
        specs = param_specs(axes, aparams, rules)
        self.param_dtype = next(iter(tree_leaves(aparams))).dtype
        m, H = self.model_size, cfg.num_heads
        self.split_attention = self._model_on(
            specs, axes, lambda ls: ls.mixer == MIXER_ATTN, "mixer", "wq",
            "heads") and (H // m) % (H // cfg.num_kv_heads) == 0
        self.split_mlp = self._model_on(
            specs, axes, lambda ls: ls.ffn == FFN_DENSE, "ffn", "w1", "ffn")
        self.split_moe = self._model_on(
            specs, axes, lambda ls: ls.ffn == FFN_MOE, "ffn", "w1", "ffn")
        self.split_ssm = self._model_on(
            specs, axes, lambda ls: ls.mixer != MIXER_ATTN, "mixer", "in_x",
            "d_inner") and cfg.ssm_heads % m == 0
        self.split_vocab = self._vocab_mode(specs)
        layer = cfg.layer_specs()
        #: the first attention layer's mixer (the heads' cuts are alike)
        self.attn_prefix = next(
            (f"blocks/pos{i}/mixer" for i, ls in enumerate(layer)
             if ls.mixer == MIXER_ATTN), None)
        self.leaves = []
        for path, names in _leaves(axes):
            spec = check_spec(_get(specs, path), self.mesh)
            shape = tuple(_get(aparams, path).shape)
            stacked = path[0] == "blocks"
            pnames, pspec = (names[1:], spec[1:]) if stacked else (names, spec)
            mode, cut = "whole", None
            if stacked:
                ls = layer[int(path[1][3:])]
                name = path[-1]
                if path[2] == "mixer" and ls.mixer == MIXER_ATTN:
                    if self.split_attention:
                        cut = ATTN_SPLIT.get(name) or ATTN_TAKE.get(name)
                        mode = "split" if name in ATTN_SPLIT else "take"
                elif path[2] == "mixer":
                    if self.split_ssm and name in SSM_SPLIT:
                        mode, cut = "split", SSM_SPLIT[name]
                elif path[2] == "ffn" and ls.ffn == FFN_DENSE:
                    if self.split_mlp:
                        mode, cut = "split", MLP_SPLIT[name]
                elif path[2] == "ffn" and ls.ffn == FFN_MOE:
                    if self.split_moe and name in MOE_SPLIT:
                        mode, cut = "split", MOE_SPLIT[name]
            elif path[0] == "embed" and self.split_vocab:
                mode, cut = self.split_vocab, VOCAB_SPLIT[path[1]]
            dim = None if cut is None else pnames.index(cut)
            if mode == "split" and pspec[dim] != rules.model_axis:
                raise ValueError(f"{'/'.join(path)}: spec {spec} does not "
                                 f"put the model axis on {cut}")
            self.leaves.append(LeafPlan(path, shape, names, spec, stacked,
                                        mode, dim))
        self.by_key = {lf.key: lf for lf in self.leaves}

    # -- which layers split ------------------------------------------------

    def _model_on(self, specs, axes, kind, part, name, logical) -> bool:
        """Whether the model axis (of more than one rank) is on dim
        ``logical`` of leaf ``part/name`` of the first layer of ``kind``."""
        for i, ls in enumerate(self.cfg.layer_specs()):
            if kind(ls):
                path = ("blocks", f"pos{i}", part, name)
                spec = _get(specs, path)
                return (self.model_size > 1 and spec[_get(axes, path).index(
                    logical)] == self.rules.model_axis)
        return False

    def _vocab_mode(self, specs) -> Optional[str]:
        """How the model ranks use the vocabulary: "split" where the spec
        puts the model axis on it, "take" where m does not divide it (the
        ranks' ranges ceil(V / m) wide, each rank at least one word), else
        None."""
        m, V = self.model_size, self.cfg.vocab_size
        if m == 1:
            return None
        if specs["embed"]["tokens"][0] == self.rules.model_axis:
            return "split"
        return "take" if (m - 1) * -(-V // m) < V else None

    def cut(self, lf: LeafPlan, coords) -> tuple:
        """[lo, hi) of ``lf.dim`` that the rank at ``coords`` computes
        with: its model block (ceil(n / m) wide, the last ranks fewer
        where m does not divide n)."""
        n, w = lf.piece_shape[lf.dim], self.out_shape(lf)[lf.dim]
        lo = min(coords[-1] * w, n)
        return lo, min(lo + w, n)

    @property
    def split_leaves(self) -> list:
        """The leaves the model axis splits in compute."""
        return [lf.key for lf in self.leaves if lf.mode != "whole"]

    # -- placement ------------------------------------------------------------

    def coords(self, index: int) -> tuple:
        return mesh_coords(self.mesh, index)

    def batch_index(self, coords) -> int:
        """The rank's place along the batch axes (its data column's order)."""
        return axis_part(tuple(self.rules.batch_axes), self.mesh, coords)[1]

    def shard(self, params: dict, index: int) -> dict:
        """Mesh rank ``index``'s blocks of the whole ``params`` (contiguous
        copies)."""
        c = self.coords(index)
        out = {}
        for lf in self.leaves:
            _set(out, lf.path, shard_leaf(_get(params, lf.path), lf.spec,
                                          self.mesh, c).contiguous().clone())
        return out

    def local_batch(self, batch: dict, index: int, microbatch: int = 0
                    ) -> dict:
        """Mesh rank ``index``'s rows of a whole batch (the batch split
        evenly over the batch axes).  With ``microbatch`` n > 1 the rows
        are micro-batch-major: JAX's micro-batch i is the global rows
        [i B / n, (i + 1) B / n), and data rank r takes its r-th
        B / (n d) of each, so the rank's micro-batch i is its rows
        [i B / (n d), (i + 1) B / (n d))."""
        bi = self.batch_index(self.coords(index))
        d = self.data_size
        n = microbatch if microbatch and microbatch > 1 else 1
        out = {}
        for k, v in batch.items():
            B = v.shape[0]
            if n == 1:
                if B % d:
                    raise ValueError(f"batch {B} does not split over {d} "
                                     f"data ranks")
                w = B // d
                out[k] = v[bi * w:(bi + 1) * w]
                continue
            if B % (n * d):
                raise ValueError(f"batch {B} does not split into {n} "
                                 f"micro-batches over {d} data ranks")
            w = B // (n * d)
            out[k] = torch.cat([v[i * (B // n) + bi * w:
                                  i * (B // n) + (bi + 1) * w]
                                for i in range(n)])
        return out

    # -- serving: the batch and the decode state by JAX's specs -------------

    def _batch_spec(self, names: tuple, shape: tuple) -> tuple:
        """The activation spec of a batch field (JAX's ``batch_shardings``
        entry): the data axes on ``batch`` where they divide it, else the
        rows replicated (``long_500k``'s batch of 1)."""
        spec = check_spec(spec_for(names, shape, rules=self.rules,
                                   is_param=False), self.mesh)
        if any(self.rules.model_axis in spec_axes(e) for e in spec):
            raise ValueError(f"batch spec {spec}: the serving steps do not "
                             f"split a batch field over the model axis "
                             f"(seq_shard)")
        return spec

    def serve_batch(self, batch: dict, index: int) -> dict:
        """Mesh rank ``index``'s rows of a whole serving batch, by each
        field's spec (``local_batch`` splits evenly or raises; this
        replicates a batch the data axes do not divide)."""
        c = self.coords(index)
        out = {}
        for k, v in batch.items():
            spec = self._batch_spec(BATCH_AXES[k], tuple(v.shape))
            out[k] = v[ceil_region(tuple(v.shape), spec, self.mesh, c)]
        return out

    def _state_leaves(self, batch: int, max_seq: int):
        """(path, whole shape, spec) of every cache leaf; the model axis
        may sit on an attention cache's positions only."""
        specs = state_specs(self.cfg, self.rules, batch, max_seq)["caches"]
        shapes = tf.init_decode_state(self.cfg, batch, max_seq,
                                      device="meta")["caches"]
        out = []
        for path, spec in _leaves(specs):
            on = [i for i, e in enumerate(spec)
                  if self.rules.model_axis in spec_axes(e)]
            if path[-1] in ("k", "v") and on not in ([], [2]):
                raise ValueError(f"{'/'.join(path)}: spec {spec} puts the "
                                 f"model axis off the cache positions")
            out.append((path, tuple(_get(shapes, path).shape), spec))
        return out

    def _span(self, leaves, c) -> SeqSpan:
        for path, shape, spec in leaves:
            if path[-1] == "k":
                r = ceil_region(shape, spec, self.mesh, c)[2]
                return SeqSpan(r.start, r.stop, self.model_size > 1 and
                               self.rules.model_axis in spec_axes(spec[2]),
                               shape[2])
        return SeqSpan(0, 0, False, 0)

    def decode_state(self, batch: int, max_seq: int, index: int = 0,
                     device=None, *, rank: int = 0) -> dict:
        """Mesh rank ``rank``'s blocks of a zero decode state of global
        ``batch`` x ``max_seq`` (compute dtype; only its blocks are
        allocated: ceil(max_seq / m) positions of its rows of an
        attention cache), the host int ``index`` and the rank's
        ``SeqSpan`` (``"span"``)."""
        c = self.coords(rank)
        dt = dtype_of(self.cfg.compute_dtype)
        leaves = self._state_leaves(batch, max_seq)
        caches = {}
        for path, shape, spec in leaves:
            _set(caches, path, torch.zeros(
                ceil_block_shape(shape, spec, self.mesh, c), dtype=dt,
                device=device))
        return {"caches": caches, "index": int(index),
                "span": self._span(leaves, c)}

    def unshard_state(self, states: list, batch: int, max_seq: int) -> dict:
        """The whole decode caches from every mesh rank's blocks
        (``states[i]`` rank i's)."""
        out = {}
        for path, shape, spec in self._state_leaves(batch, max_seq):
            _set(out, path, ceil_unshard(
                [_get(st["caches"], path) for st in states], shape, spec,
                self.mesh))
        return out

    def state_bytes(self, batch: int, max_seq: int, rank: int = 0) -> int:
        """Bytes of mesh rank ``rank``'s decode-state blocks (rank 0's are
        the largest)."""
        cz = dtype_of(self.cfg.compute_dtype).itemsize
        c = self.coords(rank)
        return sum(math.prod(ceil_block_shape(shape, spec, self.mesh, c))
                   for _, shape, spec in self._state_leaves(batch, max_seq)
                   ) * cz

    def serve_param_bytes(self) -> int:
        """Bytes of a rank's blocks of the compute params (``compute_params``
        : the matmul weights in the compute dtype, the rest in
        ``param_dtype``), what a serving rank holds."""
        return sum(math.prod(block_shape(lf.shape, lf.spec, self.mesh))
                   * self._serve_size(lf) for lf in self.leaves)

    def _serve_size(self, lf: LeafPlan) -> int:
        dt = (self.cfg.compute_dtype if lf.path[-1] in tf.COMPUTE_LEAVES
              else self.cfg.param_dtype)
        return dtype_of(dt).itemsize

    def logits_range(self, coords) -> tuple:
        """[lo, hi) of the vocabulary of the rank's logits (JAX's
        ``constrain(logits, "batch", "vocab")``: ceil(V / m) a model
        rank where V >= m, else all of it)."""
        V = self.cfg.vocab_size
        spec = spec_for(("vocab",), (V,), rules=self.rules, is_param=False)
        r = ceil_region((V,), spec, self.mesh, coords)[0]
        return r.start, r.stop

    @functools.cached_property
    def ssm_state_dims(self) -> dict:
        """{leaf: the dim of one block's SSM cache leaf that the model
        axis splits, or None} (``ssm``, ``conv/x``, ``conv/B``,
        ``conv/C``; alike for every SSM layer and batch)."""
        out = {}
        for path, shape, spec in self._state_leaves(self.data_size, 1):
            if path[-1] not in ("k", "v"):
                key = "/".join(path[1:])
                on = [i - 1 for i, e in enumerate(spec)
                      if self.rules.model_axis in spec_axes(e)]
                out[key] = (on[0], shape[on[0] + 1]) if on else None
        return out

    def block_numel(self) -> int:
        """Elements of one rank's blocks of the params."""
        return sum(math.prod(block_shape(lf.shape, lf.spec, self.mesh))
                   for lf in self.leaves)

    def counted(self, lf: LeafPlan, coords) -> bool:
        """Whether the rank at ``coords`` counts ``lf``'s elements in the
        global norm: the one at coordinate 0 of every axis the spec leaves
        out."""
        used = {a for e in lf.spec for a in spec_axes(e)}
        return all(c == 0 for a, c in zip(self.mesh.axes, coords)
                   if a not in used)

    def owns(self, lf: LeafPlan, b: Optional[int], coords) -> bool:
        """Whether the rank at ``coords`` holds a piece of block ``b`` of a
        stacked leaf (always, for a leaf whose blocks dim is not split)."""
        if not lf.stacked or lf.spec[0] is None:
            return True
        parts, idx = axis_part(lf.spec[0], self.mesh, coords)
        return idx == b // (lf.shape[0] // parts)

    # -- the schedule's groups ---------------------------------------------

    def _axes(self, lf: LeafPlan, gathered_spec) -> set:
        used = {a for e in gathered_spec for a in spec_axes(e)}
        if lf.stacked and lf.spec[0] is not None:
            used |= set(spec_axes(lf.spec[0]))
        return used

    def gather_kind(self, lf: LeafPlan) -> Optional[str]:
        """The group a use of ``lf`` gathers over: "world", "data",
        "model" or None."""
        spec = (_without(lf.piece_spec, lf.dim, self.rules.model_axis)
                if lf.mode == "split" else lf.piece_spec)
        used = self._axes(lf, spec)
        has_m = self.rules.model_axis in used
        has_d = bool(used & set(self.rules.batch_axes))
        if has_m and has_d:
            return "world"
        return "model" if has_m else ("data" if has_d else None)

    def members(self, kind: str, index: int) -> list:
        """The mesh ranks of this rank's group of ``kind``, in rank order."""
        m = self.model_size
        if kind == "world":
            return list(range(self.size))
        if kind == "data":
            return [d * m + index % m for d in range(self.data_size)]
        return [(index // m) * m + j for j in range(m)]

    def kind_size(self, kind: Optional[str]) -> int:
        return {None: 1, "world": self.size, "data": self.data_size,
                "model": self.model_size}[kind]

    def out_shape(self, lf: LeafPlan) -> tuple:
        """The shape a rank computes with: the piece whole, or its
        model slice along ``lf.dim`` (ceil(n / m) wide: a "take" of an
        uneven vocabulary is padded to it in the gradient's gather)."""
        shape = list(lf.piece_shape)
        if lf.mode != "whole":
            shape[lf.dim] = -(-shape[lf.dim] // self.model_size)
        return tuple(shape)

    def uses(self) -> list:
        """(leaf, block) of every gather of one step."""
        out = [(self.by_key[k], None) for k in self._embed_keys()]
        for b in range(self.cfg.num_blocks):
            out += [(lf, b) for lf in self.leaves if lf.stacked]
        out += [(self.by_key["final_norm/scale"], None)]
        return out

    def _embed_keys(self) -> list:
        return [lf.key for lf in self.leaves if lf.path[0] == "embed"]

    # -- counts -----------------------------------------------------------------

    def collective_bytes(self, batch: int, seq: int, tcfg=None, *,
                         kind: str = "train") -> dict:
        """The bytes each kind of collective carries on a rank in one step
        at global ``batch`` x ``seq`` tokens (``Group.bytes``: each
        ``all_reduce``'s buffer once), and their total: in training,
        ``tcfg.microbatch`` micro-batches' gathers and sums, and under
        ``cfg.remat`` each block's gathers and forward sums twice (the
        recompute).  ``kind`` "train"
        (the default), or "prefill" (a ``seq``-token prompt) and "decode"
        (one token against ``seq`` cache positions) with the greedy
        token's ``argmax``, on the compute params (``serve_param_bytes``)."""
        if kind != "train":
            return self._serve_bytes(batch, seq, kind)
        cfg, ds, ms, n = self.cfg, self.data_size, self.model_size, self.size
        mb = tcfg.microbatch if tcfg is not None and tcfg.microbatch and \
            tcfg.microbatch > 1 else 1
        # remat runs each block's forward again in the backward: its
        # gathers and forward sums twice a micro-batch
        fwd = 2 if cfg.remat else 1
        pz = torch.empty((), dtype=self.param_dtype).element_size()
        cz = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                         ).element_size()
        out = {"gather": 0, "grad_sum": 0, "tensor_parallel": 0, "scalars": 0}
        for lf, b in self.uses():
            kind = self.gather_kind(lf)
            pieces = math.prod(block_shape(lf.piece_shape, lf.piece_spec,
                                           self.mesh))
            if lf.mode == "split":
                pieces = math.prod(block_shape(
                    self.out_shape(lf),
                    _without(lf.piece_spec, lf.dim, self.rules.model_axis),
                    self.mesh))
            if self.kind_size(kind) > 1:
                out["gather"] += (mb * (fwd if b is not None else 1)
                                  * self.kind_size(kind) * pieces * pz)
            used = math.prod(self.out_shape(lf))
            if lf.mode == "take":
                out["grad_sum"] += mb * n * used * pz
            elif ds > 1:
                out["grad_sum"] += mb * ds * used * pz
        if batch % (ds * mb):
            raise ValueError(f"batch {batch} does not split into {mb} "
                             f"micro-batches over {ds} data ranks")
        rows = (batch // (ds * mb)) * seq     # a rank's tokens a micro-batch
        act = rows * cfg.d_model * cz
        tp = 0
        for ls in cfg.layer_specs():
            if ls.mixer == MIXER_ATTN and self.split_attention:
                tp += (1 + fwd) * ms * act          # copy_in, sum_out
            elif ls.mixer != MIXER_ATTN and self.split_ssm:
                # copy_in of h and of (B, C); sum_out; the gated norm's
                # float32 sum of squares, forward and backward
                tp += ((1 + fwd) * ms * act + ms * rows * 2 * cfg.ssm_state
                       * cz + (1 + fwd) * ms * rows * 4)
            if ls.ffn == FFN_DENSE and self.split_mlp:
                tp += (1 + fwd) * ms * act
            elif ls.ffn == FFN_MOE and self.split_moe:
                tp += ((1 + fwd) * ms * act
                       + ms * rows * cfg.top_k * cz)          # + gates
            if ls.ffn == FFN_MOE and ds > 1:
                G = min(cfg.moe_seq_chunk, seq)
                chunks = seq // G if seq > G and seq % G == 0 else 1
                out["scalars"] += (mb * fwd * cfg.num_blocks * chunks * ds
                                   * cfg.num_experts * 4)
        out["tensor_parallel"] = mb * cfg.num_blocks * tp
        if self.split_vocab:
            text = (batch // (ds * mb)) * text_len(cfg, seq) * cfg.d_model \
                * cz
            # the embedding's sum_out, the head's copy_in, and the loss's
            # float32 max and (sum of exps, gold) over a rank's tokens
            out["tensor_parallel"] += mb * (ms * text + ms * act
                                            + (1 + 2 * ms) * rows * 4)
        if ds > 1:
            # a micro-batch's label count; the metrics (loss, ce, aux, or
            # the micro-batches' losses)
            out["scalars"] += mb * ds * 4 + ds * (3 if mb == 1 else mb) * 4
        if n > 1:
            out["scalars"] += n * 4                 # the global norm
            if tcfg is not None and tcfg.grad_compress:
                out["scalars"] += len(self.leaves) * 4   # amax a leaf
        out["total"] = sum(out.values())
        return out

    def _serve_bytes(self, batch: int, seq: int, kind: str) -> dict:
        """``collective_bytes`` of a serving step: the leaves gathered by
        spec; the partial sums (``sum_out``; ``copy_in`` carries nothing
        forward); in decode the q gather, the split softmax's max and
        sums, and the SSM cache gathered whole where its split does not
        hold; the greedy token's gather."""
        if kind not in ("prefill", "decode"):
            raise ValueError(f"kind must be train, prefill or decode, not "
                             f"{kind!r}")
        cfg, ds, ms = self.cfg, self.data_size, self.model_size
        cz = dtype_of(cfg.compute_dtype).itemsize
        out = {"gather": 0, "tensor_parallel": 0, "attention": 0,
               "state": 0, "argmax": 0}
        for lf, _ in self.uses():
            k = self.gather_kind(lf)
            if self.kind_size(k) == 1:
                continue
            spec = (_without(lf.piece_spec, lf.dim, self.rules.model_axis)
                    if lf.mode == "split" else lf.piece_spec)
            shape = self.out_shape(lf) if lf.mode == "split" else \
                lf.piece_shape
            out["gather"] += (self.kind_size(k) * self._serve_size(lf)
                              * math.prod(block_shape(shape, spec,
                                                      self.mesh)))
        rows_b = batch // ds if batch % ds == 0 else batch   # the spec's
        prefill = kind == "prefill"
        rows = rows_b * (seq if prefill else 1)
        act = rows * cfg.d_model * cz
        H, hd = cfg.num_heads, cfg.head_dim
        tp = att = 0
        cache_split = ms > 1 and seq >= ms
        for ls in cfg.layer_specs():
            if ls.mixer == MIXER_ATTN:
                if self.split_attention:
                    tp += ms * act                                # sum_out
                    if not prefill:
                        tp += rows_b * H * hd * cz                # q gather
                if not prefill and cache_split:
                    # the max of m, and (acc, l) summed in rank order
                    att += rows_b * H * 4 + ms * rows_b * H * (hd + 1) * 4
            elif self.split_ssm:
                tp += ms * act + ms * rows * 4     # sum_out, the norm's sum
            if (ls.ffn == FFN_DENSE and self.split_mlp) or (
                    ls.ffn == FFN_MOE and self.split_moe):
                tp += ms * act
        nb = cfg.num_blocks
        out["tensor_parallel"] = nb * tp
        out["attention"] = nb * att
        if not prefill and ms > 1 and not self.split_ssm:
            # an SSM cache split by its spec, gathered whole a layer: the
            # blocks padded to rank 0's
            zero = (0,) * len(self.mesh.shape)
            for path, shape, spec in self._state_leaves(batch, seq):
                if path[-1] not in ("k", "v") and any(
                        self.rules.model_axis in spec_axes(e) for e in spec):
                    out["state"] += nb * ms * cz * math.prod(
                        ceil_block_shape(shape, spec, self.mesh, zero)[1:])
        if self.split_vocab:               # the embedding's sum_out
            toks = rows_b * (text_len(cfg, seq) if prefill else 1)
            out["tensor_parallel"] += ms * toks * cfg.d_model * cz
        lo, hi = self.logits_range((0,) * len(self.mesh.shape))
        if hi - lo < cfg.vocab_size:
            out["argmax"] = ms * 2 * rows_b * 8
        out["total"] = sum(out.values())
        return out



def state_specs(cfg: ModelConfig, rules, batch: int, max_seq: int) -> dict:
    """The spec of every decode-state leaf at global ``batch`` x
    ``max_seq`` (JAX's ``decode_state_shardings``): ``{"caches": ...,
    "index": ()}``."""
    axes = tf.decode_state_axes(cfg)
    shapes = tf.init_decode_state(cfg, batch, max_seq, device="meta")
    return {"caches": param_specs(axes["caches"], shapes["caches"], rules,
                                  is_param=False),
            "index": ()}


def _without(spec: tuple, dim: int, axis: str) -> tuple:
    """``spec`` with ``axis`` taken off entry ``dim``."""
    out = list(spec)
    rest = tuple(a for a in spec_axes(spec[dim]) if a != axis)
    out[dim] = None if not rest else (rest[0] if len(rest) == 1 else rest)
    return tuple(out)


def _rank_sum(parts: torch.Tensor) -> torch.Tensor:
    total = parts[0]
    for r in range(1, parts.shape[0]):
        total = total + parts[r]
    return total


class _Gather(torch.autograd.Function):
    """One use of a leaf: forward the gathered (or cut) tensor, backward
    this rank's block of the gradient summed by the rule."""

    @staticmethod
    def forward(ctx, x, mp, lf, b):
        ctx.mp, ctx.lf, ctx.b = mp, lf, b
        return mp._forward(x, lf, b)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mp._backward(grad.contiguous(), ctx.lf, ctx.b), None, \
            None, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return ctx.mp.model_sum(grad.contiguous()), None


class _SumOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mp):
        return mp.model_sum(x.contiguous())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ModelParallel:
    """A rank's view of the sharded params for one step: the model code
    reads its gathered leaves (``embed``, ``block``, ``final_norm``) and
    its tensor-parallel operators."""

    def __init__(self, plan: ShardPlan, groups, params: dict, *,
                 serving: bool = False, span: Optional[SeqSpan] = None):
        self.plan, self.groups, self.params = plan, groups, params
        self.index = groups.index
        self.coords = plan.coords(self.index)
        self.model_size, self.data_size = plan.model_size, plan.data_size
        self.split_attention = plan.split_attention
        self.split_mlp = plan.split_mlp
        self.split_moe = plan.split_moe
        self.split_ssm = plan.split_ssm
        self.split_vocab = plan.split_vocab is not None
        #: [lo, hi) of the vocabulary this rank computes
        self.vocab_range = (plan.cut(plan.by_key["embed/tokens"], self.coords)
                            if self.split_vocab else None)
        #: a serving step's view: forward only, the attention's wk / wv /
        #: bk / bv whole (the cache needs every kv head), no aux loss, and
        #: the rank's span of cache positions
        self.serving, self.span = serving, span
        if self.split_attention:
            wq, wk = (plan.by_key[f"{plan.attn_prefix}/{n}"]
                      for n in ("wq", "wk"))
            self.head_range = plan.cut(wq, self.coords)
            self.kv_heads = plan.cut(wk, self.coords)
        self._views = {}

    # -- the model's reads --------------------------------------------------

    def _use(self, lf: LeafPlan, b=None) -> torch.Tensor:
        x = _get(self.params, lf.path)
        if lf.stacked:
            views = self._views.get(lf.key)
            if views is None:
                views = self._views[lf.key] = x.unbind(0)
            if self.plan.owns(lf, b, self.coords):
                per = len(views)
                x = views[b % per]
            else:
                x = views[0]          # a stand-in: its gradient is zero
        return _Gather.apply(x, self, lf, b)

    def embed(self) -> dict:
        out = {}
        for key in self.plan._embed_keys():
            lf = self.plan.by_key[key]
            out[lf.path[-1]] = self._use(lf)
        return out

    def final_norm(self) -> dict:
        return {"scale": self._use(self.plan.by_key["final_norm/scale"])}

    def block(self, b: int) -> dict:
        out = {}
        for lf in self.plan.leaves:
            if lf.stacked:
                _set(out, lf.path[1:], self._use(lf, b))
        return out

    # -- the tensor-parallel operators and sums -------------------------------

    def copy_in(self, x):
        return _CopyIn.apply(x, self)

    def sum_out(self, x):
        return _SumOut.apply(x, self)

    def all_sum(self, x):
        """``x`` summed over the model ranks in rank order, and so its
        gradient (``copy_in`` then ``sum_out``): a sum whose consumer is
        itself split (the gated norm's sum of squares)."""
        return self.sum_out(self.copy_in(x))

    @torch.no_grad()
    def model_max(self, t):
        """The elementwise max of ``t`` over the model ranks (no
        gradient: the loss's shift)."""
        return self.groups.model.all_reduce(t.detach().contiguous().clone(),
                                            "max")

    def model_sum(self, t):
        """``t`` summed over the model ranks in rank order."""
        return self.groups.model.sum_in_rank_order(t)

    @torch.no_grad()
    def data_sum(self, t):
        """``t`` summed over the data ranks in rank order (no gradient)."""
        if self.data_size == 1:
            return t.detach()
        return self.groups.data.sum_in_rank_order(t.detach().contiguous())

    # -- serving ------------------------------------------------------------

    @torch.no_grad()
    def gather_heads(self, q: torch.Tensor) -> torch.Tensor:
        """(B, H, hd): every model rank's (B, H / m, hd) heads in rank
        order (``Group.gather``)."""
        parts = self.groups.model.gather(q.contiguous())
        return parts.permute(1, 0, *range(2, parts.dim())).reshape(
            q.shape[0], -1, *q.shape[2:])

    def vocab_slice(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's columns of the logits (``plan.logits_range``): as
        computed under a vocabulary split, else cut from the whole."""
        if self.split_vocab:
            return logits
        lo, hi = self.plan.logits_range(self.coords)
        return logits if hi - lo == logits.shape[-1] else logits[:, lo:hi]

    @torch.no_grad()
    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy token (B,) int64 of logits split over the model ranks
        by vocabulary (``logits`` this rank's ``vocab_slice``): the max
        over the ranks, the lowest global index among the ranks that hold
        it, taken in rank order; equal to ``torch.argmax`` of the whole
        logits (the first maximum)."""
        lo, hi = self.plan.logits_range(self.coords)
        if hi - lo == self.plan.cfg.vocab_size:
            return torch.argmax(logits, dim=-1)
        B = logits.shape[0]
        if hi > lo:
            idx = torch.argmax(logits, dim=-1)
            val = logits.gather(-1, idx[:, None])[:, 0].double()
            idx = (idx + lo).double()
        else:
            val = logits.new_full((B,), float("-inf"), dtype=torch.float64)
            idx = torch.zeros_like(val)
        parts = self.groups.model.gather(torch.stack([val, idx]))  # (m,2,B)
        hit = parts[:, 0] == parts[:, 0].amax(0)
        first = torch.argmax(hit.to(torch.int8), dim=0)       # first rank
        return parts[first, 1, torch.arange(B, device=logits.device)].long()

    def _model_dims(self, cache: dict):
        dims = self.plan.ssm_state_dims
        for path, x in _leaves(cache):
            yield path, x, dims["/".join(path)]

    @torch.no_grad()
    def state_whole(self, cache: dict) -> dict:
        """One block's SSM cache gathered whole over the model ranks (the
        blocks ceil(n / m) wide, padded for the gather)."""
        m, out = self.model_size, {}
        for path, x, dim in self._model_dims(cache):
            if dim is None:
                _set(out, path, x.clone())
                continue
            d, n = dim
            w = -(-n // m)
            pad = list(x.shape)
            pad[d] = w - x.shape[d]
            xp = torch.cat([x, x.new_zeros(pad)], dim=d) if pad[d] else x
            parts = self.groups.model.gather(xp.contiguous())
            _set(out, path, torch.cat(list(parts.unbind(0)), dim=d)
                 .narrow(d, 0, n).contiguous())
        return out

    @torch.no_grad()
    def state_keep(self, cache: dict, whole: dict) -> None:
        """Write this rank's blocks of a whole SSM cache into ``cache``."""
        m, c = self.model_size, self.coords[-1]
        for path, x, dim in self._model_dims(cache):
            y = _get(whole, path)
            if dim is not None:
                d, n = dim
                lo = min(c * -(-n // m), n)
                y = y.narrow(d, lo, x.shape[d])
            x.copy_(y)

    @torch.no_grad()
    def splice(self, caches: dict, pieces: dict) -> None:
        """Write prefill's caches (stacked over blocks; ``prefill``'s
        pieces under this ``mp``) into the rank's decode-state blocks:
        an attention cache's first positions of its span, an SSM cache
        as it is (the rank's heads) or cut to its block (computed
        whole)."""
        dims = self.plan.ssm_state_dims
        m, c = self.model_size, self.coords[-1]
        for path, dst in _leaves(caches):
            src = _get(pieces, path)
            if path[-1] in ("k", "v"):
                dst[:, :, :src.shape[2]] = src.to(dst.dtype)
                continue
            dim = dims["/".join(path[1:])]
            if src.shape != dst.shape:
                d, n = dim
                d += 1                                   # the blocks dim
                src = src.narrow(d, min(c * -(-n // m), n), dst.shape[d])
            dst.copy_(src)

    # -- gathers -------------------------------------------------------------

    def _group(self, kind):
        return {"world": self.groups.world, "data": self.groups.data,
                "model": self.groups.model}[kind]

    def _gather(self, x, lf, b, kind, shape, spec):
        """The tensor of ``shape`` whose ``spec`` blocks the ranks of
        group ``kind`` hold (this rank's is ``x``), bit-exact."""
        plan = self.plan
        g = self._group(kind)
        buf = x.new_zeros((g.size,) + tuple(x.shape))
        if plan.owns(lf, b, self.coords):
            buf[g.rank] = x
        g.all_reduce(buf)
        out = x.new_empty(shape)
        for i, mi in enumerate(plan.members(kind, self.index)):
            c = plan.coords(mi)
            if plan.owns(lf, b, c):
                out[region(shape, spec, plan.mesh, c)] = buf[i]
        return out

    def _forward(self, x, lf, b):
        plan = self.plan
        kind = plan.gather_kind(lf)
        if lf.mode == "split":
            shape = plan.out_shape(lf)
            spec = _without(lf.piece_spec, lf.dim, plan.rules.model_axis)
        else:
            shape, spec = lf.piece_shape, lf.piece_spec
        out = (x.clone() if plan.kind_size(kind) == 1
               else self._gather(x, lf, b, kind, shape, spec))
        # serving keeps the attention's kv leaves whole: the cache needs
        # every kv head
        if lf.mode == "take" and not (self.serving
                                      and lf.path[-1] in ATTN_TAKE):
            lo, hi = plan.cut(lf, self.coords)
            out = out.narrow(lf.dim, lo, hi - lo).contiguous()
        return out

    def _backward(self, grad, lf, b):
        plan = self.plan
        if lf.mode == "take":
            w = plan.out_shape(lf)[lf.dim]
            if grad.shape[lf.dim] < w:        # a short cut, padded
                pad = list(grad.shape)
                pad[lf.dim] = w - grad.shape[lf.dim]
                grad = torch.cat([grad, grad.new_zeros(pad)], dim=lf.dim)
            parts = self.groups.world.gather(grad)
            ms, n = self.model_size, lf.piece_shape[lf.dim]
            whole = [torch.cat([parts[d * ms + m] for m in range(ms)],
                               dim=lf.dim).narrow(lf.dim, 0, n)
                     for d in range(self.data_size)]
            total = whole[0]
            for w in whole[1:]:
                total = total + w
            shape, spec = lf.piece_shape, lf.piece_spec
        else:
            total = (self.groups.data.sum_in_rank_order(grad)
                     if self.data_size > 1 else grad)
            if lf.mode == "split":
                shape = plan.out_shape(lf)
                spec = _without(lf.piece_spec, lf.dim, plan.rules.model_axis)
            else:
                shape, spec = lf.piece_shape, lf.piece_spec
        if not plan.owns(lf, b, self.coords):
            return torch.zeros(block_shape(shape, spec, plan.mesh),
                               dtype=grad.dtype, device=grad.device)
        return total[region(shape, spec, plan.mesh, self.coords)].contiguous()

    # -- the optimizer's reductions ---------------------------------------------

    @torch.no_grad()
    def global_norm(self, grads: dict) -> torch.Tensor:
        """sqrt of the sum over the mesh, in rank order, of each rank's
        sum of squares over the elements it counts."""
        part = None
        for lf in self.plan.leaves:
            if self.plan.counted(lf, self.coords):
                s = torch.sum(torch.square(_get(grads, lf.path).float()))
                part = s if part is None else part + s
        if part is None:
            part = torch.zeros((), dtype=torch.float32,
                               device=next(iter(tree_leaves(grads))).device)
        if self.plan.size > 1:
            part = self.groups.world.sum_in_rank_order(part.reshape(1))[0]
        return torch.sqrt(part)

    @torch.no_grad()
    def amax(self, a: torch.Tensor) -> torch.Tensor:
        """The largest of the ranks' ``a`` (a 0-d float32 tensor)."""
        if self.plan.size == 1:
            return a
        return self.groups.world.all_reduce(a.reshape(1).clone(), "max")[0]


def unshard_tree(plan: ShardPlan, groups, tree: dict, *, keep: bool = True
                 ) -> Optional[dict]:
    """The whole leaves of a tree of this rank's blocks (params, moments
    or residuals), gathered over the mesh leaf by leaf; every rank must
    call it.  With ``keep`` False the leaves are dropped as they come
    (ranks that do not save), and None is returned."""
    out = {}
    for lf in plan.leaves:
        blk = _get(tree, lf.path)
        if plan.size > 1:
            parts = groups.world.gather(blk.contiguous())
            whole = unshard(list(parts.unbind(0)), lf.spec, plan.mesh)
        else:
            whole = blk.clone()
        if keep:
            _set(out, lf.path, whole)
    return out if keep else None


class Sharding(NamedTuple):
    """A rank's place in a sharded ``TrainState``, for checkpoints: the
    plan, the rank's ``MeshGroups`` and a device its backend carries
    (the barrier's)."""
    plan: ShardPlan
    groups: object
    device: object

    def gather_state(self, state):
        """The whole ``TrainState`` on the host on mesh rank 0 (None on the
        others); every rank must call it."""
        keep = self.groups.index == 0

        def whole(tree):
            if tree is None:
                return None
            out = unshard_tree(self.plan, self.groups, tree, keep=keep)
            return None if out is None else _host(out)

        parts = {k: whole(getattr(state, k))
                 for k in ("params", "mu", "nu", "compress_err")}
        return state._replace(**parts) if keep else None

    def slice_state(self, state, device=None):
        """This rank's blocks of a whole ``TrainState`` on ``device``."""
        def blocks(tree):
            if tree is None:
                return None
            return _to(self.plan.shard(tree, self.groups.index), device)

        return state._replace(**{k: blocks(getattr(state, k)) for k in
                                 ("params", "mu", "nu", "compress_err")})

    def barrier(self) -> None:
        self.groups.world.barrier(self.device)


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


__all__ = ["LeafPlan", "ModelParallel", "ShardPlan", "Sharding",
           "unshard_tree"]
