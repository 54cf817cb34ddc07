"""Data-parallel sharding of a packed graph batch (the data-parallel half
of ``repro/distributed/sharding.py``).

JAX stages a packed batch onto its mesh with ``shard_batch_put``, splitting
every flat node / edge / warp / graph axis evenly and letting GSPMD handle
the graphs that straddle a shard.  The port runs one process per rank, so
:func:`shard_batch` gives a rank a contiguous range of WHOLE graphs instead:
that range's node, edge and warp rows, with the ``edge_src`` / ``edge_dst``
/ ``warp_seg`` offsets and the graph ids rebased, padded to power-of-two
buckets as ``core/batching.pack_graphs`` pads (the batch ``pack_graphs``
would make of those graphs).  Every layer of the encoder works per node or
per graph (its layer norm is over features, the readout per graph, the
augmentations draw per node, edge or graph), so the math is that of the
whole batch.  Ranks take ``ceil(G / W)`` graphs each, padding graphs
included, so the last ranks may hold fewer graphs, or none: the
counterpart of JAX's pad-or-skip rule for sizes that do not divide
(``batch_put_spec``).  A rank with no graph still joins every collective.

The parameter half restates JAX's logical-axis policy in plain Python:
``PARAM_MODEL_PREF`` / ``ACT_MODEL_PREF`` / ``FSDP_PREF``, ``MeshRules``
over the port's ``launch/mesh.Mesh`` of ranks, ``spec_for`` and
``param_specs`` (the tree counterpart of JAX's ``param_shardings``).  A
spec is a tuple with one entry a dim: ``None``, a mesh axis name, or a
tuple of axis names (a ``PartitionSpec``'s shape).  ``spec_for`` returns
JAX's spec for every input, including the one JAX gets wrong: a param
with literal ``batch`` dims that FSDP cannot see, e.g. names ``('embed',
'embed', 'batch', 'batch')`` at dims ``(1, 1, 16, 16)`` on a 16-wide data
axis, gets ``('data', 'data')`` on its last two dims (ROADMAP C12).  A
spec that uses a mesh axis twice places nothing: ``check_spec`` raises a
ValueError naming the axis, and every placement (``shard_leaf``,
``unshard``, ``region``) calls it first.

``shard_leaf(x, spec, mesh, coords)`` is the block of a leaf that the rank
at mesh coordinates ``coords`` holds (each dim split evenly over the
product of its axes' sizes, the first axis of a tuple the major one, as
``NamedSharding`` splits), and ``unshard`` rebuilds the leaf from every
rank's block.  An activation spec (``is_param=False``: a serving batch or
decode state) may split a dim unevenly, as GSPMD pads it: ``ceil_region``
gives a rank ceil(n / p) of it, the last ranks fewer or none, and
``ceil_unshard`` rebuilds it.  JAX's ``constrain`` and the activation
hints stay out: the port's tensor-parallel region is written out in
``distributed/model_parallel.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.core.batching import (
    EDGE_FLOOR, NODE_FLOOR, WARP_FLOOR, bucket_size,
)
from repro_torch.core.graphs import NUM_RELATIONS

#: logical axis names for every field of a packed graph batch (a copy of
#: JAX's): the flat node / edge / warp / graph axes are the data-parallel
#: 'batch' axis
PACKED_BATCH_AXES: dict[str, tuple] = {
    "node_type": ("batch",),
    "token": ("batch",),
    "pc_norm": ("batch",),
    "vstats": ("batch", None),
    "graph_id": ("batch",),
    "warp_seg": ("batch",),
    "node_mask": ("batch",),
    "edge_src": ("batch",),
    "edge_dst": ("batch",),
    "edge_type": ("batch",),
    "edge_graph": ("batch",),
    "edge_mask": ("batch",),
    "edge_norm": ("batch",),
    "warp_graph": ("batch",),
    "graph_mask": ("batch",),
    "trunc_nodes": ("batch",),
    "trunc_edges": ("batch",),
}

#: which flat axis each field's rows run along
_NODE = ("node_type", "token", "pc_norm", "vstats", "graph_id", "warp_seg",
         "node_mask")
_EDGE = ("edge_src", "edge_dst", "edge_type", "edge_graph", "edge_mask",
         "edge_norm")
_WARP = ("warp_graph",)
_GRAPH = ("graph_mask", "trunc_nodes", "trunc_edges")


class ShardRange(NamedTuple):
    """A rank's rows of a packed batch: [lo, hi) along each flat axis of
    the whole batch, and the padded lengths of its own batch."""
    graphs: tuple
    nodes: tuple
    edges: tuple
    warps: tuple
    P: int            # its node rows, padded
    Q: int            # its edge rows, padded
    W: int            # its warp rows, padded

    @property
    def n_graphs(self) -> int:
        return self.graphs[1] - self.graphs[0]


def shard_ranges(packed: dict, rank: int, world: int) -> ShardRange:
    """Rank ``rank`` of ``world``'s contiguous range of whole graphs of a
    packed batch (host arrays as ``pack_graphs`` makes them: the real
    nodes and edges a prefix, in graph order)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a group of {world}")
    G = packed["graph_mask"].shape[0]
    P = packed["node_mask"].shape[0]
    Q = packed["edge_mask"].shape[0]
    W = packed["warp_graph"].shape[0]
    if world == 1:
        return ShardRange((0, G), (0, P), (0, Q), (0, W), P, Q, W)
    per = -(-G // world)
    g0 = min(rank * per, G)
    g1 = min(g0 + per, G)
    p_used = int(np.count_nonzero(packed["node_mask"]))
    q_used = int(np.count_nonzero(packed["edge_mask"]))
    wg = packed["warp_graph"]
    # the real warps are a prefix, graph ids ascending; the padding rows
    # after them hold graph 0, so the prefix ends after the last nonzero id
    # (with one real graph every row is graph 0's)
    nz = np.flatnonzero(wg)
    w_used = int(nz[-1]) + 1 if len(nz) else W

    def span(ids, used):
        lo, hi = np.searchsorted(ids[:used], [g0, g1], side="left")
        return int(lo), int(hi)

    nodes = span(packed["graph_id"], p_used)
    edges = span(packed["edge_graph"], q_used)
    warps = span(wg, w_used)
    return ShardRange(
        (g0, g1), nodes, edges, warps,
        bucket_size(nodes[1] - nodes[0], NODE_FLOOR),
        bucket_size(max(edges[1] - edges[0], 1), EDGE_FLOOR),
        bucket_size(max(warps[1] - warps[0], 1), WARP_FLOOR))


def _rows(a: np.ndarray, lo: int, hi: int, n: int) -> np.ndarray:
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[:hi - lo] = a[lo:hi]
    return out


def shard_batch(packed: dict, rank: int, world: int) -> dict:
    """Rank ``rank`` of ``world``'s packed batch (host arrays): its range
    of whole graphs (:func:`shard_ranges`), offsets and graph ids rebased,
    padded as ``pack_graphs`` pads, the degree normalizer re-derived from
    its own rows (equal on its real edges).  One rank gets the batch as it
    is."""
    if world == 1:
        return dict(packed)
    r = shard_ranges(packed, rank, world)
    axes = {**{k: (r.nodes, r.P) for k in _NODE},
            **{k: (r.edges, r.Q) for k in _EDGE},
            **{k: (r.warps, r.W) for k in _WARP},
            **{k: (r.graphs, r.n_graphs) for k in _GRAPH}}
    out = {}
    for k, a in packed.items():
        (lo, hi), n = axes[k]
        out[k] = _rows(a, lo, hi, n)
    rebase = {"graph_id": r.graphs[0], "edge_graph": r.graphs[0],
              "warp_graph": r.graphs[0], "edge_src": r.nodes[0],
              "edge_dst": r.nodes[0], "warp_seg": r.warps[0]}
    for k, off in rebase.items():
        (lo, hi), _ = axes[k]
        out[k][:hi - lo] -= off
    if "edge_norm" in out:
        key = (out["edge_dst"].astype(np.int64) * NUM_RELATIONS
               + out["edge_type"])
        deg = np.zeros(r.P * NUM_RELATIONS, np.float32)
        np.add.at(deg, key, out["edge_mask"])
        out["edge_norm"] = (np.float32(1.0)
                            / np.maximum(deg[key], np.float32(1.0)))
    return out


# ---------------------------------------------------------------------------
# The parameter half: logical-axis specs over a (data, model) mesh
# ---------------------------------------------------------------------------

#: preference order for placing the tensor-parallel 'model' axis (JAX's)
PARAM_MODEL_PREF = (
    "vocab", "ffn", "heads", "d_inner", "ssm_heads", "attn_hidden", "embed",
)
ACT_MODEL_PREF = (
    "vocab", "ffn", "heads", "d_inner", "ssm_heads", "cache_seq",
)
#: preference order for placing the FSDP (batch) axes on parameters
FSDP_PREF = (
    "embed", "ffn", "vocab", "d_inner", "heads", "attn_hidden",
    "kv_hidden", "experts", "blocks",
)


@dataclass(frozen=True)
class MeshRules:
    """JAX's ``MeshRules`` over a mesh with ``shape`` and ``axes`` (the
    port's ``launch/mesh.Mesh``)."""
    mesh: object
    batch_axes: tuple = ("data",)
    model_axis: str = "model"
    fsdp: bool = True
    act_model_pref: tuple = ACT_MODEL_PREF
    param_model_pref: tuple = PARAM_MODEL_PREF
    fsdp_pref: tuple = FSDP_PREF
    seq_shard: bool = False

    def axis_size(self, axis: str) -> int:
        return self.mesh.shape[self.mesh.axes.index(axis)]

    @property
    def model_size(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def fsdp_size(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= self.axis_size(a)
        return n


def _shardable(dim: int, n: int, *, exact: bool) -> bool:
    """Can a dim of size ``dim`` be sharded n ways?  Parameters must divide
    exactly; activations tolerate uneven dims (GSPMD pads)."""
    if exact:
        return dim % n == 0
    return dim >= n


def spec_for(names: Sequence[Optional[str]], shape: Sequence[int], *,
             rules: MeshRules, is_param: bool) -> tuple:
    """JAX's ``spec_for``, entry for entry: the batch axes on 'batch' dims
    that divide, the model axis on the first name of the preference list
    whose dim can take it, then (params) FSDP on the first remaining
    FSDP_PREF name that divides, unless a dim already holds the batch
    axes.  The spec is returned as JAX gives it, even where it uses an
    axis twice (``check_spec`` refuses that one)."""
    if len(names) != len(shape):
        raise ValueError(f"names {tuple(names)} and shape {tuple(shape)} "
                         f"differ in length")
    assign: list = [None] * len(names)
    bsize = rules.fsdp_size
    for i, n in enumerate(names):
        if n == "batch" and shape[i] % bsize == 0:
            assign[i] = tuple(rules.batch_axes)

    pref = rules.param_model_pref if is_param else rules.act_model_pref
    msize = rules.model_size
    for cand in pref:
        placed = False
        for i, n in enumerate(names):
            if n == cand and assign[i] is None and _shardable(
                    shape[i], msize, exact=is_param):
                assign[i] = (rules.model_axis,)
                placed = True
                break
        if placed:
            break

    if not is_param and rules.seq_shard:
        if not any(a == (rules.model_axis,) for a in assign):
            for i, n in enumerate(names):
                if n == "seq" and assign[i] is None and _shardable(
                        shape[i], msize, exact=False):
                    assign[i] = (rules.model_axis,)
                    break

    if is_param and rules.fsdp and not any(
            a is not None and set(a) & set(rules.batch_axes)
            for a in assign):
        fsize = rules.fsdp_size
        for cand in rules.fsdp_pref:
            placed = False
            for i, n in enumerate(names):
                if n == cand and assign[i] is None and shape[i] % fsize == 0:
                    assign[i] = tuple(rules.batch_axes)
                    placed = True
                    break
            if placed:
                break

    return tuple(a if a is None else (a[0] if len(a) == 1 else a)
                 for a in assign)


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def check_spec(spec: tuple, mesh=None) -> tuple:
    """``spec`` if it may place a leaf: no mesh axis used twice (and, with
    ``mesh``, every axis one of its axes); else a ValueError naming the
    axis."""
    seen = set()
    for entry in spec:
        for a in spec_axes(entry):
            if a in seen:
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice; "
                                 f"a leaf is split over an axis once")
            if mesh is not None and a not in mesh.axes:
                raise ValueError(f"spec {spec} names axis {a!r}, not one "
                                 f"of the mesh's {tuple(mesh.axes)}")
            seen.add(a)
    return spec


def mesh_coords(mesh, index: int) -> tuple:
    """The coordinates of the ``index``-th rank of ``mesh`` (data-major)."""
    return tuple(int(c) for c in np.unravel_index(index, tuple(mesh.shape)))


def axis_part(entry, mesh, coords) -> tuple:
    """(parts, index): how many even parts a dim with spec ``entry`` has,
    and which of them the rank at ``coords`` holds."""
    parts, idx = 1, 0
    for a in spec_axes(entry):
        n = mesh.shape[mesh.axes.index(a)]
        parts, idx = parts * n, idx * n + coords[mesh.axes.index(a)]
    return parts, idx


def block_shape(shape: Sequence[int], spec: tuple, mesh) -> tuple:
    """The shape of each rank's block of a leaf of ``shape``."""
    check_spec(spec, mesh)
    out = []
    for dim, entry in zip(shape, spec):
        parts, _ = axis_part(entry, mesh, (0,) * len(mesh.shape))
        if dim % parts:
            raise ValueError(f"dim {dim} does not split {parts} ways "
                             f"(spec {spec})")
        out.append(dim // parts)
    return tuple(out)


def region(shape: Sequence[int], spec: tuple, mesh, coords) -> tuple:
    """The slices of a leaf of ``shape`` that the rank at ``coords``
    holds under ``spec``."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not fit shape {tuple(shape)}")
    blk = block_shape(shape, spec, mesh)
    out = []
    for n, entry in zip(blk, spec):
        _, idx = axis_part(entry, mesh, coords)
        out.append(slice(idx * n, (idx + 1) * n))
    return tuple(out)


def shard_leaf(x, spec: tuple, mesh, coords):
    """The block of ``x`` (a tensor or array) that the rank at mesh
    coordinates ``coords`` holds under ``spec``."""
    return x[region(tuple(x.shape), spec, mesh, coords)]


def ceil_region(shape: Sequence[int], spec: tuple, mesh, coords) -> tuple:
    """The slices of an activation of ``shape`` that the rank at ``coords``
    holds under ``spec`` (``spec_for(..., is_param=False)``): a dim of n
    split p ways is ceil(n / p) wide a part, the last parts shorter or
    empty (GSPMD pads an uneven dim)."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not fit shape {tuple(shape)}")
    check_spec(spec, mesh)
    out = []
    for n, entry in zip(shape, spec):
        parts, idx = axis_part(entry, mesh, coords)
        w = -(-n // parts)
        lo = min(idx * w, n)
        out.append(slice(lo, min(lo + w, n)))
    return tuple(out)


def ceil_block_shape(shape: Sequence[int], spec: tuple, mesh,
                     coords) -> tuple:
    """The shape of the rank at ``coords``'s ``ceil_region``."""
    return tuple(s.stop - s.start
                 for s in ceil_region(shape, spec, mesh, coords))


def ceil_unshard(blocks: Sequence, shape: Sequence[int], spec: tuple, mesh):
    """The whole activation of ``shape`` from every rank's ``ceil_region``
    block (``blocks[i]`` mesh rank i's)."""
    whole = blocks[0].new_empty(tuple(shape))
    for i, blk in enumerate(blocks):
        whole[ceil_region(shape, spec, mesh, mesh_coords(mesh, i))] = blk
    return whole


def unshard(blocks: Sequence, spec: tuple, mesh):
    """The whole leaf (a tensor) from every rank's block (``blocks[i]`` the
    block of mesh rank i): the inverse of ``shard_leaf``."""
    parts = [axis_part(e, mesh, (0,) * len(mesh.shape))[0] for e in spec]
    shape = tuple(n * p for n, p in zip(blocks[0].shape, parts))
    whole = blocks[0].new_empty(shape)
    for i, blk in enumerate(blocks):
        whole[region(shape, spec, mesh, mesh_coords(mesh, i))] = blk
    return whole


def _is_axes_leaf(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(x, (str, type(None)))
                                        for x in t)


def param_specs(param_axes: dict, abstract_params: dict,
                rules: MeshRules, *, is_param: bool = True) -> dict:
    """The spec of every leaf (the tree counterpart of JAX's
    ``param_shardings``; with ``is_param`` False, of its activation
    trees, ``batch_shardings`` / ``decode_state_shardings``):
    ``param_axes`` names each leaf's dims, ``abstract_params`` (same
    structure) gives its shape.  An activation spec passes ``check_spec``
    first."""
    if _is_axes_leaf(param_axes):
        spec = spec_for(param_axes, tuple(abstract_params.shape),
                        rules=rules, is_param=is_param)
        return spec if is_param else check_spec(spec, rules.mesh)
    if set(param_axes) != set(abstract_params):
        raise KeyError(f"axes tree {sorted(param_axes)} and params tree "
                       f"{sorted(abstract_params)} differ")
    return {k: param_specs(v, abstract_params[k], rules, is_param=is_param)
            for k, v in param_axes.items()}
