"""Copy of ``repro/core/graphs.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

HRG construction from SASS traces (paper §3.2), fully vectorized.

Node categories: instruction (token = opcode), pseudo (MemRef), variable
(register versions via SSA discipline — a new node per write, reads attach to
the most recent version; memory variables keyed by address).

Edge relations (4, matching the paper's model-config):
  0 control-flow   (instr_i -> instr_{i+1} in warp temporal order)
  1 data-src       (variable -> instruction reading it)
  2 data-dst       (instruction -> variable it writes)
  3 mem-ref        (memory variable <-> MemRef pseudo <-> instruction)

Each warp's trace becomes its own subgraph; the kernel graph is their union,
with warp_id labels so the readout can mean-pool per warp then across warps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.tracing.isa import PSEUDO_IDS, VAR_IDS
from repro_torch.tracing.tracer import WarpTrace

NUM_RELATIONS = 4
NODE_INSTR, NODE_PSEUDO, NODE_VAR = 0, 1, 2


@dataclass
class KernelGraph:
    node_type: np.ndarray   # (N,) int8
    token: np.ndarray       # (N,) int16  opcode / pseudo kind / var kind
    pc_norm: np.ndarray     # (N,) float32
    vstats: np.ndarray      # (N,8) float32
    warp_id: np.ndarray     # (N,) int16
    edge_src: np.ndarray    # (E,) int32
    edge_dst: np.ndarray    # (E,) int32
    edge_type: np.ndarray   # (E,) int8
    n_warps: int

    @property
    def n_nodes(self):
        return len(self.token)

    @property
    def n_edges(self):
        return len(self.edge_src)


def _warp_graph(tr: WarpTrace):
    """Build one warp subgraph; returns node/edge arrays."""
    n = len(tr.opcode)
    max_pc = max(float(tr.pc.max()), 1.0)

    # ---- node bookkeeping ------------------------------------------------
    nt = [np.full(n, NODE_INSTR, np.int8)]
    tok = [tr.opcode.astype(np.int16)]
    pcn = [tr.pc.astype(np.float32) / max_pc]
    vst = [np.zeros((n, 8), np.float32)]
    next_id = n

    es, ed, et = [], [], []

    # ---- control flow ----------------------------------------------------
    if n > 1:
        es.append(np.arange(n - 1, dtype=np.int32))
        ed.append(np.arange(1, n, dtype=np.int32))
        et.append(np.zeros(n - 1, np.int8))

    # ---- register SSA ----------------------------------------------------
    # events: writes from dest slots, reads from src slots
    wi, wreg = [], []
    for c in range(tr.dest.shape[1]):
        m = tr.dest[:, c] >= 0
        wi.append(np.nonzero(m)[0])
        wreg.append(tr.dest[m, c])
    wi = np.concatenate(wi) if wi else np.zeros(0, np.int64)
    wreg = np.concatenate(wreg).astype(np.int64) if len(wi) else np.zeros(0, np.int64)

    ri, rreg = [], []
    for c in range(tr.src.shape[1]):
        m = tr.src[:, c] >= 0
        ri.append(np.nonzero(m)[0])
        rreg.append(tr.src[m, c])
    ri = np.concatenate(ri) if ri else np.zeros(0, np.int64)
    rreg = np.concatenate(rreg).astype(np.int64) if len(ri) else np.zeros(0, np.int64)

    # merge events sorted by (reg, instr, is_write) — reads see writes < i
    ev_reg = np.concatenate([rreg, wreg])
    ev_i = np.concatenate([ri, wi])
    ev_w = np.concatenate([np.zeros(len(ri), np.int8), np.ones(len(wi), np.int8)])
    order = np.lexsort((ev_w, ev_i, ev_reg))
    sreg, si, sw = ev_reg[order], ev_i[order], ev_w[order]
    # version = inclusive cumsum of writes within each reg group
    grp_start = np.concatenate([[True], sreg[1:] != sreg[:-1]])
    wcum = np.cumsum(sw)
    base = np.zeros(len(sw), np.int64)
    starts = np.nonzero(grp_start)[0]
    if len(starts):
        base_vals = wcum[starts] - sw[starts]
        base = np.repeat(base_vals, np.diff(np.concatenate([starts, [len(sw)]])))
    ver = wcum - base  # for writes: its version (>=1); for reads: versions seen

    # write nodes: one per write event (version >= 1)
    w_sel = sw == 1
    n_writes = int(w_sel.sum())
    write_node = next_id + np.arange(n_writes, dtype=np.int64)
    next_id += n_writes
    # map (reg, version) -> write node id for reads
    wkey = sreg[w_sel] * (n + 1) + ver[w_sel]
    worder = np.argsort(wkey, kind="stable")
    wkey_sorted = wkey[worder]
    wnode_sorted = write_node[worder]
    w_instr = si[w_sel]

    nt.append(np.full(n_writes, NODE_VAR, np.int8))
    tok.append(np.full(n_writes, VAR_IDS["reg"], np.int16))
    pcn.append(np.zeros(n_writes, np.float32))
    vst.append(tr.vstats[w_instr.astype(np.int64)])

    # init nodes: regs read at version 0
    r_sel = sw == 0
    r_reg, r_ver, r_i = sreg[r_sel], ver[r_sel], si[r_sel]
    init_mask = r_ver == 0
    init_regs = np.unique(r_reg[init_mask])
    init_ids = next_id + np.arange(len(init_regs), dtype=np.int64)
    next_id += len(init_regs)
    nt.append(np.full(len(init_regs), NODE_VAR, np.int8))
    tok.append(np.full(len(init_regs), VAR_IDS["init"], np.int16))
    pcn.append(np.zeros(len(init_regs), np.float32))
    # init value = stats of first reading instruction (recorded trace value)
    first_read_idx = np.searchsorted(init_regs, r_reg[init_mask])
    init_vst = np.zeros((len(init_regs), 8), np.float32)
    # last assignment wins; order within reg ascending i, so reverse to keep first
    rv = r_i[init_mask][::-1]
    init_vst[first_read_idx[::-1]] = tr.vstats[rv.astype(np.int64)]
    vst.append(init_vst)

    # data-dst edges: write instr -> write var node
    es.append(w_instr.astype(np.int32))
    ed.append(write_node.astype(np.int32))
    et.append(np.full(n_writes, 2, np.int8))

    # data-src edges: var node -> reading instr
    src_nodes = np.empty(len(r_reg), np.int64)
    # versioned reads
    vmask = ~init_mask
    if vmask.any():
        rkey = r_reg[vmask] * (n + 1) + r_ver[vmask]
        pos = np.searchsorted(wkey_sorted, rkey)
        src_nodes[vmask] = wnode_sorted[pos]
    if init_mask.any():
        pos = np.searchsorted(init_regs, r_reg[init_mask])
        src_nodes[init_mask] = init_ids[pos]
    es.append(src_nodes.astype(np.int32))
    ed.append(r_i.astype(np.int32))
    et.append(np.full(len(r_reg), 1, np.int8))

    # ---- memory: MemRef pseudo + memory variable nodes --------------------
    mem_mask = tr.mem_width > 0
    mem_i = np.nonzero(mem_mask)[0]
    if len(mem_i):
        n_mem = len(mem_i)
        pseudo_ids = next_id + np.arange(n_mem, dtype=np.int64)
        next_id += n_mem
        nt.append(np.full(n_mem, NODE_PSEUDO, np.int8))
        tok.append(np.full(n_mem, PSEUDO_IDS["MemRef"], np.int16))
        pcn.append(np.zeros(n_mem, np.float32))
        vst.append(np.zeros((n_mem, 8), np.float32))

        # memory variables live at 128-byte cache-line granularity: loads
        # hitting the same line share one node, so spatial reuse is visible
        # as graph STRUCTURE (what hand-crafted features cannot see).
        addrs = tr.mem_addr[mem_i] >> 7
        uniq, inv = np.unique(addrs, return_inverse=True)
        mem_var_ids = next_id + np.arange(len(uniq), dtype=np.int64)
        next_id += len(uniq)
        nt.append(np.full(len(uniq), NODE_VAR, np.int8))
        tok.append(np.full(len(uniq), VAR_IDS["mem"], np.int16))
        pcn.append(np.zeros(len(uniq), np.float32))
        first_pos = np.full(len(uniq), -1, np.int64)
        first_pos[inv[::-1]] = mem_i[::-1]
        vst.append(tr.vstats[first_pos])

        mvar = mem_var_ids[inv]
        # loads: mem_var -> pseudo -> instr ; stores: instr -> pseudo -> mem_var
        from repro_torch.tracing.isa import OPCODE_IDS

        store_ops = {OPCODE_IDS[o] for o in ("STG", "STS", "RED")}
        is_store = np.isin(tr.opcode[mem_i], list(store_ops))
        ld, st = ~is_store, is_store
        es += [mvar[ld].astype(np.int32), pseudo_ids[ld].astype(np.int32)]
        ed += [pseudo_ids[ld].astype(np.int32), mem_i[ld].astype(np.int32)]
        et += [np.full(ld.sum(), 3, np.int8)] * 2
        es += [mem_i[st].astype(np.int32), pseudo_ids[st].astype(np.int32)]
        ed += [pseudo_ids[st].astype(np.int32), mvar[st].astype(np.int32)]
        et += [np.full(st.sum(), 3, np.int8)] * 2

    node_type = np.concatenate(nt)
    token = np.concatenate(tok)
    pc_norm = np.concatenate(pcn)
    vstats = np.concatenate(vst, axis=0)
    edge_src = np.concatenate(es) if es else np.zeros(0, np.int32)
    edge_dst = np.concatenate(ed) if ed else np.zeros(0, np.int32)
    edge_type = np.concatenate(et) if et else np.zeros(0, np.int8)
    return node_type, token, pc_norm, vstats, edge_src, edge_dst, edge_type


def build_kernel_graph(traces: list[WarpTrace]) -> KernelGraph:
    """Union of per-warp subgraphs with warp ids (paper: kernel graph =
    union of warp graphs; readout averages warp embeddings)."""
    parts = [_warp_graph(t) for t in traces]
    offs = np.cumsum([0] + [len(p[0]) for p in parts])
    node_type = np.concatenate([p[0] for p in parts])
    token = np.concatenate([p[1] for p in parts])
    pc_norm = np.concatenate([p[2] for p in parts])
    vstats = np.concatenate([p[3] for p in parts], axis=0)
    warp_id = np.concatenate(
        [np.full(len(p[0]), w, np.int16) for w, p in enumerate(parts)]
    )
    edge_src = np.concatenate([p[4] + offs[w] for w, p in enumerate(parts)])
    edge_dst = np.concatenate([p[5] + offs[w] for w, p in enumerate(parts)])
    edge_type = np.concatenate([p[6] for p in parts])
    return KernelGraph(
        node_type, token, pc_norm, vstats, warp_id,
        edge_src.astype(np.int32), edge_dst.astype(np.int32), edge_type,
        n_warps=len(parts),
    )


def iter_kernel_graphs(program, cap_warps: int | None = None,
                       cap_instr: int | None = None):
    """Lazily trace + build one HRG per invocation of a
    `tracing.programs.Program` (duck-typed: anything with `.kernels` whose
    items have `.trace`); nothing is retained between yields — the
    streaming-ingestion primitive (see repro_torch.workloads.streaming).

    Omitted caps resolve through ``repro_torch.config.resolve_trace_caps`` — the
    program's own ``trace_caps`` (model-zoo programs) or the repo defaults —
    so this path can never trace at a different window than ``trace()``."""
    from repro_torch.config import resolve_trace_caps

    cap_warps, cap_instr = resolve_trace_caps(cap_warps, cap_instr, program)
    for k in program.kernels:
        yield build_kernel_graph(k.trace(cap_warps, cap_instr))


def pad_batch(graphs: list[KernelGraph], max_nodes=None, max_edges=None,
              max_warps=None):
    """Pad a list of KernelGraphs into dense batch arrays (jit-ready).

    Compatibility shim — new code should use the packed representation in
    core/batching.py, which avoids padding every graph to the batch-wide max.
    When `max_nodes`/`max_edges` caps drop nodes or edges, the per-graph
    counts are surfaced in `trunc_nodes`/`trunc_edges` (B,) and a warning is
    emitted, so sampler fidelity loss is observable instead of silent.
    """
    B = len(graphs)
    N = max_nodes or max(g.n_nodes for g in graphs)
    E = max_edges or max(max(g.n_edges for g in graphs), 1)
    W = max_warps or max(g.n_warps for g in graphs)
    out = {
        "node_type": np.zeros((B, N), np.int32),
        "token": np.zeros((B, N), np.int32),
        "pc_norm": np.zeros((B, N), np.float32),
        "vstats": np.zeros((B, N, 8), np.float32),
        "warp_id": np.zeros((B, N), np.int32),
        "node_mask": np.zeros((B, N), np.float32),
        "edge_src": np.zeros((B, E), np.int32),
        "edge_dst": np.zeros((B, E), np.int32),
        "edge_type": np.zeros((B, E), np.int32),
        "edge_mask": np.zeros((B, E), np.float32),
        "n_warps": np.zeros((B,), np.int32),
        "trunc_nodes": np.zeros((B,), np.int32),
        "trunc_edges": np.zeros((B,), np.int32),
    }
    for b, g in enumerate(graphs):
        n = min(g.n_nodes, N)
        e = min(g.n_edges, E)
        out["node_type"][b, :n] = g.node_type[:n]
        out["token"][b, :n] = g.token[:n]
        out["pc_norm"][b, :n] = g.pc_norm[:n]
        out["vstats"][b, :n] = g.vstats[:n]
        out["warp_id"][b, :n] = g.warp_id[:n]
        out["node_mask"][b, :n] = 1.0
        keep = (g.edge_src[:e] < n) & (g.edge_dst[:e] < n)
        out["edge_src"][b, :e] = np.where(keep, g.edge_src[:e], 0)
        out["edge_dst"][b, :e] = np.where(keep, g.edge_dst[:e], 0)
        out["edge_type"][b, :e] = np.where(keep, g.edge_type[:e], 0)
        out["edge_mask"][b, :e] = keep.astype(np.float32)
        out["n_warps"][b] = g.n_warps
        out["trunc_nodes"][b] = g.n_nodes - n
        out["trunc_edges"][b] = g.n_edges - e + int(e - keep.sum())
    if out["trunc_nodes"].any() or out["trunc_edges"].any():
        import warnings

        warnings.warn(
            f"pad_batch truncated {int(out['trunc_nodes'].sum())} nodes / "
            f"{int(out['trunc_edges'].sum())} edges across "
            f"{int(((out['trunc_nodes'] > 0) | (out['trunc_edges'] > 0)).sum())}"
            f" graph(s); counts are in batch['trunc_nodes'/'trunc_edges']",
            stacklevel=2,
        )
    return out, W
