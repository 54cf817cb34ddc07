"""Copy of ``repro/tracing/tracer.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

NVBit-like tracer over synthetic kernel templates.

Faithful to the paper's scoping strategy (§3.1): one representative SM per
kernel invocation, all CTAs on that SM, instructions grouped per warp in
temporal order.  Each trace entry carries the Table-1 record fields.

The trace is generated lazily and deterministically from
(template, params, seed): the *graph* subject uses a bounded per-warp window
(cap_instr) of a bounded number of warps (cap_warps), while the *timing*
subject (KernelStats) is computed analytically over the full grid — the same
split real samplers make between per-SM traces and whole-kernel metrics.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.config import resolve_trace_caps
from repro_torch.tracing.isa import (
    CLASS_IDS, INSTR_CLASSES, OPCODE_IDS,
)


@dataclass
class BodyInstr:
    op: str
    dests: tuple = ()
    srcs: tuple = ()
    mem: Optional[dict] = None  # {'kind','width','stride_iter','base','pattern'}


@dataclass
class KernelStats:
    """Whole-kernel analytic statistics (full grid) for the timing model."""
    warp_instructions: float           # total dynamic warp-instructions
    class_counts: np.ndarray           # (num_classes,) warp-instruction counts
    flops: float
    bytes_accessed: float              # total global bytes requested
    working_set: float                 # unique global bytes
    reuse_factor: float                # accesses per unique byte
    pattern: str                       # coalesced | strided | random
    ctas: int
    threads_per_cta: int
    regs_per_thread: int
    smem_per_cta: int
    ilp: float                         # independent-instruction factor
    divergence: float                  # 0..1 branch divergence

    @property
    def instr_mix(self) -> np.ndarray:
        tot = max(self.class_counts.sum(), 1.0)
        return self.class_counts / tot


@dataclass
class WarpTrace:
    """Per-warp instruction stream (Table-1 record, vectorized)."""
    opcode: np.ndarray      # (N,) int16 token ids
    pc: np.ndarray          # (N,) int32
    mask: np.ndarray        # (N,) uint32 active-lane mask
    dest: np.ndarray        # (N,2) int16, -1 = none
    src: np.ndarray         # (N,3) int16, -1 = none
    mem_width: np.ndarray   # (N,) int16, 0 = not memory
    mem_addr: np.ndarray    # (N,) int64, 0 = not memory
    vstats: np.ndarray      # (N,8) float32 dynamic-value stats of the write


@dataclass
class KernelInvocation:
    name: str
    template: str
    params: dict
    seq: int                 # invocation index within the program
    seed: int
    body_fn: Callable = None  # params -> (body, n_iter, meta)
    stats_fn: Callable = None  # (params, platform) -> KernelStats

    def stats(self, platform: str = "P1") -> KernelStats:
        return self.stats_fn(self.params, platform)

    def trace(self, cap_warps: Optional[int] = None,
              cap_instr: Optional[int] = None, *,
              loop: bool = False) -> list[WarpTrace]:
        cap_warps, cap_instr = resolve_trace_caps(cap_warps, cap_instr)
        body, n_iter, meta = self.body_fn(self.params)
        st = self.stats("P1")  # launch geometry for the S2R prologue values
        meta = dict(meta, ctas=st.ctas, threads=st.threads_per_cta,
                    working_set=st.working_set)
        fn = trace_kernel_loop if loop else trace_kernel
        return fn(self, body, n_iter, meta, cap_warps, cap_instr)


def _rng_for(inv: KernelInvocation, warp: int) -> np.random.Generator:
    h = hashlib.blake2b(
        f"{inv.template}|{sorted(inv.params.items())}|{inv.seed}|{warp}".encode(),
        digest_size=8,
    ).digest()
    return np.random.default_rng(int.from_bytes(h, "little"))


def _value_stats(rng, scale, n=8):
    """8-dim dynamic-value summary: mean, std, median, min, max, p25, p75,
    skew — synthesized from a lane-value distribution (32 lanes)."""
    lanes = rng.normal(loc=scale, scale=abs(scale) * 0.1 + 1e-3, size=32)
    q25, med, q75 = np.percentile(lanes, [25, 50, 75])
    std = lanes.std()
    skew = float(np.mean(((lanes - lanes.mean()) / (std + 1e-9)) ** 3))
    return np.array(
        [lanes.mean(), std, med, lanes.min(), lanes.max(), q25, q75, skew],
        np.float32,
    )


def trace_kernel_loop(inv, body, n_iter, meta, cap_warps, cap_instr) -> list[WarpTrace]:
    """Reference tracer: unroll the loop body instruction-by-instruction.

    Kept as the bit-exact oracle for the vectorized ``trace_kernel`` below —
    both consume the identical `_rng_for` stream, so their outputs must match
    to the last bit (the parity suite enforces it).

    Every warp starts with the SASS prologue real kernels carry:
    S2R ctaid / S2R tid — their recorded dynamic values expose the launch
    geometry to the graph features (microarchitecture-independent, exactly
    what NVBit captures)."""
    prologue = [
        BodyInstr("S2R", (0,), ()),   # ctaid
        BodyInstr("S2R", (1,), ()),   # tid
        BodyInstr("IMAD", (2,), (0, 1)),
    ]
    body_len = len(body)
    iters = max(1, min(n_iter, max(1, (cap_instr - len(prologue)) // body_len)))
    warps = min(cap_warps, meta.get("warps_per_cta", 8))
    ctas = meta.get("ctas", 1)
    threads = meta.get("threads", 256)
    out = []
    for w in range(warps):
        rng = _rng_for(inv, w)
        N = len(prologue) + body_len * iters
        opcode = np.empty(N, np.int16)
        pc = np.empty(N, np.int32)
        mask = np.full(N, 0xFFFFFFFF, np.uint32)
        dest = np.full((N, 2), -1, np.int16)
        src = np.full((N, 3), -1, np.int16)
        mem_width = np.zeros(N, np.int16)
        mem_addr = np.zeros(N, np.int64)
        vstats = np.zeros((N, 8), np.float32)
        div = meta.get("divergence", 0.0)
        # each traced warp's addresses live in its CTA's slice of the kernel
        # footprint (warps on the representative SM cover evenly-spaced
        # CTAs) — address MAGNITUDE faithfully encodes the working set,
        # which is how real traces expose problem size to the HRG.
        ws = float(meta.get("working_set", 1 << 20))
        warp_base = (int((w + 1) / (warps + 1) * ws) // 128) * 128

        cta_sample = float(rng.integers(0, max(ctas, 1)))
        for j, ins in enumerate(prologue):
            opcode[j] = OPCODE_IDS[ins.op]
            pc[j] = 16 * j
            for d_i, d in enumerate(ins.dests[:2]):
                dest[j, d_i] = d
            for s_i, s_ in enumerate(ins.srcs[:3]):
                src[j, s_i] = s_
        # launch-geometry values: scale encodes grid/block size
        vstats[0] = _value_stats(rng, np.log1p(ctas) + cta_sample * 1e-6)
        vstats[1] = _value_stats(rng, np.log1p(threads))
        vstats[2] = _value_stats(rng, np.log1p(ctas * threads))

        p0 = len(prologue)
        for it in range(iters):
            for j, ins in enumerate(body):
                idx = p0 + it * body_len + j
                opcode[idx] = OPCODE_IDS[ins.op]
                pc[idx] = 16 * (p0 + j)  # static PC: iterations share PCs
                if div > 0 and ins.op in ("BRA", "ISETP"):
                    lanes = rng.random(32) > div
                    mask[idx] = np.uint32(
                        int("".join("1" if b else "0" for b in lanes[::-1]), 2)
                    )
                for d_i, d in enumerate(ins.dests[:2]):
                    dest[idx, d_i] = d
                for s_i, s_ in enumerate(ins.srcs[:3]):
                    src[idx, s_i] = s_
                if ins.mem is not None:
                    m = ins.mem
                    mem_width[idx] = m.get("width", 4)
                    stride = m.get("stride_iter", 128)
                    # buffers are ws-sized allocations: the template's base
                    # constant selects WHICH buffer; its address scale is the
                    # kernel's footprint (as in real allocator behavior).
                    buf = (int(m.get("base", 0)) >> 28) & 0xF
                    mem_addr[idx] = (
                        buf * (int(ws) // 128) * 128 + warp_base + it * stride
                    )
                    vstats[idx] = _value_stats(rng, float(mem_addr[idx]) * 1e-6)
                elif ins.dests and ins.dests[0] == 2 and ins.op == "IADD3":
                    # loop counter: NVBit records its values over the FULL
                    # execution (0..n_iter) even though the graph window is
                    # bounded — the trip count is real trace information.
                    vstats[idx] = np.array(
                        [n_iter / 2, n_iter / 3.46, n_iter / 2, 0.0,
                         n_iter, n_iter / 4, 3 * n_iter / 4, 0.0],
                        np.float32,
                    )
                elif ins.dests:
                    vstats[idx] = _value_stats(rng, float(rng.normal(0, 2.0)))
        out.append(
            WarpTrace(opcode, pc, mask, dest, src, mem_width, mem_addr, vstats)
        )
    return out


def trace_kernel(inv, body, n_iter, meta, cap_warps, cap_instr) -> list[WarpTrace]:
    """Vectorized tracer: numpy tiling instead of per-instruction loops.

    Bit-exact with ``trace_kernel_loop``: the per-warp RNG stream is replayed
    draw-for-draw, but consecutive normal draws are merged into single
    ``standard_normal`` calls (a Generator's normal stream is
    position-deterministic, so ``normal(loc, s, 32)`` equals
    ``loc + s * standard_normal(32)`` and back-to-back draws concatenate) and
    the 8-dim value statistics are computed for all write events at once over
    an (M, 32) lane matrix.  Uniform divergence draws interleave with the
    normal stream, so runs are split at each branch event when
    ``divergence > 0``."""
    prologue = [
        BodyInstr("S2R", (0,), ()),   # ctaid
        BodyInstr("S2R", (1,), ()),   # tid
        BodyInstr("IMAD", (2,), (0, 1)),
    ]
    body_len = len(body)
    iters = max(1, min(n_iter, max(1, (cap_instr - len(prologue)) // body_len)))
    warps = min(cap_warps, meta.get("warps_per_cta", 8))
    ctas = meta.get("ctas", 1)
    threads = meta.get("threads", 256)
    div = meta.get("divergence", 0.0)
    ws = float(meta.get("working_set", 1 << 20))
    p0 = len(prologue)
    N = p0 + body_len * iters

    # -- static instruction template (identical across warps/iterations) ----
    allins = prologue + list(body)
    tmpl_op = np.array([OPCODE_IDS[i.op] for i in allins], np.int16)
    tmpl_dest = np.full((len(allins), 2), -1, np.int16)
    tmpl_src = np.full((len(allins), 3), -1, np.int16)
    for j, ins in enumerate(allins):
        for d_i, d in enumerate(ins.dests[:2]):
            tmpl_dest[j, d_i] = d
        for s_i, s_ in enumerate(ins.srcs[:3]):
            tmpl_src[j, s_i] = s_
    tmpl_mw = np.array(
        [(i.mem.get("width", 4) if i.mem is not None else 0) for i in allins],
        np.int16,
    )
    opcode = np.concatenate([tmpl_op[:p0], np.tile(tmpl_op[p0:], iters)])
    pc = np.concatenate(
        [16 * np.arange(p0), np.tile(16 * (p0 + np.arange(body_len)), iters)]
    ).astype(np.int32)
    dest = np.concatenate([tmpl_dest[:p0], np.tile(tmpl_dest[p0:], (iters, 1))])
    src = np.concatenate([tmpl_src[:p0], np.tile(tmpl_src[p0:], (iters, 1))])
    mem_width = np.concatenate([tmpl_mw[:p0], np.tile(tmpl_mw[p0:], iters)])

    # -- per-iteration RNG event sequence (body order, same as the oracle) --
    # 'u' = 32 uniform lanes (branch divergence), 'm' = 32 normals keyed on
    # the address, 'd' = 1 scalar normal + 32 lane normals.
    ev: list[tuple[str, int]] = []
    loop_js: list[int] = []
    for j, ins in enumerate(body):
        if div > 0 and ins.op in ("BRA", "ISETP"):
            ev.append(("u", j))
        if ins.mem is not None:
            ev.append(("m", j))
        elif ins.dests and ins.dests[0] == 2 and ins.op == "IADD3":
            loop_js.append(j)
        elif ins.dests:
            ev.append(("d", j))
    val_events = [(k, j) for k, j in ev if k != "u"]
    unif_js = [j for k, j in ev if k == "u"]
    n_val, n_u = len(val_events), len(unif_js)
    per_iter = [(-1 if k == "u" else (33 if k == "d" else 32)) for k, _ in ev]
    per_iter_normals = sum(c for c in per_iter if c > 0)

    M = 3 + iters * n_val  # value-stat event rows (3 prologue rows first)
    ev_counts = np.array([33 if k == "d" else 32 for k, _ in val_events],
                         np.int64)
    counts = np.concatenate([np.full(3, 32, np.int64), np.tile(ev_counts, iters)])
    offs = np.zeros(M, np.int64)
    np.cumsum(counts[:-1], out=offs[1:])
    has_scalar = counts == 33
    it_arr = np.arange(iters, dtype=np.int64)
    if loop_js:
        lc_row = np.array(
            [n_iter / 2, n_iter / 3.46, n_iter / 2, 0.0,
             n_iter, n_iter / 4, 3 * n_iter / 4, 0.0],
            np.float32,
        )

    out = []
    for w in range(warps):
        rng = _rng_for(inv, w)
        warp_base = (int((w + 1) / (warps + 1) * ws) // 128) * 128
        cta_sample = float(rng.integers(0, max(ctas, 1)))

        # replay the draw stream: merged normal runs split by uniform draws
        chunks: list[np.ndarray] = []
        unifs: list[np.ndarray] = []
        if n_u == 0:
            chunks.append(rng.standard_normal(96 + iters * per_iter_normals))
        else:
            run = 96
            for _ in range(iters):
                for c in per_iter:
                    if c < 0:
                        if run:
                            chunks.append(rng.standard_normal(run))
                            run = 0
                        unifs.append(rng.random(32))
                    else:
                        run += c
            if run:
                chunks.append(rng.standard_normal(run))
        z = np.concatenate(chunks)

        # locs per value-event row; mem addresses land in mem_addr as we go
        mem_addr = np.zeros(N, np.int64)
        locs = np.empty(M, np.float64)
        locs[0] = np.log1p(ctas) + cta_sample * 1e-6
        locs[1] = np.log1p(threads)
        locs[2] = np.log1p(ctas * threads)
        if n_val:
            body_rows = locs[3:].reshape(iters, n_val)
            for e, (kind, j) in enumerate(val_events):
                if kind == "m":
                    m = body[j].mem
                    stride = m.get("stride_iter", 128)
                    buf = (int(m.get("base", 0)) >> 28) & 0xF
                    addr = (buf * (int(ws) // 128) * 128 + warp_base
                            + it_arr * stride)
                    mem_addr[p0 + it_arr * body_len + j] = addr
                    body_rows[:, e] = addr.astype(np.float64) * 1e-6
        locs[has_scalar] = 2.0 * z[offs[has_scalar]]

        lane_idx = (offs + has_scalar)[:, None] + np.arange(32)[None, :]
        lanes = locs[:, None] + (np.abs(locs) * 0.1 + 1e-3)[:, None] * z[lane_idx]
        q25, med, q75 = np.percentile(lanes, [25, 50, 75], axis=1)
        mean = lanes.mean(axis=1)
        std = lanes.std(axis=1)
        skew = np.mean(((lanes - mean[:, None]) / (std[:, None] + 1e-9)) ** 3,
                       axis=1)
        stats8 = np.stack(
            [mean, std, med, lanes.min(axis=1), lanes.max(axis=1),
             q25, q75, skew], axis=1,
        ).astype(np.float32)

        vstats = np.zeros((N, 8), np.float32)
        vstats[:3] = stats8[:3]
        if n_val:
            val_j = np.array([j for _, j in val_events], np.int64)
            tgt = p0 + (it_arr[:, None] * body_len + val_j[None, :]).ravel()
            vstats[tgt] = stats8[3:]
        if loop_js:
            lj = np.array(loop_js, np.int64)
            tgt = p0 + (it_arr[:, None] * body_len + lj[None, :]).ravel()
            vstats[tgt] = lc_row

        mask = np.full(N, 0xFFFFFFFF, np.uint32)
        if n_u:
            ub = np.asarray(unifs) > div  # (iters*n_u, 32), iteration-major
            bits = (ub.astype(np.uint64)
                    << np.arange(32, dtype=np.uint64)[None, :]).sum(axis=1)
            uj = np.array(unif_js, np.int64)
            tgt = p0 + (it_arr[:, None] * body_len + uj[None, :]).ravel()
            mask[tgt] = bits.astype(np.uint32)

        out.append(
            WarpTrace(opcode.copy(), pc.copy(), mask, dest.copy(), src.copy(),
                      mem_width.copy(), mem_addr, vstats)
        )
    return out


def make_stats(
    *, body_class_counts, n_iter, ctas, threads_per_cta, flops_total,
    bytes_accessed, working_set, pattern, regs=32, smem=0, ilp=2.0,
    divergence=0.0,
) -> KernelStats:
    warps_per_cta = (threads_per_cta + 31) // 32
    total_warp_instr = float(
        sum(body_class_counts.values()) * n_iter * warps_per_cta * ctas
    )
    counts = np.zeros(len(INSTR_CLASSES), np.float64)
    for cls, c in body_class_counts.items():
        counts[CLASS_IDS[cls]] = c * n_iter * warps_per_cta * ctas
    return KernelStats(
        warp_instructions=total_warp_instr,
        class_counts=counts,
        flops=float(flops_total),
        bytes_accessed=float(bytes_accessed),
        working_set=float(max(working_set, 1.0)),
        reuse_factor=float(max(bytes_accessed / max(working_set, 1.0), 1.0)),
        pattern=pattern,
        ctas=int(ctas),
        threads_per_cta=int(threads_per_cta),
        regs_per_thread=int(regs),
        smem_per_cta=int(smem),
        ilp=float(ilp),
        divergence=float(divergence),
    )
