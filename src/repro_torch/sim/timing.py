"""Copy of ``repro/sim/timing.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

Stall-aware cycle-approximate GPU timing model (HyFiSS-flavored).

Interval model: per-SM issue throughput is bounded by warp-level parallelism
via Little's law (active_warps x ILP / weighted latency), and the kernel is
bounded by the max of compute issue, L2 and DRAM service times.  Cache hit
rates come from an analytic reuse/capacity model over the kernel's working
set and access pattern.  Deterministic in (KernelStats, HardwareConfig).

The model is evaluated structure-of-arrays: :func:`stack_stats` packs a
program's per-kernel :class:`KernelStats` into a :class:`StackedKernelStats`
and :func:`simulate_batch` times EVERY kernel in one vectorized numpy pass
(no per-kernel Python dispatch).  :func:`simulate_kernel` survives as a
single-kernel shim over the batch path; ``_simulate_kernel_scalar`` keeps
the original per-kernel arithmetic as the parity reference (tests pin
batch == scalar to float64 exactness).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.sim.hardware import HardwareConfig
from repro_torch.tracing.isa import CLASS_IDS, INSTR_CLASSES
from repro_torch.tracing.tracer import KernelStats

# per-class issue latencies (cycles) and throughput weights
CLASS_LATENCY = {
    "mem_load": 1.0, "mem_store": 1.0, "smem": 1.0, "fp": 1.0, "alu": 1.0,
    "sfu": 4.0, "tensor": 2.0, "control": 1.0, "barrier": 2.0, "shuffle": 1.0,
}
# execution-dependency latency per class (for Little's law)
CLASS_EXEC_LATENCY = {
    "mem_load": 1.0,  # replaced by cfg.mem_latency scaled by miss ratio
    "mem_store": 8.0, "smem": 25.0, "fp": 4.0, "alu": 4.0, "sfu": 16.0,
    "tensor": 16.0, "control": 6.0, "barrier": 25.0, "shuffle": 10.0,
}

COALESCE_FACTOR = {"coalesced": 1.0, "strided": 3.0, "random": 8.0}

#: access-pattern string -> dense id for the SoA representation
PATTERNS = ("coalesced", "strided", "random")
PATTERN_IDS = {p: i for i, p in enumerate(PATTERNS)}
_COALESCE_BY_ID = np.array([COALESCE_FACTOR[p] for p in PATTERNS])
_L1_PATTERN_PEN = np.array([1.0, 0.7, 0.25])  # coalesced / strided / random


@dataclass
class KernelMetrics:
    cycles: float
    time_s: float          # native execution time
    ipc: float             # per-SM instructions/cycle
    l1_hit: float
    l2_hit: float
    occupancy: float
    dram_bytes: float
    sim_time_s: float      # simulator wall time to model this kernel


_METRIC_FIELDS = ("cycles", "time_s", "ipc", "l1_hit", "l2_hit", "occupancy",
                  "dram_bytes", "sim_time_s")


@dataclass
class BatchKernelMetrics:
    """Structure-of-arrays metrics for a whole program: every field is an
    (n,) float64 array.  Supports the sequence protocol (len / indexing /
    iteration yields :class:`KernelMetrics`) so per-kernel call sites keep
    working, while vectorized consumers (reconstruct / evaluate / speedup)
    read the arrays directly."""
    cycles: np.ndarray
    time_s: np.ndarray
    ipc: np.ndarray
    l1_hit: np.ndarray
    l2_hit: np.ndarray
    occupancy: np.ndarray
    dram_bytes: np.ndarray
    sim_time_s: np.ndarray

    def __len__(self) -> int:
        return len(self.cycles)

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return KernelMetrics(**{f: float(getattr(self, f)[i])
                                    for f in _METRIC_FIELDS})
        return BatchKernelMetrics(**{f: getattr(self, f)[i]
                                     for f in _METRIC_FIELDS})

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def tolist(self) -> list[KernelMetrics]:
        return [self[i] for i in range(len(self))]

    @classmethod
    def from_list(cls, metrics) -> "BatchKernelMetrics":
        return cls(**{f: np.array([getattr(m, f) for m in metrics],
                                  np.float64) for f in _METRIC_FIELDS})


@dataclass
class StackedKernelStats:
    """SoA view over a list of :class:`KernelStats` (one row per kernel)."""
    warp_instructions: np.ndarray   # (n,) f64
    class_counts: np.ndarray        # (n, num_classes) f64
    bytes_accessed: np.ndarray      # (n,) f64
    working_set: np.ndarray         # (n,) f64
    reuse_factor: np.ndarray        # (n,) f64
    pattern_id: np.ndarray          # (n,) int
    ctas: np.ndarray                # (n,) int
    threads_per_cta: np.ndarray     # (n,) int
    regs_per_thread: np.ndarray     # (n,) int
    smem_per_cta: np.ndarray        # (n,) int
    ilp: np.ndarray                 # (n,) f64
    divergence: np.ndarray          # (n,) f64

    def __len__(self) -> int:
        return len(self.warp_instructions)


def stack_stats(stats: list) -> StackedKernelStats:
    """Pack per-kernel :class:`KernelStats` into the SoA form."""
    return StackedKernelStats(
        warp_instructions=np.array([s.warp_instructions for s in stats],
                                   np.float64),
        class_counts=np.stack([np.asarray(s.class_counts, np.float64)
                               for s in stats]) if stats
        else np.zeros((0, len(INSTR_CLASSES))),
        bytes_accessed=np.array([s.bytes_accessed for s in stats],
                                np.float64),
        working_set=np.array([s.working_set for s in stats], np.float64),
        reuse_factor=np.array([s.reuse_factor for s in stats], np.float64),
        pattern_id=np.array([PATTERN_IDS[s.pattern] for s in stats], int),
        ctas=np.array([s.ctas for s in stats], int),
        threads_per_cta=np.array([s.threads_per_cta for s in stats], int),
        regs_per_thread=np.array([s.regs_per_thread for s in stats], int),
        smem_per_cta=np.array([s.smem_per_cta for s in stats], int),
        ilp=np.array([s.ilp for s in stats], np.float64),
        divergence=np.array([s.divergence for s in stats], np.float64),
    )


def _occupancy_batch(st: StackedKernelStats, hw: HardwareConfig):
    warps_per_cta = (st.threads_per_cta + 31) // 32
    regs_per_cta = st.regs_per_thread * st.threads_per_cta
    lim_regs = np.maximum(1, hw.regs_per_sm // np.maximum(regs_per_cta, 1))
    lim_smem = np.where(
        st.smem_per_cta > 0,
        np.maximum(1, hw.smem_per_sm // np.maximum(st.smem_per_cta, 1)), 64)
    lim_warps = np.maximum(1, hw.max_warps_per_sm // warps_per_cta)
    ctas_per_sm = np.minimum(np.minimum(lim_regs, lim_smem),
                             np.minimum(lim_warps, 32))
    # can't exceed the grid itself spread over SMs
    grid_cap = np.maximum(1, np.ceil(st.ctas / hw.num_sms).astype(int))
    ctas_per_sm = np.minimum(ctas_per_sm, grid_cap)
    active_warps = ctas_per_sm * warps_per_cta
    return np.minimum(active_warps, hw.max_warps_per_sm), ctas_per_sm


def _cache_hits_batch(st: StackedKernelStats, hw: HardwareConfig,
                      ctas_per_sm: np.ndarray):
    """Analytic reuse/capacity model (vectorized)."""
    potential = np.maximum(0.0, 1.0 - 1.0 / st.reuse_factor)
    # L1: per-SM slice of the working set must fit
    sms_used = np.minimum(hw.num_sms, np.maximum(st.ctas, 1))
    ws_per_sm = (st.working_set / np.maximum(sms_used, 1)
                 * np.maximum(ctas_per_sm, 1) ** 0.5)
    l1_cap = np.minimum(1.0, (hw.l1_kb_per_sm * 1024.0)
                        / np.maximum(ws_per_sm, 1.0))
    pattern_pen = _L1_PATTERN_PEN[st.pattern_id]
    l1_hit = potential * l1_cap ** 0.5 * pattern_pen
    # L2: whole working set vs L2 capacity
    l2_cap = np.minimum(1.0, (hw.l2_mb * 1e6)
                        / np.maximum(st.working_set, 1.0))
    resid_potential = (np.maximum(0.0, potential - l1_hit)
                       + 0.3 * (1 - potential))
    l2_hit = np.minimum(0.95, resid_potential * l2_cap ** 0.5 + 0.15 * l2_cap)
    return np.clip(l1_hit, 0.0, 0.98), np.clip(l2_hit, 0.0, 0.98)


def simulate_batch(st: StackedKernelStats,
                   hw: HardwareConfig) -> BatchKernelMetrics:
    """Vectorized interval model: one numpy pass over every kernel of a
    program (same arithmetic, same accumulation order as the scalar
    reference — results are float64-identical)."""
    active_warps, ctas_per_sm = _occupancy_batch(st, hw)
    occupancy = active_warps / hw.max_warps_per_sm
    l1_hit, l2_hit = _cache_hits_batch(st, hw, ctas_per_sm)

    tot = np.maximum(st.class_counts.sum(axis=1), 1.0)
    mix = st.class_counts / tot[:, None]            # (n, num_classes)
    # effective average execution latency per instruction (class order
    # preserved so the accumulation matches the scalar loop bit-for-bit)
    lat = np.zeros(len(st))
    for cls in INSTR_CLASSES:
        w = mix[:, CLASS_IDS[cls]]
        if cls == "mem_load":
            miss_lat = hw.mem_latency_cycles
            eff = (30.0 * l1_hit
                   + miss_lat * (1 - l1_hit) * (0.4 * l2_hit + (1 - l2_hit)))
            lat += w * eff
        else:
            lat += w * CLASS_EXEC_LATENCY[cls]
    lat = np.maximum(lat, 2.0)

    # issue cost per instruction (tensor/sfu lower throughput)
    issue_cost = np.zeros(len(st))
    for cls in INSTR_CLASSES:
        issue_cost += mix[:, CLASS_IDS[cls]] * CLASS_LATENCY[cls]

    # Little's law: sustainable IPC per SM
    wlp_ipc = active_warps * st.ilp / lat
    peak_ipc = hw.schedulers_per_sm / np.maximum(issue_cost, 1e-6)
    div_pen = 1.0 - 0.5 * st.divergence
    ipc = np.maximum(np.minimum(wlp_ipc, peak_ipc) * div_pen, 0.05)

    sms_used = np.minimum(hw.num_sms, np.maximum(st.ctas, 1))
    instr_per_sm = st.warp_instructions / sms_used
    compute_cycles = instr_per_sm / ipc

    # memory service times
    coal = _COALESCE_BY_ID[st.pattern_id]
    dram_bytes = st.bytes_accessed * coal * (1 - l1_hit) * (1 - l2_hit)
    l2_bytes = st.bytes_accessed * coal * (1 - l1_hit)
    dram_cycles = dram_bytes / hw.dram_gbps / 1e9 * hw.clock_ghz * 1e9
    l2_cycles = l2_bytes / hw.l2_gbps / 1e9 * hw.clock_ghz * 1e9

    cycles = np.maximum(np.maximum(compute_cycles, dram_cycles),
                        l2_cycles) + 2000.0  # launch
    time_s = cycles / (hw.clock_ghz * 1e9)
    eff_ipc = instr_per_sm / cycles

    # simulator wall-time model (cycle-approximate simulators run ~1e5-1e6
    # warp-instructions/sec); constant per-kernel overhead for setup/teardown
    sim_time_s = st.warp_instructions / 4.0e5 + 0.05
    return BatchKernelMetrics(
        cycles=cycles, time_s=time_s, ipc=eff_ipc, l1_hit=l1_hit,
        l2_hit=l2_hit, occupancy=occupancy.astype(np.float64),
        dram_bytes=dram_bytes, sim_time_s=sim_time_s,
    )


def simulate_kernel(stats: KernelStats, hw: HardwareConfig) -> KernelMetrics:
    """Single-kernel shim over :func:`simulate_batch` (kept for per-kernel
    call sites; program-level paths should stack + batch)."""
    return simulate_batch(stack_stats([stats]), hw)[0]


def _simulate_kernel_scalar(stats: KernelStats,
                            hw: HardwareConfig) -> KernelMetrics:
    """The original per-kernel arithmetic, kept verbatim as the parity
    reference for `simulate_batch` (tests/test_plan_engine.py)."""
    active_warps, ctas_per_sm = _occupancy(stats, hw)
    occupancy = active_warps / hw.max_warps_per_sm
    l1_hit, l2_hit = _cache_hits(stats, hw, ctas_per_sm)

    mix = stats.instr_mix  # (num_classes,)
    # effective average execution latency per instruction
    lat = 0.0
    for cls in INSTR_CLASSES:
        w = mix[CLASS_IDS[cls]]
        if cls == "mem_load":
            miss_lat = hw.mem_latency_cycles
            eff = 30.0 * l1_hit + miss_lat * (1 - l1_hit) * (0.4 * l2_hit + (1 - l2_hit))
            lat += w * eff
        else:
            lat += w * CLASS_EXEC_LATENCY[cls]
    lat = max(lat, 2.0)

    # issue cost per instruction (tensor/sfu lower throughput)
    issue_cost = sum(mix[CLASS_IDS[c]] * CLASS_LATENCY[c] for c in INSTR_CLASSES)

    # Little's law: sustainable IPC per SM
    wlp_ipc = active_warps * stats.ilp / lat
    peak_ipc = hw.schedulers_per_sm / max(issue_cost, 1e-6)
    div_pen = 1.0 - 0.5 * stats.divergence
    ipc = max(min(wlp_ipc, peak_ipc) * div_pen, 0.05)

    sms_used = min(hw.num_sms, max(stats.ctas, 1))
    instr_per_sm = stats.warp_instructions / sms_used
    compute_cycles = instr_per_sm / ipc

    # memory service times
    coal = COALESCE_FACTOR[stats.pattern]
    dram_bytes = stats.bytes_accessed * coal * (1 - l1_hit) * (1 - l2_hit)
    l2_bytes = stats.bytes_accessed * coal * (1 - l1_hit)
    dram_cycles = dram_bytes / hw.dram_gbps / 1e9 * hw.clock_ghz * 1e9
    l2_cycles = l2_bytes / hw.l2_gbps / 1e9 * hw.clock_ghz * 1e9

    cycles = max(compute_cycles, dram_cycles, l2_cycles) + 2000.0  # launch
    time_s = cycles / (hw.clock_ghz * 1e9)
    eff_ipc = instr_per_sm / cycles

    # simulator wall-time model (cycle-approximate simulators run ~1e5-1e6
    # warp-instructions/sec); constant per-kernel overhead for setup/teardown
    sim_time_s = stats.warp_instructions / 4.0e5 + 0.05
    return KernelMetrics(
        cycles=float(cycles), time_s=float(time_s), ipc=float(eff_ipc),
        l1_hit=float(l1_hit), l2_hit=float(l2_hit),
        occupancy=float(occupancy), dram_bytes=float(dram_bytes),
        sim_time_s=float(sim_time_s),
    )


def _occupancy(stats: KernelStats, hw: HardwareConfig):
    warps_per_cta = (stats.threads_per_cta + 31) // 32
    regs_per_cta = stats.regs_per_thread * stats.threads_per_cta
    lim_regs = max(1, hw.regs_per_sm // max(regs_per_cta, 1))
    lim_smem = max(1, hw.smem_per_sm // max(stats.smem_per_cta, 1)) if stats.smem_per_cta else 64
    lim_warps = max(1, hw.max_warps_per_sm // warps_per_cta)
    ctas_per_sm = min(lim_regs, lim_smem, lim_warps, 32)
    # can't exceed the grid itself spread over SMs
    ctas_per_sm = min(ctas_per_sm, max(1, int(np.ceil(stats.ctas / hw.num_sms))))
    active_warps = ctas_per_sm * warps_per_cta
    return min(active_warps, hw.max_warps_per_sm), ctas_per_sm


def _cache_hits(stats: KernelStats, hw: HardwareConfig, ctas_per_sm: int):
    """Analytic reuse/capacity model."""
    potential = max(0.0, 1.0 - 1.0 / stats.reuse_factor)
    # L1: per-SM slice of the working set must fit
    sms_used = min(hw.num_sms, max(stats.ctas, 1))
    ws_per_sm = stats.working_set / max(sms_used, 1) * max(ctas_per_sm, 1) ** 0.5
    l1_cap = min(1.0, (hw.l1_kb_per_sm * 1024.0) / max(ws_per_sm, 1.0))
    pattern_pen = {"coalesced": 1.0, "strided": 0.7, "random": 0.25}[stats.pattern]
    l1_hit = potential * l1_cap ** 0.5 * pattern_pen
    # L2: whole working set vs L2 capacity
    l2_cap = min(1.0, (hw.l2_mb * 1e6) / max(stats.working_set, 1.0))
    resid_potential = max(0.0, potential - l1_hit) + 0.3 * (1 - potential)
    l2_hit = min(0.95, resid_potential * l2_cap ** 0.5 + 0.15 * l2_cap)
    return float(np.clip(l1_hit, 0.0, 0.98)), float(np.clip(l2_hit, 0.0, 0.98))
