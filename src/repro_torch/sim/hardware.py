"""Copy of ``repro/sim/hardware.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

Hardware configs for the three evaluation platforms (paper Table 2).

The original's accelerator roofline constants serve only the JAX package's
dry-run analysis and are left out of this copy."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareConfig:
    name: str
    arch: str
    num_sms: int
    clock_ghz: float
    max_warps_per_sm: int
    schedulers_per_sm: int
    regs_per_sm: int
    smem_per_sm: int          # bytes
    l1_kb_per_sm: int
    l2_mb: float
    dram_gbps: float
    l2_gbps: float
    fp32_tflops: float
    tensor_tflops: float
    mem_latency_cycles: int


# RTX 2080 Ti (Turing TU102)
P1 = HardwareConfig(
    name="P1", arch="Turing", num_sms=68, clock_ghz=1.545,
    max_warps_per_sm=32, schedulers_per_sm=4, regs_per_sm=65536,
    smem_per_sm=65536, l1_kb_per_sm=64, l2_mb=5.5, dram_gbps=616.0,
    l2_gbps=1800.0, fp32_tflops=13.4, tensor_tflops=107.0,
    mem_latency_cycles=420,
)

# RTX 3080 Ti (Ampere GA102)
P2 = HardwareConfig(
    name="P2", arch="Ampere", num_sms=80, clock_ghz=1.665,
    max_warps_per_sm=48, schedulers_per_sm=4, regs_per_sm=65536,
    smem_per_sm=102400, l1_kb_per_sm=128, l2_mb=6.0, dram_gbps=912.0,
    l2_gbps=2400.0, fp32_tflops=34.1, tensor_tflops=136.0,
    mem_latency_cycles=400,
)

# RTX 4090 (Ada AD102)
P3 = HardwareConfig(
    name="P3", arch="Ada", num_sms=128, clock_ghz=2.52,
    max_warps_per_sm=48, schedulers_per_sm=4, regs_per_sm=65536,
    smem_per_sm=102400, l1_kb_per_sm=128, l2_mb=72.0, dram_gbps=1008.0,
    l2_gbps=5000.0, fp32_tflops=82.6, tensor_tflops=330.0,
    mem_latency_cycles=380,
)

PLATFORMS = {"P1": P1, "P2": P2, "P3": P3}
