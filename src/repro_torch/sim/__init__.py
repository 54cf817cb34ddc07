from repro_torch.sim.hardware import PLATFORMS, HardwareConfig
from repro_torch.sim.timing import (
    BatchKernelMetrics, KernelMetrics, StackedKernelStats, simulate_batch,
    simulate_kernel, stack_stats,
)
from repro_torch.sim.simulate import (
    simulate_program, reconstruct, sampling_error, speedup, SamplingPlan,
)
