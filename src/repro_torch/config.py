"""Copy of the trace-window caps of ``repro/config.py`` for the PyTorch port.

Only ``DEFAULT_CAP_*`` and ``resolve_trace_caps`` are copied: the model,
shape, train and mesh configs of the original serve slices the port has
not reached yet.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Trace-window caps: the single source of truth for the graph subject's
# bounded per-warp window (paper §3.1).  Every trace call site —
# ``KernelInvocation.trace``, ``core.graphs.iter_kernel_graphs``, the
# ingestion engine and the graph cache key — resolves omitted caps here, so
# two paths can never silently trace the same kernel at different windows
# (they used to: trace() defaulted to 256 instructions while
# iter_kernel_graphs defaulted to 96).
# ---------------------------------------------------------------------------

DEFAULT_CAP_WARPS = 2
DEFAULT_CAP_INSTR = 96


def resolve_trace_caps(cap_warps=None, cap_instr=None, program=None):
    """Resolve (cap_warps, cap_instr): explicit argument > the program's own
    ``trace_caps`` (model-zoo programs carry 10-100x larger windows) > the
    repo-wide defaults above."""
    prog_caps = getattr(program, "trace_caps", None) or (None, None)
    cw = cap_warps if cap_warps is not None else prog_caps[0]
    ci = cap_instr if cap_instr is not None else prog_caps[1]
    return (int(cw) if cw is not None else DEFAULT_CAP_WARPS,
            int(ci) if ci is not None else DEFAULT_CAP_INSTR)
