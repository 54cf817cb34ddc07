"""Known-bad R1: a hot entry reaches the trace->graph ingestion root
(linted as ``repro_torch.core.train`` beside ``ingest_tracer.py`` as
``repro_torch.tracing.tracer``)."""
import torch

from repro_torch.tracing.tracer import trace_kernel


def train_step(x: torch.Tensor, kernel):
    trace = trace_kernel(kernel)         # tracing inside a step
    return x * len(trace)
