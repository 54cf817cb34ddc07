"""Known-good R1: the ingestion root runs on the host, before the step."""
import torch

from repro_torch.tracing.tracer import trace_kernel


def prepare(kernel):
    return len(trace_kernel(kernel))


def train_step(x: torch.Tensor, n: int):
    return x * n
