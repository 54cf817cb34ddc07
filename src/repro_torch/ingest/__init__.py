"""Copy of ``repro/ingest/__init__.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

Parallel, deterministic, cache-backed trace->graph ingestion.

The host-side front door of the sampler: `IngestEngine` traces kernels and
builds their HRGs through a worker pool with deterministic output order and
bounded peak residency, while `GraphStore` persists packed graphs on disk so
warm runs skip tracing entirely (DESIGN.md §13).
"""

from repro_torch.ingest.engine import IngestConfig, IngestEngine
from repro_torch.ingest.store import GRAPH_SCHEMA, GraphStore, kernel_graph_key

__all__ = [
    "GRAPH_SCHEMA",
    "GraphStore",
    "IngestConfig",
    "IngestEngine",
    "kernel_graph_key",
]
