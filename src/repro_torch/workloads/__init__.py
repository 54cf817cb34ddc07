"""Copy of ``repro/workloads/__init__.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

repro_torch.workloads — scenario-diverse generated programs + streaming
trace->graph ingestion.

    from repro_torch.workloads import ScenarioSpec, build_scenario, scenario_matrix

    prog = build_scenario(ScenarioSpec("pipeline", seed=3))
    names = scenario_matrix(["iterative", "long_tail"], seeds=(0, 1))

Generated programs are addressable by name (``scn:<family>[:k=v,...]``)
through ``repro_torch.tracing.programs.get_program`` and the launch grid
(``python -m repro_torch.launch.sample --suite scenarios``).  See
`repro_torch.workloads.streaming` for the bounded-memory ingestion path.
"""

from repro_torch.workloads.modelzoo import (
    MODEL_ZOO, PHASES, model_program, zoo_names,
)
from repro_torch.workloads.scenarios import (
    FAMILIES, build_scenario, scenario_families, scenario_family_of,
    scenario_matrix, scenario_program,
)
from repro_torch.workloads.spec import (
    SCN_PREFIX, ScenarioSpec, is_scenario_name, spec_from_name,
)
from repro_torch.workloads.streaming import (
    iter_program_graphs, materialized_peak, stream_pack,
)

__all__ = [
    "FAMILIES", "MODEL_ZOO", "PHASES", "SCN_PREFIX", "ScenarioSpec",
    "build_scenario", "is_scenario_name", "iter_program_graphs",
    "materialized_peak", "model_program", "scenario_families",
    "scenario_family_of", "scenario_matrix", "scenario_program",
    "spec_from_name", "stream_pack", "zoo_names",
]
