"""repro_torch.serving — sampling-as-a-service over the port's PlanEngine
(counterpart of ``repro.serving``; the open-loop load generator comes with
a later slice)."""

from repro_torch.serving.service import PlanService

__all__ = ["PlanService"]
