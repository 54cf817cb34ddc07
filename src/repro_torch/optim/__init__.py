"""AdamW with global-norm clipping and LR schedules (counterpart of
``repro/optim``)."""

from repro_torch.optim.adamw import (  # noqa: F401
    TrainConfig, adamw_init, adamw_update, global_norm,
)
from repro_torch.optim.schedules import (  # noqa: F401
    SCHEDULES, constant_schedule, cosine_schedule,
)
