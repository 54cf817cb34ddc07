"""AdamW with global-norm clipping, bf16 moments and int8 error-feedback
compression, and the LR schedules (counterpart of ``repro/optim``)."""

from repro_torch.config import TrainConfig  # noqa: F401
from repro_torch.optim.adamw import (  # noqa: F401
    TrainState, adamw_init, adamw_update, apply_gradients, global_norm,
)
from repro_torch.optim.schedules import (  # noqa: F401
    SCHEDULES, constant_schedule, cosine_schedule,
)
