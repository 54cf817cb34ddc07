"""K5: flat RGCN pre-basis aggregate (kernel wrapper, plain version)."""

from repro_torch.kernels.rgcn_spmm.ops import (  # noqa: F401
    rgcn_message_agg_flat, rgcn_spmm_flat, rgcn_spmm_flat_plain,
)
