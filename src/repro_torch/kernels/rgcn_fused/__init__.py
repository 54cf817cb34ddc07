"""K1: fused RGCN encode front-end (kernel wrapper, plain version, readout)."""

from repro_torch.kernels.rgcn_fused.ops import (  # noqa: F401
    fused_two_level_readout, rgcn_fused_agg_flat, rgcn_fused_agg_flat_plain,
)
