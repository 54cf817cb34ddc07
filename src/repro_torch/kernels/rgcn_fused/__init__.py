"""K1 / K1b: fused RGCN encode front-end and its backward (kernel wrappers,
plain versions, readout)."""

from repro_torch.kernels.rgcn_fused.ops import (  # noqa: F401
    EdgeIndex, edge_index, fused_two_level_readout, rgcn_fused_agg_flat,
    rgcn_fused_agg_flat_plain, rgcn_fused_bwd, rgcn_fused_bwd_plain,
    rgcn_fused_flat_fwd,
)
