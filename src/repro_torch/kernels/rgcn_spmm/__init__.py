"""K5 / K6: flat and dense RGCN pre-basis aggregates (kernel wrappers,
plain versions)."""

from repro_torch.kernels.rgcn_spmm.ops import (  # noqa: F401
    dense_csr, rgcn_message_agg, rgcn_message_agg_flat, rgcn_spmm_dense,
    rgcn_spmm_dense_plain, rgcn_spmm_flat, rgcn_spmm_flat_plain,
)
