"""K8 / K8b: the Mamba-2 SSD intra-chunk kernel and its backward (wrappers,
plain versions) and the chunked scan around them."""

from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    ssd_chunked, ssd_intra_chunk, ssd_intra_chunk_bwd,
    ssd_intra_chunk_bwd_plain, ssd_intra_chunk_plain, ssd_scan,
    ssd_sequential_ref,
)
