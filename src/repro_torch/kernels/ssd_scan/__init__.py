"""K8: the Mamba-2 SSD intra-chunk kernel (wrapper, plain version) and the
chunked scan around it."""

from repro_torch.kernels.ssd_scan.ops import (  # noqa: F401
    ssd_chunked, ssd_intra_chunk, ssd_intra_chunk_plain, ssd_scan,
    ssd_sequential_ref,
)
