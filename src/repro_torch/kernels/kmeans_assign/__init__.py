"""K2 / K3 / K4: fused K-Means assignment, blocked silhouette sums and the
sequential reference's unmasked assignment."""

from repro_torch.kernels.kmeans_assign.ops import (  # noqa: F401
    K2Workspace, kmeans_assign, kmeans_assign_fused,
    kmeans_assign_fused_batched, kmeans_assign_fused_batched_plain,
    kmeans_assign_fused_plain, kmeans_assign_plain, silhouette_sums,
    silhouette_sums_plain,
)
