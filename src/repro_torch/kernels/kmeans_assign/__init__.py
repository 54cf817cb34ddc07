"""K2 / K3: fused K-Means assignment and blocked silhouette sums."""

from repro_torch.kernels.kmeans_assign.ops import (  # noqa: F401
    kmeans_assign_fused, kmeans_assign_fused_plain, silhouette_sums,
    silhouette_sums_plain,
)
