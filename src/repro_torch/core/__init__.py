"""The port of the paper's primary contribution, GCL-Sampler (serving).

graphs       SASS trace -> Heterogeneous Relational Graph (copy)
batching     packed, bucketed graph batching (copy)
precision    mixed-precision policy with torch dtypes
rgcn         RGCN encoder (nn.Module) + packed encode through K1
train        packed embedding with the content-hash cache
clustering   swept K-Means (K2) + silhouette K selection (K3)
sampler      the serving pipeline behind the port's `gcl` method
"""
