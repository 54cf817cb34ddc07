"""The port of the paper's primary contribution, GCL-Sampler.

graphs       SASS trace -> Heterogeneous Relational Graph (copy)
batching     packed, bucketed graph batching (copy)
precision    mixed-precision policy with torch dtypes
augment      packed augmented views (draws split from their application)
contrastive  symmetric InfoNCE
rgcn         RGCN encoder (nn.Module) + packed encode through K1 (K1b + K5
             in the backward)
train        contrastive trainer (fit, resume) + packed embedding with the
             content-hash cache
clustering   swept K-Means (K2) + silhouette K selection (K3)
sampler      the pipeline behind the port's `gcl` method (fit, embed, plan)
"""
