"""repro_torch — the GCL-Sampler ported to PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

It mirrors ``repro``'s layout and names so each module has a visible
counterpart, imports ``torch`` and ``numpy`` only (never ``jax``, nothing
of ``repro``), and is held against the JAX package by ``tests/test_torch_*``.

Main path::

    program -> trace -> HRG -> pack_graphs
      -> (no encoder yet) contrastive fit: augmented views, RGCN forward
         (K1) and backward (K1b + K5), InfoNCE, AdamW
      -> RGCN encode_packed (K1) -> content-hash embedding cache
      -> multi-K masked K-Means sweep (K2) -> silhouette K selection (K3)
      -> plan_from_labels -> simulate_batch

Entry points take ``device=``: they run on ``cuda`` unless the caller asks
for ``"cpu"`` (as the tests do), and raise when no card is present.  A CUDA
tensor always goes to the hand-written kernel, a CPU tensor to the kernel's
plain PyTorch version beside it (``repro_torch.kernels``).
"""
