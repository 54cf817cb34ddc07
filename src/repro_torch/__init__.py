"""repro_torch — the GCL-Sampler ported to PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

It mirrors ``repro``'s layout and names so each module has a visible
counterpart, imports ``torch`` and ``numpy`` only (never ``jax``, nothing
of ``repro``), and is held against the JAX package by ``tests/test_torch_*``.

Main path: the paper's comparison grid
(``python -m repro_torch.launch.sample``), gcl / pka / sieve / stem_root
over programs and platforms through an ``ArtifactStore``; its gcl column::

    program -> trace -> HRG (ingest engine, graph store) -> pack_graphs
      -> (no encoder yet) contrastive fit: augmented views, RGCN forward
         (K1) and backward (K1b + K5), InfoNCE, AdamW
      -> RGCN encode_packed (K1) -> content-hash embedding cache
      -> multi-K masked K-Means sweep (K2) -> silhouette K selection (K3)
      -> plan_from_labels -> simulate_batch

pka runs the same sweep on 12 profiled features; sieve and stem_root are
numpy.  The sequential K-Means reference (``select_k_and_cluster``: K4 per
Lloyd step, K3 per candidate) serves ``PlanEngine(engine="sequential")``
and the ``errors="isolate"`` retry.

The LM zoo's serving entry point (``python -m repro_torch.launch.serve
--arch <id>``) runs batched prefill — attention through K7, the Mamba-2
SSD scan through K8, the MoE FFN in torch ops — and greedy KV / SSM-cache
decode over ``models/``, for every arch of the zoo.

Entry points take ``device=``: they run on ``cuda`` unless the caller asks
for ``"cpu"`` (as the tests do), and raise when no card is present.  A CUDA
tensor always goes to the hand-written kernel, a CPU tensor to the kernel's
plain PyTorch version beside it (``repro_torch.kernels``).
"""
