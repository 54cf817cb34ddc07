#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device   the card's name and power limit (nvidia-smi) and torch's view;
2. build    the CUDA kernels built from ``src/repro_torch/csrc`` with nvcc
            for sm_90a, with the build time and ptxas's register /
            shared-memory report;
3. kernels  every kernel of the serving, training, sequential, dense and LM
            paths (K1 rgcn_fused, K2 kmeans_assign_fused, K3
            silhouette_sums, K5 rgcn_spmm_flat, K1b rgcn_fused_bwd, K6
            rgcn_spmm_dense, K4 kmeans_assign, K7 flash_attention, K8
            ssd_intra_chunk, K7b flash_attention_bwd, K8b
            ssd_intra_chunk_bwd) against its plain PyTorch version on the
            card
            at the main-path shapes (K5 / K1b at the embed path's first
            micro-batch and the fit's bucket, D 64 / 128, f32 and bf16,
            equal bits on a repeat, the table rows from the fit's bucket at
            D = 128 f32 with D = 64's times as ``d64_*`` keys; K1b also as
            the unit-norm backward paths call it — phi-2's first dense
            batch flattened, and the embed batch's padded tail on node 0 —
            timed against the same call with the padded edges' wnorm set
            to 0; the bytes bounds count the rows and edges the live edges
            need; K6 at phi-2's and cfd's first dense batch, D 64 / 128,
            f32 and bf16 (bytes bound from the h rows and edge slots the
            live edges need, s in full), plus E = 0 and a batch of
            padding at node 0, and the dense aggregation's backward on
            the card against the CPU;
            K2 also over a sweep's 47 candidates in one call
            (``kmeans_assign_fused_batched``, one Lloyd step of cfd's
            sweep), and K2 / K3 over the program axis (8 programs of one
            bucket in one call, bucket 4096 and the served mix's 64, each
            program bit-equal to its one-program call, timed against 8
            one-program calls and one library call over the 8 programs:
            the table's ``b8_*`` keys); K2 / K3 / K4
            also at PKA's feature width d = 12; K7
            also over hd 16/64/256, G 1/3/8, S 64/512/1536, f32 and bf16;
            K7b over hd 16/64/256, G 1/3, S 64/100/512, then at llama3.2-
            3b's training shape (8, 256, 8, 3, 128), its table row, and the
            prefill shape, f32 (1e-4) and bf16, a repeat bit-equal, with the
            backward of scaled_dot_product_attention as its library call;
            K8 also at mamba's smoke shape and a single 64-row chunk; K8b
            at mamba's smoke training shape, mamba2-780m's training shape
            (8, 1, 256, 48, 64, 128), its table row, and the prefill shape,
            with a random dy and nonzero dstates, f32 within 1e-4, a repeat
            bit-equal, its ptxas registers and spills); K7 also at the MoE
            archs' prefill shapes (dbrx / grok G = 6, jamba G = 4), K7b at
            dbrx's training shape (8, 256, 8, 6, 128), K8 at jamba's SSD
            prefill (nh = 128), each timed beside its plain version, its
            library call and its bound, with
            its time, the plain version's, one library call's where there
            is one, and the least time the card could take (bound); K1 and
            K8, whose float32 products run as 3xTF32 on the tensor cores,
            also with that design's bound (three passes at the TF32 rate),
            ptxas's registers and spills, and equal bits on a second call.
            Each device time comes from a torch.profiler record that holds
            every launch of the timed calls (``profile_verdict``) and is
            printed with ``[cupti]``, or else is the spin-primed device span
            and printed with ``[spin-primed]``;
4. reference the JAX-trained encoder committed in
            ``src/repro_torch/assets/reference_phi2.npz``: the card embeds
            and plans phi-2 and cfd and must match the JAX results stored
            there (embeddings 1e-4 relative, equal K and representatives,
            eq. 5 / eq. 6 within 1e-6);
4b. dense  the dense encoder path with the same fixture encoder:
            ``ContrastiveTrainer.embed_dense`` of all of phi-2 and cfd
            (``pad_batch`` of the whole program, batches of 64, K6 in each
            of the 3 layers) within 1e-4 of the fixture's embeddings and of
            the port's packed ``embed`` on the card; both programs planned
            from the dense embeddings with the fixture's K and
            representatives; K6 launched 3 x the number of batches (its
            ``launches`` in the kernel table); dense and packed embed times,
            cold and warm.  Then the dense InfoNCE loss and its gradient on
            16 phi-2 training graphs, card against CPU with the same draws
            (loss 1e-5, gradient 1e-3 of its norm), and ``encode`` /
            ``encode_packed`` with ``use_vstats=False, relations_used=(0,)``
            on the card against the CPU (1e-4);
5. serve    a PlanService answers submit_program for cfd, phi-2 and nw with
            that encoder; the serving kernels' launch counts (zeroed just
            before) must be > 0, a sweep dispatch may make at most
            iters + 1 K2 calls (``SweepCount``), and no request may fail;
            mean batch, dispatches and K2 / K3 calls a plan are logged;
5a. sweep_batch 8 programs of one bucket (the served mix's 64, and 4096)
            at the engine's defaults in one sweep dispatch: each program's
            labels, K and scores bit-equal to its one-program dispatch;
            the dispatch's peak memory and host wall;
5b. plan_serve the plan-serving load path: ``repro_torch.launch.
            plan_serve.main`` on the card at JAX's CLI defaults (120
            requests, d 16, k_max 8, iters 10, max_batch 8, max_delay 5
            ms) and at the gcl engine's defaults (d 256, k_max 48, iters
            50), each at 0.5x and 3x the closed-loop capacity (plans/s of
            a warm ``PlanEngine.plan_many`` over the same fleet): p50 /
            p99 / mean latency, plans/s, occupancy, queue depth, flush
            causes, and the first request's latency cold and after
            ``warmup``.  No request may fail, every served plan must equal
            its closed-loop plan (labels, K, representatives), and K2 and
            K3 must have been launched; the closed loop's dispatches and
            mean batch, the served runs' dispatches, mean batch and K2 / K3
            calls a plan, and ``SweepCount``'s iters + 1 a dispatch;
5c. fault  the fault protocol and the sanitizer on the card: on-device
            kmeans++ (``init="device"``) fed the same Gumbel rows on the
            card and on the CPU (equal indices) at cfd's fixture
            embeddings (k_max 48) and a plan_serve request (d 16, k_max 8);
            the sweep and the sequential reference seeded on the card
            (equal labels and K), the device init's ms a program against
            the numpy host init's, and K with each; a PlanService with
            ``init="device"`` at the engine defaults (d 256, k_max 48,
            iters 50) serving plans equal to its closed-loop plans inside
            ``recompile_guard(0)``; a DeviceLost injected into a
            ``data_devices=2`` service (every request served, one degraded
            dispatch, width 1) and a poisoned request through
            ``sanitize=True`` (only its future fails, one trip); then the
            default phi-2 fit raising DeviceLost at its first chunk
            boundary after checkpointing, and ``fit_resilient`` finishing
            every step with parameters bit-equal to an uninterrupted fit;
6. train    three training steps of the full-width encoder on the card
            against the same steps on the CPU with the same draws (loss
            1e-5, parameters 1e-4 relative);
7. resume   a fit interrupted at a checkpoint and resumed against the
            uninterrupted fit, on the card (parameters 1e-5; whether the
            bits are equal is printed);
8. fit      the default fit on phi-2 (120 steps, batch 16, subsample 400):
            losses, validation, steps/s, launches of K1 / K1b / K5, then the
            same fit under torch.profiler for the busy share, the split of
            its device time (K1, K1b, K5 with their us a launch) and top
            ops;
8s. staging the one-ahead staging (``GCLTrainConfig.prefetch``) and bf16
            messages (``RGCNConfig.message_dtype``): the default phi-2 fit
            with prefetch off, on, on, off (parameters, history and
            val_loss bit-equal; steps/s, stage / wait seconds and overlap,
            warm after phase 8), ``embed`` and ``embed_stream`` of all of
            phi-2 from a cold cache in the same turns (embeddings
            bit-equal, wall seconds), phi-2's first micro-batch encoded
            with bf16 against float32 messages (gap > 0 and at most 5e-3
            of the largest |z|, K1 launched), and a 32-step fit with bf16
            messages (finite losses whose last quarter's mean is below the
            first's; K1 / K1b / K5 launched);
8a. data_parallel the data-parallel fit and the placed sweep on the card,
            at the default encoder's width (``RGCNConfig()``, the default
            optimizer; 32 steps, fault boundaries and checkpoints every 8)
            on the phi-2 training graphs, which reach the spawned ranks
            through a file (the library, built in phase 1, is loaded, not
            built, by each rank): two ranks of a gloo group, both on
            ``cuda:0``, fit within RESUME_TOL (parameters) / LOSS_TOL
            (losses) of the one-rank fit on the card, every rank with the
            same bits; a refit and an interrupted-then-resumed fit at width
            2 bit-equal to it; ``fit_resilient`` going 2 -> 1 on an injected
            DeviceLost and finishing every step with ``data_shards`` 1;
            ``compressed_psum_mean`` within JAX's grid (amax / 127) of
            ``psum_mean`` over the two ranks, on tensors of the encoder's
            shapes; a one-rank NCCL group's fit bit-equal to the fit with
            no group; K1 / K1b / K5 launches a step of each rank equal to
            the one-rank fit's; step ms and collective bytes a step at
            widths 1 and 2 beside the card's name and power limit (two
            ranks sharing one card check correctness, not scaling); then
            ``PlanEngine(data_devices=2, devices=[cuda:0, cuda:0])``:
            labels, K and scores bit-equal to the unplaced dispatch, JAX's
            dispatch count, K2 and K3 launched;
8b. model_parallel LM model sharding (A9c): K7 and K7b at a (2, 2)
            rank's shape (MP_TP_SHAPE, bf16) against their plain versions,
            timed beside them, SDPA and their bounds (the table's ``tp_*``
            keys); llama3.2-3b at its widths, MP_LAYERS layers, JAX's CLI
            batch, MP_STEPS steps through ``launch.train.main`` on one card,
            then on a (2, 2) mesh of four gloo ranks sharing ``cuda:0``
            (``main(mesh=)``; each rank holds MP_RANK_PARAMS of
            MP_WHOLE_PARAMS parameters, the vocabulary, attention and the
            dense FFN split over the model axis): its losses within
            MP_LOSS_TOL of the one-card run's and equal on every rank,
            each rank's state bytes the specs' count, its collective bytes
            a step equal to ``ShardPlan.collective_bytes`` and below
            MP_WHOLE_TABLE_BYTES, K7 and K7b launched in its run (counts
            zeroed just before ``main``) on MP_TP_SHAPE only; each
            rank's step ms, peak and state bytes beside the card's name
            and power limit; then MP_PARITY_STEPS float32 steps at smoke
            width on the mesh within PARAM_TOL of each leaf of the
            one-card steps on the card; then MP_MB_STEPS steps of
            ``--microbatch MP_MICROBATCH`` on the mesh (JAX's gradient
            accumulation: each data rank its rows of each micro-batch)
            against the same on one card at MP_LOSS_TOL, equal on every
            rank, the bytes the plan counts; every step under JAX's
            default remat (each block's gathers and forward sums run
            again in the backward, counted); a hung rank is killed after
            MP_DEADLINE s;
8c. model_split the SSM split over the model axis (A9d): K8 and K8b at
            a (2, 2) rank's shape (MP_SSM_SHAPE, f32) against their plain
            versions, timed beside them and their bounds (the table's K8 /
            K8b ``tp_*`` keys); mamba2-780m at its widths, MP_SSM_LAYERS
            layers, MP_SSM_STEPS steps at JAX's CLI batch through
            ``launch.train.main`` on one card, then on the (2, 2) mesh of
            four gloo ranks sharing ``cuda:0`` (the vocabulary and the
            SSM's heads split): losses within MP_LOSS_TOL of the one card's
            and equal on every rank, collective bytes a step equal to
            ``ShardPlan.collective_bytes``, K8 and K8b launched in the
            ranks' run (counts zeroed just before) on the rank's shape
            only; each rank's step ms, peak and state bytes;
8d. model_split the MoE experts' ``ffn`` and the untied head's vocabulary
            split (A9d): K7 and K7b at a (1, 4) rank's q (MP_MOE_TP_SHAPE,
            bf16) against their plain versions, timed beside them, SDPA
            and their bounds (the table's ``tp14_*`` keys); dbrx-132b at
            its widths, MP_MOE_LAYERS layer, bf16 moments, MP_MOE_STEPS
            steps through ``steps.make_sharded_train_step`` on a (1, 4)
            mesh of four gloo ranks sharing ``cuda:0`` (the ranks draw the
            whole tree in turn and keep their blocks), against the same
            steps on one card in a process of its own before the ranks
            start: the checks of 8c with K7 / K7b on MP_MOE_TP_SHAPE only,
            and the four ranks' peaks; each of 8c / 8d kills its ranks
            after MP_SPLIT_DEADLINE s;
8e. model_serve sharded LM serving (A9f): K7 at a (2, 2) serving rank's
            q (SERVE_K7_SHAPE, bf16) and K8 at its (SERVE_K8_SHAPE, f32)
            against their plain versions, timed beside them and their
            bounds (the table's ``serve_*`` keys, with a rank's launches
            and the shape); then each SERVE_MP_RUNS arch (llama3.2-3b and
            mamba2-780m at their widths, 2 layers), in bf16 and again in
            float32 (SERVE_MP_DTYPES), served on one card
            (``tf.prefill`` and ``tf.decode_step``, greedy:
            SERVE_MP_BATCH prompts of SERVE_MP_PROMPT tokens,
            SERVE_MP_TOKENS tokens) and through
            ``steps.make_sharded_prefill_step`` / ``make_sharded_decode_
            step`` on MP_MESH, four gloo ranks sharing ``cuda:0``, fed the
            one card's tokens: every step's unsharded logits within the
            dtype's SERVE_MP_TOL of the one card's largest logit, the
            ranks' own greedy picks (``step.argmax``) equal to the one
            card's: every pick in float32, in bf16 wherever its top two
            logits differ by more than twice the step's error (printed:
            how many are held), each rank's
            collective bytes a step equal to ``collective_bytes(kind=)``,
            its params and decode-state blocks the plan's (its k cache
            ceil(max_seq / 2) positions of its 2 rows), K7 / K8 launched
            once a layer in its run (counts zeroed just before) on the
            rank's shape only; prefill and decode ms (gloo through the
            host) and peaks beside the one card's; then llama in bf16
            with ``decode_split`` DECODE_SPLIT_CHUNKS over a cache of
            SERVE_MP_PROMPT + 2 SERVE_MP_TOKENS positions on the mesh
            (JAX's split softmax, each rank's chunks merged over the
            model ranks), its logits within the bf16 SERVE_MP_TOL of the
            one card's unsplit ones and its bytes the counted; the ranks
            are killed after SERVE_MP_DEADLINE s;
9. fit+serve a fresh ``gcl`` method with no encoder behind a PlanService:
            submit_program(phi-2) fits its own encoder (prepare), then cfd,
            phi-2 and nw are served with it; K, eq. 5 and eq. 6 are printed
            beside the JAX-trained fixture's (reported, not held equal: the
            draws differ); every kernel's launch count over this run must
            be > 0 and no request may fail;
10. sequential the sequential K-Means reference on the card (K4 per Lloyd
            step, K3 per candidate): ``select_k_and_cluster`` on the
            fixture encoder's phi-2 and cfd embeddings must give the K,
            labels and representatives JAX's sequential path gave
            (``src/repro_torch/assets/reference_grid.json``), scores within
            1e-3 of the exact silhouettes of JAX's labels; then
            ``PlanEngine(engine="sequential")``; then the ``errors=
            "isolate"`` retry with the sweep patched to fail one of three
            requests, which the sequential path must serve (equal to the
            sequential engine's plan, no error, K4 launched).  Its K4 count
            is K4's ``launches`` in the kernel table;
11. grid     the paper's comparison grid through ``repro_torch.launch.
            sample.run_grid``: gcl (fitting its own encoder), pka, sieve and
            stem_root over the 11 paper programs on P1-P3.  The results
            validate, no cell fails, every pka / sieve / stem_root row
            equals JAX's (fixture: K, representatives, eq. 5, eq. 6), the gcl
            rows are printed beside JAX's; a second run on the same
            directory replays (no fit, gcl prepare under a tenth of the
            first run's).  This is the slice's main path: its counts are the
            ``launches`` of K1, K1b, K2, K3 and K5 in the kernel table (K2's
            count batched calls, at most iters + 1 a sweep dispatch; the
            sweep dispatches and their programs are logged);
12. lm_reference the JAX fixture ``src/repro_torch/assets/reference_lm.npz``
            (smoke-width llama3.2-3b and mamba2-780m at two layers, and
            jamba-v0.1-52b at one block of 8 layers with its MoE FFNs routed
            in two groups of 512; f32, B=2, a 1024-token prompt): the card's
            prefill logits and its decode logits fed JAX's 16 greedy tokens
            within 1e-4 relative, the same greedy picks where JAX's top two
            logits are clear, and K7 / K8 once per attention / mamba layer;
13. lm_serve ``repro_torch.launch.serve.main`` for llama3.2-3b and
            mamba2-780m at full width and depth, then dbrx-132b (2 of 40
            layers), grok-1-314b (1 of 64) and jamba-v0.1-52b (8 of 32) at
            full width, then granite-3-2b, qwen2-72b, yi-34b, paligemma-3b
            and musicgen-medium at full width and the depth the dry run
            picks (all layers where its serving peak with 10 % headroom
            fits the card, else the most whole blocks that do; printed)
            (2 batches x 4 requests of a 2048-token prompt, paligemma's 256
            image tokens among them, + 32 greedy tokens): prefill ms, decode
            tok/s, peak memory, finite logits; K7 launched once per
            attention layer and prefill, K8 once per mamba layer and
            prefill (these counts are K7's and K8's ``launches``); the dry
            run of each prefill beside the second batch's (predicted peak
            against the measured one, the bound against the measured ms,
            the model FLOPs' share of the bf16 peak), the predicted peak
            held within 10 % and the roofline share at most 1.05 for the
            first five archs; then decode-vs-prefill at full
            width (prefill 1536, decode 512 teacher-forced, against the
            prefill of all 2048 at its last position) in bf16 at full
            depth and in f32 at 4 layers, with 8 decode steps profiled for
            the step's device / host split, and one bf16 mamba prefill
            (4 x 2048) profiled for its top device ops and K8's share;
            then llama3.2-3b's decode with JAX's split softmax
            (``decode_split`` DECODE_SPLIT_CHUNKS, 32 teacher-forced
            steps after a 2048-token prefill) against the unsplit decode
            from the same caches within DECODE_TOL, tok/s of each;
14. lm_train ``repro_torch.launch.train.main`` at full width and depth
            and JAX's CLI defaults (batch 8 x 256 tokens, lr 3e-4, 20
            warmup steps) for llama3.2-3b (28 layers, 30 steps) and
            mamba2-780m (48 layers, 20 steps): step ms (median after the
            first), steps/s, tokens/s, peak memory, the loss of the first
            and last steps (finite and falling), under JAX's default remat
            (every block recomputed in the backward): K7 (llama) or K8
            (mamba) twice per layer a step, K7b or K8b once, and the other
            pair never (these counts are K7b's and K8b's ``launches``); 2
            more steps of
            each under torch.profiler (busy share, the device time split
            into K7, K7b, K8, K8b, matmuls, copies and the rest); then
            dbrx-132b at full width and 1 layer, 10 steps of
            ``launch/steps.make_train_step`` with bf16 moments (step ms,
            peak memory, finite losses, K7 twice and K7b once a step); the
            dry run of each of these three steps beside its median step
            and peak, held as phase 13's; then the remat turns: llama and
            mamba REMAT_STEPS steps under remat off, "full" and "dots"
            from the same seed (step ms, peak, launches a step, the dry
            run's peak held as phase 13's, the largest loss and leaf-sum
            difference between the policies); llama at 8 x LONG_SEQ,
            full depth, LONG_STEPS steps under remat (its peak held to the
            dry run's; the dry run of the same step without remat printed
            beside the card's memory); then 8
            llama steps at full width and 2 layers against 4 steps, a
            checkpoint and ``--resume auto`` (losses, params and moments
            bit-equal); then one step of llama and mamba at smoke width, 2
            layers, and of jamba at one block of 8 layers, f32, on the card
            and on the CPU (loss 1e-5, every gradient leaf 1e-3 and every
            parameter leaf after the update 1e-4 of its norm); the
            phase within LM_TRAIN_DEADLINE s;
15. dryrun ``python -m repro_torch.launch.dryrun --all``, started on the
            host (no card) beside phase 2 and read here: one line per (arch
            x shape) cell (fits, argument and temp GiB, FLOPs, the compute
            and memory terms, the dominant one), every applicable cell
            ``ok`` and ``long_500k`` skipped on the pure-attention archs;
            the roofline's HBM_BYTES within 3 % of the card's memory;
16. lint  ``python -m repro_torch.analysis.lint --check-baseline`` on this
            checkout (no card): rc 0, the findings equal to
            ``src/repro_torch/analysis/baseline.json``;
17. examples the five twins ``examples/*_torch.py`` in this process
            through ``main(argv)`` on the card at their defaults (output
            paths in a fresh temporary directory): rc 0, the lines their
            originals print with a finite error and speedup, each twin's
            hand kernels launched (quickstart, sampled_simulation,
            train_sampler: K1, K1b, K5, K2, K3; serve_lm: K8; lm_pretrain:
            K7, K7b), and each twin's wall time on an ``[examples]`` line.

Any mismatch or exception exits non-zero.  The last lines are the kernel
table as one JSON object (K1's and K8's ``bound_ms`` is their 3xTF32
design's bound, with the float32-FMA bound as ``fma_bound_ms``), the card's
name and power limit, and ``{"ok": true, "device": {...}}``.  It needs one CUDA card and the
repository's ``src/`` beside it; it imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "src" / "repro_torch" / "assets" / "reference_phi2.npz"
GRID_FIXTURE = FIXTURE.parent / "reference_grid.json"
LM_FIXTURE = FIXTURE.parent / "reference_lm.npz"

KERNEL_TOL = 1e-5       # max |kernel - plain| / max |plain|
# Training on the card against the CPU.  The encoder's gradient jumps where
# a pre-activation crosses zero (ReLU), and the card's forward differs from
# the CPU's by ~1e-6, enough to move one element across: on the CPU, one
# such flip moves one basis gradient by 2.5e-3 of its largest element and
# the whole gradient by ~2e-4 of its norm, and three Adam steps later the
# whole parameter vector by ~3e-6 of its norm (zero-initialized biases by
# up to 8e-4 of theirs).  Gradients and parameters are therefore held as
# whole vectors, relative to their norms; per-leaf gaps are printed.
LOSS_TOL = 1e-5         # card vs CPU training loss, relative, every step
GRAD_TOL = 1e-3         # card vs CPU step-0 gradient, relative norm
PARAM_TOL = 1e-4        # card vs CPU parameters after step 3, relative norm
RESUME_TOL = 1e-5       # resumed vs uninterrupted fit on the card, ditto
#: how the fit's device time is split in the report (first match wins)
FIT_SPLIT = (
    ("K1 rgcn_fused_tf32_kernel", ("rgcn_fused_tf32_kernel",)),
    ("K1b rgcn_fused_bwd_kernel", ("rgcn_fused_bwd_kernel",)),
    ("K5 rgcn_spmm_flat_kernel", ("rgcn_spmm_flat_kernel",)),
    ("CSR views (sort, searchsorted)", ("RadixSort", "radix", "searchsorted",
                                        "Sort")),
    ("matmuls (cuBLAS / CUTLASS)", ("gemm", "Gemm", "cutlass", "sm90_xmma",
                                    "splitKreduce")),
    ("copies and fills", ("Memcpy", "Memset")),
)
#: the kernels the serving path launches (K1-K3); fitting adds K5 and K1b
SERVE_KERNELS = ("rgcn_fused_flat", "kmeans_assign_fused",
                 "kmeans_assign_fused_batched", "silhouette_sums")
EMBED_TOL = 1e-4        # card embeddings vs the JAX fixture, relative
DENSE_BATCH = 64        # embed_dense's batch of graphs
METRIC_TOL = 1e-6       # eq. 5 / eq. 6 vs the JAX fixture, absolute
#: card sequential scores vs the exact float64 silhouette of JAX's labels
#: (JAX's own float32 scores sit up to 7.6e-3 from it on phi-2, whose 1125
#: points are copies of 15 rows; the gap to them is printed)
SCORE_TOL = 1e-3
#: K4: labels must equal plain's where plain's two smallest distances are
#: further apart than this share of the row's distance scale |x|^2 + |c|^2
TIE_TOL = 1e-6
PLATFORMS = ["P1", "P2", "P3"]
#: the LM serving path: both archs at full width, 2 batches x 4 requests of
#: a 2048-token prompt + 32 greedy tokens
LM_ARCHS = ("llama3.2-3b", "mamba2-780m")
#: the archs of the JAX fixture ``reference_lm.npz``
LM_FIXTURE_ARCHS = LM_ARCHS + ("jamba-v0.1-52b",)
LM_BATCH, LM_PROMPT, LM_TOKENS, LM_REQUESTS = 4, 2048, 32, 2
LLAMA_PREFILL = (LM_BATCH, LM_PROMPT, 8, 3, 128)     # K7: (B, S, K, G, hd)
MAMBA_PREFILL = (LM_BATCH, LM_PROMPT // 256, 256, 48, 64, 128)  # K8
#: the MoE archs served at full width and a cut depth (layers): dbrx 2 of
#: 40, grok 1 of 64, jamba one period block of 8 of 32 (1 attention layer,
#: 7 mamba layers, 4 MoE FFNs); the same requests as LM_ARCHS
MOE_SERVE = (("dbrx-132b", 2), ("grok-1-314b", 1), ("jamba-v0.1-52b", 8))
#: K7 / K7b / K8 at the MoE archs' shapes: dbrx's and grok's prefill q
#: (G = 6), jamba's (G = 4), dbrx's training shape, jamba's SSD prefill
#: (nh = 128)
DBRX_PREFILL = (LM_BATCH, LM_PROMPT, 8, 6, 128)
JAMBA_PREFILL = (LM_BATCH, LM_PROMPT, 8, 4, 128)
DBRX_TRAIN = (8, 256, 8, 6, 128)
JAMBA_SSD_PREFILL = (LM_BATCH, LM_PROMPT // 256, 256, 128, 64, 128)
BF16_TOL = 2 ** -7      # a bf16 kernel output vs plain: one bf16 rounding
#: K7's log-sum-exp output vs ``torch.logsumexp`` of the plain scaled
#: scores, relative to the largest (float32 sums in another order; the
#: wgmma kernel's exp2 on the special-function unit)
LSE_TOL = 1e-5
#: the kernels K2's, K3's and K4's wrappers launch per call (``device_ms``'s
#: ``own``)
K2_KERNELS = {"k2_prep_kernel": 1, "k2_assign_kernel": 1,
              "k2_stats_kernel": 1, "k2_reduce_kernel": 1}
K3_KERNELS = {"sil_rows_kernel": 1, "sil_compact_kernel": 1,
              "silhouette_sums_kernel": 1}
K4_KERNELS = {"k4_assign_kernel": 1}
#: K1's and K8's (3xTF32 tensor cores, ``csrc/tf32x3.cuh``)
K1_KERNELS = {"rgcn_fused_tf32_kernel": 1}
K8_KERNELS = {"ssd_cb_tf32_kernel": 1, "ssd_chunk_tf32_kernel": 1}
#: K5's, K1b's and K6's (``csrc/csr_gather.cuh``)
K5_KERNELS = {"rgcn_spmm_flat_kernel": 1}
K1B_KERNELS = {"rgcn_fused_bwd_kernel": 1}
K6_KERNELS = {"rgcn_spmm_dense_kernel": 1}
#: the plan_serve phase: ``repro_torch.launch.plan_serve.main`` at JAX's
#: CLI defaults (120 requests, d 16, k_max 8, iters 10, max_batch 8,
#: max_delay 5 ms), then at the gcl engine's defaults and the encoder's
#: embedding width; each at two offered loads, these multiples of the
#: closed-loop capacity (``benchmarks/bench_serve_latency.py``'s factors)
PLAN_SERVE_RUNS = (("CLI defaults", {}),
                   ("engine defaults", {"d": 256, "k_max": 48, "iters": 50}))
PLAN_SERVE_CLI = {"d": 16, "k_max": 8, "iters": 10}   # the CLI's defaults
PLAN_SERVE_LOADS = (0.5, 3.0)
#: what a K2 row's ``launches`` counts
K2_COUNTED = ("calls of the batched K2: one per Lloyd step (and one final "
              "assignment) for all candidates of all programs of a sweep "
              "dispatch")
#: programs of a sweep dispatch for the program-axis kernel checks and the
#: batch-independence phase: the engine's max_batch (JAX's default)
PROGRAM_AXIS_B = 8
#: (label, points bucket, real points of program 0, silhouette rows) of
#: the program-axis kernel checks: the grid's largest bucket (cfd, lu)
#: and the served mix's (``synthetic_fleet``: 20-60 points)
PROGRAM_AXIS_SHAPES = (("bucket 4096 (cfd, lu)", 4096, 2425, 1200),
                       ("the served mix's bucket 64", 64, 60, None))
#: phase sweep_batch's programs in bucket 4096: program i has
#: SWEEP_BATCH_BIG[0] + i SWEEP_BATCH_BIG[1] points
SWEEP_BATCH_BIG = (2000, 250)
LM_TOL = 1e-4           # card (K7, K8, f32) vs the JAX fixture, relative
#: decode-vs-prefill: a prefill length must be a multiple of K7's 512-row
#: block and K8's 256-row chunk (1792 is not)
DECODE_SPLIT = 1536
#: decode-vs-prefill in bf16: twice the largest gap of the same check (4 x
#: 2048 tokens, split at 1536) at smoke width and full depth in bf16 on the
#: CPU, seeds 0 and 1 (``python tests/test_torch_lm.py --decode-gap``):
#: llama3.2-3b (28 layers) 2.9e-2 / 2.2e-2; mamba2-780m (48 layers) 1.8e-1
#: / 2.9e-1 — JAX's own bf16 decode differs from its prefill by 3.8e-1 /
#: 3.2e-1 there: the decode path rounds the SSM state, the conv window and
#: every projection to bf16 at each step.  In float32 the gap is 9.4e-6
#: (mamba, 48 layers), and the f32 check — at full width, depth cut to
#: DECODE_F32_LAYERS so that the random model's amplification of
#: summation-order differences stays small — is the sharp one, at ten
#: times that f32 gap.
DECODE_TOL = {"llama3.2-3b": 0.06, "mamba2-780m": 0.6}
DECODE_TOL_F32 = 1e-4
DECODE_F32_LAYERS = 4
#: JAX's flash-decoding split softmax (``decode_split``, as
#: ``benchmarks/perf_iterations.py`` sets it): llama3.2-3b at full width
#: and depth, bf16, a prefill of LM_PROMPT tokens into a cache of
#: LM_PROMPT + LM_TOKENS positions (2080 = 16 x 130), then LM_TOKENS
#: teacher-forced decode steps with and without the split, each step's
#: logits within the bf16 decode tolerance (DECODE_TOL) of the unsplit
#: step's largest logit; tok/s of each
DECODE_SPLIT_CHUNKS = 16
LM_PROFILE_STEPS = 8    # decode steps under torch.profiler
#: K7b (``csrc/flash_attention_bwd.cu``): the llama3.2-3b training shape
#: (JAX's CLI defaults, --batch 8 --seq-len 256) and the serving path's
#: prefill shape; float32 within 1e-4 of the plain recompute (relative to
#: the largest element), bfloat16 within one bfloat16 rounding of it
LLAMA_TRAIN = (8, 256, 8, 3, 128)
K7B_TOL_F32 = 1e-4
#: K8b (``csrc/ssd_intra_chunk_bwd.cu``): the mamba2-780m training shape
#: (JAX's CLI defaults, --batch 8 --seq-len 256: one chunk of 256) and the
#: serving path's prefill shape; within 1e-4 of the plain backward's
#: largest element (dcum is a difference of row and column sums over the
#: chunk's triangle, whose terms cancel, summed in other orders)
MAMBA_TRAIN = (8, 1, 256, 48, 64, 128)
K8B_TOL = 1e-4
K8B_KERNELS = {"ssd_bwd_dcb_tf32_kernel": 1, "ssd_bwd_dx_tf32_kernel": 1,
               "ssd_bwd_dbs_tf32_kernel": 1, "ssd_bwd_dbc_tf32_kernel": 1}
#: the lm_train phase: ``repro_torch.launch.train.main`` at full width and
#: JAX's CLI defaults (batch 8 x 256 tokens, lr 3e-4, 20 warmup steps) for
#: each of LM_TRAIN_RUNS: (arch, steps, the forward and backward wrappers
#: each of its layers launches once a step); LM_TRAIN_LAYERS layers (None:
#: all of them); then a resume check of the first arch at full width and
#: RESUME_LAYERS layers (RESUME_STEPS steps against half of them plus
#: ``--resume auto``), and one step of each arch card vs CPU at smoke
#: width, PARITY_LAYERS layers, float32
LM_TRAIN_RUNS = (
    ("llama3.2-3b", 30, ("flash_attention", "flash_attention_bwd")),
    ("mamba2-780m", 20, ("ssd_intra_chunk", "ssd_intra_chunk_bwd")),
)
#: how a profiled training step's device time is split (first match wins)
TRAIN_SPLIT = (
    ("K7 flash_attention", ("flash_attention_wgmma_kernel",)),
    ("K7b flash_attention_bwd", ("k7b_",)),
    ("K8 ssd_intra_chunk", tuple(K8_KERNELS)),
    ("K8b ssd_intra_chunk_bwd", tuple(K8B_KERNELS)),
    ("matmuls (cuBLAS / CUTLASS)", ("gemm", "Gemm", "cutlass", "sm90_xmma",
                                    "nvjet", "splitKreduce")),
    ("copies and fills", ("Memcpy", "Memset", "direct_copy")),
)
TRAIN_PROFILE_STEPS = 2
LM_TRAIN_LAYERS = None
RESUME_LAYERS, RESUME_STEPS = 2, 8
PARITY_LAYERS = 2
#: the step parity's archs (jamba at one block of 8 layers: attention,
#: SSM and MoE layers in one step) and whether the parameters after the
#: card's whole step are held to the CPU's at PARAM_TOL.  jamba's are not:
#: its deepest SSM layer's dt_bias starts at 0 and has a gradient element
#: within ~60x of Adam's eps, where the first update g / (|g| + eps)
#: magnifies the card's float32 summation-order noise on that element
#: ~60-fold (a relative gradient noise of 1e-5 of the leaf's largest
#: element gives a parameter gap of 5.8e-4 on the CPU alone).  For jamba
#: the card's optimizer is held instead to PARAM_TOL on the CPU's
#: gradients, and its gradients to GRAD_TOL; the whole step's gap is
#: printed.
PARITY_ARCHS = (("llama3.2-3b", True), ("mamba2-780m", True),
                ("jamba-v0.1-52b", False))
#: dbrx-132b trained at full width and MOE_TRAIN_LAYERS layer(s) with
#: bfloat16 moments (JAX's ``TrainConfig.opt_dtype``; its train CLI has no
#: flag for it, so the step of ``launch/steps.py`` is driven directly):
#: f32 params and grads, bf16 moments and compute copy, ~13 bytes a
#: parameter; with float32 moments it would be ~17
MOE_TRAIN = ("dbrx-132b", 1, 10)       # (arch, layers, steps)
#: phase 14's remat turns: each REMAT_ARCHS arch at full width and depth,
#: REMAT_STEPS steps of ``launch.train.main`` at JAX's CLI defaults from
#: the same seed and batches under each REMAT_POLICIES entry (JAX's CLI
#: has no remat flag: the launcher's ``get_arch`` is narrowed for the
#: call): step ms, peak, launches a step, the dry run's predicted peak
#: (held as phase 13's); the largest difference of the losses and of the
#: parameters' leaf sums between the policies is printed (the recompute
#: re-runs the same kernels on the same inputs)
REMAT_ARCHS = ("llama3.2-3b", "mamba2-780m")
REMAT_POLICIES = (("off", {"remat": False}),
                  ("full", {"remat": True, "remat_policy": "full"}),
                  ("dots", {"remat": True, "remat_policy": "dots"}))
REMAT_STEPS = 4
#: llama3.2-3b trained at 8 x LONG_SEQ tokens, full width and depth, under
#: JAX's default remat, LONG_STEPS steps: the dry run predicts its peak
#: within PEAK_TOL (held) and, without remat, more than the card holds
#: (printed)
LONG_SEQ, LONG_STEPS = 2048, 3
#: seconds phase 14 may take
LM_TRAIN_DEADLINE = 600
#: torch.profiler records ``device_ms`` takes of one call before it falls
#: back to the spin-primed span: CUPTI now and then drops part of a record
RECORD_TRIES = 3
#: the dry run (``repro_torch.launch.dryrun``) held to the card on the LM
#: steps phases 13 and 14 measure: its predicted peak (arguments + temp)
#: within PEAK_TOL of the measured one (``max_memory_allocated`` less what
#: was allocated before the step's arguments), and its roofline share
#: (``step_time_bound_s`` over the measured step) at most SHARE_MAX
PEAK_TOL = 0.10
SHARE_MAX = 1.05
#: the zoo's other five archs, served at full width and the depth the
#: dry run finds: the whole arch where its serving peak with PEAK_TOL of
#: headroom fits the card, else the most whole blocks that do
DEPTH_ARCHS = ("granite-3-2b", "qwen2-72b", "yi-34b", "paligemma-3b",
               "musicgen-medium")
#: ``python -m repro_torch.launch.dryrun --all`` runs on the host beside the
#: card phases (one process, no card) and must end within this many seconds
#: of its start
DRYRUN_TIMEOUT = 1000
#: the linter's run over the checkout (a few seconds on one host core)
LINT_TIMEOUT = 120


def log(*a):
    print(*a, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, iters, warmup=3):
    """Host-visible time of one call: CUDA events around ``iters`` calls
    (launch overhead and any host work in the call included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _spin_primed_ms(fn, iters):
    """Device time of one call from CUDA events around ``iters`` calls that
    the host queues while a spin kernel holds the stream, so the span holds
    the calls' device work back to back and no host launch time.  A spin
    that ended before the host had queued the calls is taken once more,
    four times as long (the host's pace varies on a shared machine); None
    when that one ends early too (a call that waits for the device)."""
    import torch

    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    for spans in (2, 8):
        primed = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # ``spans`` x the host's queueing time at the card's top clock,
        # <= 2 GHz
        torch.cuda._sleep(int(max(host_s, 1e-3) * spans * 2e9))
        primed.record()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        starved = primed.query()
        torch.cuda.synchronize()
        if not starved:
            return start.elapsed_time(end) / iters
    return None


class DeviceTime(NamedTuple):
    """Device time of one call in ms: every device event the call runs
    (``total``), the events named in ``own`` (``own``), and where the
    numbers come from: ``"cupti"`` (torch.profiler) or ``"spin-primed"``
    (``_spin_primed_ms``, the call's whole device span; then own = total)."""
    total: float
    own: float
    source: str

    def __str__(self):
        return f"{self.own:.4f} ({self.source})"


def profile_verdict(events, iters, expect=None, min_events=0):
    """Whether a torch.profiler record of ``iters`` calls holds all of them.

    ``events``: (name, count) of every device event in the record (kernels,
    copies, fills).  ``expect``: {kernel name: launches per call}; every
    name must appear exactly ``iters`` x its launches (counted over the
    events whose name contains it).  ``min_events``: for a call whose
    kernels cannot be listed (library kernels picked by shape), the device
    events of one call in a first recorded pass; the record must hold at
    least ``iters`` x that many.  A record with no events is refused.
    Returns (accepted, reason)."""
    events = list(events)
    seen = sum(c for _, c in events)
    if seen == 0:
        return False, "no device events recorded"
    for name, per_call in (expect or {}).items():
        got = sum(c for key, c in events if name in key)
        if got != iters * per_call:
            return False, (f"{name}: {got} launches recorded, expected "
                           f"{iters} x {per_call}")
    if seen < iters * min_events:
        return False, (f"{seen} device events recorded, expected at least "
                       f"{iters} x {min_events}")
    return True, "complete"


def profile_events(averages):
    """[(name, count, device us)] of the events of ``prof.key_averages()``
    that ran on the device."""
    out = []
    for ev in averages:
        t = getattr(ev, "self_device_time_total", None)
        t = ev.self_cuda_time_total if t is None else t
        if ev.count and t > 0:
            out.append((ev.key, ev.count, t))
    return out


def _record(fn, iters):
    """``profile_events`` of ``iters`` calls under torch.profiler.  One call
    runs first in a warm-up step, whose events are dropped, so CUPTI is
    already collecting when the recorded calls start."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return profile_events(prof.key_averages())


def device_ms(fn, iters, own=None) -> DeviceTime:
    """Device time of one call from torch.profiler (CUPTI), accepted only
    when the record provably holds every call (``profile_verdict``):
    ``own`` = {kernel name: launches per call} lists every kernel the
    wrapper launches, each of which must appear exactly ``iters`` x its
    count; without ``own`` the record must hold at least ``iters`` x the
    device events of one call recorded first.  A refused record is taken
    again, up to ``RECORD_TRIES`` records; then the number is the call's
    device span behind a spin kernel (``_spin_primed_ms``, which needs a
    call that does not wait for the device), and the source says so.
    Raises when neither can be had."""
    import torch

    fn()
    torch.cuda.synchronize()
    own = dict(own or {})
    min_events = 0
    if not own:
        for _ in range(RECORD_TRIES):
            min_events = sum(c for _, c, _ in _record(fn, 1))
            if min_events:
                break
    why = "the first recorded call held no device events"
    if own or min_events:
        for _ in range(RECORD_TRIES):
            events = _record(fn, iters)
            ok, why = profile_verdict([(k, c) for k, c, _ in events], iters,
                                      own, min_events)
            if ok:
                total = sum(t for _, _, t in events)
                mine = sum(t for k, _, t in events
                           if any(o in k for o in own))
                return DeviceTime(total / 1e3 / iters, mine / 1e3 / iters,
                                  "cupti")
    t = _spin_primed_ms(fn, iters)
    if t is None:
        raise RuntimeError(f"no device time: torch.profiler's record was "
                           f"refused ({why}) and the call waits for the "
                           f"device")
    log(f"[kernels] torch.profiler's record refused {RECORD_TRIES} times "
        f"({why}): "
        f"{t:.4f} ms is the call's device span behind a spin kernel")
    return DeviceTime(t, t, "spin-primed")


def own_split_ms(fn, iters, own):
    """{kernel: device ms a call} for each kernel of ``own`` ({name:
    launches per call}), from a torch.profiler record of ``iters`` calls
    that ``profile_verdict`` accepts, taken up to ``RECORD_TRIES`` times;
    None when every record is refused."""
    for _ in range(RECORD_TRIES):
        events = _record(fn, iters)
        ok, _ = profile_verdict([(k, c) for k, c, _ in events], iters, own)
        if ok:
            return {o: sum(t for k, _, t in events if o in k) / 1e3 / iters
                    for o in own}
    return None


def ptxas_report(kernel):
    """ptxas's registers and spill bytes of each compiled entry whose name
    holds ``kernel`` (the build's ``-Xptxas -v`` report), as text."""
    import re

    from repro_torch import kernels

    out, entry, spills = [], None, ""
    for line in kernels.BUILD_INFO.get("ptxas", "").splitlines():
        if "Compiling entry function" in line:
            entry = line if kernel in line else None
        elif entry and "spill stores" in line:
            st = re.search(r"(\d+) bytes spill stores", line)
            ld = re.search(r"(\d+) bytes spill loads", line)
            spills = (f"spills {st.group(1)} / {ld.group(1)} bytes (stores / "
                      f"loads)" if st and ld else "")
        elif entry and "registers" in line:
            kind = ("<bf16>" if "bfloat16" in entry
                    else "<float>" if f"{kernel}IfE" in entry else "")
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{kernel}{kind}: {regs.group(1) if regs else '?'} "
                       f"registers, {spills or 'spills not reported'}")
            entry = None
    return "; ".join(out) or f"{kernel}: not in this build's ptxas report"


def rel_err(got, want):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return err, err / max(scale, 1e-30)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import numpy as np
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    log(f"[device] nvidia-smi: {smi_line}")
    log(f"[device] numpy {np.__version__} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return smi_line


def phase_build():
    from repro_torch import kernels

    t0 = time.perf_counter()
    kernels.library()
    info = kernels.BUILD_INFO
    log(f"[build] {len(list(kernels.CSRC.glob('*.cu')))} sources -> "
        f"{info['path']} in {info['seconds']:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s, cached={info['cached']})")
    for line in info.get("ptxas", "").splitlines():
        line = line.strip()
        if line.startswith("==") or "Used" in line or "spill" in line \
                or "Compiling entry" in line:
            log(f"[build] {line}")


def _main_path_batch():
    """The first micro-batch ``embed`` packs for phi-2's distinct graphs
    (budget 4096 nodes / 8192 edges): the encoder's main-path bucket."""
    from repro_torch.core.batching import (
        bucket_size, graph_content_hash, pack_graphs, plan_microbatches,
    )
    from repro_torch.core.sampler import GCLSampler
    from repro_torch.tracing.programs import get_program

    seen = {}
    for g in GCLSampler(device="cpu").iter_graphs(get_program("phi-2")):
        seen.setdefault(graph_content_hash(g), g)
    graphs = list(seen.values())
    first = [graphs[i] for i in plan_microbatches(graphs)[0]]
    packed, _ = pack_graphs(first, pad_graphs_to=bucket_size(len(first), 8))
    return packed


def _k2_bytes(B, n, d, C, k, live):
    """Bytes one K2 call must move: per program x and pmask, the ``live``
    centroid rows of its candidates (the kernel reads no dead slot),
    labels and min distances (B, C, n), sums (C, k, d) and counts written
    once; the candidates' masks (C, k), shared by the programs, once."""
    return (B * (n * d * 4 + n * 4 + live * d * 4 + C * n * 8
                 + C * k * d * 4 + C * k * 4) + C * k * 4)


def _k2_batched_check(got, x, cent, cmask, pmask):
    """K2 over candidates against the plain version on the card: labels
    must equal plain's wherever the two nearest live centroids are further
    apart than TIE_TOL of the row's scale (|x|^2 plus the larger |c|^2);
    returns (pairs clear of near-ties, labels differing in all, max abs
    and scale-relative error of the min distance, relative error of sums
    and counts against the plain sums of the kernel's own labels)."""
    import torch

    from repro_torch.kernels.kmeans_assign.ops import (
        kmeans_assign_fused_batched_plain,
    )

    want = kmeans_assign_fused_batched_plain(x, cent, cmask, pmask)
    clear_n = flips = 0
    err = rel = sums_rel = 0.0
    for c in range(cent.shape[0]):
        _, clear, scale = _expected_labels(x, cent[c], cmask[c])
        require(torch.equal(got[0][c][clear], want[0][c][clear]),
                f"K2 batched candidate {c}: labels differ from plain outside "
                f"near-ties")
        clear_n += int(clear.sum())
        flips += int((got[0][c] != want[0][c]).sum())
        gap = (got[1][c] - want[1][c]).abs()
        err = max(err, float(gap.max()))
        rel = max(rel, float((gap / scale).max()))
        onehot = (torch.nn.functional.one_hot(got[0][c].long(),
                                              cent.shape[1]).float()
                  * pmask[:, None])
        sums_rel = max(sums_rel, rel_err(got[2][c], onehot.T @ x)[1],
                       rel_err(got[3][c], onehot.sum(0))[1])
    return clear_n, flips, err, rel, sums_rel


def phase_kernels(rows, dev):
    import numpy as np
    import torch

    from repro_torch.kernels.kmeans_assign.ops import (
        K2Workspace, kmeans_assign_fused, kmeans_assign_fused_batched,
        kmeans_assign_fused_batched_plain, kmeans_assign_fused_plain,
        silhouette_sums, silhouette_sums_plain,
    )
    from repro_torch.kernels.rgcn_fused.ops import (
        rgcn_fused_agg_flat, rgcn_fused_agg_flat_plain,
    )
    from repro_torch.launch.roofline import bound, tf32x3_bound

    rng = np.random.default_rng(0)

    # ---- K1 at the main path's packed bucket, every layer shape ----------
    packed = _main_path_batch()
    P, Q = len(packed["node_mask"]), len(packed["edge_mask"])
    src = torch.from_numpy(packed["edge_src"]).to(dev)
    dst = torch.from_numpy(packed["edge_dst"]).to(dev)
    wnorm = torch.from_numpy(packed["edge_mask"] * packed["edge_norm"]).to(dev)
    etype = torch.from_numpy(packed["edge_type"]).long()
    node_mask = torch.from_numpy(packed["node_mask"]).to(dev)
    q_live = int((wnorm != 0).sum())
    rows_live = int(torch.unique(dst[wnorm != 0]).numel())
    log(f"[kernels] K1 batch: P={P} Q={Q} live edges={q_live} "
        f"destination rows={rows_live}")
    k1 = None
    for D, O in ((64, 128), (128, 128), (128, 256)):
        for dt in (torch.float32, torch.bfloat16):
            nb = 2
            comb = torch.from_numpy(rng.standard_normal((4, nb))
                                    .astype(np.float32))
            coef = comb[etype].contiguous().to(dev)
            h = (torch.from_numpy(rng.standard_normal((P, D))
                                  .astype(np.float32)).to(dev)
                 * node_mask[:, None]).to(dt).contiguous()
            basis = torch.from_numpy((rng.standard_normal((nb, D, O))
                                      / np.sqrt(D)).astype(np.float32)).to(dev)
            args = (h, basis, src, dst, coef, wnorm, P)
            got = rgcn_fused_agg_flat(*args)
            torch.cuda.synchronize()
            want = rgcn_fused_agg_flat_plain(*args)
            err, rel = rel_err(got, want)
            require(rel <= KERNEL_TOL,
                    f"K1 D={D} O={O} {dt}: rel err {rel:.3e} > {KERNEL_TOL}")
            # timed as the staged paths call it: the edges were checked
            # by the call above, so the timed calls make no host sync
            call = lambda: rgcn_fused_agg_flat(*args, checked=False)  # noqa
            call_ms = time_ms(call, 50)
            wrap_ms, ms, ms_src = device_ms(call, 20, own=K1_KERNELS)
            plain_ms, _, plain_src = device_ms(
                lambda: rgcn_fused_agg_flat_plain(*args), 20)
            esz = h.element_size()
            bytes_ = (P * D * esz + Q * 4 * 2 + Q * nb * 4 + Q * 4
                      + nb * D * O * 4 + P * O * 4)
            ops = 2 * q_live * nb * D + 2 * rows_live * nb * D * O
            b_ms, b_by = bound(bytes_, ops)
            tc_ms, tc_by = tf32x3_bound(bytes_, ops)
            again = rgcn_fused_agg_flat(*args, checked=False)
            require(torch.equal(got, again),
                    f"K1 D={D} O={O} {dt}: two calls differ")
            dname = "f32" if dt == torch.float32 else "bf16"
            log(f"[kernels] K1 rgcn_fused D={D} O={O} h={dname}: "
                f"max_abs_err {err:.3e} rel {rel:.3e} (tol {KERNEL_TOL}), "
                f"repeat bit-equal; kernel device ms {ms:.4f} [{ms_src}] "
                f"(wrapper device ms {wrap_ms:.4f}, call ms {call_ms:.4f}) "
                f"plain device ms {plain_ms:.4f} [{plain_src}] bound_us "
                f"{b_ms * 1e3:.2f} ({b_by}, float32 FMAs); 3xTF32 design "
                f"bound_us {tc_ms * 1e3:.2f} ({tc_by})")
            if (D, O, dt) == (128, 256, torch.float32):
                # the bound of the work as the kernel does it (3xTF32);
                # the float32-FMA bound rides along as an extra key
                k1 = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=tc_ms,
                          bound_by=tc_by, library_ms=None,
                          fma_bound_ms=b_ms)
    log(f"[kernels] K1 ptxas: {ptxas_report('rgcn_fused_tf32_kernel')}")
    rows.append(("rgcn_fused_flat", "src/repro_torch/csrc/rgcn_fused.cu",
                 "src/repro/kernels/rgcn_fused/kernel.py:107",
                 rgcn_fused_agg_flat, k1))
    _k5_k1b(rows, dev, rng, {"embed batch": packed,
                             "training bucket": _training_batches(1)[0]})
    _k6(rows, dev, rng)

    # ---- K2 / K3 at the sweep's main-path shape (cfd: n=2425 -> 4096) ----
    n, d, k, n_real, n_sil = 4096, 256, 48, 2425, 1200
    centers = rng.standard_normal((k, d)).astype(np.float32) * 5
    lab_true = rng.integers(0, k, n)
    x_np = centers[lab_true] + rng.standard_normal((n, d)).astype(np.float32)
    x = torch.from_numpy(x_np.astype(np.float32)).to(dev)
    cent = torch.from_numpy(centers + 0.1 * rng.standard_normal((k, d))
                            .astype(np.float32)).to(dev)
    k_live = 40
    cmask = (torch.arange(k, device=dev) < k_live).float()
    pmask = (torch.arange(n, device=dev) < n_real).float()
    args = (x, cent, cmask, pmask)
    got = kmeans_assign_fused(*args)
    torch.cuda.synchronize()
    want = kmeans_assign_fused_plain(*args)
    require(torch.equal(got[0], want[0]), "K2 labels differ from plain")
    errs = [rel_err(g, w) for g, w in zip(got[1:], want[1:])]
    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    require(rel <= KERNEL_TOL, f"K2: rel err {rel:.3e} > {KERNEL_TOL}")
    call_ms = time_ms(lambda: kmeans_assign_fused(*args), 200)
    _, ms, ms_src = device_ms(lambda: kmeans_assign_fused(*args), 50,
                              own=K2_KERNELS)
    plain_ms, _, plain_src = device_ms(
        lambda: kmeans_assign_fused_plain(*args), 50)

    def k2_library():
        dist = torch.cdist(x, cent) ** 2
        dist = torch.where(cmask[None, :] > 0, dist, float("inf"))
        return torch.min(dist, dim=1)

    lib_ms, _, lib_src = device_ms(k2_library, 50)
    bytes_ = _k2_bytes(1, n, d, 1, k, k_live)
    ops = 2 * n * k_live * d + 2 * n * d + n_real * d
    b_ms, b_by = bound(bytes_, ops)
    log(f"[kernels] K2 kmeans_assign_fused n={n} d={d} k={k}: labels equal, "
        f"max_abs_err {err:.3e} rel {rel:.3e} (tol {KERNEL_TOL}) kernel "
        f"device ms {ms:.4f} [{ms_src}] (call ms {call_ms:.4f}) plain device "
        f"ms {plain_ms:.4f} [{plain_src}] library device ms {lib_ms:.4f} "
        f"[{lib_src}] (cdist^2 + mask + min) bound_us {b_ms * 1e3:.2f} "
        f"({b_by})")
    rows.append(("kmeans_assign_fused", "src/repro_torch/csrc/kmeans_assign.cu",
                 "src/repro/kernels/kmeans_assign/kernel.py:113",
                 kmeans_assign_fused_batched,
                 dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=lib_ms,
                      launches_counted=K2_COUNTED)))

    # ---- K2 over the sweep's candidates: one Lloyd step of cfd's sweep ---
    C = k - 1                                    # K = 2..48
    cent_b = torch.from_numpy(
        centers[None] + 0.1 * rng.standard_normal((C, k, d)).astype(
            np.float32)).to(dev)
    ks = torch.arange(2, k + 1, device=dev)
    cmask_b = (torch.arange(k, device=dev)[None] < ks[:, None]).float()
    args_b = (x, cent_b, cmask_b, pmask)
    ws = K2Workspace(C, n, k, d, dev)
    got = [t.clone() for t in kmeans_assign_fused_batched(*args_b, out=ws)]
    torch.cuda.synchronize()
    clear, flips, err, rel, sums_rel = _k2_batched_check(got, *args_b)
    require(rel <= KERNEL_TOL and sums_rel <= KERNEL_TOL,
            f"K2 batched: mind {rel:.3e} of the scale, sums {sums_rel:.3e}")
    call_ms = time_ms(lambda: kmeans_assign_fused_batched(*args_b, out=ws),
                      50)
    _, ms, ms_src = device_ms(
        lambda: kmeans_assign_fused_batched(*args_b, out=ws), 20,
        own=K2_KERNELS)
    plain_ms, _, plain_src = device_ms(
        lambda: kmeans_assign_fused_batched_plain(*args_b), 5)

    def k2_batched_library():
        dist = torch.cdist(x[None].expand(C, n, d), cent_b) ** 2
        dist = torch.where(cmask_b[:, None, :] > 0, dist, float("inf"))
        return torch.min(dist, dim=2)

    lib_ms, _, lib_src = device_ms(k2_batched_library, 20)
    live = int(ks.sum())
    bytes_ = _k2_bytes(1, n, d, C, k, live)
    ops = 2 * n * live * d + 2 * n * d + 2 * live * d + C * n_real * d
    b_ms, b_by = bound(bytes_, ops)
    log(f"[kernels] K2 kmeans_assign_fused_batched n={n} d={d} k={k} C={C} "
        f"(K = 2..{k}, {live} live slots): labels equal to plain on "
        f"{clear} of {C * n} (candidate, point) pairs clear of near-ties, "
        f"{flips} differ in all, max_abs_err min_sq {err:.3e}, {rel:.3e} of "
        f"the row's scale, sums of the kernel's labels rel err "
        f"{sums_rel:.3e} (tol {KERNEL_TOL}) kernel device ms {ms:.4f} "
        f"[{ms_src}] (call ms {call_ms:.4f}; the replaced design ran "
        f"{C} launches for this) plain device ms {plain_ms:.4f} "
        f"[{plain_src}] library device ms {lib_ms:.4f} [{lib_src}] "
        f"(batched cdist^2 + mask + min) bound_us {b_ms * 1e3:.2f} ({b_by})")
    rows.append(("kmeans_assign_fused_batched",
                 "src/repro_torch/csrc/kmeans_assign.cu",
                 "src/repro/kernels/kmeans_assign/kernel.py:113",
                 kmeans_assign_fused_batched,
                 dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=lib_ms,
                      launches_counted=K2_COUNTED)))

    sil = torch.zeros(n, device=dev)
    sil[torch.from_numpy(rng.choice(n_real, n_sil, replace=False)).to(dev)] = 1
    onehot = (torch.nn.functional.one_hot(want[0].long(), k).float()
              * sil[:, None]).contiguous()
    got = silhouette_sums(x, onehot)
    torch.cuda.synchronize()
    want3 = silhouette_sums_plain(x, onehot)
    err, rel = rel_err(got, want3)
    require(rel <= KERNEL_TOL, f"K3: rel err {rel:.3e} > {KERNEL_TOL}")
    call_ms = time_ms(lambda: silhouette_sums(x, onehot), 20)
    _, ms, ms_src = device_ms(lambda: silhouette_sums(x, onehot), 10,
                              own=K3_KERNELS)
    plain_ms, _, plain_src = device_ms(
        lambda: silhouette_sums_plain(x, onehot), 10)
    lib_ms, _, lib_src = device_ms(lambda: torch.cdist(x, x) @ onehot, 10)
    j_live = int((onehot != 0).any(1).sum())
    nnz = int((onehot != 0).sum())
    bytes_ = n * d * 4 + n * k * 4 * 2
    ops = 2 * n * j_live * d + 2 * n * nnz
    b_ms, b_by = bound(bytes_, ops)
    log(f"[kernels] K3 silhouette_sums n={n} d={d} k={k} live rows "
        f"{j_live}: max_abs_err {err:.3e} rel {rel:.3e} (tol {KERNEL_TOL}) "
        f"kernel device ms {ms:.4f} [{ms_src}] (call ms {call_ms:.4f}) plain "
        f"device ms {plain_ms:.4f} [{plain_src}] library device ms "
        f"{lib_ms:.4f} [{lib_src}] (cdist @ onehot) bound_us "
        f"{b_ms * 1e3:.2f} ({b_by})")
    rows.append(("silhouette_sums", "src/repro_torch/csrc/silhouette_sums.cu",
                 "src/repro/kernels/kmeans_assign/kernel.py:173",
                 silhouette_sums,
                 dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=lib_ms)))
    for shape in PROGRAM_AXIS_SHAPES:
        _program_axis(rows, dev, rng, *shape)


def _program_axis(rows, dev, rng, label, n, n_real, n_sil):
    """K2 (one Lloyd step of a sweep dispatch: C = 47 candidates) and K3
    (one candidate) over PROGRAM_AXIS_B programs of one points bucket in
    one call, each program its own points, live count and centroids:
    every program held to its plain version (K2 as ``_k2_batched_check``)
    and bit-equal to its own one-program call; device ms of the call, of
    the same programs as B one-program calls, and of the plain version;
    the bound.  The first shape's numbers ride on the K2 / K3 rows of the
    kernel table as ``b8_*`` keys."""
    import numpy as np
    import torch

    from repro_torch.kernels.kmeans_assign.ops import (
        K2Workspace, kmeans_assign_fused_batched,
        kmeans_assign_fused_batched_plain, silhouette_sums,
        silhouette_sums_plain,
    )
    from repro_torch.launch.roofline import bound

    B, k, d = PROGRAM_AXIS_B, 48, 256
    C = k - 1
    reals = [max(k + 1, n_real - b * (n_real // 24)) for b in range(B)]
    xs, cents = [], []
    for b in range(B):
        centers = rng.standard_normal((k, d)).astype(np.float32) * 5
        xs.append(centers[rng.integers(0, k, n)]
                  + rng.standard_normal((n, d)).astype(np.float32))
        cents.append(centers[None] + 0.1 * rng.standard_normal(
            (C, k, d)).astype(np.float32))
    x = torch.from_numpy(np.stack(xs)).to(dev)
    cent = torch.from_numpy(np.stack(cents)).to(dev)
    pmask = torch.stack([(torch.arange(n, device=dev) < r).float()
                         for r in reals])
    ks = torch.arange(2, k + 1, device=dev)
    cmask = (torch.arange(k, device=dev)[None] < ks[:, None]).float()
    ws = K2Workspace(C, n, k, d, dev, B)
    got = [t.clone() for t in kmeans_assign_fused_batched(x, cent, cmask,
                                                          pmask, out=ws)]
    torch.cuda.synchronize()
    clear = flips = 0
    err = rel = sums_rel = 0.0
    for b in range(B):
        c_, f_, e_, r_, s_ = _k2_batched_check([g[b] for g in got], x[b],
                                               cent[b], cmask, pmask[b])
        clear, flips = clear + c_, flips + f_
        err, rel, sums_rel = max(err, e_), max(rel, r_), max(sums_rel, s_)
        one = kmeans_assign_fused_batched(x[b], cent[b], cmask, pmask[b])
        require(all(torch.equal(g[b], o) for g, o in zip(got, one)),
                f"K2 program axis {label}: program {b} differs from its "
                f"one-program call")
    require(rel <= KERNEL_TOL and sums_rel <= KERNEL_TOL,
            f"K2 program axis {label}: mind {rel:.3e} of the scale, sums "
            f"{sums_rel:.3e}")
    ws1 = K2Workspace(C, n, k, d, dev)
    _, ms, ms_src = device_ms(
        lambda: kmeans_assign_fused_batched(x, cent, cmask, pmask, out=ws),
        10, own=K2_KERNELS)
    _, solo_ms, solo_src = device_ms(
        lambda: [kmeans_assign_fused_batched(x[b], cent[b], cmask, pmask[b],
                                             out=ws1) for b in range(B)],
        10, own={name: B for name in K2_KERNELS})
    # one call a record: a record of three held ~26000 device events, and
    # CUPTI dropped some of them (the plain version waits for the device,
    # so no spin-primed span can stand in)
    plain_ms, _, plain_src = device_ms(
        lambda: kmeans_assign_fused_batched_plain(x, cent, cmask, pmask), 1)

    def k2_library():            # every program and candidate in one call
        dist = torch.cdist(x[:, None], cent) ** 2        # (B, C, n, k)
        dist = torch.where(cmask[None, :, None, :] > 0, dist, float("inf"))
        return torch.min(dist, dim=3)

    lib_ms, _, lib_src = device_ms(k2_library, 10)
    live = int(ks.sum())
    bytes_ = _k2_bytes(B, n, d, C, k, live)
    ops = sum(2 * n * live * d + 2 * n * d + 2 * live * d + C * r * d
              for r in reals)
    b_ms, b_by = bound(bytes_, ops)
    log(f"[kernels] K2 program axis {label}: B={B} n={n} d={d} k={k} C={C} "
        f"(real points {reals[0]}..{reals[-1]}): every program bit-equal to "
        f"its one-program call; labels equal to plain on {clear} of "
        f"{B * C * n} pairs clear of near-ties, {flips} differ in all, "
        f"min_sq {rel:.3e} of the row's scale, sums rel err {sums_rel:.3e} "
        f"(tol {KERNEL_TOL}); kernel device ms {ms:.4f} [{ms_src}], "
        f"{B} one-program calls {solo_ms:.4f} [{solo_src}], plain device ms "
        f"{plain_ms:.4f} [{plain_src}] library device ms {lib_ms:.4f} "
        f"[{lib_src}] (cdist^2 + mask + min over the {B} programs and {C} "
        f"candidates) bound_us {b_ms * 1e3:.2f} ({b_by})")
    k2 = dict(b8_ms=ms, b8_solo_ms=solo_ms, b8_plain_ms=plain_ms,
              b8_library_ms=lib_ms, b8_bound_ms=b_ms, b8_bound_by=b_by,
              b8_max_abs_err=err)

    sil = torch.zeros(B, n, device=dev)
    for b, r in enumerate(reals):
        live_rows = (rng.choice(r, n_sil, replace=False) if n_sil
                     else np.arange(r))
        sil[b, torch.from_numpy(live_rows).to(dev)] = 1.0
    onehot = (torch.nn.functional.one_hot(got[0][:, C - 1].long(), k).float()
              * sil[..., None]).contiguous()
    got3 = silhouette_sums(x, onehot)
    torch.cuda.synchronize()
    err3 = rel3 = 0.0
    for b in range(B):
        e_, r_ = rel_err(got3[b], silhouette_sums_plain(x[b], onehot[b]))
        err3, rel3 = max(err3, e_), max(rel3, r_)
        require(torch.equal(got3[b], silhouette_sums(x[b], onehot[b])),
                f"K3 program axis {label}: program {b} differs from its "
                f"one-program call")
    require(rel3 <= KERNEL_TOL, f"K3 program axis {label}: rel err "
            f"{rel3:.3e} > {KERNEL_TOL}")
    _, ms3, ms3_src = device_ms(lambda: silhouette_sums(x, onehot), 10,
                                own=K3_KERNELS)
    _, solo3, solo3_src = device_ms(
        lambda: [silhouette_sums(x[b], onehot[b]) for b in range(B)], 10,
        own={name: B for name in K3_KERNELS})
    plain3, _, plain3_src = device_ms(
        lambda: silhouette_sums_plain(x, onehot), 3)
    lib3, _, lib3_src = device_ms(lambda: torch.cdist(x, x) @ onehot, 10)
    j_live = (onehot != 0).any(2).sum(1).tolist()
    nnz = (onehot != 0).sum((1, 2)).tolist()
    b3_ms, b3_by = bound(B * (n * d * 4 + n * k * 4 * 2),
                         sum(2 * n * j * d + 2 * n * z
                             for j, z in zip(j_live, nnz)))
    log(f"[kernels] K3 program axis {label}: B={B} n={n} d={d} k={k} live "
        f"rows {min(j_live)}..{max(j_live)}: every program bit-equal to its "
        f"one-program call; max_abs_err {err3:.3e} rel {rel3:.3e} (tol "
        f"{KERNEL_TOL}); kernel device ms {ms3:.4f} [{ms3_src}], {B} "
        f"one-program calls {solo3:.4f} [{solo3_src}], plain device ms "
        f"{plain3:.4f} [{plain3_src}] library device ms {lib3:.4f} "
        f"[{lib3_src}] (cdist @ onehot over the {B} programs) bound_us "
        f"{b3_ms * 1e3:.2f} ({b3_by})")
    if label == PROGRAM_AXIS_SHAPES[0][0]:
        table = {r[0]: r[4] for r in rows}
        table["kmeans_assign_fused_batched"].update(k2)
        table["silhouette_sums"].update(
            b8_ms=ms3, b8_solo_ms=solo3, b8_plain_ms=plain3,
            b8_library_ms=lib3, b8_bound_ms=b3_ms, b8_bound_by=b3_by,
            b8_max_abs_err=err3)


def _k4_inputs():
    """K4's inputs: cfd's fixture embeddings (n = 2425, d = 256, 5
    distinct rows; the table's row at k = 48) and PKA's cfd features
    (d = 12), each with kmeans++ rows as centroids, as the sequential
    reference seeds them; and standard normal points of the same shape,
    where no two distances tie."""
    import numpy as np

    from repro_torch.core.baselines.pka import pka_features
    from repro_torch.core.clustering import _kmeanspp_init
    from repro_torch.tracing.programs import get_program

    with np.load(FIXTURE) as z:
        emb = z["cfd:emb_distinct"][z["cfd:index"]]
    feats = pka_features(get_program("cfd"), "P1")
    noise = np.random.default_rng(0).standard_normal(emb.shape, np.float32)
    out = []
    for label, x, k in (("standard normal", noise, 48),
                        ("cfd embeddings", emb, 2), ("cfd embeddings", emb, 48),
                        ("cfd PKA features", feats, 48)):
        out.append((label, x, x[_kmeanspp_init(x, k, 0)]))
    return out


def _expected_labels(x, cent, cmask=None):
    """What an argmin with ties to the lowest index must give, decided on
    the distinct centroid rows (kmeans++ seeds duplicates: cfd has 5
    distinct embeddings among 2425 points): (the lowest live index holding
    the nearest distinct centroid, rows where the two nearest distinct
    centroids are further apart than TIE_TOL of the row's distance scale,
    that scale (n,): |x|^2 plus the larger |c|^2 of those two)."""
    import torch

    live = (torch.ones(len(cent), dtype=torch.bool, device=x.device)
            if cmask is None else cmask > 0)
    uniq, inv = torch.unique(cent[live], dim=0, return_inverse=True)
    idx = torch.nonzero(live).flatten()
    first = torch.full((len(uniq),), len(cent), dtype=torch.long,
                       device=x.device)
    first = first.scatter_reduce(0, inv, idx, reduce="amin")
    x2 = (x * x).sum(1)
    u2 = (uniq * uniq).sum(1)
    dist = torch.clamp_min(x2[:, None] - 2 * x @ uniq.T + u2[None], 0)
    if len(uniq) == 1:
        scale = x2 + u2[0]
        clear = torch.ones(len(x), dtype=torch.bool, device=x.device)
    else:
        top2 = torch.topk(dist, 2, dim=1, largest=False)
        scale = x2 + u2[top2.indices].max(1).values
        clear = top2.values[:, 1] - top2.values[:, 0] > TIE_TOL * scale
    return (first[torch.argmin(dist, dim=1)].to(torch.int32), clear,
            scale.clamp_min(1e-30))


def phase_k4(rows, dev):
    """K4 against its plain version at the sequential path's shapes; K2 /
    K3 at PKA's width d = 12 (the pka sweep's padded bucket)."""
    import numpy as np
    import torch

    from repro_torch.kernels.kmeans_assign.ops import (
        kmeans_assign, kmeans_assign_fused, kmeans_assign_fused_plain,
        kmeans_assign_plain, silhouette_sums, silhouette_sums_plain,
    )
    from repro_torch.launch.roofline import bound

    k4 = None
    for label, x_np, c_np in _k4_inputs():
        x = torch.from_numpy(np.ascontiguousarray(x_np)).to(dev)
        cent = torch.from_numpy(np.ascontiguousarray(c_np)).to(dev)
        n, d = x.shape
        k = cent.shape[0]
        lab, mind = kmeans_assign(x, cent)
        torch.cuda.synchronize()
        plab, pmind = kmeans_assign_plain(x, cent)
        expect, clear, scale = _expected_labels(x, cent)
        flips = int((lab != plab).sum())
        plain_off = int((plab != expect)[clear].sum())
        require(torch.equal(lab[clear], expect[clear]),
                f"K4 {label} k={k}: labels differ from the lowest-index "
                f"argmin outside near-ties")
        err = float((mind - pmind).abs().max())
        rel = float(((mind - pmind).abs() / scale).max())
        require(rel <= KERNEL_TOL,
                f"K4 {label} k={k}: min_sq err {rel:.3e} of the row's scale "
                f"> {KERNEL_TOL}")
        args = (x, cent)
        call_ms = time_ms(lambda: kmeans_assign(*args), 200)
        _, ms, ms_src = device_ms(lambda: kmeans_assign(*args), 50,
                                  own=K4_KERNELS)
        span_ms = _spin_primed_ms(lambda: kmeans_assign(*args), 50)
        plain_ms, _, plain_src = device_ms(
            lambda: kmeans_assign_plain(*args), 50)
        lib_ms, _, lib_src = device_ms(
            lambda: torch.min(torch.cdist(x, cent) ** 2, dim=1), 50)
        bytes_ = n * d * 4 + k * d * 4 + n * 4 * 2
        ops = 2 * n * k * d + 2 * n * d + 2 * k * d
        b_ms, b_by = bound(bytes_, ops)
        log(f"[kernels] K4 kmeans_assign {label} n={n} d={d} k={k} "
            f"({len(torch.unique(cent, dim=0))} distinct centroids): labels "
            f"the lowest-index argmin on {int(clear.sum())} rows clear of "
            f"near-ties (plain's differ there on {plain_off}; kernel vs "
            f"plain differ on {flips} rows in all), max_abs_err min_sq "
            f"{err:.3e}, {rel:.3e} of the row's scale (tol {KERNEL_TOL}) "
            f"kernel device ms {ms:.4f} [{ms_src}] (call ms {call_ms:.4f}, "
            f"device span behind a spin kernel {span_ms:.4f}) plain device "
            f"ms {plain_ms:.4f} [{plain_src}] library device ms "
            f"{lib_ms:.4f} [{lib_src}] (cdist^2 + min) bound_us "
            f"{b_ms * 1e3:.2f} ({b_by})")
        if (d, k) == (256, 48):
            k4 = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=lib_ms)
    rows.append(("kmeans_assign", "src/repro_torch/csrc/kmeans_assign_seq.cu",
                 "src/repro/kernels/kmeans_assign/kernel.py:43",
                 kmeans_assign, k4))

    # ---- K2 / K3 at d = 12: the pka sweep's bucket for cfd -------------
    _, feats, _ = _k4_inputs()[-1]
    n, n_real, d, k, k_live = 4096, len(feats), feats.shape[1], 48, 40
    xb = np.zeros((n, d), np.float32)
    xb[:n_real] = feats
    x = torch.from_numpy(xb).to(dev)
    cent = x[torch.arange(k, device=dev) * 50].contiguous()
    cmask = (torch.arange(k, device=dev) < k_live).float()
    pmask = (torch.arange(n, device=dev) < n_real).float()
    args = (x, cent, cmask, pmask)
    got = kmeans_assign_fused(*args)
    torch.cuda.synchronize()
    want = kmeans_assign_fused_plain(*args)
    expect, clear, scale = _expected_labels(x, cent, cmask)
    flips = int((got[0] != want[0]).sum())
    require(torch.equal(got[0][clear], expect[clear]),
            "K2 d=12: labels differ from the lowest-index argmin outside "
            "near-ties")
    err = float((got[1] - want[1]).abs().max())
    rel = float(((got[1] - want[1]).abs() / scale).max())
    require(rel <= KERNEL_TOL,
            f"K2 d=12: min_sq err {rel:.3e} of the row's scale")
    sums = want[2:]
    if flips:       # the sums follow the kernel's labels: the plain sums of those
        onehot = (torch.nn.functional.one_hot(got[0].long(), k).float()
                  * pmask[:, None])
        sums = (onehot.T @ x, onehot.sum(0))
    sums_rel = max(rel_err(g, w)[1] for g, w in zip(got[2:], sums))
    require(sums_rel <= KERNEL_TOL, f"K2 d=12: sums rel err {sums_rel:.3e}")
    _, ms, ms_src = device_ms(lambda: kmeans_assign_fused(*args), 50,
                              own=K2_KERNELS)
    plain_ms, _, plain_src = device_ms(
        lambda: kmeans_assign_fused_plain(*args), 50)
    bytes_ = _k2_bytes(1, n, d, 1, k, k_live)
    b_ms, b_by = bound(bytes_, 2 * n * k_live * d + 2 * n * d + n_real * d)
    log(f"[kernels] K2 kmeans_assign_fused d=12 n={n} k={k} (cfd PKA "
        f"features): labels the lowest-index argmin on {int(clear.sum())} "
        f"rows clear of near-ties ({flips} differ from plain in all), "
        f"max_abs_err min_sq {err:.3e}, {rel:.3e} of the row's scale, sums "
        f"rel err {sums_rel:.3e} (tol {KERNEL_TOL}) kernel device ms "
        f"{ms:.4f} [{ms_src}] plain device ms {plain_ms:.4f} [{plain_src}] "
        f"bound_us {b_ms * 1e3:.2f} ({b_by})")
    sil = (torch.arange(n, device=dev) < 1200).float()
    onehot = (torch.nn.functional.one_hot(want[0].long(), k).float()
              * sil[:, None]).contiguous()
    got3 = silhouette_sums(x, onehot)
    torch.cuda.synchronize()
    want3 = silhouette_sums_plain(x, onehot)
    err, rel = rel_err(got3, want3)
    require(rel <= KERNEL_TOL, f"K3 d=12: rel err {rel:.3e} > {KERNEL_TOL}")
    _, ms, ms_src = device_ms(lambda: silhouette_sums(x, onehot), 10,
                           own=K3_KERNELS)
    plain_ms, _, plain_src = device_ms(
        lambda: silhouette_sums_plain(x, onehot), 10)
    lib_ms, _, lib_src = device_ms(lambda: torch.cdist(x, x) @ onehot, 10)
    b_ms, b_by = bound(n * d * 4 + n * k * 4 * 2,
                       2 * n * 1200 * d + 2 * n * 1200)
    log(f"[kernels] K3 silhouette_sums d=12 n={n} k={k} live rows 1200: "
        f"max_abs_err {err:.3e} rel {rel:.3e} (tol {KERNEL_TOL}) kernel "
        f"device ms {ms:.4f} [{ms_src}] plain device ms {plain_ms:.4f} "
        f"[{plain_src}] library device ms {lib_ms:.4f} [{lib_src}] (cdist "
        f"@ onehot) bound_us {b_ms * 1e3:.2f} ({b_by})")


def _training_batches(n_steps):
    """The first ``n_steps`` packed batches of the default fit on phi-2
    (the same subsample, split and selections as ``GCLSampler.train``)."""
    from repro_torch.core.batching import (
        MAX_EDGES_PER_MICROBATCH, MAX_NODES_PER_MICROBATCH, plan_epoch,
    )
    from repro_torch.core.rgcn import RGCNConfig
    from repro_torch.core.train import ContrastiveTrainer

    graphs = _phi2_training_graphs()
    _, _, selections = ContrastiveTrainer(
        RGCNConfig(), device="cpu").split(len(graphs))
    plan = plan_epoch(graphs, selections[:n_steps],
                      max_nodes_per_graph=MAX_NODES_PER_MICROBATCH,
                      max_edges_per_graph=MAX_EDGES_PER_MICROBATCH)
    return [{f: a[i] for f, a in seg.batches.items()}
            for seg in plan.segments for i in range(len(seg))]


def _k5_k1b(rows, dev, rng, batches):
    """K5 and K1b against their plain versions at each batch's shape (the
    embed path's first micro-batch and the fit's bucket), h of width D in
    {64, 128} (the layers' input widths), float32 and bfloat16, each timed
    and held to equal bits on a repeat; then K1b on the unit-norm paths.
    The table rows: the fit's bucket at D = 128, float32, with D = 64's
    times as extra keys."""
    import numpy as np
    import torch

    from repro_torch.kernels.rgcn_fused.ops import (
        rgcn_fused_bwd, rgcn_fused_bwd_plain,
    )
    from repro_torch.kernels.rgcn_spmm.ops import (
        rgcn_spmm_flat, rgcn_spmm_flat_plain,
    )
    from repro_torch.launch.roofline import bound

    nb = 2
    res = {}
    for label, packed in batches.items():
        P, Q = len(packed["node_mask"]), len(packed["edge_mask"])
        src = torch.from_numpy(packed["edge_src"]).to(dev)
        dst = torch.from_numpy(packed["edge_dst"]).to(dev)
        wnorm = torch.from_numpy(packed["edge_mask"] * packed["edge_norm"]
                                 ).to(dev)
        etype = torch.from_numpy(packed["edge_type"]).long()
        node_mask = torch.from_numpy(packed["node_mask"]).to(dev)
        live = wnorm != 0
        q_live = int(live.sum())
        deg = torch.bincount(src[live].long(), minlength=P)
        # the rows the work needs: h at the live edges' sources, t at their
        # destinations (padding rows are never read)
        n_src = int(torch.unique(src[live]).numel())
        n_dst = int(torch.unique(dst[live]).numel())
        log(f"[kernels] K5/K1b {label}: P={P} Q={Q} live edges={q_live} "
            f"largest out-degree {int(deg.max())}, in-degree "
            f"{int(torch.bincount(dst[live].long(), minlength=P).max())}; "
            f"rows read: {n_src} sources, {n_dst} destinations")
        for D in (64, 128):
            comb = torch.from_numpy(rng.standard_normal((4, nb))
                                    .astype(np.float32))
            coef = comb[etype].contiguous().to(dev)
            w = (coef * wnorm[:, None]).contiguous()
            h32 = (torch.from_numpy(rng.standard_normal((P, D))
                                    .astype(np.float32)).to(dev)
                   * node_mask[:, None]).contiguous()
            t = torch.from_numpy(rng.standard_normal((P, nb * D))
                                 .astype(np.float32)).to(dev)
            # the library yardstick for K5: one sparse product computing s
            # (rows k*P + v of the (nb*P, P) matrix hold w[e, k] at src_e)
            rows_k = torch.cat([k * P + dst[live].long() for k in range(nb)])
            cols_k = torch.cat([src[live].long()] * nb)
            vals = torch.cat([w[live, k] for k in range(nb)])
            A = torch.sparse_coo_tensor(torch.stack([rows_k, cols_k]), vals,
                                        (nb * P, P)).coalesce().to_sparse_csr()
            for dt in (torch.float32, torch.bfloat16):
                h = h32.to(dt).contiguous()
                dname = "f32" if dt == torch.float32 else "bf16"
                esz = h.element_size()
                tag = f"{label} D={D} h={dname}"
                # ---- K5 --------------------------------------------------
                got = rgcn_spmm_flat(h, src, dst, w, P)
                torch.cuda.synchronize()
                err, rel = rel_err(got, rgcn_spmm_flat_plain(h, src, dst, w,
                                                             P))
                require(rel <= KERNEL_TOL, f"K5 {tag}: rel err {rel:.3e} > "
                        f"{KERNEL_TOL}")
                again = rgcn_spmm_flat(h, src, dst, w, P, checked=False)
                require(torch.equal(got, again), f"K5 {tag}: two calls "
                        f"differ")
                call = lambda: rgcn_spmm_flat(  # noqa: E731
                    h, src, dst, w, P, checked=False)
                call_ms = time_ms(call, 50)
                wrap_ms, ms, ms_src = device_ms(call, 20, own=K5_KERNELS)
                plain_ms, _, plain_src = device_ms(
                    lambda: rgcn_spmm_flat_plain(h, src, dst, w, P), 20)
                lib_ms = lib_src = None
                if dt == torch.float32:
                    lib = torch.sparse.mm(A, h).reshape(nb, P, D)
                    err_lib, _ = rel_err(lib.permute(1, 0, 2).reshape(P, -1),
                                         got)
                    require(err_lib <= 1e-3 * float(got.abs().max()),
                            f"K5 library yardstick disagrees ({err_lib:.3e})")
                    lib_ms, _, lib_src = device_ms(
                        lambda: torch.sparse.mm(A, h), 20)
                # h's live source rows, the live edges' src, perm and w, the
                # rowptr; s written in full
                bytes_ = (n_src * D * esz + q_live * (4 * 2 + nb * 4)
                          + (P + 1) * 4 + P * nb * D * 4)
                ops = 2 * q_live * nb * D
                b_ms, b_by = bound(bytes_, ops)
                lib_txt = (f"{lib_ms:.4f} [{lib_src}] (sparse.mm)"
                           if lib_ms is not None
                           else "none (no bf16 sparse product)")
                log(f"[kernels] K5 rgcn_spmm_flat {tag}: max_abs_err "
                    f"{err:.3e} rel {rel:.3e} (tol {KERNEL_TOL}), repeat "
                    f"bit-equal; kernel device ms {ms:.4f} [{ms_src}] "
                    f"(wrapper device ms {wrap_ms:.4f}, call ms "
                    f"{call_ms:.4f}) plain device ms {plain_ms:.4f} "
                    f"[{plain_src}] library device ms {lib_txt} bound_us "
                    f"{b_ms * 1e3:.2f} ({b_by})")
                res["K5", label, D, dname] = dict(
                    err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=lib_ms)
                # ---- K1b -------------------------------------------------
                dh, dcoef = rgcn_fused_bwd(h, t, src, dst, coef, wnorm, P)
                torch.cuda.synchronize()
                want = rgcn_fused_bwd_plain(h, t, src, dst, coef, wnorm, P)
                e1, r1 = rel_err(dh, want[0])
                e2, r2 = rel_err(dcoef, want[1])
                tol_dh = BF16_TOL if dt == torch.bfloat16 else KERNEL_TOL
                require(r1 <= tol_dh and r2 <= KERNEL_TOL,
                        f"K1b {tag}: rel err dh {r1:.3e} dcoef {r2:.3e}")
                args = (h, t, src, dst, coef, wnorm, P)
                again = rgcn_fused_bwd(*args, checked=False)
                require(torch.equal(dh, again[0])
                        and torch.equal(dcoef, again[1]),
                        f"K1b {tag}: two calls differ")
                call = lambda: rgcn_fused_bwd(*args, checked=False)  # noqa
                call_ms = time_ms(call, 50)
                wrap_ms, ms, ms_src = device_ms(call, 20, own=K1B_KERNELS)
                plain_ms, _, plain_src = device_ms(
                    lambda: rgcn_fused_bwd_plain(*args), 20)
                # h's live source rows, t's live destination rows, the live
                # edges' src, dst, perm, coef and wnorm, the rowptr; dh and
                # dcoef written in full
                bytes_ = (n_src * D * esz + n_dst * nb * D * 4
                          + q_live * (4 * 3 + nb * 4 + 4) + (P + 1) * 4
                          + P * D * esz + Q * nb * 4)
                ops = 4 * q_live * nb * D
                b_ms, b_by = bound(bytes_, ops)
                log(f"[kernels] K1b rgcn_fused_bwd {tag}: max_abs_err dh "
                    f"{e1:.3e} rel {r1:.3e} (tol {tol_dh:.1e}) dcoef "
                    f"{e2:.3e} rel {r2:.3e} (tol {KERNEL_TOL}), repeat "
                    f"bit-equal; kernel device ms {ms:.4f} [{ms_src}] "
                    f"(wrapper device ms {wrap_ms:.4f}, call ms "
                    f"{call_ms:.4f}) plain device ms {plain_ms:.4f} "
                    f"[{plain_src}] library none (dh and dcoef: no one "
                    f"call) bound_us {b_ms * 1e3:.2f} ({b_by})")
                res["K1b", label, D, dname] = dict(
                    err=max(e1, e2), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)
    _k1b_unit_norms(dev, rng, batches["embed batch"])

    def row(kernel):
        m = dict(res[kernel, "training bucket", 128, "f32"])
        d64 = res[kernel, "training bucket", 64, "f32"]
        m.update(d64_ms=d64["ms"], d64_bound_ms=d64["bound_ms"])
        return m

    rows.append(("rgcn_spmm_flat", "src/repro_torch/csrc/rgcn_spmm.cu",
                 "src/repro/kernels/rgcn_spmm/kernel.py:119",
                 rgcn_spmm_flat, row("K5")))
    rows.append(("rgcn_fused_bwd", "src/repro_torch/csrc/rgcn_fused_bwd.cu",
                 "src/repro/kernels/rgcn_fused/ops.py:47", rgcn_fused_bwd,
                 row("K1b")))


def _k1b_unit_norms(dev, rng, packed):
    """K1b as the unit-norm backward paths call it (the weights as the
    coefficients, wnorm = 1 on every edge, padded ones included), D = 128,
    float32: phi-2's first dense batch flattened as ``_MessageAgg.backward``
    flattens it, and the embed path's first micro-batch as
    ``_MessageAggFlat.backward`` passes it (its padded tail on node 0).
    Each against its plain version, timed against the same call with the
    padded edges' wnorm set to 0.  Both backward passes at these shapes,
    card against CPU, are card tests (``tests/test_torch_cuda.py``)."""
    import numpy as np
    import torch

    from repro_torch.core.rgcn import edge_norm_dense
    from repro_torch.kernels import weight_csr
    from repro_torch.kernels.rgcn_fused.ops import (
        rgcn_fused_bwd, rgcn_fused_bwd_plain,
    )

    nb, D = 2, 128
    t_ = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    batch, _ = _dense_first_batch("phi-2")
    B, N = batch["node_mask"].shape
    E = batch["edge_src"].shape[1]
    etype = torch.from_numpy(batch["edge_type"]).long()
    emask = torch.from_numpy(batch["edge_mask"])
    wn = emask * edge_norm_dense(torch.from_numpy(batch["edge_dst"]), etype,
                                 emask, N, 4)
    comb = torch.from_numpy(rng.standard_normal((4, nb)).astype(np.float32))
    w3 = (comb[etype] * wn[..., None]).contiguous().to(dev)   # (B, E, nb)
    off = (N * torch.arange(B, dtype=torch.int32))[:, None]
    dense = dict(
        h=t_(rng.standard_normal((B * N, D)).astype(np.float32)),
        src=t_((torch.from_numpy(batch["edge_src"]) + off).reshape(-1)),
        dst=t_((torch.from_numpy(batch["edge_dst"]) + off).reshape(-1)),
        w=w3.reshape(B * E, nb).contiguous(), P=B * N)
    P = len(packed["node_mask"])
    wnorm = t_(packed["edge_mask"] * packed["edge_norm"])
    coef = comb[torch.from_numpy(packed["edge_type"]).long()].to(dev)
    flat = dict(h=t_(rng.standard_normal((P, D)).astype(np.float32)),
                src=t_(packed["edge_src"]), dst=t_(packed["edge_dst"]),
                w=(coef * wnorm[:, None]).contiguous(), P=P)
    for label, c in (("dense batch (phi-2, B=64 x N=426, E=714)", dense),
                     ("embed batch via rgcn_message_agg_flat", flat)):
        h, src, dst, w, P = c["h"], c["src"], c["dst"], c["w"], c["P"]
        ones = torch.ones(w.shape[0], device=dev)
        t = t_(rng.standard_normal((P, nb * D)).astype(np.float32))
        live = (w != 0).any(1)
        deg_all = torch.bincount(src.long(), minlength=P)
        deg = torch.bincount(src[live].long(), minlength=P)
        args = (h, t, src, dst, w, ones, P)
        got = rgcn_fused_bwd(*args)
        torch.cuda.synchronize()
        want = rgcn_fused_bwd_plain(*args)
        e1, r1 = rel_err(got[0], want[0])
        e2, r2 = rel_err(got[1], want[1])
        require(r1 <= KERNEL_TOL and r2 <= KERNEL_TOL,
                f"K1b unit norms {label}: rel err dh {r1:.3e} dcoef {r2:.3e}")
        csr = weight_csr(src, w, P)
        unit = lambda: rgcn_fused_bwd(*args, csr=csr, checked=False)  # noqa
        ms = device_ms(unit, 20, own=K1B_KERNELS)
        zeroed = live.float()
        ms0 = device_ms(lambda: rgcn_fused_bwd(
            h, t, src, dst, w, zeroed, P, csr=csr, checked=False), 20,
            own=K1B_KERNELS)
        log(f"[kernels] K1b unit norms, {label}: Q={w.shape[0]} live "
            f"{int(live.sum())}, largest out-degree {int(deg_all.max())} "
            f"with the padded edges, {int(deg.max())} without; max_abs_err "
            f"dh {e1:.3e} rel {r1:.3e} dcoef {e2:.3e} rel {r2:.3e} (tol "
            f"{KERNEL_TOL}); kernel device ms {ms} against {ms0} with the "
            f"padded edges' wnorm set to 0 ({ms.own / ms0.own:.2f}x, aim "
            f"<= 1.3x)")


@functools.lru_cache(maxsize=None)
def _program_graphs(name):
    """Every kernel graph of a program (default trace caps), traced once
    per run."""
    from repro_torch.core.sampler import GCLSampler
    from repro_torch.tracing.programs import get_program

    return list(GCLSampler(device="cpu").iter_graphs(get_program(name)))


def _dense_first_batch(name):
    """The first batch ``embed_dense`` encodes for a program: the whole
    program padded to its largest graph, its first 64 graphs."""
    from repro_torch.core.graphs import pad_batch

    full, max_warps = pad_batch(_program_graphs(name))
    return {k: v[:DENSE_BATCH] for k, v in full.items()}, max_warps


def _k6_reads(src, w, N):
    """(h rows, edge slots) K6 must read: the distinct (graph, source)
    rows of the live edges (w != 0 in some base), and those edges."""
    import torch

    live = (w != 0).any(-1)
    B = src.shape[0]
    rows = src.long() + N * torch.arange(B, device=src.device)[:, None]
    return int(torch.unique(rows[live]).numel()), int(live.sum())


def _k6_check(dev, label, h, src, dst, w, N, timed):
    """K6 against its plain version on the card; with ``timed``, its device
    time, the plain version's, the sparse-product yardstick's (f32) and
    the bound.  Returns the row's numbers."""
    import torch

    from repro_torch.kernels.rgcn_spmm.ops import (
        rgcn_spmm_dense, rgcn_spmm_dense_plain,
    )
    from repro_torch.launch.roofline import bound

    B, _, D = h.shape
    E, nb = w.shape[1], w.shape[2]
    got = rgcn_spmm_dense(h, src, dst, w, N)
    torch.cuda.synchronize()
    err, rel = rel_err(got, rgcn_spmm_dense_plain(h, src, dst, w, N))
    dname = "f32" if h.dtype == torch.float32 else "bf16"
    require(rel <= KERNEL_TOL,
            f"K6 {label} D={D} {dname}: rel err {rel:.3e} > {KERNEL_TOL}")
    require(torch.equal(got, rgcn_spmm_dense(h, src, dst, w, N,
                                             checked=False)),
            f"K6 {label} D={D} {dname}: two calls differ")
    if not timed:
        log(f"[kernels] K6 rgcn_spmm_dense {label} B={B} N={N} E={E} D={D} "
            f"h={dname}: max_abs_err {err:.3e} rel {rel:.3e} (tol "
            f"{KERNEL_TOL}), repeat bit-equal")
        return None
    n_src, e_live = _k6_reads(src, w, N)
    live = (w != 0).any(-1)
    args = (h, src, dst, w, N)
    # timed as the dense encoder calls it: the edges were checked by the
    # call above, so the timed calls make no host sync
    call = lambda: rgcn_spmm_dense(*args, checked=False)  # noqa: E731
    call_ms = time_ms(call, 50)
    wrap_ms, ms, ms_src = device_ms(call, 20, own=K6_KERNELS)
    plain_ms, _, plain_src = device_ms(
        lambda: rgcn_spmm_dense_plain(*args), 20)
    lib_ms = lib_src = None
    if h.dtype == torch.float32:
        # the library yardstick: one sparse product over the block-diagonal
        # CSR of the flattened batch (row k*B*N + b*N + v holds w[b,e,k] at
        # column b*N + src[b,e])
        off = (N * torch.arange(B, device=dev))[:, None]
        rows_b = (dst.long() + off)[live]
        cols_b = (src.long() + off)[live]
        A = torch.sparse_coo_tensor(
            torch.stack([torch.cat([k * B * N + rows_b for k in range(nb)]),
                         torch.cat([cols_b] * nb)]),
            torch.cat([w[..., k][live] for k in range(nb)]),
            (nb * B * N, B * N)).coalesce().to_sparse_csr()
        hf = h.reshape(B * N, D)
        lib = torch.sparse.mm(A, hf).reshape(nb, B, N, D)
        err_lib, _ = rel_err(lib.permute(1, 2, 0, 3).reshape(B, N, -1), got)
        require(err_lib <= 1e-3 * float(got.abs().max()),
                f"K6 library yardstick disagrees ({err_lib:.3e})")
        lib_ms, _, lib_src = device_ms(lambda: torch.sparse.mm(A, hf), 20)
    esz = h.element_size()
    # h's rows that live edges read, the live edges' src, perm and w, the
    # rowptr; s written in full
    bytes_ = (n_src * D * esz + e_live * (4 * 2 + nb * 4)
              + (B * N + 1) * 4 + B * N * nb * D * 4)
    b_ms, b_by = bound(bytes_, 2 * e_live * nb * D)
    lib_txt = (f"{lib_ms:.4f} [{lib_src}] (sparse.mm, block-diagonal CSR)"
               if lib_ms is not None else "none (no bf16 sparse product)")
    log(f"[kernels] K6 rgcn_spmm_dense {label} B={B} N={N} E={E} live edges "
        f"{e_live} D={D} h={dname}: max_abs_err {err:.3e} rel {rel:.3e} (tol "
        f"{KERNEL_TOL}), repeat bit-equal; kernel device ms {ms:.4f} "
        f"[{ms_src}] (wrapper device ms {wrap_ms:.4f}, call ms "
        f"{call_ms:.4f}) plain device ms {plain_ms:.4f} [{plain_src}] "
        f"library device ms {lib_txt} bound_us {b_ms * 1e3:.2f} ({b_by})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def _k6(rows, dev, rng):
    """K6 against its plain version at phi-2's and cfd's first dense batch
    (the dense phase's shapes), h of width D in {64, 128} (the layers'
    input widths), float32 and bfloat16, each timed; then E = 0 and a
    batch whose edges are all padding at node 0 but ten per graph; then
    the dense aggregation's forward and backward (K6, K1b and the matmuls)
    on the card against the CPU.  The table row: phi-2, D = 128, f32."""
    import numpy as np
    import torch

    from repro_torch.core.rgcn import edge_norm_dense
    from repro_torch.kernels.rgcn_spmm.ops import (
        rgcn_message_agg, rgcn_spmm_dense,
    )

    nb = 2
    k6 = None
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    for name in ("phi-2", "cfd"):
        batch, _ = _dense_first_batch(name)
        B, N = batch["node_mask"].shape
        etype = torch.from_numpy(batch["edge_type"]).long()
        emask = torch.from_numpy(batch["edge_mask"])
        dst_c = torch.from_numpy(batch["edge_dst"])
        wnorm = emask * edge_norm_dense(dst_c, etype, emask, N, 4)
        src, dst = t(batch["edge_src"]), t(batch["edge_dst"])
        node_mask = t(batch["node_mask"])
        E = batch["edge_src"].shape[1]
        live = wnorm.to(dev) != 0
        n_src, e_live = _k6_reads(src, live[..., None].float(), N)
        deg = torch.bincount((dst.long() + N * torch.arange(
            B, device=dev)[:, None])[live], minlength=B * N)
        log(f"[kernels] K6 {name} batch: B={B} N={N} E={E} live edges "
            f"{e_live} of {B * E} slots, largest in-degree {int(deg.max())}, "
            f"rows without an edge {int((deg == 0).sum())} of {B * N}; rows "
            f"read: {n_src} distinct (graph, source) h rows of {B * N}")
        for D in (64, 128):
            comb = torch.from_numpy(rng.standard_normal((4, nb))
                                    .astype(np.float32))
            w = (comb[etype] * wnorm[..., None]).contiguous().to(dev)
            h32 = (t(rng.standard_normal((B, N, D)).astype(np.float32))
                   * node_mask[..., None])
            for dt in (torch.float32, torch.bfloat16):
                m = _k6_check(dev, name, h32.to(dt).contiguous(), src, dst,
                              w, N, timed=True)
                if (name, D, dt) == ("phi-2", 128, torch.float32):
                    k6 = m
                    fwd_bwd = (h32, src, dst, w, N)
    # E = 0, and padding at node 0 (pad_batch's padded and truncated edges)
    B, N, E, D = DENSE_BATCH, 436, 734, 128
    h = t(rng.standard_normal((B, N, D)).astype(np.float32))
    e0 = torch.zeros(B, 0, dtype=torch.int32, device=dev)
    _k6_check(dev, "E=0", h, e0, e0, torch.zeros(B, 0, nb, device=dev), N,
              timed=False)
    src = rng.integers(0, N, (B, E)).astype(np.int32)
    dst = rng.integers(0, N, (B, E)).astype(np.int32)
    w = rng.standard_normal((B, E, nb)).astype(np.float32)
    src[:, 10:] = dst[:, 10:] = 0
    w[:, 10:] = 0.0
    _k6_check(dev, "padding at node 0", h, t(src), t(dst), t(w), N,
              timed=True)
    # the dense aggregation's forward and backward, card against CPU
    h32, src, dst, w, N = fwd_bwd
    basis = t((rng.standard_normal((nb, 128, 128)) / np.sqrt(128))
              .astype(np.float32))
    g = t(rng.standard_normal(h32.shape[:2] + (128,)).astype(np.float32))
    res = {}
    for where in (dev, "cpu"):
        xs = [x.detach().to(where).requires_grad_() for x in (h32, basis, w)]
        out = rgcn_message_agg(xs[0], xs[1], src.to(where), dst.to(where),
                               xs[2], N)
        res[str(where)] = (out, *torch.autograd.grad(out, xs, g.to(where)))
    gaps = {k: rel_err(a.detach().cpu(), b.detach())[1] for k, a, b in zip(
        ("agg", "dh", "dbasis", "dw"), res[str(dev)], res["cpu"])}
    log(f"[kernels] dense rgcn_message_agg phi-2 D=128 O=128 f32, card "
        f"(K6 + K1b) vs CPU: rel err {json.dumps(gaps)} (tol {KERNEL_TOL})")
    require(max(gaps.values()) <= KERNEL_TOL,
            f"dense rgcn_message_agg card vs CPU: {gaps}")
    rows.append(("rgcn_spmm_dense", "src/repro_torch/csrc/rgcn_spmm.cu",
                 "src/repro/kernels/rgcn_spmm/kernel.py:156",
                 rgcn_spmm_dense, k6))


def _reference_method(dev):
    import numpy as np

    from repro_torch.sampling import Artifacts, get_method

    with np.load(FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    params = {k[len("param:"):]: v for k, v in ref.items()
              if k.startswith("param:")}
    method = get_method("gcl", device=dev)
    method.adopt(Artifacts("gcl", "phi-2", "jax", payload={"params": params},
                           meta={"trained_on": "phi-2"}))
    return method, ref


def phase_reference(dev):
    import numpy as np

    from repro_torch.sampling import evaluate
    from repro_torch.tracing.programs import get_program

    method, ref = _reference_method(dev)
    for name in ("phi-2", "cfd"):
        t0 = time.perf_counter()
        prog = get_program(name)
        art = method.prepare(prog)
        emb = np.asarray(art.payload["embeddings"])
        index = ref[f"{name}:index"]
        want = ref[f"{name}:emb_distinct"]
        firsts = [int(np.argmax(index == i)) for i in range(len(want))]
        got = emb[firsts]
        require(np.array_equal(emb, got[index]),
                f"{name}: embeddings of identical graphs differ")
        err = float(np.abs(got - want).max()) / float(np.abs(want).max())
        require(err <= EMBED_TOL,
                f"{name}: embeddings rel err {err:.3e} > {EMBED_TOL}")
        plan = method.plan(prog, art)
        ev = evaluate(plan, prog, "P1")
        k_ref, reps_ref = int(ref[f"{name}:k"]), ref[f"{name}:reps"].tolist()
        scores = plan.extra.get("scores", {})
        ref_scores = dict(zip(ref[f"{name}:scores_k"].tolist(),
                              ref[f"{name}:scores"].tolist()))
        gap = max((abs(scores[k] - ref_scores[k]) for k in ref_scores
                   if k in scores), default=0.0)
        log(f"[reference] {name}: n={len(emb)} distinct={len(want)} "
            f"emb rel err {err:.3e} (tol {EMBED_TOL}) K {plan.num_clusters} "
            f"(jax {k_ref}) reps {plan.rep_indices()} eq5 "
            f"{ev.error_pct['cycles']!r} (jax "
            f"{float(ref[f'{name}:error_cycles'])!r}) eq6 {ev.speedup!r} "
            f"(jax {float(ref[f'{name}:speedup'])!r}) max per-K silhouette "
            f"gap {gap:.3e} ({time.perf_counter() - t0:.2f} s)")
        require(plan.num_clusters == k_ref, f"{name}: K differs from JAX")
        require(plan.rep_indices() == reps_ref,
                f"{name}: representatives differ from JAX")
        require(abs(ev.error_pct["cycles"]
                    - float(ref[f"{name}:error_cycles"])) <= METRIC_TOL,
                f"{name}: eq. 5 differs from JAX")
        require(abs(ev.speedup - float(ref[f"{name}:speedup"])) <= METRIC_TOL,
                f"{name}: eq. 6 differs from JAX")


def phase_dense(dev):
    """The dense encoder path through its entry points with the fixture
    encoder: ``embed_dense`` of phi-2 and cfd (the path's run: K6's launch
    count), the plans from those embeddings, dense against packed embed
    times, the dense loss and its gradient, the ablation encodes.  Returns
    the path's launch counts."""
    import copy
    import math

    import numpy as np
    import torch

    from repro_torch.core.batching import pack_graphs
    from repro_torch.core.graphs import pad_batch
    from repro_torch.core.rgcn import RGCNConfig, encode, encode_packed
    from repro_torch.core.train import (
        ContrastiveTrainer, dense_loss, draw_seed, draw_step,
    )
    from repro_torch.kernels.rgcn_fused.ops import rgcn_fused_bwd
    from repro_torch.kernels.rgcn_spmm.ops import rgcn_spmm_dense
    from repro_torch.sampling import Artifacts, evaluate
    from repro_torch.tracing.programs import get_program

    method, ref = _reference_method(dev)
    enc = method.sampler.params
    rc = RGCNConfig()
    names = ("phi-2", "cfd")
    graphs = {name: _program_graphs(name) for name in names}
    trainer = ContrastiveTrainer(rc, device=dev)
    z_dense, cold = {}, {}
    _zero_counts()
    for name in names:
        t0 = time.perf_counter()
        z_dense[name] = trainer.embed_dense(enc, graphs[name])
        cold[name] = time.perf_counter() - t0
    counts = _counts()
    batches = sum(math.ceil(len(g) / DENSE_BATCH) for g in graphs.values())
    log(f"[dense] embed_dense launches {json.dumps(counts)} ({batches} "
        f"batches of {DENSE_BATCH})")
    require(counts["rgcn_spmm_dense"] == 3 * batches,
            f"dense: K6 launched {counts['rgcn_spmm_dense']} times, not "
            f"3 x {batches}")
    for name in names:
        prog = get_program(name)
        z, g = z_dense[name], graphs[name]
        want = ref[f"{name}:emb_distinct"][ref[f"{name}:index"]]
        err = float(np.abs(z - want).max()) / float(np.abs(want).max())
        t0 = time.perf_counter()
        z_warm = trainer.embed_dense(enc, g)
        warm = time.perf_counter() - t0
        packed = ContrastiveTrainer(rc, device=dev)
        t0 = time.perf_counter()
        z_packed = packed.embed(enc, g)
        p_cold = time.perf_counter() - t0
        packed._embed_cache.clear()
        t0 = time.perf_counter()
        packed.embed(enc, g)
        p_warm = time.perf_counter() - t0
        gap = float(np.abs(z - z_packed).max()) / float(np.abs(z_packed).max())
        full, _ = pad_batch(g)
        art = Artifacts("gcl", name, "dense", payload={
            "embeddings": z, "seqs": np.array([k.seq for k in prog.kernels])})
        plan = method.plan(prog, art)
        ev = evaluate(plan, prog, "P1")
        k_ref, reps_ref = int(ref[f"{name}:k"]), ref[f"{name}:reps"].tolist()
        log(f"[dense] {name}: n={len(g)} padded to N={full['node_mask'].shape[1]}"
            f" E={full['edge_mask'].shape[1]} ({int(full['node_mask'].sum())} "
            f"real nodes in {full['node_mask'].size} slots): emb rel err vs "
            f"fixture {err:.3e} (tol {EMBED_TOL}), vs packed embed on the card "
            f"{gap:.3e} (tol {EMBED_TOL}); embed_dense cold {cold[name]:.4f} s "
            f"warm {warm:.4f} s; packed embed cold {p_cold:.4f} s warm (cache "
            f"cleared) {p_warm:.4f} s ({packed.embed_stats['encoded']} "
            f"distinct graphs encoded); K {plan.num_clusters} (jax {k_ref}) "
            f"reps {plan.rep_indices()} eq5 {ev.error_pct['cycles']!r} eq6 "
            f"{ev.speedup!r}")
        require(np.array_equal(z, z_warm), f"dense {name}: warm run differs")
        require(err <= EMBED_TOL, f"dense {name}: rel err {err:.3e}")
        require(gap <= EMBED_TOL, f"dense {name}: vs packed {gap:.3e}")
        require(plan.num_clusters == k_ref, f"dense {name}: K differs")
        require(plan.rep_indices() == reps_ref,
                f"dense {name}: representatives differ")

    # the dense loss and its gradient on one training batch, card vs CPU
    train_graphs = _phi2_training_graphs()
    _, _, selections = ContrastiveTrainer(rc, device="cpu").split(
        len(train_graphs))
    batch, mw = pad_batch([train_graphs[i] for i in selections[0]])
    b_cpu = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws = draw_step(torch.Generator().manual_seed(draw_seed(0, 0)), b_cpu,
                      rc)
    out = {}
    for where in ("cpu", dev):
        e = copy.deepcopy(enc).to(where)
        params = dict(e.named_parameters())
        k6, k1b = rgcn_spmm_dense.launches, rgcn_fused_bwd.launches
        loss, _ = dense_loss(e, rc, 0.05, {k: v.to(where)
                                           for k, v in b_cpu.items()},
                             mw, tuple(d.to(where) for d in draws))
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        out[str(where)] = (loss.item(), grads, rgcn_spmm_dense.launches - k6,
                           rgcn_fused_bwd.launches - k1b)
    (l_cpu, g_cpu, _, _), (l_card, g_card, n_k6, n_k1b) = \
        out["cpu"], out[str(dev)]
    loss_gap = abs(l_card - l_cpu) / abs(l_cpu)
    grad_gap = _norm_gap(g_card, g_cpu)
    log(f"[dense] dense loss on {len(selections[0])} phi-2 training graphs "
        f"(N={batch['node_mask'].shape[1]}, E={batch['edge_mask'].shape[1]}):"
        f" card {l_card!r} cpu {l_cpu!r} rel gap {loss_gap:.3e} (tol "
        f"{LOSS_TOL}); gradient |card - cpu| / |cpu| {grad_gap:.3e} (tol "
        f"{GRAD_TOL}); card launches K6 {n_k6} K1b {n_k1b}")
    require(loss_gap <= LOSS_TOL, f"dense loss gap {loss_gap:.3e}")
    require(grad_gap <= GRAD_TOL, f"dense gradient gap {grad_gap:.3e}")
    require(n_k6 == 6 and n_k1b == 6,
            f"dense loss: K6 {n_k6} / K1b {n_k1b} launches, not 6 / 6")

    # the ablation switches, dense and packed, card vs CPU
    abl = RGCNConfig(use_vstats=False, relations_used=(0,))
    dense_b, mw = _dense_first_batch("cfd")
    packed_b, _ = pack_graphs(graphs["phi-2"][:DENSE_BATCH])
    got = {}
    for where in ("cpu", dev):
        e = copy.deepcopy(enc).to(where)
        with torch.inference_mode():
            got[str(where)] = (
                encode(e, abl, {k: torch.from_numpy(v).to(where)
                                for k, v in dense_b.items()}, mw).cpu(),
                encode_packed(e, abl, {k: torch.from_numpy(v).to(where)
                                       for k, v in packed_b.items()}).cpu())
    gaps = [rel_err(a, b)[1] for a, b in zip(got[str(dev)], got["cpu"])]
    moved = float((got["cpu"][0] - torch.from_numpy(
        z_dense["cfd"][:DENSE_BATCH])).abs().max())
    log(f"[dense] ablation use_vstats=False relations_used=(0,): card vs CPU "
        f"rel err encode {gaps[0]:.3e} encode_packed {gaps[1]:.3e} (tol "
        f"{EMBED_TOL}); max |z_ablated - z_default| {moved:.3e}")
    require(max(gaps) <= EMBED_TOL, f"dense ablation card vs CPU {gaps}")
    require(moved > 1e-3, "dense ablation: the switches changed nothing")
    return counts


class SweepCount:
    """Counts, inside its block, the sweeps (``clustering._sweep_core``
    calls: one per sweep dispatch), the programs they carry (real rows of
    the program axis) and the K2 calls they may make: iters + 1 each (one
    per Lloyd step for all candidates of all programs, and the final
    assignment)."""

    def __enter__(self):
        from repro_torch.core import clustering

        self._mod, self._real = clustering, clustering._sweep_core
        self.sweeps = self.programs = self.allowed = 0

        def counted(*a, **kw):
            self.sweeps += 1
            self.programs += sum(1 for n in kw["n_real"] if n > 0)
            self.allowed += kw["iters"] + 1
            return self._real(*a, **kw)

        clustering._sweep_core = counted
        return self

    def __exit__(self, *exc):
        self._mod._sweep_core = self._real

    def check(self, tag, k2_calls, k3_calls=None):
        k3 = ("" if k3_calls is None else
              f", {k3_calls} K3 calls ({k3_calls / max(self.programs, 1):.2f}"
              f" a program)")
        log(f"[{tag}] {self.sweeps} sweep dispatches of {self.programs} "
            f"programs ({self.programs / max(self.sweeps, 1):.2f} a "
            f"dispatch), {k2_calls} K2 calls "
            f"({k2_calls / max(self.sweeps, 1):.1f} a dispatch, "
            f"{k2_calls / max(self.programs, 1):.2f} a program; at most "
            f"{self.allowed}: iters + 1 a dispatch){k3}")
        require(self.sweeps > 0 and k2_calls <= self.allowed,
                f"{tag}: {k2_calls} K2 calls for {self.sweeps} sweeps")


def phase_serve(rows, dev):
    import numpy as np
    import torch

    from repro_torch.sampling import evaluate
    from repro_torch.serving import PlanService
    from repro_torch.tracing.programs import get_program

    method, _ = _reference_method(dev)        # fresh embedding cache
    rows = [r for r in rows if r[0] in SERVE_KERNELS]
    for r in rows:
        r[3].launches = 0
    with SweepCount() as sweeps, \
            PlanService(device=dev, max_delay_ms=2.0) as svc:
        svc.warmup()
        for name in ("cfd", "phi-2", "nw"):
            prog = get_program(name)
            t0 = time.perf_counter()
            plan = svc.submit_program(method, prog).result(timeout=600)
            lat = time.perf_counter() - t0
            ev = evaluate(plan, prog, "P1")
            require(np.isfinite(ev.error_pct["cycles"])
                    and np.isfinite(ev.speedup), f"{name}: non-finite eval")
            log(f"[serve] {name}: n={len(prog)} latency_s {lat:.3f} K "
                f"{plan.num_clusters} eq5 {ev.error_pct['cycles']!r} eq6 "
                f"{ev.speedup!r} mode {plan.extra.get('mode')}")
        stats = svc.stats()
    launches = {r[0]: r[3].launches for r in rows}
    log(f"[serve] stats {json.dumps(stats, default=str)}")
    log(f"[serve] launches {json.dumps(launches)}")
    log(f"[serve] mean batch {stats['mean_batch']:.2f}, engine dispatches "
        f"{stats['engine']['dispatches']} for {stats['served']} plans; K2 "
        f"calls a plan {launches['kmeans_assign_fused'] / 3:.2f}, K3 calls "
        f"a plan {launches['silhouette_sums'] / 3:.2f}")
    sweeps.check("serve", launches["kmeans_assign_fused"],
                 launches["silhouette_sums"])
    require(stats["failed"] == 0 and stats["served"] == 3,
            f"serve: {stats['served']} served, {stats['failed']} failed")
    for name, count in launches.items():
        require(count > 0, f"serve: kernel {name} was never launched")
    profile_request(dev, "cfd")
    return launches


def phase_sweep_batch(dev):
    """Batch independence on the card at the engine's defaults (k_max 48,
    iters 50, d 256): PROGRAM_AXIS_B programs of one points bucket in one
    sweep dispatch, against each program's one-program dispatch: labels,
    K and every score bit-equal.  Run for the served mix's bucket
    (``synthetic_fleet`` at d 256) and for bucket 4096 (blob programs of
    2000-4000 points, the grid's largest bucket), the latter with the
    dispatch's peak memory (``max_memory_allocated`` over what was
    allocated before it) and both with the host wall of the batched
    dispatch against the B one-program dispatches and the numpy seeding
    of its programs."""
    import numpy as np
    import torch

    from repro_torch.core.clustering import (
        _kmeanspp_init, bucket_points, sweep_cluster_stack,
    )
    from repro_torch.serving import synthetic_fleet

    B = PROGRAM_AXIS_B
    rng = np.random.default_rng(3)
    fleet = [r.embeddings for r in synthetic_fleet(40, d=256, seed=0)]
    mix = [x for x in fleet if bucket_points(len(x)) == 64][:B]
    big = []
    for i in range(B):
        k = int(rng.integers(2, 12))
        centers = rng.standard_normal((k, 256)) * 4
        n = SWEEP_BATCH_BIG[0] + SWEEP_BATCH_BIG[1] * i
        big.append((centers[rng.integers(0, k, n)]
                    + rng.standard_normal((n, 256))).astype(np.float32))
    for label, xs in (("the served mix's bucket 64", mix),
                      (f"bucket {bucket_points(len(big[-1]))}", big)):
        require(len(xs) == B, f"sweep_batch {label}: {len(xs)} programs")
        seeds = list(range(B))
        t0 = time.perf_counter()
        for x, s in zip(xs, seeds):                  # the dispatch's host
            _kmeanspp_init(x, min(48, len(x) - 1), s)   # seeding
        seed_s = time.perf_counter() - t0
        sweep_cluster_stack(xs, seed=seeds, device=dev)        # warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = sweep_cluster_stack(xs, seed=seeds, device=dev)
        batched_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        solo = [sweep_cluster_stack([x], seed=s, device=dev)[0]
                for x, s in zip(xs, seeds)]
        solo_s = time.perf_counter() - t0
        for i, ((gl, gi), (sl, si)) in enumerate(zip(got, solo)):
            require(np.array_equal(gl, sl) and gi["k"] == si["k"]
                    and gi["sil"] == si["sil"]
                    and gi.get("scores") == si.get("scores"),
                    f"sweep_batch {label}: program {i} differs from its "
                    f"one-program dispatch")
        log(f"[sweep_batch] {label}: {B} programs (n "
            f"{min(map(len, xs))}..{max(map(len, xs))}, d 256, k_max 48, "
            f"iters 50) in one dispatch: labels, K and scores bit-equal to "
            f"the one-program dispatches (K {[r[1]['k'] for r in got]}); "
            f"host wall {batched_s * 1e3:.1f} ms against "
            f"{solo_s * 1e3:.1f} ms for {B} one-program dispatches, of it "
            f"the numpy kmeans++ seeding of the {B} programs "
            f"{seed_s * 1e3:.1f} ms; peak memory of the dispatch "
            f"{peak / 2 ** 20:.1f} MiB")


def profile_request(dev, name):
    """One more cold request (fresh encoder cache) under torch.profiler:
    wall time, how much of it the dispatcher's sweep took, and the share of
    it the device was busy (sum of device time over wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import PlanService
    from repro_torch.tracing.programs import get_program

    method, _ = _reference_method(dev)
    prog = get_program(name)
    with PlanService(device=dev, max_delay_ms=2.0) as svc:
        svc.warmup()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            svc.submit_program(method, prog).result(timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        stats = svc.stats()
    busy = 0.0
    top = []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = ev.self_cuda_time_total if t is None else t
        busy += t
        top.append((t, ev.key, ev.count))
    busy_s = busy / 1e6
    top.sort(reverse=True)
    log(f"[profile] {name}: wall_s {wall:.3f} (profiled) sweep dispatch_s "
        f"{stats['mean_dispatch_ms'] / 1e3:.3f} device busy_s {busy_s:.4f} "
        f"busy share {busy_s / wall:.4f} idle share {1 - busy_s / wall:.4f}")
    for t, key, count in top[:8]:
        log(f"[profile]   {t / 1e3:9.3f} ms  x{count:<6d} {key[:70]}")


def phase_plan_serve(dev):
    """The plan-serving load path: ``repro_torch.launch.plan_serve.main``
    on the card for each of ``PLAN_SERVE_RUNS``, at ``PLAN_SERVE_LOADS`` x
    the closed-loop capacity (plans/s of a warm ``PlanEngine.plan_many``
    over the same fleet, measured first).  Every request must be served,
    every served plan must equal the same request's closed-loop plan
    (labels, K, representatives), and K2 and K3 must have been launched
    (counts zeroed just before each run).  The K2 / K3 calls are counted
    for the closed loop's measured ``plan_many`` and for the served runs,
    those of the services' warm-up sweeps apart.  Also the first request's
    latency of a fresh service, cold and after ``warmup`` (the allocator's
    cache emptied before each)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.launch import plan_serve
    from repro_torch.sampling.engine import PlanEngine, bucket_key
    from repro_torch.serving import PlanService, synthetic_fleet

    class Recording(PlanService):
        """A PlanService that keeps every future it hands out, and counts
        the K2 / K3 calls its ``warmup`` sweeps make."""
        futures: list = []
        warm = {"kmeans_assign_fused_batched": 0, "silhouette_sums": 0}

        def submit(self, request):
            fut = super().submit(request)
            Recording.futures.append(fut)
            return fut

        def warmup(self, *a, **kw):
            before = _counts()
            try:
                return super().warmup(*a, **kw)
            finally:
                after = _counts()
                for name in Recording.warm:
                    Recording.warm[name] += after[name] - before[name]

    for label, overrides in PLAN_SERVE_RUNS:
        argv = ["--device", dev.type]
        for k, v in overrides.items():
            argv += [f"--{k.replace('_', '-')}", str(v)]
        cfg = dict(PLAN_SERVE_CLI, **overrides)
        d, k_max, iters = cfg["d"], cfg["k_max"], cfg["iters"]
        n_req, seed = 120, 0                  # the CLI's requests and seed
        fleet = synthetic_fleet(n_req, d=d, seed=seed)
        buckets = sorted({bucket_key(r.embeddings) for r in fleet})
        eng_kw = dict(k_max=k_max, iters=iters, seed=seed, max_batch=8)
        first = {}
        for warm in (False, True):
            torch.cuda.empty_cache()
            with PlanService(device=dev, max_delay_ms=5.0, **eng_kw) as svc:
                if warm:
                    svc.warmup(buckets)
                t0 = time.perf_counter()
                svc.submit(fleet[0]).result(timeout=600)
                first[warm] = time.perf_counter() - t0
        eng = PlanEngine(device=dev, **eng_kw)
        eng.warmup(buckets)
        eng.plan_many(fleet)
        eng.reset_stats()
        _zero_counts()
        t0 = time.perf_counter()
        ref = eng.plan_many(fleet)
        closed_s = time.perf_counter() - t0
        closed = _counts()
        cap = n_req / closed_s
        loads = [f * cap for f in PLAN_SERVE_LOADS]
        log(f"[plan_serve] {label} (d={d} k_max={k_max} iters={iters}, "
            f"{n_req} requests, buckets {buckets}): closed-loop capacity "
            f"{cap:.2f} plans/s ({closed_s:.3f} s, "
            f"{eng.stats['dispatches']} dispatches, mean batch "
            f"{n_req / eng.stats['dispatches']:.2f}, K2 calls "
            f"{closed['kmeans_assign_fused_batched']} K3 calls "
            f"{closed['silhouette_sums']}: "
            f"{closed['kmeans_assign_fused_batched'] / n_req:.2f} / "
            f"{closed['silhouette_sums'] / n_req:.2f} a plan, counted); "
            f"first request of a "
            f"fresh service cold {first[False] * 1e3:.1f} ms, after warmup "
            f"{first[True] * 1e3:.1f} ms; offered loads "
            f"{', '.join(f'{x:.2f}' for x in loads)} req/s")
        Recording.futures = []
        Recording.warm = dict.fromkeys(Recording.warm, 0)
        orig = plan_serve.PlanService
        plan_serve.PlanService = Recording
        _zero_counts()
        try:
            with tempfile.TemporaryDirectory() as tmp, \
                    SweepCount() as sweeps:
                path = Path(tmp) / "plan_serve.json"
                rc = plan_serve.main(argv + [
                    "--load", ",".join(f"{x:.6g}" for x in loads),
                    "--json", str(path)])
                doc = json.loads(path.read_text())
        finally:
            plan_serve.PlanService = orig
        counts = _counts()
        require(rc == 0, f"plan_serve {label}: exit code {rc}")
        for row in doc["loads"]:
            lat, svc = row["latency_ms"], row["service"]
            log(f"[plan_serve] {label} offered {row['offered_per_s']:.2f}/s "
                f"({row['offered_per_s'] / cap:.1f}x capacity): served "
                f"{row['n_ok']} / {row['n_requests']}, errors "
                f"{row['n_err']}; latency ms p50 {lat['p50']:.2f} p99 "
                f"{lat['p99']:.2f} mean {lat['mean']:.2f} max "
                f"{lat['max']:.2f}; {row['plans_per_s']:.2f} plans/s over "
                f"{row['wall_s']:.3f} s; occupancy "
                f"{svc['batch_occupancy']:.3f} mean batch "
                f"{svc['mean_batch']:.2f} mean queue depth "
                f"{svc['mean_queue_depth']:.2f} dispatch ms "
                f"{svc['mean_dispatch_ms']:.2f}; flushes "
                f"{json.dumps(svc['flush_causes'])}")
            require(row["n_err"] == 0 and row["n_ok"] == n_req,
                    f"plan_serve {label}: {row['n_err']} failed requests")
        futs = Recording.futures
        require(len(futs) == n_req * len(loads),
                f"plan_serve {label}: {len(futs)} requests recorded")
        for i, fut in enumerate(futs):
            got, want = fut.result(), ref[i % n_req]
            require(np.array_equal(got.labels, want.labels)
                    and got.num_clusters == want.num_clusters
                    and got.reps == want.reps,
                    f"plan_serve {label}: request {i % n_req} served a "
                    f"plan other than its closed-loop plan")
        k2, k3 = counts["kmeans_assign_fused_batched"], counts[
            "silhouette_sums"]
        w2, w3 = (Recording.warm["kmeans_assign_fused_batched"],
                  Recording.warm["silhouette_sums"])
        disp = sum(row["service"]["engine"]["dispatches"]
                   for row in doc["loads"])
        log(f"[plan_serve] {label}: {len(futs)} served plans equal to their "
            f"closed-loop plans (labels, K, representatives); launches K2 "
            f"{k2} K3 {k3}, of them the services' warm-up sweeps K2 {w2} K3 "
            f"{w3}; serving alone K2 {k2 - w2} K3 {k3 - w3} "
            f"({(k2 - w2) / len(futs):.2f} / {(k3 - w3) / len(futs):.2f} a "
            f"plan, counted), engine dispatches {disp} (mean batch "
            f"{len(futs) / max(disp, 1):.2f})")
        sweeps.check(f"plan_serve {label}", k2, k3)
        require(k2 > 0 and k3 > 0,
                f"plan_serve {label}: K2 {k2} / K3 {k3} launches")


# ---------------------------------------------------------------------------
# fault protocol, device init and the sanitizer
# ---------------------------------------------------------------------------

FAULT_SERVE_REQUESTS = 8  # requests of the d 256 fleet served with init="device"


def _host_ms(fn, iters=20, warmup=3):
    """ms a call on the host clock, the card synchronized before and after
    the ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _fault_device_init(dev):
    """On-device kmeans++: the card against the CPU on the same Gumbel rows
    (equal indices), the sweep against the sequential reference with
    ``init="device"`` on the card (equal labels and K), the device init's
    time against the numpy host init's (ms a program, host clock, card
    synchronized), and K under each seeding."""
    import numpy as np
    import torch

    from repro_torch.core.clustering import (
        _device_init, _kmeanspp_init, _pad_bucket, device_gumbel,
        device_kmeanspp, select_k_and_cluster, sweep_cluster_stack,
    )
    from repro_torch.serving import synthetic_fleet

    with np.load(FIXTURE) as z:
        cfd = z["cfd:emb_distinct"][z["cfd:index"]]
    req = synthetic_fleet(120, d=16, seed=0)[0]
    cases = (("cfd fixture embeddings", cfd, 48, 0),
             ("plan_serve request 0 (d 16)", req.embeddings, 8, req.seed))
    for label, x, k_max, seed in cases:
        n, d = x.shape
        k_up = min(k_max, n - 1)
        xb, pm = (torch.from_numpy(a) for a in _pad_bucket(x))
        g = device_gumbel(seed, k_up, len(xb), "cpu")
        want = device_kmeanspp(xb, pm, g)
        got = device_kmeanspp(xb.to(dev), pm.to(dev), g.to(dev)).cpu()
        require(torch.equal(got, want),
                f"fault: {label}: device kmeans++ on the card drew "
                f"{got.tolist()} against the CPU's {want.tolist()}")
        xb_d, pm_d = xb.to(dev), pm.to(dev)
        own = _device_init(xb_d, pm_d, seed, k_up).cpu()
        dev_ms = _host_ms(lambda: _device_init(xb_d, pm_d, seed, k_up))
        g_d = g.to(dev)
        draw_ms = _host_ms(lambda: device_gumbel(seed, k_up, len(xb), dev))
        loop_ms = _host_ms(lambda: device_kmeanspp(xb_d, pm_d, g_d))
        host_ms = _host_ms(lambda: _kmeanspp_init(x, k_up, seed))
        kw = dict(k_max=k_max, seed=seed, device=dev)
        (ls, si), = sweep_cluster_stack([x], init="device", **kw)
        lq, qi = select_k_and_cluster(x, init="device", **kw)
        (_, hi), = sweep_cluster_stack([x], init="host", **kw)
        log(f"[fault] device init {label}: n={n} d={d} k_up={k_up} bucket "
            f"{len(xb)}: card == cpu on the same Gumbel rows "
            f"({want[:8].tolist()} ...); torch-drawn indices "
            f"{own[:8].tolist()} ...; device init {dev_ms:.3f} ms a "
            f"program (host clock, synchronized; its Gumbel rows "
            f"{draw_ms:.3f} ms, the D^2 loop {loop_ms:.3f} ms) vs numpy "
            f"host init {host_ms:.3f} ms; K sweep {si['k']} sequential {qi['k']} "
            f"(init='device') vs host-init K {hi['k']}; labels equal "
            f"{bool(np.array_equal(ls, lq))}")
        require(np.array_equal(ls, lq) and si["k"] == qi["k"],
                f"fault: {label}: init='device' sweep K {si['k']} vs "
                f"sequential K {qi['k']}, labels differ")


def _fault_served_device_init(dev):
    """A PlanService with ``init="device"`` at the engine defaults: every
    served plan equals its closed-loop plan, and the warm requests build
    nothing (``recompile_guard(0)``)."""
    import numpy as np

    from repro_torch.analysis import recompile_guard
    from repro_torch.sampling.engine import PlanEngine, bucket_key
    from repro_torch.serving import PlanService, synthetic_fleet

    fleet = synthetic_fleet(FAULT_SERVE_REQUESTS, d=256, seed=0)
    buckets = sorted({bucket_key(r.embeddings) for r in fleet})
    kw = dict(k_max=48, iters=50, seed=0, init="device")
    ref = PlanEngine(device=dev, **kw).plan_many(fleet)
    _zero_counts()
    with PlanService(device=dev, max_delay_ms=5.0, **kw) as svc:
        svc.warmup(buckets)
        t0 = time.perf_counter()
        with recompile_guard(0, label="warm init='device' serve") as guard:
            plans = [f.result(timeout=600)
                     for f in [svc.submit(r) for r in fleet]]
        wall = time.perf_counter() - t0
        stats = svc.stats()
    counts = _counts()
    for i, (got, want) in enumerate(zip(plans, ref)):
        require(np.array_equal(got.labels, want.labels)
                and got.num_clusters == want.num_clusters
                and got.reps == want.reps,
                f"fault: served request {i} (init='device') differs from "
                f"its closed-loop plan")
    log(f"[fault] served init='device' (d 256, k_max 48, iters 50, buckets "
        f"{buckets}): {stats['served']} / {len(fleet)} served in "
        f"{wall:.3f} s, K {[p.num_clusters for p in plans]}, equal to the "
        f"closed-loop plans; recompile_guard(0) builds {guard.builds}; "
        f"launches K2 {counts['kmeans_assign_fused_batched']} K3 "
        f"{counts['silhouette_sums']}")
    require(stats["served"] == len(fleet) and stats["failed"] == 0,
            f"fault: init='device' service failed {stats['failed']}")
    require(counts["kmeans_assign_fused_batched"] > 0
            and counts["silhouette_sums"] > 0,
            "fault: init='device' service launched no K2 / K3")


def _fault_drill(dev):
    """A DeviceLost injected into a two-wide service degrades it; a
    poisoned plan through ``sanitize=True`` fails only its own future."""
    import numpy as np

    from repro_torch.analysis import NonFiniteError
    from repro_torch.distributed import DeviceLost
    from repro_torch.serving import PlanService, synthetic_fleet

    fleet = synthetic_fleet(8, d=16, seed=0)
    fired = []

    def lose_once():
        if not fired:
            fired.append(1)
            raise DeviceLost("injected participant loss")

    kw = dict(k_max=8, iters=10, seed=0, device=dev, max_delay_ms=2.0)
    with PlanService(data_devices=2, fault_hook=lose_once, **kw) as svc:
        plans = [f.result(timeout=600) for f in [svc.submit(r)
                                                 for r in fleet]]
        st = svc.stats()
    eng = st["engine"]
    log(f"[fault] drill data_devices=2 + one DeviceLost: served "
        f"{st['served']} / {len(fleet)} failed {st['failed']} "
        f"degraded_dispatches {eng['degraded_dispatches']} data_shards "
        f"{eng['data_shards']}")
    require(st["served"] == len(fleet) and st["failed"] == 0
            and all(p.num_clusters >= 1 for p in plans),
            "fault: a request failed under the injected DeviceLost")
    require(eng["degraded_dispatches"] == 1 and eng["data_shards"] == 1,
            f"fault: degraded {eng['degraded_dispatches']} to width "
            f"{eng['data_shards']}")

    poisoned = list(fleet[:3])
    poisoned[1] = dataclasses.replace(poisoned[1],
                                      extra={"score": float("nan")})
    with PlanService(sanitize=True, **kw) as svc:
        futs = [svc.submit(r) for r in poisoned]
        outcome = []
        for f in futs:
            try:
                outcome.append(bool(np.isfinite(
                    f.result(timeout=600).labels).all()))
            except NonFiniteError as e:
                outcome.append(type(e).__name__)
        st = svc.stats()
    log(f"[fault] drill sanitize=True, request 1 poisoned: outcomes "
        f"{outcome} sanitize_trips {st['sanitize_trips']} served "
        f"{st['served']} failed {st['failed']}")
    require(outcome == [True, "NonFiniteError", True]
            and st["sanitize_trips"] == 1 and st["served"] == 2,
            "fault: the sanitizer did not isolate the poisoned plan")


def _fault_fit(dev):
    """The default phi-2 fit with a fault at its first chunk boundary: the
    fit checkpoints there and raises; ``fit_resilient`` resumes and
    finishes with parameters bit-equal to an uninterrupted fit."""
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.rgcn import RGCNConfig
    from repro_torch.core.train import (
        ContrastiveTrainer, GCLTrainConfig, fit_resilient,
    )
    from repro_torch.distributed import DeviceLost

    graphs = _phi2_training_graphs()
    tc = GCLTrainConfig(checkpoint_every=40)
    seen = []

    def lose_first(done):
        seen.append(done)
        if len(seen) == 1:
            raise DeviceLost("injected at the first boundary")

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ck:
        try:
            ContrastiveTrainer(RGCNConfig(), tc, device=dev).fit(
                graphs, checkpoint_dir=ck, fault_hook=lose_first)
            raise SmokeFailure("fault: the fit did not raise DeviceLost")
        except DeviceLost:
            pass
        saved = CheckpointManager(ck).latest_step()
    require(saved == seen[0], f"fault: fit raised at boundary {seen[0]} "
            f"but its latest checkpoint is {saved}")
    seen.clear()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ck:
        enc, info = fit_resilient(RGCNConfig(), tc, graphs,
                                  checkpoint_dir=ck, device_counts=[1, 1],
                                  fault_hook=lose_first, device=dev)
    res_s = time.perf_counter() - t0
    full, full_info = ContrastiveTrainer(RGCNConfig(), tc,
                                         device=dev).fit(graphs)
    p_res, p_full = dict(enc.named_parameters()), dict(
        full.named_parameters())
    gap = _norm_gap(p_res, p_full)
    _, equal = _param_gap(p_res, p_full)
    steps = tc.steps
    log(f"[fault] fit: DeviceLost at the first boundary (step {saved}, "
        f"checkpointed there); fit_resilient {res_s:.2f} s: degradations "
        f"{info['degradations']} resumed_from {info['resumed_from']} "
        f"history {len(info['history'])} / {steps} boundaries {seen} "
        f"chunk_len {info['chunk_len']}; parameters vs the uninterrupted "
        f"fit: bits equal {equal} (|diff| / |full| {gap:.3e}); loss "
        f"history equal {[h['loss'] for h in info['history']] == [h['loss'] for h in full_info['history']]}")
    require(len(info["history"]) == steps and len(info["degradations"]) == 1
            and info["resumed_from"] == saved,
            f"fault: fit_resilient finished {len(info['history'])} steps")
    require(equal, f"fault: fit_resilient parameters differ from the "
            f"uninterrupted fit ({gap:.3e})")


def phase_fault(dev):
    _fault_device_init(dev)
    _fault_served_device_init(dev)
    _fault_drill(dev)
    _fault_fit(dev)


# ---------------------------------------------------------------------------
# training phases
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _phi2_training_graphs():
    """The phi-2 graphs the default fit trains on (``train_subsample``
    draw), traced once per run."""
    from repro_torch.core.sampler import GCLSampler
    from repro_torch.tracing.programs import get_program

    sampler = GCLSampler(device="cpu")
    prog = get_program("phi-2")
    return sampler.training_graphs(sampler.iter_graphs(prog), len(prog))


def _param_gap(got: dict, want: dict):
    """(largest max|got - want| / max|want| over the leaves, whether every
    bit is equal)."""
    import torch

    worst, equal = 0.0, True
    for k, w in want.items():
        g = got[k].detach().float().cpu()
        w = w.detach().float().cpu()
        equal &= torch.equal(g, w)
        worst = max(worst, rel_err(g, w)[1])
    return worst, equal


def _norm_gap(got: dict, want: dict) -> float:
    """|got - want| / |want| over all leaves as one vector (2-norms)."""
    import torch

    num = sum(float(torch.sum((got[k].detach().double().cpu()
                               - w.detach().double().cpu()) ** 2))
              for k, w in want.items())
    den = sum(float(torch.sum(w.detach().double().cpu() ** 2))
              for w in want.values())
    return (num / max(den, 1e-300)) ** 0.5


def phase_train(dev):
    """Three steps of the full-width encoder on the card and on the CPU from
    the same initial parameters, batches and draws (made on the CPU); the
    step-0 gradients of both are compared too."""
    import torch

    from repro_torch.core.rgcn import RGCNConfig, init_rgcn
    from repro_torch.core.train import (
        GCLTrainConfig, draw_seed, draw_step, packed_loss, train_step,
    )
    from repro_torch.optim import adamw_init

    batches = _training_batches(3)
    rc, tc = RGCNConfig(), GCLTrainConfig()
    out = {}
    for where in ("cpu", dev):
        enc = init_rgcn(tc.seed, rc).to(where)
        params = dict(enc.named_parameters())
        state = adamw_init(params, tc.opt)
        losses, grads = [], None
        t0 = time.perf_counter()
        for i, packed in enumerate(batches):
            b_cpu = {k: torch.from_numpy(v) for k, v in packed.items()}
            gen = torch.Generator().manual_seed(draw_seed(tc.seed, i))
            draws = draw_step(gen, b_cpu, rc)
            batch = {k: v.to(where) for k, v in b_cpu.items()}
            draws = tuple(d.to(where) for d in draws)
            if i == 0:
                loss, _ = packed_loss(enc, rc, tc.tau, batch, draws)
                grads = dict(zip(params, torch.autograd.grad(
                    loss, list(params.values()))))
            state, m = train_step(enc, rc, tc.tau, tc.opt, batch, draws,
                                  state)
            losses.append(float(m[0]))
        out[str(where)] = (losses, grads, params, time.perf_counter() - t0)
    (l_cpu, g_cpu, p_cpu, s_cpu), (l_card, g_card, p_card, s_card) = \
        out["cpu"], out[str(dev)]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    grad_gap = _norm_gap(g_card, g_cpu)
    grad_elem, _ = _param_gap(g_card, g_cpu)
    param_gap = _norm_gap(p_card, p_cpu)
    param_elem, _ = _param_gap(p_card, p_cpu)
    leaf_gap = max((_norm_gap({k: p_card[k]}, {k: p_cpu[k]}), k)
                   for k in p_cpu)
    P = [len(b["node_mask"]) for b in batches]
    log(f"[train] 3 steps, batches P={P}: losses card {l_card} cpu {l_cpu} "
        f"max rel loss gap {loss_gap:.3e} (tol {LOSS_TOL}); step-0 gradient "
        f"|card - cpu| / |cpu| {grad_gap:.3e} (tol {GRAD_TOL}; largest "
        f"element gap / max of its leaf {grad_elem:.3e}); parameters after "
        f"step 3 |card - cpu| / |cpu| {param_gap:.3e} (tol {PARAM_TOL}; "
        f"worst leaf {leaf_gap[1]} {leaf_gap[0]:.3e}, largest element gap / "
        f"max of its leaf {param_elem:.3e}); wall card {s_card:.2f} s cpu "
        f"{s_cpu:.2f} s")
    require(loss_gap <= LOSS_TOL, f"train: loss gap {loss_gap:.3e}")
    require(grad_gap <= GRAD_TOL, f"train: gradient gap {grad_gap:.3e}")
    require(param_gap <= PARAM_TOL, f"train: parameter gap {param_gap:.3e}")


def phase_resume(dev):
    """A fit interrupted at step 8 and resumed from its checkpoint against
    the uninterrupted fit, both on the card."""
    import tempfile

    from repro_torch.core.rgcn import RGCNConfig
    from repro_torch.core.train import (
        ContrastiveTrainer, FitInterrupted, GCLTrainConfig,
    )

    graphs = _phi2_training_graphs()
    tc = GCLTrainConfig(steps=16, checkpoint_every=4, log_every=8)
    full, i_full = ContrastiveTrainer(RGCNConfig(), tc, device=dev).fit(graphs)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ck:
        try:
            ContrastiveTrainer(RGCNConfig(), tc, device=dev).fit(
                graphs, checkpoint_dir=ck, interrupt_after=8)
            raise SmokeFailure("resume: the fit was not interrupted")
        except FitInterrupted:
            pass
        res, i_res = ContrastiveTrainer(RGCNConfig(), tc, device=dev).fit(
            graphs, checkpoint_dir=ck)
    p_res, p_full = dict(res.named_parameters()), dict(full.named_parameters())
    gap = _norm_gap(p_res, p_full)
    _, equal = _param_gap(p_res, p_full)
    same_hist = [h["loss"] for h in i_full["history"]] == \
        [h["loss"] for h in i_res["history"]]
    log(f"[resume] 16 steps, interrupted at 8, resumed from "
        f"{i_res['resumed_from']}: |resumed - full| / |full| over the "
        f"parameters {gap:.3e} (tol "
        f"{RESUME_TOL}) bits equal {equal} loss history equal {same_hist} "
        f"val_loss {i_full['val_loss']!r} vs {i_res['val_loss']!r}")
    require(i_res["resumed_from"] == 8, "resume: did not resume from step 8")
    require(gap <= RESUME_TOL, f"resume: parameter gap {gap:.3e}")


def _device_profile(prof):
    """(busy seconds, [(device us, name, count)] sorted) of a profile."""
    busy, top = 0.0, []
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        t = ev.self_cuda_time_total if t is None else t
        busy += t
        top.append((t, ev.key, ev.count))
    top.sort(reverse=True)
    return busy / 1e6, top


def phase_fit(dev):
    """The default fit on phi-2 through ``GCLSampler.train``, then the same
    fit under torch.profiler for the device's busy share and top ops."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.sampler import GCLSampler

    graphs = _phi2_training_graphs()
    wrappers = {k: w for k, w in _all_wrappers().items()
                if k in ("rgcn_fused_flat", "rgcn_fused_bwd",
                         "rgcn_spmm_flat")}
    for w in wrappers.values():
        w.launches = 0
    sampler = GCLSampler(device=dev)
    t0 = time.perf_counter()
    info = sampler.train(graphs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    hist = info["history"]
    steps = len(hist)
    pick = [i for i in (0, 50, steps - 1) if i < steps]
    losses = {i: hist[i]["loss"] for i in pick}
    log(f"[fit] phi-2: {len(graphs)} graphs, {steps} steps, bucket keys "
        f"{info['bucket_keys']}: loss at steps {losses} val_loss "
        f"{info['val_loss']!r} val_acc {info['val_acc']!r} steps/s "
        f"{steps / info['fit_s']:.2f} (step loop {info['fit_s']:.2f} s, "
        f"whole fit with packing and validation {wall:.2f} s) host syncs "
        f"{info['host_syncs']} launches {json.dumps(launches)} "
        f"({ {k: v / max(steps, 1) for k, v in launches.items()} } per step)")
    require(all(math.isfinite(h["loss"]) for h in hist),
            "fit: non-finite loss")
    require(hist[-1]["loss"] < hist[0]["loss"],
            f"fit: last loss {hist[-1]['loss']} not below the first "
            f"{hist[0]['loss']}")
    for name, count in launches.items():
        require(count > 0, f"fit: kernel {name} was never launched")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p_info = GCLSampler(device=dev).train(graphs)
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
    busy_s, top = _device_profile(prof)
    split: dict = {}
    for t, key, count in top:
        kind = next((k for k, marks in FIT_SPLIT if any(m in key for m in marks)),
                    "other (elementwise, reductions: autograd, LayerNorm, "
                    "AdamW, InfoNCE)")
        t0, n0 = split.get(kind, (0.0, 0))
        split[kind] = (t0 + t / 1e6, n0 + count)
    launches_per_step = sum(c for t, k, c in top
                            if not k.startswith("Mem")) / len(hist)
    log(f"[fit] profiled fit: wall_s {p_wall:.3f} (step loop "
        f"{p_info['fit_s']:.3f} s) device busy_s {busy_s:.4f} busy share "
        f"{busy_s / p_wall:.4f} idle share {1 - busy_s / p_wall:.4f}; device "
        f"kernels per step {launches_per_step:.0f} (validation included)")
    for kind, (t, n) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        per = (f" (x{n}, {t * 1e6 / n:.2f} us a launch)"
               if kind.startswith("K") else "")
        log(f"[fit]   split {t * 1e3:9.3f} ms {100 * t / busy_s:5.1f} %  "
            f"{kind}{per}")
    for t, key, count in top[:12]:
        log(f"[fit]   {t / 1e3:9.3f} ms {100 * t / 1e6 / busy_s:5.1f} %  "
            f"x{count:<7d} {key[:70]}")
    return launches


#: the staging phase's modes in turn (prefetch off, on, on, off), its
#: bf16-message fit's steps, and the bf16 messages' limit against float32
#: messages on the card (largest gap over the largest |z|)
STAGING_TURNS = (False, True, True, False)
STAGING_BF16_STEPS = 32
MSG_TOL = 5e-3


def _staging_fit(dev, graphs, rc=None, **tc):
    """(encoder, info, wall s) of a fit on ``dev``, the card synchronized."""
    import torch

    from repro_torch.core.rgcn import RGCNConfig
    from repro_torch.core.train import ContrastiveTrainer, GCLTrainConfig

    t0 = time.perf_counter()
    enc, info = ContrastiveTrainer(rc or RGCNConfig(), GCLTrainConfig(**tc),
                                   device=dev).fit(graphs)
    torch.cuda.synchronize(dev)
    return enc, info, time.perf_counter() - t0


def _staging_line(info) -> str:
    return (f"stage_s {info['prefetch_stage_s']:.4f} wait_s "
            f"{info['prefetch_wait_s']:.4f} overlap "
            f"{info['prefetch_overlap']:.4f}")


def phase_staging(dev, smi_line):
    """Phase 8s (see the module docstring)."""
    import math

    import numpy as np
    import torch

    from repro_torch.core.rgcn import RGCNConfig, encode_packed
    from repro_torch.core.train import ContrastiveTrainer, GCLTrainConfig

    graphs = _phi2_training_graphs()
    fits = []
    for on in STAGING_TURNS:
        enc, info, wall = _staging_fit(dev, graphs, prefetch=on)
        fits.append((on, enc, info))
        steps = len(info["history"])
        log(f"[staging] fit prefetch={on}: {steps} steps, steps/s "
            f"{steps / info['fit_s']:.2f} (step loop {info['fit_s']:.3f} s, "
            f"whole fit {wall:.3f} s), {_staging_line(info)} on {smi_line}")
    _, e0, i0 = fits[0]
    p0 = dict(e0.named_parameters())
    for on, e, info in fits[1:]:
        _, equal = _param_gap(dict(e.named_parameters()), p0)
        require(equal and info["history"] == i0["history"]
                and info["val_loss"] == i0["val_loss"],
                f"staging: the fit with prefetch={on} differs from the fit "
                f"with prefetch=False")
    log("[staging] fit: parameters, history and val_loss bit-equal in all "
        "four turns")

    program = _program_graphs("phi-2")
    enc = e0
    for kind in ("embed", "embed_stream"):
        outs = []
        for on in STAGING_TURNS:
            tr = ContrastiveTrainer(RGCNConfig(), GCLTrainConfig(prefetch=on),
                                    device=dev)       # a cold cache each turn
            t0 = time.perf_counter()
            z = (tr.embed(enc, program) if kind == "embed"
                 else tr.embed_stream(enc, iter(program)))
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            outs.append(z)
            st = tr.embed_stats
            log(f"[staging] {kind} prefetch={on}: {len(program)} graphs, "
                f"{st['encoded']} encoded in {st['microbatches']} "
                f"micro-batches, wall {wall:.4f} s, {_staging_line(st)}")
        require(all(np.array_equal(z, outs[0]) for z in outs[1:]),
                f"staging: {kind} differs between prefetch on and off")
        log(f"[staging] {kind}: embeddings bit-equal in all four turns")

    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in _main_path_batch().items()}
    _zero_counts()
    with torch.inference_mode():
        z16 = encode_packed(enc, RGCNConfig(message_dtype="bfloat16"), batch)
        z32 = encode_packed(enc, RGCNConfig(), batch)
    k1 = _counts()["rgcn_fused_flat"]
    gap = float((z16 - z32).abs().max()) / float(z32.abs().max())
    log(f"[staging] bf16 messages, phi-2's first micro-batch (P="
        f"{batch['node_mask'].shape[0]}): max |z_bf16 - z_f32| / max |z_f32| "
        f"{gap:.3e} (limit {MSG_TOL}, > 0), K1 launches {k1}")
    require(0 < gap <= MSG_TOL, f"staging: bf16 message gap {gap:.3e}")
    require(k1 == 6, f"staging: K1 launched {k1} times, not 3 a call")

    _zero_counts()
    _, info, wall = _staging_fit(
        dev, graphs, RGCNConfig(message_dtype="bfloat16"),
        steps=STAGING_BF16_STEPS, log_every=8)
    counts = {k: v for k, v in _counts().items()
              if k in ("rgcn_fused_flat", "rgcn_fused_bwd", "rgcn_spmm_flat")}
    losses = [h["loss"] for h in info["history"]]
    q = len(losses) // 4
    f32 = [h["loss"] for h in i0["history"][:len(losses)]]
    log(f"[staging] bf16-message fit, {len(losses)} steps: losses every 4 "
        f"steps {' '.join(f'{x:.4f}' for x in losses[::4])}, the f32 fit's "
        f"at the same steps {' '.join(f'{x:.4f}' for x in f32[::4])}; "
        f"mean of the first / last {q} steps bf16 {np.mean(losses[:q]):.4f}"
        f" / {np.mean(losses[-q:]):.4f}, f32 {np.mean(f32[:q]):.4f} / "
        f"{np.mean(f32[-q:]):.4f}; steps/s "
        f"{len(losses) / info['fit_s']:.2f}, launches {json.dumps(counts)}")
    require(all(math.isfinite(x) for x in losses),
            "staging: a bf16-message loss is not finite")
    require(np.mean(losses[-q:]) < np.mean(losses[:q]),
            "staging: the bf16-message fit's losses did not fall")
    require(all(v > 0 for v in counts.values()),
            f"staging: a fit kernel was never launched: {counts}")


#: the data-parallel phase's fit: the default encoder and optimizer, 32
#: steps of 16 graphs, fault boundaries and checkpoints every 8 steps
DP_FIT = dict(steps=32, scan_chunk=8, checkpoint_every=8, log_every=8)
#: the steps over which a width-2 fit is held to the one-rank fit (JAX's
#: ``test_scaleout.py`` horizon: the first 8 steps of DP_FIT's fit, whose
#: selections, draws and boundaries they are).  Further on, the partial
#: gradients' other summation order (8e-9 of the parameters after one
#: step) is magnified as the card's noise is against the CPU (see
#: GRAD_TOL): 1.9e-4 of the parameters after 32 steps; printed, not held
DP_HELD_STEPS = 8
#: the fit's kernels, counted a step in each rank
DP_KERNELS = ("rgcn_fused_flat", "rgcn_fused_bwd", "rgcn_spmm_flat")
#: seconds a spawn of ranks may take before the phase kills it and fails
DP_DEADLINE = 300


def _dp_fit(dev, group, graphs, steps=None, **kw):
    """The phase's fit on ``dev`` over ``group`` (None: no group), cut to
    ``steps``: (encoder, info, the fit's kernels' launches a step)."""
    import torch

    from repro_torch.core.rgcn import RGCNConfig
    from repro_torch.core.train import ContrastiveTrainer, GCLTrainConfig

    wrappers = {k: w for k, w in _all_wrappers().items() if k in DP_KERNELS}
    for w in wrappers.values():
        w.launches = 0
    tc = GCLTrainConfig(**dict(DP_FIT, steps=steps or DP_FIT["steps"]))
    enc, info = ContrastiveTrainer(RGCNConfig(), tc, device=dev,
                                   group=group).fit(graphs, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    steps = max(len(info["history"]) - info["resumed_from"], 1)
    return enc, info, {k: w.launches / steps for k, w in wrappers.items()}


def _np_params(enc) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in enc.state_dict().items()}


def _dp_rank(rank, world, tmp, backend, device):
    """One rank of phase ``data_parallel`` (a spawned process on
    ``device``); its results go to ``rank<r>-<backend>.pkl`` in ``tmp``."""
    import os
    import pickle

    import numpy as np
    import torch

    from repro_torch.core.rgcn import RGCNConfig
    from repro_torch.core.train import (
        FitInterrupted, GCLTrainConfig, fit_resilient,
    )
    from repro_torch.distributed import DeviceLost
    from repro_torch.distributed.group import init_group
    from repro_torch.optim.grad_compress import (
        compressed_psum_mean, psum_mean,
    )
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(device)
    group = init_group(backend, rank, world,
                       os.path.join(tmp, f"store-{backend}"))
    with open(os.path.join(tmp, "graphs.pkl"), "rb") as f:
        graphs = pickle.load(f)
    held, h_info, _ = _dp_fit(dev, group, graphs, steps=DP_HELD_STEPS)
    out = {"held": dict(params=_np_params(held), val_loss=h_info["val_loss"],
                        losses=[h["loss"] for h in h_info["history"]])}
    enc, info, launches = _dp_fit(dev, group, graphs)
    out["fit"] = dict(
        params=_np_params(enc), losses=[h["loss"] for h in info["history"]],
        val_loss=info["val_loss"], data_shards=info["data_shards"],
        step_ms=1e3 * info["fit_s"] / len(info["history"]),
        collective_bytes=info["collective_bytes"], launches=launches,
        prefetch=info["prefetch"], overlap=info["prefetch_overlap"])
    if backend == "nccl":
        plain, p_info, _ = _dp_fit(dev, None, graphs)
        out["no_group"] = _np_params(plain)
        out["no_group_step_ms"] = 1e3 * p_info["fit_s"] / DP_FIT["steps"]
    else:
        again, a_info, _ = _dp_fit(dev, group, graphs)
        out["refit"] = _np_params(again)
        out["refit_step_ms"] = 1e3 * a_info["fit_s"] / DP_FIT["steps"]
        ck = os.path.join(tmp, "ck")
        try:
            _dp_fit(dev, group, graphs, checkpoint_dir=ck, interrupt_after=8)
            out["interrupted"] = False
        except FitInterrupted:
            out["interrupted"] = True
        res, i_res, _ = _dp_fit(dev, group, graphs, checkpoint_dir=ck)
        out["resume"] = dict(params=_np_params(res),
                             resumed_from=i_res["resumed_from"],
                             losses=[h["loss"] for h in i_res["history"]])
        # the collectives on tensors of the encoder's shapes: rank r holds
        # row r of each seeded (world, ...) array
        rng = np.random.default_rng(0)
        rows = {k: rng.standard_normal((world,) + v.shape).astype(np.float32)
                for k, v in out["fit"]["params"].items()}
        grads = {k: torch.from_numpy(v[rank].copy()).to(dev)
                 for k, v in rows.items()}
        exact = psum_mean(grads, group)
        approx, err = compressed_psum_mean(
            grads, {k: torch.zeros_like(v) for k, v in grads.items()}, group)
        out["psum"] = {k: (float((approx[k] - exact[k]).abs().max()),
                           float(np.abs(rows[k]).max() / 127.0),
                           float(err[k].abs().max()),
                           bool(torch.isfinite(err[k]).all()))
                       for k in grads}
        calls = []

        def lose_once(done):
            calls.append(done)
            if len(calls) == 1 and rank == world - 1:
                raise DeviceLost("injected participant loss")

        r_enc, r_info = fit_resilient(
            RGCNConfig(), GCLTrainConfig(**DP_FIT), graphs,
            checkpoint_dir=os.path.join(tmp, "ck_res"), fault_hook=lose_once,
            device=dev, group=group)
        out["resilient"] = dict(
            params=None if r_enc is None else _np_params(r_enc),
            degradations=r_info["degradations"],
            data_shards=r_info["data_shards"],
            steps=len(r_info.get("history", ())),
            resumed_from=r_info.get("resumed_from"))
    with open(os.path.join(tmp, f"rank{rank}-{backend}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _dp_spawn(world, tmp, backend, dev):
    """Run ``world`` ranks of ``_dp_rank`` to their end (a rank's exception
    fails the phase; the spawn is killed after DP_DEADLINE s); returns
    their results in rank order."""
    import pickle

    import torch.multiprocessing as mp

    ctx = mp.start_processes(_dp_rank, args=(world, tmp, backend, str(dev)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DP_DEADLINE
    try:
        while not ctx.join(timeout=1):
            require(time.monotonic() < deadline,
                    f"data_parallel: {backend} ranks still running after "
                    f"{DP_DEADLINE} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    out = []
    for r in range(world):
        with open(Path(tmp) / f"rank{r}-{backend}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _same_params(a: dict, b: dict) -> bool:
    import numpy as np

    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def _np_gap(got: dict, want: dict) -> float:
    import torch

    return _norm_gap({k: torch.from_numpy(v) for k, v in got.items()},
                     {k: torch.from_numpy(v) for k, v in want.items()})


def phase_data_parallel(dev, smi_line):
    """Phase 8a (see the module docstring)."""
    import pickle

    import numpy as np

    graphs = _phi2_training_graphs()
    steps = DP_FIT["steps"]
    held1, h_info1, _ = _dp_fit(dev, None, graphs, steps=DP_HELD_STEPS)
    enc1, info1, launch1 = _dp_fit(dev, None, graphs)
    one = _np_params(enc1)
    loss1 = [h["loss"] for h in info1["history"]]
    step1 = 1e3 * info1["fit_s"] / steps
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        with open(Path(tmp) / "graphs.pkl", "wb") as f:
            pickle.dump(list(graphs), f)
        t0 = time.perf_counter()
        gloo = _dp_spawn(2, tmp, "gloo", dev)
        gloo_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (nccl,) = _dp_spawn(1, tmp, "nccl", dev)
        nccl_s = time.perf_counter() - t0
    held2, fit2 = gloo[0]["held"], gloo[0]["fit"]
    loss_h1 = [h["loss"] for h in h_info1["history"]]
    gap = _np_gap(held2["params"], _np_params(held1))
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(held2["losses"], loss_h1))
    val_gap = abs(held2["val_loss"] - h_info1["val_loss"]) / abs(
        h_info1["val_loss"])
    log(f"[data_parallel] width 2 (gloo, both ranks on {dev}) vs width 1, "
        f"{DP_HELD_STEPS} steps of {len(graphs)} phi-2 graphs: |params - "
        f"one rank| / |one rank| {gap:.3e} (tol {RESUME_TOL}), max rel loss "
        f"gap {loss_gap:.3e} and val_loss {val_gap:.3e} (tol {LOSS_TOL}), "
        f"step-0 loss bits equal {held2['losses'][0] == loss_h1[0]}")
    require(fit2["data_shards"] == 2, "data_parallel: data_shards is not 2")
    require(all(o["fit"]["prefetch"] for o in gloo + [nccl]),
            "data_parallel: a rank's fit ran without prefetch")
    overlaps = " / ".join(f"{o['fit']['overlap']:.4f}" for o in gloo)
    log(f"[data_parallel] every rank staged one chunk ahead (prefetch=True),"
        f" overlap {overlaps} (gloo), {nccl['fit']['overlap']:.4f} (nccl)")
    require(gap <= RESUME_TOL, f"data_parallel: parameter gap {gap:.3e}")
    require(max(loss_gap, val_gap) <= LOSS_TOL,
            f"data_parallel: loss gap {max(loss_gap, val_gap):.3e}")
    gaps = [abs(a - b) / abs(b) for a, b in zip(fit2["losses"], loss1)]
    log(f"[data_parallel] the same at {steps} steps (printed, not held; "
        f"see DP_HELD_STEPS): parameters {_np_gap(fit2['params'], one):.3e}, "
        f"loss gaps a step {' '.join(f'{g:.1e}' for g in gaps)}, val_loss "
        f"{fit2['val_loss']!r} vs {info1['val_loss']!r}; the ranks' bits "
        f"equal {_same_params(gloo[1]['fit']['params'], fit2['params'])}")
    for o in gloo[1:]:
        require(_same_params(o["fit"]["params"], fit2["params"])
                and _same_params(o["held"]["params"], held2["params"]),
                "data_parallel: the two ranks' encoders differ")
    for r, o in enumerate(gloo):
        require(_same_params(o["refit"], o["fit"]["params"]),
                f"data_parallel: rank {r}'s refit at width 2 differs")
        res = o["resume"]
        require(o["interrupted"] and res["resumed_from"] == 8
                and res["losses"] == o["fit"]["losses"]
                and _same_params(res["params"], o["fit"]["params"]),
                f"data_parallel: rank {r}'s resume at width 2 differs")
    log("[data_parallel] width 2: refit bit-equal, interrupted at 8 and "
        "resumed bit-equal, on both ranks")
    worst = max(d / g for o in gloo for d, g, _, _ in o["psum"].values())
    for o in gloo:
        for k, (d, g, e, fin) in o["psum"].items():
            require(d <= g + 1e-6 and e <= g + 1e-6 and fin,
                    f"data_parallel: compressed_psum_mean {k} off by {d} "
                    f"(grid {g})")
    log(f"[data_parallel] compressed_psum_mean vs psum_mean over 2 ranks on "
        f"the card, {len(gloo[0]['psum'])} leaves of the encoder's shapes: "
        f"largest |diff| / grid (amax / 127) {worst:.4f} (tol 1)")
    fin = gloo[0]["resilient"]
    log(f"[data_parallel] fit_resilient 2 -> 1: degradations "
        f"{fin['degradations']} data_shards {fin['data_shards']} resumed "
        f"from {fin['resumed_from']} steps {fin['steps']}; rank 1 returned "
        f"{gloo[1]['resilient']['params'] is None and 'no encoder'} "
        f"(data_shards {gloo[1]['resilient']['data_shards']})")
    require(fin["data_shards"] == 1 and fin["steps"] == steps
            and fin["degradations"] == [{
                "from_devices": 2, "to_devices": 1,
                "error": "injected participant loss"}]
            and gloo[1]["resilient"]["params"] is None,
            "data_parallel: fit_resilient did not go 2 -> 1 and finish")
    require(all(np.isfinite(v).all() for v in fin["params"].values()),
            "data_parallel: fit_resilient's encoder is not finite")
    require(_same_params(nccl["no_group"], nccl["fit"]["params"]),
            "data_parallel: the one-rank NCCL fit differs from the fit "
            "with no group")
    log(f"[data_parallel] one-rank NCCL group: bit-equal to the fit with no "
        f"group (spawn {nccl_s:.1f} s; gloo spawn {gloo_s:.1f} s)")
    require(all(v > 0 for v in launch1.values()),
            f"data_parallel: a fit kernel was never launched: {launch1}")
    for r, o in enumerate(gloo + [nccl]):
        require(o["fit"]["launches"] == launch1,
                f"data_parallel: rank {r}'s launches a step "
                f"{o['fit']['launches']} differ from one rank's {launch1}")
    log(f"[data_parallel] K1 / K1b / K5 launches a step: one rank "
        f"{launch1}, each width-2 rank {gloo[0]['fit']['launches']}")
    log(f"[data_parallel] step ms (step loop / {steps} steps; the ranks' "
        f"first 32-step fit follows their 8-step one) and collective bytes a "
        f"step on {smi_line}: width 1 no group {step1:.3f} ms 0 B (this "
        f"process), {nccl['no_group_step_ms']:.3f} ms (the NCCL rank's "
        f"process, after its group fit); width 1 nccl "
        f"{nccl['fit']['step_ms']:.3f} ms "
        f"{nccl['fit']['collective_bytes']:.0f} B; width 2 gloo ranks "
        f"{gloo[0]['fit']['step_ms']:.3f} / {gloo[1]['fit']['step_ms']:.3f} "
        f"ms, refit {gloo[0]['refit_step_ms']:.3f} / "
        f"{gloo[1]['refit_step_ms']:.3f} ms, "
        f"{fit2['collective_bytes']:.0f} B")
    _dp_placed_sweep(dev)


def _dp_placed_sweep(dev):
    """The sweep dispatch placed over [dev, dev] against the unplaced one
    (labels, K, scores bit-equal), with JAX's dispatch count."""
    import numpy as np

    from repro_torch.sampling.engine import PlanEngine, bucket_key

    rng = np.random.default_rng(7)
    embs = [rng.standard_normal((60 + 23 * i, 256)).astype(np.float32)
            for i in range(24)]
    wrappers = {k: w for k, w in _all_wrappers().items()
                if k in ("kmeans_assign_fused", "silhouette_sums")}
    kw = dict(data_devices=2, device=dev)
    results, walls = {}, {"placed": [], "unplaced": []}
    # unplaced, placed, placed, unplaced: the first dispatches of a run
    # pay for the allocator's growth
    for name in ("unplaced", "placed", "placed", "unplaced"):
        eng = PlanEngine(devices=[dev, dev] if name == "placed" else [dev],
                         **kw)
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        results[name] = eng.cluster_many(embs)
        walls[name].append(time.perf_counter() - t0)
        if name == "placed":
            placed = (eng.stats["dispatches"],
                      {k: w.launches for k, w in wrappers.items()},
                      eng.engine_stats()["data_shards"])
    cap = eng.cfg.max_batch * 2
    groups: dict = {}
    for x in embs:
        groups[bucket_key(x)] = groups.get(bucket_key(x), 0) + 1
    want = sum(-(-n // cap) for n in groups.values())
    same = all(np.array_equal(a[0], b[0]) and a[1]["k"] == b[1]["k"]
               and a[1].get("scores") == b[1].get("scores")
               for a, b in zip(results["placed"], results["unplaced"]))
    log(f"[data_parallel] placed sweep: {len(embs)} programs (d 256, k_max "
        f"48) over [{dev}, {dev}], data_shards {placed[2]}: dispatches "
        f"{placed[0]} (JAX's rule {want}), K2 / K3 launches {placed[1]}, "
        f"bit-equal to the unplaced dispatch {same}; wall s unplaced, "
        f"placed, placed, unplaced {walls['unplaced'][0]:.3f} "
        f"{walls['placed'][0]:.3f} {walls['placed'][1]:.3f} "
        f"{walls['unplaced'][1]:.3f}")
    require(same, "data_parallel: the placed sweep differs from the "
            "unplaced dispatch")
    require(placed[0] == want, f"data_parallel: {placed[0]} dispatches, "
            f"JAX's rule gives {want}")
    require(all(v > 0 for v in placed[1].values()),
            "data_parallel: K2 or K3 was not launched by the placed sweep")


#: phase 8b: llama3.2-3b at its widths, MP_LAYERS layers, trained through
#: ``launch.train.main`` over a (2, 2) mesh of MP_WORLD gloo ranks that
#: share ``cuda:0``, at JAX's CLI batch (8 x 256), MP_STEPS steps
MP_WORLD = 4
MP_MESH = (2, 2)
MP_ARCH, MP_LAYERS, MP_STEPS = "llama3.2-3b", 2, 4
MP_BATCH = (8, 256)
#: a (2, 2) rank's K7 / K7b input q: its 4 rows of the batch, 12 of the 24
#: heads as 4 kv heads of G = 3, head dim 128
MP_TP_SHAPE = (4, 256, 4, 3, 128)
#: a rank's parameters at MP_ARCH, MP_LAYERS layers, on MP_MESH (JAX's
#: specs), and the whole model's
MP_RANK_PARAMS, MP_WHOLE_PARAMS = 148_836_864, 595_344_384
#: the sharded bf16 run's losses against the one-card run's, relative
#: (``tests/test_torch_lm_train.py``'s BF16_TOL: bf16 partial outputs are
#: rounded before their sum over the model ranks)
MP_LOSS_TOL = 3e-2
#: the float32 smoke-width parity's steps, held at PARAM_TOL of each leaf
MP_PARITY_STEPS = 3
#: JAX's gradient accumulation on the mesh: MP_MB_STEPS steps of
#: ``--microbatch MP_MICROBATCH`` after the main path, against the same on
#: one card at MP_LOSS_TOL
MP_MICROBATCH, MP_MB_STEPS = 2, 2
#: seconds the spawn may take before the phase kills it and fails
MP_DEADLINE = 300
#: the bytes a rank carried a step at MP_ARCH on MP_MESH while the tied
#: table was gathered whole on every rank (its vocabulary not split): the
#: split step's count must stay below it
MP_WHOLE_TABLE_BYTES = 6_162_714_672


def _mp_parity_run(dev, step, plan=None, index=0):
    """MP_PARITY_STEPS float32 steps of MP_ARCH at smoke width from the
    seed-0 weights on ``dev`` (sharded when ``plan`` is given); the final
    state."""
    import torch

    from repro_torch.configs import smoke_arch
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten

    cfg = smoke_arch(MP_ARCH).replace(num_layers=MP_LAYERS)
    host = tf.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    if plan is not None:
        host = plan.shard(host, index)
    state = adamw_init(tree_unflatten(host, [x.to(dev) for x in
                                             tree_leaves(host)]),
                       _mp_parity_tcfg())
    data = TokenStream(cfg.vocab_size, MP_BATCH[1], MP_BATCH[0], seed=0)
    for _ in range(MP_PARITY_STEPS):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.next().items()}
        if plan is not None:
            batch = plan.local_batch(batch, index)
        state, _ = step(state, batch)
    return state


def _mp_parity_tcfg():
    from repro_torch.config import TrainConfig

    return TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=10)


def _mp_argv(steps, microbatch=0):
    """``launch.train.main``'s argv for phase 8b's llama runs."""
    return ["--arch", MP_ARCH, "--num-layers", str(MP_LAYERS), "--steps",
            str(steps), "--batch", str(MP_BATCH[0]), "--seq-len",
            str(MP_BATCH[1]), "--log-every", "1", "--microbatch",
            str(microbatch), "--device", "cuda"]


def _mp_rank(rank, world, tmp, device):
    """One rank of phase ``model_parallel`` on ``device``: the main path
    (``launch.train.main`` over the (2, 2) mesh, K7 / K7b counts zeroed
    just before it and read just after, the q shapes K7 was given), then
    the float32 smoke-width parity run; results to ``mp-rank<r>.pkl`` in
    ``tmp``."""
    import math
    import os
    import pickle

    import torch

    from repro_torch.config import TrainConfig
    from repro_torch.configs import smoke_arch
    from repro_torch.distributed.group import init_group
    from repro_torch.distributed.model_parallel import unshard_tree
    from repro_torch.interop import lm_params_to_numpy
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps, train
    from repro_torch.models import attention as attn_mod
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(device)
    group = init_group("gloo", rank, world, os.path.join(tmp, "store-mp"))
    mesh = mesh_mod.make_debug_mesh(*MP_MESH, group=group)
    shapes = set()
    inner = attn_mod.flash_attention

    def recorded(q, k, v, scale):
        shapes.add(tuple(q.shape))
        return inner(q, k, v, scale)

    attn_mod.flash_attention = recorded
    out = {}
    fa_ops.flash_attention.launches = 0
    fa_ops.flash_attention_bwd.launches = 0
    train.main(_mp_argv(MP_STEPS), out=out, mesh=mesh)
    launches = {"flash_attention": fa_ops.flash_attention.launches,
                "flash_attention_bwd": fa_ops.flash_attention_bwd.launches}
    attn_mod.flash_attention = inner
    plan = out["plan"]
    res = {"losses": [float(r["loss"]) for r in out["steps"]],
           "step_ms": [r["ms"] for r in out["steps"]],
           "peak_bytes": out["peak_bytes"] - out["base_bytes"],
           "state_bytes": out["state_bytes"],
           "collective_bytes": out["collective_bytes"],
           "counted_bytes": plan.collective_bytes(*MP_BATCH),
           "rank_params": plan.block_numel(),
           "whole_params": sum(math.prod(lf.shape) for lf in plan.leaves),
           "split": out["info"]["split"], "launches": launches,
           "q_shapes": sorted(shapes)}
    del out, plan
    torch.cuda.empty_cache()
    cfg = smoke_arch(MP_ARCH).replace(num_layers=MP_LAYERS)
    step = steps.make_sharded_train_step(
        cfg, _mp_parity_tcfg(), mesh_mod.make_rules(mesh), group)
    state = _mp_parity_run(dev, step, step.plan, step.groups.index)
    whole = unshard_tree(step.plan, step.groups, state.params)
    res["parity"] = lm_params_to_numpy(whole) if rank == 0 else None
    res["coords"] = step.groups.coords
    del state, whole
    torch.cuda.empty_cache()
    mb = {}
    train.main(_mp_argv(MP_MB_STEPS, MP_MICROBATCH), out=mb, mesh=mesh)
    res["mb"] = {"losses": [float(r["loss"]) for r in mb["steps"]],
                 "step_ms": [r["ms"] for r in mb["steps"]],
                 "collective_bytes": mb["collective_bytes"],
                 "counted": mb["plan"].collective_bytes(
                     *MP_BATCH, TrainConfig(microbatch=MP_MICROBATCH))}
    with open(os.path.join(tmp, f"mp-rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


def _mp_spawn(tmp, dev, fn=None, args=(), world=MP_WORLD,
              deadline=MP_DEADLINE, label="model_parallel", prefix="mp"):
    """Run ``world`` ranks of ``fn`` (``_mp_rank`` by default; called as
    ``fn(rank, world, tmp, str(dev), *args)``) to their end (a rank's
    exception fails the phase; the spawn is killed after ``deadline``
    s); their results, ``<prefix>-rank<r>.pkl`` in ``tmp``, in rank
    order."""
    import pickle

    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn or _mp_rank, args=(world, tmp, str(dev),
                                                   *args),
                             nprocs=world, join=False, start_method="spawn")
    t_end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=1):
            require(time.monotonic() < t_end,
                    f"{label}: ranks still running after {deadline} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    out = []
    for r in range(world):
        with open(Path(tmp) / f"{prefix}-rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _mp_kernels(rows, dev, shape=None, where="(2, 2)", key="tp", bwd=True):
    """K7 and (with ``bwd``) K7b at a mesh rank's shape (``shape``,
    MP_TP_SHAPE by default, bf16) against their plain versions, each timed
    beside its plain version, its library call and its bound; the times
    go into the table's K7 / K7b rows as ``<key>_*`` keys."""
    import torch

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_cost,
        flash_attention_bwd_plain, flash_attention_cost,
        flash_attention_plain,
    )
    from repro_torch.launch.roofline import PEAK_BF16_S, bound

    shape = MP_TP_SHAPE if shape is None else shape
    B, S, K, G, hd = shape
    H, dt = K * G, torch.bfloat16
    err, rel, q, k, v, scale = _k7_check(dev, shape, dt, 31)
    ms = device_ms(lambda: flash_attention(q, k, v, scale), 5,
                   own=k7_kernels(hd, dt))
    plain = device_ms(lambda: flash_attention_plain(q, k, v, scale), 3)
    qh = q.reshape(B, S, H, hd).transpose(1, 2).contiguous()
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    lib = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True), 5)
    ops, bytes_ = flash_attention_cost(B, S, K, G, hd, q.element_size())
    b_ms, b_by = bound(bytes_, ops, PEAK_BF16_S)
    log(f"[kernels] K7 flash_attention at a {where} rank's shape "
        f"{shape} bf16: max_abs_err {err:.3e} rel {rel:.3e} (tol "
        f"{BF16_TOL:.3e}) kernel device ms {ms.own:.4f} [{ms.source}] plain "
        f"device ms {plain.total:.4f} [{plain.source}] library device ms "
        f"{lib.total:.4f} [{lib.source}] (scaled_dot_product_attention, "
        f"causal, GQA) bound ms {b_ms:.4f} ({b_by})")
    tp = {"flash_attention": _keyed(key, ms.own, plain.total, lib.total,
                                    b_ms, err)}
    del q, k, v, qh, kh, vh
    if not bwd:
        torch.cuda.empty_cache()
        _update_rows(rows, tp)
        return
    err, rel, (q, k, v, o, do, scale, lse) = _k7b_check(dev, shape, dt, 32)
    ms = device_ms(lambda: flash_attention_bwd(q, k, v, o, do, scale, lse),
                   5, own=k7b_kernels(hd, dt))
    plain = device_ms(lambda: flash_attention_bwd_plain(q, k, v, o, do,
                                                        scale), 3)
    qh = q.reshape(B, S, H, hd).transpose(1, 2).contiguous()
    kh, vh = (t.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
              for t in (k, v))
    leaves = [t.requires_grad_(True) for t in (qh, kh, vh)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves,
                                                           is_causal=True)
    doh = do.reshape(B, S, H, hd).transpose(1, 2).contiguous()
    lib = device_ms(lambda: torch.autograd.grad(out, leaves, doh,
                                                retain_graph=True), 5)
    ops, bytes_ = flash_attention_bwd_cost(B, S, K, G, hd, q.element_size())
    b_ms, b_by = bound(bytes_, ops, PEAK_BF16_S)
    log(f"[kernels] K7b flash_attention_bwd at a {where} rank's shape "
        f"{shape} bf16: max_abs_err {err:.3e} rel {rel:.3e} (tol "
        f"{BF16_TOL:.3e}), repeat bit-equal; kernel device ms {ms.own:.4f} "
        f"[{ms.source}] plain device ms {plain.total:.4f} [{plain.source}] "
        f"library device ms {lib.total:.4f} [{lib.source}] "
        f"(scaled_dot_product_attention backward, K / V expanded to {H} "
        f"heads) bound ms {b_ms:.4f} ({b_by})")
    tp["flash_attention_bwd"] = _keyed(key, ms.own, plain.total, lib.total,
                                       b_ms, err)
    del q, k, v, o, do, lse, out, leaves, qh, kh, vh, doh
    torch.cuda.empty_cache()
    _update_rows(rows, tp)


def _keyed(key, ms, plain_ms, library_ms, bound_ms, err):
    """A kernel's times at a mesh rank's shape as the table's
    ``<key>_*`` keys."""
    return {f"{key}_ms": ms, f"{key}_plain_ms": plain_ms,
            f"{key}_library_ms": library_ms, f"{key}_bound_ms": bound_ms,
            f"{key}_max_abs_err": err}


def _update_rows(rows, extra):
    for name, _, _, _, m in rows:
        if name in extra:
            m.update(extra[name])


def phase_model_parallel(rows, dev, smi_line):
    """Phase 8b (see the module docstring)."""
    import numpy as np
    import torch

    from repro_torch.configs import smoke_arch
    from repro_torch.interop import lm_params_to_numpy
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step

    _mp_kernels(rows, dev)
    one, one_mb = {}, {}
    train.main(_mp_argv(MP_MB_STEPS, MP_MICROBATCH), out=one_mb)
    one_mb = {"losses": [float(r["loss"]) for r in one_mb["steps"]],
              "step_ms": [r["ms"] for r in one_mb["steps"]]}
    train.main(_mp_argv(MP_STEPS), out=one)
    one_losses = [float(r["loss"]) for r in one["steps"]]
    one_ms = [r["ms"] for r in one["steps"]]
    one_peak = one["peak_bytes"] - one["base_bytes"]
    one_state = one["state_bytes"]
    del one
    cfg = smoke_arch(MP_ARCH).replace(num_layers=MP_LAYERS)
    ref = lm_params_to_numpy(_mp_parity_run(
        dev, make_train_step(cfg, _mp_parity_tcfg())).params)
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        ranks = _mp_spawn(tmp, dev)
        spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    gaps = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], one_losses)]
    log(f"[model_parallel] {MP_ARCH} at its widths, {MP_LAYERS} layers, "
        f"bf16, batch {MP_BATCH[0]}x{MP_BATCH[1]}, {MP_STEPS} steps through "
        f"launch.train.main on a {MP_MESH} mesh of {MP_WORLD} gloo ranks "
        f"sharing {dev}: losses {' '.join(f'{x:.5f}' for x in r0['losses'])}"
        f" vs one card {' '.join(f'{x:.5f}' for x in one_losses)}, max rel "
        f"gap {max(gaps):.3e} (tol {MP_LOSS_TOL}); split in compute: "
        f"{len(r0['split'])} leaves ({', '.join(r0['split'])})")
    for r, o in enumerate(ranks):
        require(o["losses"] == r0["losses"],
                f"model_parallel: rank {r}'s losses differ from rank 0's")
    require(max(gaps) <= MP_LOSS_TOL,
            f"model_parallel: loss gap {max(gaps):.3e} > {MP_LOSS_TOL}")
    for r, o in enumerate(ranks):
        log(f"[model_parallel] rank {r} {tuple(o['coords'])} on "
            f"{smi_line}: step ms {' '.join(f'{x:.1f}' for x in o['step_ms'])}"
            f"; peak {o['peak_bytes']} B; state {o['state_bytes']} B "
            f"({o['rank_params']} of {o['whole_params']} params); "
            f"collective bytes a step {o['collective_bytes']} (counted "
            f"{o['counted_bytes']['total']}: "
            + ", ".join(f"{k} {v}" for k, v in o["counted_bytes"].items()
                        if k != "total")
            + f"); K7 / K7b launches {o['launches']['flash_attention']} / "
            f"{o['launches']['flash_attention_bwd']}, K7's q shapes "
            f"{o['q_shapes']}")
        require(o["rank_params"] == MP_RANK_PARAMS
                and o["whole_params"] == MP_WHOLE_PARAMS,
                f"model_parallel: rank {r} holds {o['rank_params']} of "
                f"{o['whole_params']} params")
        require(o["state_bytes"] == 12 * MP_RANK_PARAMS,
                f"model_parallel: rank {r}'s state is {o['state_bytes']} B")
        require(o["collective_bytes"] == o["counted_bytes"]["total"],
                f"model_parallel: rank {r} carried {o['collective_bytes']} "
                f"B a step, counted {o['counted_bytes']['total']}")
        require(o["collective_bytes"] < MP_WHOLE_TABLE_BYTES,
                f"model_parallel: rank {r} carried {o['collective_bytes']} "
                f"B a step, the whole table's {MP_WHOLE_TABLE_BYTES}")
        require(all(n > 0 for n in o["launches"].values()),
                f"model_parallel: rank {r} launched {o['launches']}")
        require(o["q_shapes"] == [MP_TP_SHAPE],
                f"model_parallel: rank {r}'s K7 took {o['q_shapes']}")
    log(f"[model_parallel] one card on {smi_line}: step ms "
        f"{' '.join(f'{x:.1f}' for x in one_ms)}; peak {one_peak} B; state "
        f"{one_state} B; the spawn of {MP_WORLD} ranks took {spawn_s:.1f} s")
    par = r0["parity"]
    worst = max((float(np.linalg.norm(par[k] - ref[k])
                       / max(np.linalg.norm(ref[k]), 1e-30)), k)
                for k in ref)
    log(f"[model_parallel] float32 smoke-width parity ({MP_LAYERS} layers, "
        f"batch {MP_BATCH[0]}x{MP_BATCH[1]}, {MP_PARITY_STEPS} steps): the "
        f"{MP_MESH} mesh's parameters vs one card's, worst leaf "
        f"{worst[0]:.3e} ({worst[1]}; tol {PARAM_TOL})")
    require(set(par) == set(ref) and worst[0] <= PARAM_TOL,
            f"model_parallel: smoke-width parity gap {worst[0]:.3e}")
    mb = r0["mb"]
    gaps = [abs(a - b) / abs(b) for a, b in zip(mb["losses"],
                                               one_mb["losses"])]
    log(f"[model_parallel] --microbatch {MP_MICROBATCH}, {MP_MB_STEPS} "
        f"steps on {MP_MESH}: losses "
        f"{' '.join(f'{x:.5f}' for x in mb['losses'])} vs one card "
        f"{' '.join(f'{x:.5f}' for x in one_mb['losses'])}, max rel gap "
        f"{max(gaps):.3e} (tol {MP_LOSS_TOL}); rank 0 step ms "
        f"{' '.join(f'{x:.1f}' for x in mb['step_ms'])} (one card "
        f"{' '.join(f'{x:.1f}' for x in one_mb['step_ms'])}); collective "
        f"bytes a step {mb['collective_bytes']} (counted "
        f"{mb['counted']['total']}: " + ", ".join(
            f"{k} {v}" for k, v in mb["counted"].items() if k != "total")
        + ")")
    require(len(mb["losses"]) == MP_MB_STEPS and max(gaps) <= MP_LOSS_TOL,
            f"model_parallel: --microbatch loss gap {max(gaps):.3e}")
    for r, o in enumerate(ranks):
        require(o["mb"]["losses"] == mb["losses"],
                f"model_parallel: --microbatch rank {r}'s losses differ")
        require(o["mb"]["collective_bytes"] == o["mb"]["counted"]["total"],
                f"model_parallel: --microbatch rank {r} carried "
                f"{o['mb']['collective_bytes']} B, counted "
                f"{o['mb']['counted']['total']}")


#: phase 8c: mamba2-780m at its widths, MP_SSM_LAYERS layers, trained
#: through ``launch.train.main`` over MP_MESH at MP_BATCH, MP_SSM_STEPS
#: steps; the SSM split over the model axis on a rank's heads
MP_SSM_ARCH, MP_SSM_LAYERS, MP_SSM_STEPS = "mamba2-780m", 2, 3
#: a (2, 2) rank's K8 / K8b shape (B, nc, Q, nh, hp, ds): its 4 rows, one
#: 256-token chunk, 24 of the 48 heads
MP_SSM_SHAPE = (4, 1, 256, 24, 64, 128)
#: phase 8d: dbrx-132b at its widths, MP_MOE_LAYERS layer(s), on a (1, 4)
#: mesh (every spec's model dim divides by 4, and each element of state
#: is held once), MP_MOE_STEPS steps at MP_BATCH with MOE_TRAIN's
#: optimizer (bf16 moments) through ``steps.make_sharded_train_step``
MP_MOE_ARCH, MP_MOE_LAYERS, MP_MOE_STEPS = "dbrx-132b", 1, 3
MP_MOE_MESH = (1, 4)
#: a (1, 4) rank's K7 / K7b q: the whole batch, 12 of the 48 heads as 2
#: kv heads of G = 6
MP_MOE_TP_SHAPE = (8, 256, 2, 6, 128)
#: seconds each of phases 8c / 8d may take to spawn and run its ranks
MP_SPLIT_DEADLINE = 150
#: the kernel table's keys of the mesh ranks' shapes: ``tp`` a (2, 2)
#: rank's (K7 / K7b phase 8b's, K8 / K8b 8c's), ``tp14`` a (1, 4) rank's
#: (K7 / K7b, 8d's)
TP_KEYS = tuple(f"{k}_{v}" for k in ("tp", "tp14", "serve") for v in (
    "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")) + (
    "serve_launches", "serve_shape")


def _mp_moe_tcfg():
    from repro_torch.config import TrainConfig

    return TrainConfig(learning_rate=3e-4, warmup_steps=20,
                       total_steps=MP_MOE_STEPS, opt_dtype="bfloat16")


def _mp_moe_run(dev, step=None, plan=None, groups=None):
    """MP_MOE_STEPS steps of MP_MOE_ARCH at MP_MOE_LAYERS layer(s) from
    the seed-0 weights drawn on ``dev`` as the train launcher draws them
    (one card with ``step`` None; else this rank's blocks: the ranks draw
    the whole tree in turn, each keeping its blocks, so one whole tree is
    on the card at a time).  Returns losses, step ms, the peak of the
    steps, collective bytes a step and the state's bytes."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init

    cfg = get_arch(MP_MOE_ARCH).replace(num_layers=MP_MOE_LAYERS)
    tcfg = _mp_moe_tcfg()
    index = 0 if groups is None else groups.index
    params = None
    base = torch.cuda.memory_allocated(dev)
    for r in range(1 if groups is None else groups.world.size):
        if r == index:
            gen = torch.Generator(device=dev).manual_seed(0)
            params = tf.init_params(cfg, gen, device=dev)
            if plan is not None:
                params = plan.shard(params, index)
            torch.cuda.empty_cache()
        if groups is not None:
            groups.world.barrier(dev)
    state = adamw_init(params, tcfg)
    del params
    step = step or make_train_step(cfg, tcfg)
    data = TokenStream(cfg.vocab_size, MP_BATCH[1], MP_BATCH[0], seed=0)
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"losses": [], "step_ms": [], "bytes": [],
           "state_bytes": train.state_bytes(state)}
    for _ in range(MP_MOE_STEPS):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.next().items()}
        if plan is not None:
            batch = plan.local_batch(batch, index)
        carried = 0 if groups is None else groups.bytes
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["bytes"].append(0 if groups is None else groups.bytes - carried)
        out["losses"].append(float(m["loss"]))
    # as train.main's: the state and the steps, above what was held
    # before the draw
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    del state
    torch.cuda.empty_cache()
    return out


def _mp_moe_reference(rank, world, tmp, device):
    """Phase 8d's one-card reference, alone in its process: MP_MOE_ARCH's
    steps on one card (``_mp_moe_run``); results to ``moe1-rank0.pkl``."""
    import os
    import pickle

    from repro_torch.utils.device import resolve_device

    res = _mp_moe_run(resolve_device(device))
    with open(os.path.join(tmp, "moe1-rank0.pkl"), "wb") as f:
        pickle.dump(res, f)


def _mp_split_rank(rank, world, tmp, device, which):
    """One rank of phase 8c (``which`` "ssm": ``launch.train.main`` of
    MP_SSM_ARCH over MP_MESH) or 8d ("moe": ``_mp_moe_run`` of MP_MOE_ARCH
    over MP_MOE_MESH through ``steps.make_sharded_train_step``).  The
    hand kernels' counts are zeroed just before the run and read just
    after, with the shapes the path gave K8 (8c) or K7 (8d); results to
    ``<which>-rank<r>.pkl`` in ``tmp``."""
    import math
    import os
    import pickle

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed.group import init_group
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps, train
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(device)
    group = init_group("gloo", rank, world,
                       os.path.join(tmp, f"store-{which}"))
    mod, name = ((ssm_mod, "ssd_scan") if which == "ssm"
                 else (attn_mod, "flash_attention"))
    inner, shapes = getattr(mod, name), set()

    def recorded(x, *a):
        shapes.add(tuple(x.shape))
        return inner(x, *a)

    setattr(mod, name, recorded)
    if which == "ssm":
        mesh = mesh_mod.make_debug_mesh(*MP_MESH, group=group)
        out = {}
        _zero_counts()
        train.main(["--arch", MP_SSM_ARCH, "--num-layers",
                    str(MP_SSM_LAYERS), "--steps", str(MP_SSM_STEPS),
                    "--batch", str(MP_BATCH[0]), "--seq-len",
                    str(MP_BATCH[1]), "--log-every", "1", "--device",
                    "cuda"], out=out, mesh=mesh)
        counts = _counts()
        plan = out["plan"]
        res = {"losses": [float(r["loss"]) for r in out["steps"]],
               "step_ms": [r["ms"] for r in out["steps"]],
               "peak_bytes": out["peak_bytes"] - out["base_bytes"],
               "state_bytes": out["state_bytes"],
               "bytes": [out["collective_bytes"]],
               "info": out["info"]}
    else:
        mesh = mesh_mod.make_debug_mesh(*MP_MOE_MESH, group=group)
        cfg = get_arch(MP_MOE_ARCH).replace(num_layers=MP_MOE_LAYERS)
        step = steps.make_sharded_train_step(
            cfg, _mp_moe_tcfg(), mesh_mod.make_rules(mesh), group)
        plan = step.plan
        _zero_counts()
        res = _mp_moe_run(dev, step, plan, step.groups)
        counts = _counts()
        res["info"] = step.info
    setattr(mod, name, inner)
    res.update(
        counted_bytes=plan.collective_bytes(*MP_BATCH),
        rank_params=plan.block_numel(),
        whole_params=sum(math.prod(lf.shape) for lf in plan.leaves),
        coords=plan.coords(rank), shapes=sorted(shapes),
        launches={k: counts[k] for k in (
            ("ssd_intra_chunk", "ssd_intra_chunk_bwd") if which == "ssm"
            else ("flash_attention", "flash_attention_bwd"))})
    with open(os.path.join(tmp, f"{which}-rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


def _mp_split_report(label, arch, ranks, one, smi_line, kernel_shape,
                     spawn_s):
    """Print and check a split phase's ranks against the one-card run:
    losses within MP_LOSS_TOL and equal on every rank, collective bytes a
    step equal to the counted, every hand kernel of the path launched and
    given ``kernel_shape`` only."""
    r0 = ranks[0]
    gaps = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], one["losses"])]
    log(f"[{label}] {arch}: losses "
        f"{' '.join(f'{x:.5f}' for x in r0['losses'])} vs one card "
        f"{' '.join(f'{x:.5f}' for x in one['losses'])}, max rel gap "
        f"{max(gaps):.3e} (tol {MP_LOSS_TOL}); split in compute: "
        f"{len(r0['info']['split'])} leaves ({', '.join(r0['info']['split'])})"
        f"; the spawn took {spawn_s:.1f} s")
    require(len(r0["losses"]) == len(one["losses"]) and all(
        math.isfinite(x) for x in r0["losses"]), f"{label}: losses "
        f"{r0['losses']}")
    require(max(gaps) <= MP_LOSS_TOL,
            f"{label}: loss gap {max(gaps):.3e} > {MP_LOSS_TOL}")
    for r, o in enumerate(ranks):
        require(o["losses"] == r0["losses"],
                f"{label}: rank {r}'s losses differ from rank 0's")
        counted = o["counted_bytes"]
        log(f"[{label}] rank {r} {tuple(o['coords'])} on {smi_line}: step "
            f"ms {' '.join(f'{x:.1f}' for x in o['step_ms'])}; peak "
            f"{o['peak_bytes']} B; state {o['state_bytes']} B "
            f"({o['rank_params']} of {o['whole_params']} params); "
            f"collective bytes a step {o['bytes'][-1]} (counted "
            f"{counted['total']}: " + ", ".join(
                f"{k} {v}" for k, v in counted.items() if k != "total")
            + f"); launches {o['launches']}, kernel shapes {o['shapes']}")
        require(all(b == counted["total"] for b in o["bytes"]),
                f"{label}: rank {r} carried {o['bytes']} B a step, counted "
                f"{counted['total']}")
        require(all(n > 0 for n in o["launches"].values()),
                f"{label}: rank {r} launched {o['launches']}")
        require(o["shapes"] == [kernel_shape],
                f"{label}: rank {r}'s kernel took {o['shapes']}")
    log(f"[{label}] one card on {smi_line}: step ms "
        f"{' '.join(f'{x:.1f}' for x in one['step_ms'])}; peak "
        f"{one['peak_bytes']} B; state {one['state_bytes']} B")


def _mp_ssm_kernels(rows, dev, shape=None, key="tp", bwd=True):
    """K8 and (with ``bwd``) K8b at a (2, 2) rank's shape (``shape``,
    MP_SSM_SHAPE by default, f32) against their plain versions, with a
    random dy and nonzero dstates for K8b, each timed beside its plain
    version and its bound (no library call computes either); the table's
    K8 / K8b rows get ``<key>_*`` keys."""
    import torch

    from repro_torch.kernels.ssd_scan.ops import (
        ssd_intra_chunk, ssd_intra_chunk_bwd, ssd_intra_chunk_bwd_cost,
        ssd_intra_chunk_bwd_plain, ssd_intra_chunk_cost,
        ssd_intra_chunk_plain,
    )
    from repro_torch.launch.roofline import tf32x3_bound

    shape = MP_SSM_SHAPE if shape is None else shape
    B, nc, Q, nh, hp, ds = shape
    args = _k8_inputs(dev, B, nc, Q, nh, hp, ds, 41)
    g = torch.Generator(device=dev).manual_seed(42)
    dy = torch.randn((B, nc, Q, nh, hp), generator=g, device=dev)
    dst = torch.randn((B, nc, nh, hp, ds), generator=g, device=dev)
    tp = {}
    for name, fn, plain_fn, cost, tol, own, extra in (
            ("ssd_intra_chunk", ssd_intra_chunk, ssd_intra_chunk_plain,
             ssd_intra_chunk_cost, KERNEL_TOL, K8_KERNELS, ()),
            ("ssd_intra_chunk_bwd", ssd_intra_chunk_bwd,
             ssd_intra_chunk_bwd_plain, ssd_intra_chunk_bwd_cost, K8B_TOL,
             K8B_KERNELS, (dy, dst)))[:2 if bwd else 1]:
        got = fn(*args, *extra)
        torch.cuda.synchronize()
        want = plain_fn(*args, *extra)
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
        require(rel <= tol, f"{name} at a (2, 2) rank's shape: rel err "
                f"{rel:.3e} > {tol}")
        again = fn(*args, *extra)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"{name} at a (2, 2) rank's shape: two calls differ")
        del got, want, again
        ms = device_ms(lambda: fn(*args, *extra), 5, own=own)
        plain = device_ms(lambda: plain_fn(*args, *extra), 3)
        ops, bytes_ = cost(B, nc, Q, nh, hp, ds)
        b_ms, b_by = tf32x3_bound(bytes_, ops)
        log(f"[kernels] {'K8' if not extra else 'K8b'} {name} at a (2, 2) "
            f"{'serving ' if key == 'serve' else ''}rank's shape (B, nc, Q, "
            f"nh, hp, ds) = {shape} f32: "
            f"max_abs_err {err:.3e} rel {rel:.3e} (tol {tol}), repeat "
            f"bit-equal; kernel device ms {ms.own:.4f} [{ms.source}] plain "
            f"device ms {plain.total:.4f} [{plain.source}] library none; "
            f"3xTF32 design bound ms {b_ms:.4f} ({b_by}; {ops:.3e} ops, "
            f"{bytes_ / 1e6:.1f} MB)")
        tp[name] = _keyed(key, ms.own, plain.total, None, b_ms, err)
    del args, dy, dst
    torch.cuda.empty_cache()
    _update_rows(rows, tp)


def phase_model_split(rows, dev, smi_line):
    """Phases 8c and 8d (see the module docstring)."""
    import torch

    from repro_torch.launch import train

    # ---- 8c: the SSM on a rank's heads
    t0 = time.perf_counter()
    _mp_ssm_kernels(rows, dev)
    one = {}
    train.main(["--arch", MP_SSM_ARCH, "--num-layers", str(MP_SSM_LAYERS),
                "--steps", str(MP_SSM_STEPS), "--batch", str(MP_BATCH[0]),
                "--seq-len", str(MP_BATCH[1]), "--log-every", "1",
                "--device", "cuda"], out=one)
    one = {"losses": [float(r["loss"]) for r in one["steps"]],
           "step_ms": [r["ms"] for r in one["steps"]],
           "peak_bytes": one["peak_bytes"] - one["base_bytes"],
           "state_bytes": one["state_bytes"]}
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    B, nc, Q, nh, hp, _ = MP_SSM_SHAPE
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t1 = time.perf_counter()
        ranks = _mp_spawn(tmp, dev, _mp_split_rank, ("ssm",),
                          deadline=MP_SPLIT_DEADLINE, label="model_split "
                          "8c", prefix="ssm")
        spawn_s = time.perf_counter() - t1
    _mp_split_report("model_split 8c", f"{MP_SSM_ARCH} at its widths, "
                     f"{MP_SSM_LAYERS} layers, batch {MP_BATCH[0]}x"
                     f"{MP_BATCH[1]}, {MP_SSM_STEPS} steps through "
                     f"launch.train.main on a {MP_MESH} mesh of {MP_WORLD} "
                     f"gloo ranks sharing {dev}", ranks, one, smi_line,
                     (B, nc * Q, nh, hp), spawn_s)
    log(f"[phase] model_split 8c {time.perf_counter() - t0:.2f} s")

    # ---- 8d: the MoE experts' ffn and the untied head over (1, 4)
    t0 = time.perf_counter()
    _mp_kernels(rows, dev, MP_MOE_TP_SHAPE, "(1, 4)", "tp14")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        one = _mp_spawn(tmp, dev, _mp_moe_reference, world=1,
                        deadline=MP_SPLIT_DEADLINE,
                        label="model_split 8d one card", prefix="moe1")[0]
        t1 = time.perf_counter()
        ranks = _mp_spawn(tmp, dev, _mp_split_rank, ("moe",),
                          deadline=MP_SPLIT_DEADLINE,
                          label="model_split 8d", prefix="moe")
        spawn_s = time.perf_counter() - t1
    _mp_split_report("model_split 8d", f"{MP_MOE_ARCH} at its widths, "
                     f"{MP_MOE_LAYERS} layer, bf16 moments, batch "
                     f"{MP_BATCH[0]}x{MP_BATCH[1]}, {MP_MOE_STEPS} steps "
                     f"through steps.make_sharded_train_step on a "
                     f"{MP_MOE_MESH} mesh of {MP_WORLD} gloo ranks sharing "
                     f"{dev}", ranks, one, smi_line, MP_MOE_TP_SHAPE,
                     spawn_s)
    log(f"[model_split 8d] the four ranks' peaks: "
        + ", ".join(f"{o['peak_bytes']}" for o in ranks) + " B, sum "
        f"{sum(o['peak_bytes'] for o in ranks)} B; the one card's "
        f"{one['peak_bytes']} B")
    log(f"[phase] model_split 8d {time.perf_counter() - t0:.2f} s")


#: phase 8e: sharded LM serving (A9f): each (arch, layers) at full width
#: served on MP_MESH through ``steps.make_sharded_prefill_step`` /
#: ``make_sharded_decode_step``, a batch of SERVE_MP_BATCH prompts of
#: SERVE_MP_PROMPT tokens (a multiple of the SSD chunk), SERVE_MP_TOKENS
#: greedy tokens, once in each SERVE_MP_DTYPES compute dtype (bfloat16:
#: K7's bf16 route, the launches the kernel table lists; float32: the
#: split softmax's merge, the cache splice and the vocabulary argmax held
#: tight, every greedy token equal)
SERVE_MP_RUNS = (("llama3.2-3b", 2), ("mamba2-780m", 2))
SERVE_MP_DTYPES = ("bfloat16", "float32")
SERVE_MP_BATCH, SERVE_MP_PROMPT, SERVE_MP_TOKENS = 4, 256, 8
#: a (2, 2) serving rank's K7 q (its 2 rows, 12 of the 24 heads as 4 kv
#: heads of G = 3, head dim 128) and K8 (B, nc, Q, nh, hp, ds): 24 of
#: mamba's 48 heads
SERVE_K7_SHAPE = (2, 256, 4, 3, 128)
SERVE_K8_SHAPE = (2, 1, 256, 24, 64, 128)
#: the ranks' unsharded logits against the one card's, of the largest
#: logit, by compute dtype.  bfloat16: two bf16 roundings of the same
#: logits (the ranks round their partial outputs before the sum over the
#: model ranks); at mamba2-780m's prefill step the one card's own bf16
#: logits are 4.6e-2 from its float32 ones and the ranks' 4.5e-2 from the
#: one card's, llama3.2-3b's 1.1e-2 (NVIDIA H100 80GB HBM3, 700.00 W).
#: float32: the ranks 1.1e-5 (mamba's prefill step) and 3.0e-6 (llama)
#: from the one card on the same card, a tenth of the limit or less
SERVE_MP_TOL = {"bfloat16": 0.1, "float32": 1e-4}
#: seconds the ranks may take before the phase kills them
SERVE_MP_DEADLINE = 240


def _serve_prompts(cfg):
    import numpy as np

    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_MP_BATCH, SERVE_MP_PROMPT)).astype(np.int32)


def _serve_one(dev, dtype):
    """Each SERVE_MP_RUNS arch on the one card in compute ``dtype``: the
    seed-0 compute params, ``tf.prefill`` and SERVE_MP_TOKENS - 1
    ``tf.decode_step``s, greedy; its logits a step, tokens (B, T), ms,
    peak above the params, and the params' and decode state's bytes."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import _splice_prefill
    from repro_torch.models import transformer as tf

    out = {}
    B, P, T = SERVE_MP_BATCH, SERVE_MP_PROMPT, SERVE_MP_TOKENS
    for arch, layers in SERVE_MP_RUNS:
        cfg = get_arch(arch).replace(num_layers=layers, compute_dtype=dtype)
        params = tf.init_compute_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        toks = torch.from_numpy(_serve_prompts(cfg)).to(dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        logits, caches, idx = tf.prefill(cfg, params, toks)
        state = _splice_prefill(cfg, tf.init_decode_state(
            cfg, B, P + T, idx, device=dev), caches, idx)
        del caches
        tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        ms = [(time.perf_counter() - t0) * 1e3]
        steps, greedy = [logits.cpu().numpy()], [tok]
        for _ in range(T - 1):
            t0 = time.perf_counter()
            logits, state = tf.decode_step(cfg, params, state, tok[:, None])
            tok = torch.argmax(logits, -1)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            steps.append(logits.cpu().numpy())
            greedy.append(tok)
        out[arch] = {
            "logits": steps, "tokens": torch.stack(greedy, 1).cpu().numpy(),
            "ms": ms, "peak": torch.cuda.max_memory_allocated(dev) - base,
            "param_bytes": sum(x.numel() * x.element_size()
                               for x in _tree_tensors(params)),
            "state_bytes": sum(x.numel() * x.element_size()
                               for x in _tree_tensors(state["caches"]))}
        del params, state, logits
        torch.cuda.empty_cache()
    return out


def _tree_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_tensors(v)
    else:
        yield tree


def _serve_rank(rank, world, tmp, device):
    """One rank of phase 8e: each SERVE_MP_RUNS arch's sharded prefill
    and decode steps on MP_MESH in each SERVE_MP_DTYPES dtype,
    teacher-forced with the one card's greedy tokens (``serve-one.pkl``
    in ``tmp``) and taking its own (``step.argmax``) beside them; the
    hand kernels' counts zeroed just before the prefill and read after
    the last step, with the shapes K7 and K8 were given; results by
    (dtype, arch) to ``serve-rank<r>.pkl``."""
    import os
    import pickle

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed.group import init_group
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tf
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(device)
    group = init_group("gloo", rank, world, os.path.join(tmp, "store-serve"))
    mesh = mesh_mod.make_debug_mesh(*MP_MESH, group=group)
    rules = mesh_mod.make_rules(mesh)
    groups = group.mesh_groups(mesh)
    with open(os.path.join(tmp, "serve-one.pkl"), "rb") as f:
        forced = pickle.load(f)
    shapes = set()
    fa, ssd = attn_mod.flash_attention, ssm_mod.ssd_scan

    def rec_fa(q, *a):
        shapes.add(("K7", tuple(q.shape)))
        return fa(q, *a)

    def rec_ssd(x, *a):
        shapes.add(("K8", tuple(x.shape)))
        return ssd(x, *a)

    attn_mod.flash_attention, ssm_mod.ssd_scan = rec_fa, rec_ssd
    B, P, T = SERVE_MP_BATCH, SERVE_MP_PROMPT, SERVE_MP_TOKENS
    res = {}
    runs = [((dtype, arch), get_arch(arch).replace(
        num_layers=layers, compute_dtype=dtype), P + T)
        for dtype, (arch, layers) in itertools.product(SERVE_MP_DTYPES,
                                                       SERVE_MP_RUNS)]
    # JAX's split softmax: the first arch in bf16 over a cache of P + 2 T
    # positions (a multiple of DECODE_SPLIT_CHUNKS)
    arch, layers = SERVE_MP_RUNS[0]
    runs.append((("split", arch), get_arch(arch).replace(
        num_layers=layers, compute_dtype="bfloat16",
        decode_split=DECODE_SPLIT_CHUNKS), P + 2 * T))
    for key, cfg, max_seq in runs:
        dtype, arch = cfg.compute_dtype, key[1]
        pf = steps.make_sharded_prefill_step(cfg, rules, groups)
        dc = steps.make_sharded_decode_step(cfg, rules, groups)
        plan, idx = pf.plan, groups.index
        whole = tf.init_compute_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        params = plan.shard(whole, idx)
        del whole
        torch.cuda.empty_cache()
        batch = plan.serve_batch(
            {"tokens": torch.from_numpy(_serve_prompts(cfg)).to(dev)}, idx)
        fed = plan.serve_batch({"tokens": torch.from_numpy(
            forced[dtype, arch]).to(dev)}, idx)["tokens"]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        state = plan.decode_state(B, max_seq, device=dev, rank=idx)
        shapes.clear()
        _zero_counts()
        b0, t0 = groups.bytes, time.perf_counter()
        logits, state = pf(params, batch, state)
        greedy = [pf.argmax(logits)]
        torch.cuda.synchronize()
        ms, carried = [(time.perf_counter() - t0) * 1e3], [groups.bytes - b0]
        out = [logits.cpu().numpy()]
        for t in range(T - 1):
            b0, t0 = groups.bytes, time.perf_counter()
            logits, state = dc(params, state,
                               {"tokens": fed[:, t:t + 1].contiguous()})
            greedy.append(dc.argmax(logits))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            carried.append(groups.bytes - b0)
            out.append(logits.cpu().numpy())
        counts = _counts()
        k = next((c["k"] for c in state["caches"].values() if "k" in c),
                 None)
        res[key] = {
            "logits": out, "tokens": torch.stack(greedy, 1).cpu().numpy(),
            "ms": ms, "bytes": carried,
            "counted": (plan.collective_bytes(B, P, kind="prefill"),
                        plan.collective_bytes(B, max_seq, kind="decode")),
            "peak": torch.cuda.max_memory_allocated(dev) - base
            + plan.serve_param_bytes(),
            "param_bytes": plan.serve_param_bytes(),
            "held_bytes": sum(x.numel() * x.element_size()
                              for x in _tree_tensors(params)),
            "state_bytes": plan.state_bytes(B, max_seq, rank=idx),
            "held_state": sum(x.numel() * x.element_size()
                              for x in _tree_tensors(state["caches"])),
            "cache_shape": None if k is None else tuple(k.shape),
            "span": tuple(state["span"]), "coords": groups.coords,
            "launches": {n: counts[n] for n in ("flash_attention",
                                                 "ssd_intra_chunk")},
            "shapes": sorted(shapes), "split": pf.info["split"]}
        del params, state, logits
        torch.cuda.empty_cache()
    attn_mod.flash_attention, ssm_mod.ssd_scan = fa, ssd
    with open(os.path.join(tmp, f"serve-rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


def phase_model_serve(rows, dev, smi_line):
    """Phase 8e (see the module docstring)."""
    import pickle

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed.model_parallel import ShardPlan
    from repro_torch.distributed.sharding import ceil_unshard, spec_for
    from repro_torch.launch import mesh as mesh_mod

    _mp_kernels(rows, dev, SERVE_K7_SHAPE, "(2, 2) serving", "serve",
                bwd=False)
    _mp_ssm_kernels(rows, dev, SERVE_K8_SHAPE, "serve", bwd=False)
    one = {(dt, a): o for dt in SERVE_MP_DTYPES
           for a, o in _serve_one(dev, dt).items()}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        with open(Path(tmp) / "serve-one.pkl", "wb") as f:
            pickle.dump({k: o["tokens"] for k, o in one.items()}, f)
        t0 = time.perf_counter()
        ranks = _mp_spawn(tmp, dev, _serve_rank, deadline=SERVE_MP_DEADLINE,
                          label="model_serve 8e", prefix="serve")
        spawn_s = time.perf_counter() - t0
    B, P, T = SERVE_MP_BATCH, SERVE_MP_PROMPT, SERVE_MP_TOKENS
    mesh = mesh_mod.rank_mesh(MP_MESH)
    rules = mesh_mod.make_rules(mesh)
    extra = {}
    for dtype, (arch, layers) in itertools.product(SERVE_MP_DTYPES,
                                                   SERVE_MP_RUNS):
        cfg = get_arch(arch).replace(num_layers=layers, compute_dtype=dtype)
        ref, runs = one[dtype, arch], [r[dtype, arch] for r in ranks]
        tol = SERVE_MP_TOL[dtype]
        spec = spec_for(("batch", "vocab"), (B, cfg.vocab_size), rules=rules,
                        is_param=False)
        gaps, held, unclear = [], 0, 0
        for t in range(T):
            got = ceil_unshard([torch.from_numpy(o["logits"][t])
                                for o in runs], (B, cfg.vocab_size), spec,
                               mesh).numpy()
            want = ref["logits"][t]
            err = float(np.abs(got - want).max())
            gaps.append(err / float(np.abs(want).max()))
            top2 = np.sort(want, axis=-1)[:, -2:]
            # bf16: a pick within twice the step's error of a tie may
            # flip; float32: every pick is held
            clear = ((top2[:, 1] - top2[:, 0]) > 2 * err
                     if dtype == "bfloat16" else np.ones(B, bool))
            unclear += int((~clear).sum())
            # a clear pick cannot flip: every logit moved by at most err
            mine = np.concatenate([runs[d * MP_MESH[1]]["tokens"][:, t]
                                   for d in range(MP_MESH[0])])
            require(np.array_equal(mine[clear], ref["tokens"][clear, t]),
                    f"model_serve 8e: {arch} step {t}: greedy tokens "
                    f"{mine} vs one card {ref['tokens'][:, t]}")
            held += int(clear.sum())
        log(f"[model_serve 8e] {arch} at its widths, {layers} layers, "
            f"{dtype}, "
            f"batch {B} x {P}-token prompts, {T} greedy tokens (the one "
            f"card's fed back) through steps.make_sharded_prefill_step / "
            f"make_sharded_decode_step on a {MP_MESH} mesh of {MP_WORLD} "
            f"gloo ranks sharing {dev}: logits vs one card max rel gap "
            f"{max(gaps):.3e} (tol {tol}; by step "
            f"{' '.join(f'{g:.2e}' for g in gaps)}); greedy tokens equal "
            f"at {held} of {held + unclear} picks ("
            + (f"{unclear} within twice the step's logit error of a tie, "
               f"not held" if dtype == "bfloat16" else "every pick held")
            + f"); split in "
            f"compute: {', '.join(runs[0]['split'])}; the spawn took "
            f"{spawn_s:.1f} s")
        require(max(gaps) <= tol,
                f"model_serve 8e: {arch} {dtype} logit gap "
                f"{max(gaps):.3e} > {tol}")
        plan = ShardPlan(cfg, rules)
        for r, o in enumerate(runs):
            pre, dec = (c["total"] for c in o["counted"])
            log(f"[model_serve 8e] {arch} {dtype} rank {r} "
                f"{tuple(o['coords'])} on "
                f"{smi_line}: prefill ms {o['ms'][0]:.1f}, decode ms a step "
                f"{' '.join(f'{x:.1f}' for x in o['ms'][1:])} (gloo through "
                f"the host, not card performance); params {o['held_bytes']}"
                f" B (plan {o['param_bytes']}), decode state "
                f"{o['held_state']} B (plan {o['state_bytes']}; k cache "
                f"block {o['cache_shape']}, positions {o['span']}), peak "
                f"{o['peak']} B; collective bytes a step "
                f"{' '.join(str(b) for b in o['bytes'])} (counted prefill "
                f"{pre}, decode {dec}: " + ", ".join(
                    f"{k} {v}" for k, v in o["counted"][1].items()
                    if k != "total")
                + f"); launches {o['launches']}, kernel shapes "
                f"{o['shapes']}")
            require(o["bytes"] == [pre] + [dec] * (T - 1),
                    f"model_serve 8e: {arch} rank {r} carried {o['bytes']}"
                    f", counted {pre} / {dec}")
            require(o["held_bytes"] == o["param_bytes"]
                    and o["held_state"] == o["state_bytes"],
                    f"model_serve 8e: {arch} rank {r} holds "
                    f"{o['held_bytes']} / {o['held_state']} B")
            if o["cache_shape"] is not None:
                w = -(-(P + T) // MP_MESH[1])
                require(o["cache_shape"][1:3] == (B // MP_MESH[0], w),
                        f"model_serve 8e: {arch} rank {r}'s cache block "
                        f"{o['cache_shape']}")
            name = ("flash_attention" if cfg.num_heads else
                    "ssd_intra_chunk")
            want = ([("K7", SERVE_K7_SHAPE)] if cfg.num_heads else
                    [("K8", SERVE_K8_SHAPE[:1] + (P,)
                      + SERVE_K8_SHAPE[3:5])])
            require(o["launches"][name] == layers and o["shapes"] == want,
                    f"model_serve 8e: {arch} rank {r} launched "
                    f"{o['launches']} on {o['shapes']}")
            extra.setdefault(name, {"serve_launches": o["launches"][name],
                                    "serve_shape": list(
                                        SERVE_K7_SHAPE if cfg.num_heads
                                        else SERVE_K8_SHAPE)})
        log(f"[model_serve 8e] {arch} {dtype} one card on {smi_line}: "
            f"prefill ms "
            f"{ref['ms'][0]:.1f}, decode ms a step "
            f"{' '.join(f'{x:.1f}' for x in ref['ms'][1:])}; params "
            f"{ref['param_bytes']} B, decode state {ref['state_bytes']} B, "
            f"peak {ref['peak'] + ref['param_bytes']} B; a rank holds "
            f"{runs[0]['param_bytes'] / ref['param_bytes']:.3f} of the "
            f"params and {runs[0]['state_bytes'] / ref['state_bytes']:.3f} "
            f"of the decode state")
    # JAX's split softmax on the mesh against the one card's unsplit bf16
    # logits, fed the same tokens
    arch, layers = SERVE_MP_RUNS[0]
    cfg = get_arch(arch).replace(num_layers=layers,
                                 compute_dtype="bfloat16")
    ref, runs = one["bfloat16", arch], [r["split", arch] for r in ranks]
    spec = spec_for(("batch", "vocab"), (B, cfg.vocab_size), rules=rules,
                    is_param=False)
    gaps = []
    for t in range(T):
        got = ceil_unshard([torch.from_numpy(o["logits"][t]) for o in runs],
                           (B, cfg.vocab_size), spec, mesh).numpy()
        want = ref["logits"][t]
        gaps.append(float(np.abs(got - want).max() / np.abs(want).max()))
    tol = SERVE_MP_TOL["bfloat16"]
    log(f"[model_serve 8e] {arch} bf16 with decode_split "
        f"{DECODE_SPLIT_CHUNKS} over a cache of {P + 2 * T} positions on "
        f"{MP_MESH}: logits vs the one card's unsplit max rel gap "
        f"{max(gaps):.3e} (tol {tol}; by step "
        f"{' '.join(f'{g:.2e}' for g in gaps)}); rank 0 decode ms a step "
        f"{' '.join(f'{x:.1f}' for x in runs[0]['ms'][1:])}, collective "
        f"bytes a decode step {runs[0]['bytes'][1]} (counted "
        f"{runs[0]['counted'][1]['total']})")
    require(max(gaps) <= tol, f"model_serve 8e: {arch} decode_split logit "
            f"gap {max(gaps):.3e} > {tol}")
    for r, o in enumerate(runs):
        pre, dec = (c["total"] for c in o["counted"])
        require(o["bytes"] == [pre] + [dec] * (T - 1),
                f"model_serve 8e: {arch} decode_split rank {r} carried "
                f"{o['bytes']}, counted {pre} / {dec}")
    _update_rows(rows, extra)


def phase_fit_serve(rows, dev):
    """The slice's main path: a ``gcl`` method with no encoder behind a
    PlanService; submit_program(phi-2) fits (prepare) and serves, then cfd
    and nw are served with the fitted encoder."""
    import numpy as np

    from repro_torch.sampling import evaluate, get_method
    from repro_torch.serving import PlanService
    from repro_torch.tracing.programs import get_program

    with np.load(FIXTURE) as z:
        ref = {k: z[k] for k in z.files}
    for r in rows:
        r[3].launches = 0
    method = get_method("gcl", device=dev)
    with PlanService(device=dev, max_delay_ms=2.0) as svc:
        svc.warmup()
        for name in ("phi-2", "cfd", "nw"):
            prog = get_program(name)
            t0 = time.perf_counter()
            plan = svc.submit_program(method, prog).result(timeout=900)
            lat = time.perf_counter() - t0
            ev = evaluate(plan, prog, "P1")
            require(np.isfinite(ev.error_pct["cycles"])
                    and np.isfinite(ev.speedup), f"{name}: non-finite eval")
            jax = (f"(JAX fixture K {int(ref[f'{name}:k'])} eq5 "
                   f"{float(ref[f'{name}:error_cycles'])!r} eq6 "
                   f"{float(ref[f'{name}:speedup'])!r})"
                   if f"{name}:k" in ref else "(not in the JAX fixture)")
            train = plan.extra.get("train")
            log(f"[fit+serve] {name}: n={len(prog)} latency_s {lat:.3f} K "
                f"{plan.num_clusters} eq5 {ev.error_pct['cycles']!r} eq6 "
                f"{ev.speedup!r} {jax}"
                + (f" fitted here: {json.dumps(train)}" if train else
                   " encoder reused"))
        stats = svc.stats()
    launches = {r[0]: r[3].launches for r in rows}
    log(f"[fit+serve] stats {json.dumps(stats, default=str)}")
    log(f"[fit+serve] launches {json.dumps(launches)}")
    require(stats["failed"] == 0 and stats["served"] == 3,
            f"fit+serve: {stats['served']} served, {stats['failed']} failed")
    for name, count in launches.items():
        require(count > 0, f"fit+serve: kernel {name} was never launched")
    return launches


def _all_wrappers():
    from repro_torch.kernels.kmeans_assign.ops import (
        kmeans_assign, kmeans_assign_fused_batched, silhouette_sums,
    )
    from repro_torch.kernels.rgcn_fused.ops import (
        rgcn_fused_agg_flat, rgcn_fused_bwd,
    )
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd,
    )
    from repro_torch.kernels.rgcn_spmm.ops import (
        rgcn_spmm_dense, rgcn_spmm_flat,
    )
    from repro_torch.kernels.ssd_scan.ops import (
        ssd_intra_chunk, ssd_intra_chunk_bwd,
    )

    return {"rgcn_fused_flat": rgcn_fused_agg_flat,
            "rgcn_fused_bwd": rgcn_fused_bwd,
            "rgcn_spmm_flat": rgcn_spmm_flat,
            "rgcn_spmm_dense": rgcn_spmm_dense,
            # K2: every launch goes through the batched wrapper
            "kmeans_assign_fused": kmeans_assign_fused_batched,
            "kmeans_assign_fused_batched": kmeans_assign_fused_batched,
            "silhouette_sums": silhouette_sums,
            "kmeans_assign": kmeans_assign,
            "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "ssd_intra_chunk": ssd_intra_chunk,
            "ssd_intra_chunk_bwd": ssd_intra_chunk_bwd}


def _zero_counts():
    for w in _all_wrappers().values():
        w.launches = 0


def _counts():
    return {k: w.launches for k, w in _all_wrappers().items()}


def phase_sequential(dev):
    """The sequential reference on the card: the fixture encoder's phi-2
    and cfd embeddings through ``select_k_and_cluster``, the sequential
    engine, and the isolate retry.  Returns the path's launch counts."""
    import numpy as np

    from repro_torch.core.clustering import select_k_and_cluster
    from repro_torch.sampling import engine as engine_mod
    from repro_torch.sampling import plan_from_labels
    from repro_torch.sampling.engine import PlanEngine, PlanRequest
    from repro_torch.tracing.programs import get_program

    with open(GRID_FIXTURE) as f:
        jax_seq = json.load(f)["sequential"]
    method, _ = _reference_method(dev)
    names = ("phi-2", "cfd", "nw")
    embs = {n: np.asarray(method.prepare(get_program(n)).payload["embeddings"])
            for n in names}
    seqs = {n: np.array([k.seq for k in get_program(n).kernels])
            for n in names}
    _zero_counts()
    t_path = time.perf_counter()
    for name in ("phi-2", "cfd"):
        want = jax_seq[name]
        t0 = time.perf_counter()
        labels, info = select_k_and_cluster(embs[name], device=dev)
        secs = time.perf_counter() - t0
        reps = plan_from_labels(labels, seqs[name], "x").rep_indices()
        exact = {int(k): v for k, v in want["scores_exact"].items()}
        jax = {int(k): v for k, v in want["scores"].items()}
        gap = max(abs(info["scores"][k] - exact[k]) for k in exact)
        jgap = max(abs(info["scores"][k] - jax[k]) for k in jax)
        jself = max(abs(jax[k] - exact[k]) for k in jax)
        log(f"[sequential] {name}: n={len(labels)} K {info['k']} (jax "
            f"{want['k']}) labels equal "
            f"{bool(np.array_equal(labels, want['labels']))} reps {reps} "
            f"(jax {want['reps']}) max |card - exact| over K {gap:.3e} (tol "
            f"{SCORE_TOL}) max |card - jax| {jgap:.3e} (jax's own float32 "
            f"gap to exact {jself:.3e}) {secs:.3f} s")
        require(info["k"] == want["k"], f"sequential {name}: K differs")
        require(np.array_equal(labels, want["labels"]),
                f"sequential {name}: labels differ from JAX")
        require(reps == want["reps"], f"sequential {name}: reps differ")
        require(sorted(info["scores"]) == sorted(exact),
                f"sequential {name}: scored K differ")
        require(gap <= SCORE_TOL, f"sequential {name}: score gap {gap:.3e}")

    reqs = [PlanRequest(embs[n], seqs[n], "x") for n in names]
    t0 = time.perf_counter()
    seq_eng = PlanEngine(engine="sequential", device=dev)
    seq_plans = seq_eng.plan_many(reqs)
    log(f"[sequential] PlanEngine(engine='sequential').plan_many {names}: K "
        f"{[p.num_clusters for p in seq_plans]} errors "
        f"{seq_eng.stats['errors']} ({time.perf_counter() - t0:.3f} s)")
    require(seq_eng.stats["errors"] == 0, "sequential engine: errors")

    real = engine_mod.sweep_cluster_stack
    poison = embs["cfd"]

    def flaky(xs, **kw):
        if any(x.shape == poison.shape and np.array_equal(x, poison)
               for x in xs):
            raise RuntimeError("injected sweep failure")
        return real(xs, **kw)

    before = _counts()["kmeans_assign"]
    engine_mod.sweep_cluster_stack = flaky
    try:
        t0 = time.perf_counter()
        eng = PlanEngine(device=dev)
        plans = eng.plan_many(reqs, errors="isolate")
    finally:
        engine_mod.sweep_cluster_stack = real
    k4_retry = _counts()["kmeans_assign"] - before
    i = names.index("cfd")
    log(f"[sequential] isolate retry (sweep fails on cfd): K "
        f"{[p.num_clusters for p in plans]} cfd equal to the sequential "
        f"engine's {bool(np.array_equal(plans[i].labels, seq_plans[i].labels))}"
        f" errors {eng.stats['errors']} K4 launches in the retry {k4_retry} "
        f"({time.perf_counter() - t0:.3f} s)")
    require(eng.stats["errors"] == 0, "isolate retry: errors")
    require(k4_retry > 0, "isolate retry: K4 was not launched")
    require(np.array_equal(plans[i].labels, seq_plans[i].labels)
            and plans[i].reps == seq_plans[i].reps,
            "isolate retry: plan differs from the sequential engine's")
    counts = _counts()
    log(f"[sequential] path {time.perf_counter() - t_path:.2f} s launches "
        f"{json.dumps(counts)}")
    for name in ("kmeans_assign", "silhouette_sums"):
        require(counts[name] > 0, f"sequential: {name} was never launched")
    return counts


def _grid_rows(out, doc):
    from repro_torch.sampling import ArtifactStore

    store = ArtifactStore(str(Path(out) / "artifacts"))
    rows = {}
    for r in doc["results"]:
        plan = store.load_plan(r["method_id"], r["artifact_key"])
        rows[(r["method_id"], r["program"], r["platform"])] = dict(
            k=r["num_clusters"], reps=plan.rep_indices(),
            eq5=r["error_pct"]["cycles"], eq6=r["speedup"])
    return rows


def _same_up_to_ties(key, reps, jax_reps):
    """Whether two representative lists of a baseline row pick the same
    kernels with bit-equal profiled times on the row's platform, pairwise
    in sorted order: STEM+ROOT spreads its picks over each cluster's
    members sorted by time with numpy's default (unstable) argsort, whose
    order among equal times depends on the host CPU's sort routine."""
    import numpy as np

    from repro_torch.core.baselines.stem_root import stem_root_times
    from repro_torch.tracing.programs import get_program

    prog = get_program(key[1])
    times = stem_root_times(prog, key[2])
    names = [k.name for k in prog.kernels]

    def sig(rs):
        return sorted((names[i], times[i].tobytes()) for i in rs)

    return len(reps) == len(jax_reps) and sig(reps) == sig(jax_reps) \
        and np.isfinite(times).all()


def phase_grid(dev):
    """The slice's main path: the four-method grid over the 11 paper
    programs on P1-P3, then a replay on the same directory.  Returns the
    first run's launch counts."""
    import tempfile

    import torch

    from repro_torch.launch.sample import run_grid, validate_results
    from repro_torch.tracing.programs import PAPER_PROGRAMS

    with open(GRID_FIXTURE) as f:
        jax_rows = {(r["method_id"], r["program"], r["platform"]): r
                    for r in json.load(f)["grid"]}
    methods = ["gcl", "pka", "sieve", "stem_root"]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
        _zero_counts()
        t0 = time.perf_counter()
        with SweepCount() as sweeps:
            doc = run_grid(methods, list(PAPER_PROGRAMS), PLATFORMS, out,
                           device=dev, verbose=False)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        validate_results(doc)
        log(f"[grid] {len(methods)} methods x {len(PAPER_PROGRAMS)} programs x "
            f"{len(PLATFORMS)} platforms: {len(doc['results'])} rows in "
            f"{wall:.2f} s, failures {doc['failures']} batch_plan_errors "
            f"{doc['batch_plan_errors']}")
        for m, t in doc["method_wall_s"].items():
            log(f"[grid] wall {m}: prepare {t['prepare_s']:.3f} s plan "
                f"{t['plan_s']:.3f} s evaluate {t['evaluate_s']:.3f} s")
        log(f"[grid] launches {json.dumps(counts)}")
        sweeps.check("grid", counts["kmeans_assign_fused"],
                     counts["silhouette_sums"])
        require(not doc["failures"] and not doc["batch_plan_errors"],
                "grid: failed cells or plan_batch fallbacks")
        rows = _grid_rows(out, doc)
        require(sorted(rows) == sorted(jax_rows), "grid: cells differ")
        bad, tied = [], []
        for key in sorted(rows):
            got, want = rows[key], jax_rows[key]
            same = (got["k"] == want["k"]
                    and abs(got["eq5"] - want["eq5"]) <= METRIC_TOL
                    and abs(got["eq6"] - want["eq6"]) <= METRIC_TOL)
            if same and got["reps"] != want["reps"] and key[0] != "gcl" \
                    and _same_up_to_ties(key, got["reps"], want["reps"]):
                tied.append(key)
                log(f"[grid] {key}: reps {got['reps']} vs JAX's "
                    f"{want['reps']}: the same kernels with bit-equal "
                    f"profiled times (numpy's unstable argsort orders "
                    f"ties by the host CPU's sort)")
            else:
                same = same and got["reps"] == want["reps"]
            if key[0] == "gcl":
                if key[2] == "P1":
                    log(f"[grid] gcl {key[1]}: K {got['k']} eq5 "
                        f"{got['eq5']!r} eq6 {got['eq6']!r} (jax gcl K "
                        f"{want['k']} eq5 {want['eq5']!r} eq6 "
                        f"{want['eq6']!r})")
            elif not same:
                bad.append(key)
                log(f"[grid] MISMATCH {key}: card {got} jax "
                    f"{ {k: want[k] for k in got} }")
        n_base = sum(1 for k in rows if k[0] != "gcl")
        log(f"[grid] pka / sieve / stem_root rows equal to JAX's: "
            f"{n_base - len(bad) - len(tied)} of {n_base}, {len(tied)} more "
            f"equal up to invocations with equal profiled times")
        require(not bad, f"grid: {len(bad)} baseline rows differ from JAX")
        for name in ("rgcn_fused_flat", "rgcn_fused_bwd", "rgcn_spmm_flat",
                     "kmeans_assign_fused", "silhouette_sums"):
            require(counts[name] > 0, f"grid: kernel {name} never launched")

        _zero_counts()
        t0 = time.perf_counter()
        again = run_grid(methods, list(PAPER_PROGRAMS), PLATFORMS, out,
                         device=dev, verbose=False)
        wall2 = time.perf_counter() - t0
        replay = _counts()
        g1 = doc["method_wall_s"]["gcl"]["prepare_s"]
        g2 = again["method_wall_s"]["gcl"]["prepare_s"]
        log(f"[grid] replay on the same directory: {wall2:.2f} s (first "
            f"{wall:.2f} s), gcl prepare {g2:.3f} s vs {g1:.3f} s, launches "
            f"{json.dumps(replay)}")
        require(not again["failures"] and not again["batch_plan_errors"],
                "grid replay: failed cells")
        require(replay["rgcn_fused_bwd"] == 0 and replay["rgcn_spmm_flat"] == 0,
                "grid replay: the encoder was refitted")
        require(g2 < g1 / 10, f"grid replay: gcl prepare {g2:.3f} s is not "
                f"under a tenth of {g1:.3f} s")
        require(_grid_rows(out, again) == rows, "grid replay: rows differ")
    profile_grid(dev, methods)
    return counts


def profile_grid(dev, methods):
    """The cold grid once more (fresh directory) under torch.profiler: the
    device's busy share of the run and the top device ops."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.sample import run_grid
    from repro_torch.tracing.programs import PAPER_PROGRAMS

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            doc = run_grid(methods, list(PAPER_PROGRAMS), PLATFORMS, out,
                           device=dev, verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    busy_s, top = _device_profile(prof)
    log(f"[grid] profiled cold grid: wall_s {wall:.3f} device busy_s "
        f"{busy_s:.4f} busy share {busy_s / wall:.4f} idle share "
        f"{1 - busy_s / wall:.4f}; " + ", ".join(
            f"{m} prepare {t['prepare_s']:.2f} s plan {t['plan_s']:.2f} s"
            for m, t in doc["method_wall_s"].items()))
    for t, key, count in top[:10]:
        log(f"[grid]   {t / 1e3:9.3f} ms {100 * t / 1e6 / busy_s:5.1f} %  "
            f"x{count:<7d} {key[:70]}")


# ---------------------------------------------------------------------------
# the LM zoo's serving path (K7 flash attention, K8 SSD intra-chunk)
# ---------------------------------------------------------------------------

def _k7_inputs(dev, B, S, K, G, hd, dt, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dt)
                 for shape in ((B, S, K, G, hd), (B, S, K, hd),
                               (B, S, K, hd)))


def k7_kernels(hd, dtype):
    """K7's kernel for a head width and input type: the wgmma kernel for
    bf16 at hd 64 / 128 / 256, mma.sync for the other bf16 widths, FMAs for
    float32 (``flash_attention`` in ``csrc/flash_attention.cu``)."""
    import torch

    if dtype == torch.float32:
        return {"flash_attention_f32_kernel": 1}
    if hd in (64, 128, 256):
        return {"flash_attention_wgmma_kernel": 1}
    return {"flash_attention_mma_kernel": 1}


def k7b_kernels(hd, dtype):
    """K7b's kernels for a head width and input type
    (``flash_attention_bwd`` in ``csrc/flash_attention_bwd.cu``): for bf16
    at hd 64 / 128 the D prologue and the wgmma kernel of both block roles;
    two tensor-core (mma.sync) kernels for the other bf16 widths up to 128;
    three float32-FMA kernels otherwise."""
    from repro_torch.kernels.flash_attention.ops import bwd_route

    route = bwd_route(dtype, hd)
    if route == "wgmma":
        return {"k7b_dvec_kernel": 1, "k7b_wgmma_kernel": 1}
    if route == "mma":
        return {"k7b_dq_mma_kernel": 1, "k7b_dkdv_mma_kernel": 1}
    return {"k7b_stats_kernel": 1, "k7b_dkdv_kernel": 1, "k7b_dq_kernel": 1}


def _k7_check(dev, shape, dt, seed):
    """K7 against its plain version; (err, rel, q, k, v, scale)."""
    import math

    import torch

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain,
    )

    B, S, K, G, hd = shape
    q, k, v = _k7_inputs(dev, B, S, K, G, hd, dt, seed)
    scale = 1.0 / math.sqrt(hd)
    got = flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    err, rel = rel_err(got, flash_attention_plain(q, k, v, scale))
    tol = KERNEL_TOL if dt == torch.float32 else BF16_TOL
    require(rel <= tol, f"K7 {shape} {dt}: rel err {rel:.3e} > {tol}")
    return err, rel, q, k, v, scale


def _k8_inputs(dev, B, nc, Q, nh, hp, ds, seed):
    """K8's inputs as the mamba mixer makes them: dt a softplus, the
    log-decay dt * A with A = -linspace(1, 16) over the heads, cumulated
    over each chunk."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = randn(B, nc, Q, nh, hp)
    dt = torch.nn.functional.softplus(randn(B, nc, nh, Q) - 1.0)
    A = -torch.linspace(1.0, 16.0, nh, device=dev)
    cum = torch.cumsum(dt * A[None, None, :, None], dim=-1).contiguous()
    return x, cum, dt.contiguous(), randn(B, nc, Q, ds), randn(B, nc, Q, ds)


def phase_lm_kernels(rows, dev):
    """K7 and K8 against their plain versions at the LM serving path's
    shapes (llama3.2-3b's and mamba2-780m's prefill) and around them; K7b
    and K8b at the training and prefill shapes."""
    import torch

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_cost, flash_attention_lse,
        flash_attention_plain,
    )
    from repro_torch.kernels.ssd_scan.ops import (
        ssd_intra_chunk, ssd_intra_chunk_cost, ssd_intra_chunk_plain,
    )
    from repro_torch.launch.roofline import (
        PEAK_BF16_S, PEAK_F32_S, bound, tf32x3_bound,
    )

    # ---- K7: every hd x G x S x dtype around the main shape, then it ----
    n = 0
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for hd in (16, 64, 256):
        for G in (1, 3, 8):
            for S in (64, 512, 1536):
                for dt in (torch.float32, torch.bfloat16):
                    _, rel, *_ = _k7_check(dev, (1, S, 2, G, hd), dt, n)
                    worst[dt] = max(worst[dt], rel)
                    n += 1
    for S in (64, 512, 1536):
        for dt in (torch.float32, torch.bfloat16):
            _, rel, *_ = _k7_check(dev, (2, S, 8, 3, 128), dt, n)
            worst[dt] = max(worst[dt], rel)
            n += 1
    log(f"[kernels] K7 flash_attention: {n} shapes (hd 16/64/128/256, G "
        f"1/3/8, S 64/512/1536, f32 and bf16) within tolerance: worst rel "
        f"f32 {worst[torch.float32]:.3e} (tol {KERNEL_TOL}) bf16 "
        f"{worst[torch.bfloat16]:.3e} (tol {BF16_TOL:.3e})")
    k7 = None
    B, S, K, G, hd = LLAMA_PREFILL
    H = K * G
    for dt in (torch.bfloat16, torch.float32):
        err, rel, q, k, v, scale = _k7_check(dev, LLAMA_PREFILL, dt, 99)
        call_ms = time_ms(lambda: flash_attention(q, k, v, scale), 10)
        _, ms, ms_src = device_ms(lambda: flash_attention(q, k, v, scale), 5,
                               own=k7_kernels(hd, dt))
        plain_ms, _, plain_src = device_ms(
            lambda: flash_attention_plain(q, k, v, scale), 3)
        qh = q.reshape(B, S, H, hd).transpose(1, 2).contiguous()
        kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        lib_ms, _, lib_src = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True), 5)
        ops, bytes_ = flash_attention_cost(B, S, K, G, hd, q.element_size())
        b_ms, b_by = bound(bytes_, ops, PEAK_BF16_S if dt == torch.bfloat16
                           else PEAK_F32_S)
        dname = "bf16" if dt == torch.bfloat16 else "f32"
        floor = (f" (the P hi/lo split's floor: 1.5 x the operations, "
                 f"{bound(bytes_, 1.5 * ops, PEAK_BF16_S)[0]:.4f} ms)"
                 if dt == torch.bfloat16 else "")
        log(f"[kernels] K7 flash_attention {LLAMA_PREFILL} {dname}: "
            f"max_abs_err {err:.3e} rel {rel:.3e} kernel device ms {ms:.4f} "
            f"[{ms_src}] (call ms {call_ms:.4f}) plain device ms "
            f"{plain_ms:.4f} [{plain_src}] library device ms {lib_ms:.4f} "
            f"[{lib_src}] (scaled_dot_product_attention, causal, GQA) "
            f"bound ms {b_ms:.4f} ({b_by}; {ops:.3e} ops, "
            f"{bytes_ / 1e6:.1f} MB){floor} achieved {ops / ms / 1e9:.2f} "
            f"TFLOP/s")
        if dt == torch.bfloat16:
            k7 = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                      bound_by=b_by, library_ms=lib_ms)
            # the training forward's variant, which also writes each row's
            # log-sum-exp for K7b
            lse_ms = device_ms(lambda: flash_attention_lse(q, k, v, scale), 5,
                               own=k7_kernels(hd, dt))
            log(f"[kernels] K7 flash_attention {LLAMA_PREFILL} bf16 with "
                f"the log-sum-exp output: kernel device ms "
                f"{lse_ms.own:.4f} [{lse_ms.source}]; without it {ms:.4f} "
                f"[{ms_src}] ({lse_ms.own / ms - 1:+.2%})")
        del q, k, v, qh, kh, vh
    rows.append(("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/kernel.py:108",
                 flash_attention, k7))

    rows.append(_k7b(dev))

    # ---- K8: the mamba prefill, mamba's smoke shape, one 64-row chunk
    k8 = None
    for label, (B, nc, Q, nh, hp, ds) in (
            ("main path", MAMBA_PREFILL), ("smoke", (2, 32, 32, 8, 16, 16)),
            ("S=64, one chunk", (4, 1, 64, 48, 64, 128))):
        args = _k8_inputs(dev, B, nc, Q, nh, hp, ds, nc)
        got = ssd_intra_chunk(*args)
        torch.cuda.synchronize()
        want = ssd_intra_chunk_plain(*args)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
        require(rel <= KERNEL_TOL,
                f"K8 {label}: rel err {rel:.3e} > {KERNEL_TOL}")
        again = ssd_intra_chunk(*args)
        require(all(torch.equal(g, a) for g, a in zip(got, again)),
                f"K8 {label}: two calls differ")
        call_ms = time_ms(lambda: ssd_intra_chunk(*args), 10)
        _, ms, ms_src = device_ms(lambda: ssd_intra_chunk(*args), 5,
                                  own=K8_KERNELS)
        plain_ms, _, plain_src = device_ms(
            lambda: ssd_intra_chunk_plain(*args), 3)
        ops, bytes_ = ssd_intra_chunk_cost(B, nc, Q, nh, hp, ds)
        b_ms, b_by = bound(bytes_, ops)
        tc_ms, tc_by = tf32x3_bound(bytes_, ops)
        log(f"[kernels] K8 ssd_intra_chunk {label} (B, nc, Q, nh, hp, ds) = "
            f"{(B, nc, Q, nh, hp, ds)}: max_abs_err {err:.3e} rel {rel:.3e} "
            f"(tol {KERNEL_TOL}), repeat bit-equal; kernel device ms "
            f"{ms:.4f} [{ms_src}] (call ms {call_ms:.4f}) plain device ms "
            f"{plain_ms:.4f} [{plain_src}] bound ms {b_ms:.4f} ({b_by}, "
            f"float32 FMAs; {ops:.3e} ops, {bytes_ / 1e6:.1f} MB); 3xTF32 "
            f"design bound ms {tc_ms:.4f} ({tc_by})")
        if label == "main path":
            k8 = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=tc_ms,
                      bound_by=tc_by, library_ms=None, fma_bound_ms=b_ms)
        del args, got, want
    log(f"[kernels] K8 ptxas: {ptxas_report('ssd_chunk_tf32_kernel')}; "
        f"{ptxas_report('ssd_cb_tf32_kernel')}")
    rows.append(("ssd_intra_chunk", "src/repro_torch/csrc/ssd_intra_chunk.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:62",
                 ssd_intra_chunk, k8))

    rows.append(_k8b(dev))
    _moe_kernel_shapes(dev)


def _moe_kernel_shapes(dev):
    """K7, K7b and K8 at the shapes the MoE archs give them, against their
    plain versions with the tolerances above, each timed beside its plain
    version, its library call (K7: SDPA, causal, GQA; K7b: SDPA's backward,
    K / V expanded) and its bound: K7 at dbrx's / grok's prefill (G = 6)
    and jamba's (G = 4), K7b at dbrx's training shape (G = 6), K8 at
    jamba's SSD prefill (nh = 128), with a repeat bit-equal."""
    import torch

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_cost,
        flash_attention_bwd_plain, flash_attention_cost, flash_attention_plain,
    )
    from repro_torch.kernels.ssd_scan.ops import (
        ssd_intra_chunk, ssd_intra_chunk_cost, ssd_intra_chunk_plain,
    )
    from repro_torch.launch.roofline import (
        PEAK_BF16_S, PEAK_F32_S, bound, tf32x3_bound,
    )

    bf16 = torch.bfloat16
    for label, shape in (("dbrx / grok prefill", DBRX_PREFILL),
                         ("jamba prefill", JAMBA_PREFILL)):
        B, S, K, G, hd = shape
        H = K * G
        err, rel, q, k, v, scale = _k7_check(dev, shape, bf16, 5)
        again = flash_attention(q, k, v, scale)
        same = torch.equal(again, flash_attention(q, k, v, scale))
        require(same, f"K7 {label}: two calls differ")
        ms = device_ms(lambda: flash_attention(q, k, v, scale), 5,
                       own=k7_kernels(hd, bf16))
        plain = device_ms(lambda: flash_attention_plain(q, k, v, scale), 3)
        qh = q.reshape(B, S, H, hd).transpose(1, 2).contiguous()
        kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        lib = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True), 5)
        ops, bytes_ = flash_attention_cost(B, S, K, G, hd, 2)
        b_ms, b_by = bound(bytes_, ops, PEAK_BF16_S)
        log(f"[kernels] K7 flash_attention {label} {shape} bf16: "
            f"max_abs_err {err:.3e} rel {rel:.3e} (tol {BF16_TOL:.3e}), "
            f"repeat bit-equal; kernel device ms {ms.own:.4f} [{ms.source}] "
            f"plain device ms {plain.total:.4f} [{plain.source}] library "
            f"device ms {lib.total:.4f} [{lib.source}] "
            f"(scaled_dot_product_attention, causal, GQA) bound ms "
            f"{b_ms:.4f} ({b_by}; {ops:.3e} ops, {bytes_ / 1e6:.1f} MB) "
            f"achieved {ops / ms.own / 1e9:.2f} TFLOP/s")
        del q, k, v, qh, kh, vh, again
        torch.cuda.empty_cache()

    B, S, K, G, hd = DBRX_TRAIN
    H = K * G
    for dt in (bf16, torch.float32):
        err, rel, (q, k, v, o, do, scale, lse) = _k7b_check(
            dev, DBRX_TRAIN, dt, 11)
        ms = device_ms(lambda: flash_attention_bwd(q, k, v, o, do, scale,
                                                   lse), 5,
                       own=k7b_kernels(hd, dt))
        plain = device_ms(lambda: flash_attention_bwd_plain(
            q, k, v, o, do, scale), 3)
        qh = q.reshape(B, S, H, hd).transpose(1, 2).contiguous()
        kh, vh = (t.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
                  for t in (k, v))
        leaves = [t.requires_grad_(True) for t in (qh, kh, vh)]
        out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=True)
        doh = do.reshape(B, S, H, hd).transpose(1, 2).contiguous()
        lib = device_ms(lambda: torch.autograd.grad(
            out, leaves, doh, retain_graph=True), 5)
        ops, bytes_ = flash_attention_bwd_cost(B, S, K, G, hd,
                                               q.element_size())
        b_ms, b_by = bound(bytes_, ops, PEAK_BF16_S if dt == bf16
                           else PEAK_F32_S)
        tol = BF16_TOL if dt == bf16 else K7B_TOL_F32
        log(f"[kernels] K7b flash_attention_bwd dbrx train {DBRX_TRAIN} "
            f"{'bf16' if dt == bf16 else 'f32'}: max_abs_err {err:.3e} rel "
            f"{rel:.3e} (tol {tol:.3e}), repeat bit-equal; kernel device ms "
            f"{ms.own:.4f} [{ms.source}] plain device ms {plain.total:.4f} "
            f"[{plain.source}] library device ms {lib.total:.4f} "
            f"[{lib.source}] (scaled_dot_product_attention backward, causal, "
            f"K / V expanded to {H} heads) bound ms {b_ms:.4f} ({b_by}; "
            f"{ops:.3e} ops, {bytes_ / 1e6:.1f} MB) achieved "
            f"{ops / ms.own / 1e9:.2f} TFLOP/s")
        del q, k, v, o, do, lse, qh, kh, vh, doh, leaves, out
        torch.cuda.empty_cache()

    B, nc, Q, nh, hp, ds = JAMBA_SSD_PREFILL
    args = _k8_inputs(dev, B, nc, Q, nh, hp, ds, 13)
    got = ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    want = ssd_intra_chunk_plain(*args)
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    del want
    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    require(rel <= KERNEL_TOL, f"K8 jamba prefill: rel err {rel:.3e} > "
            f"{KERNEL_TOL}")
    again = ssd_intra_chunk(*args)
    require(all(torch.equal(g, a) for g, a in zip(got, again)),
            "K8 jamba prefill: two calls differ")
    del got, again
    ms = device_ms(lambda: ssd_intra_chunk(*args), 5, own=K8_KERNELS)
    plain = device_ms(lambda: ssd_intra_chunk_plain(*args), 3)
    ops, bytes_ = ssd_intra_chunk_cost(B, nc, Q, nh, hp, ds)
    b_ms, b_by = bound(bytes_, ops)
    tc_ms, tc_by = tf32x3_bound(bytes_, ops)
    log(f"[kernels] K8 ssd_intra_chunk jamba prefill (B, nc, Q, nh, hp, ds) "
        f"= {JAMBA_SSD_PREFILL}: max_abs_err {err:.3e} rel {rel:.3e} (tol "
        f"{KERNEL_TOL}), repeat bit-equal; kernel device ms {ms.own:.4f} "
        f"[{ms.source}] plain device ms {plain.total:.4f} [{plain.source}] "
        f"bound ms {b_ms:.4f} ({b_by}, float32 FMAs; {ops:.3e} ops, "
        f"{bytes_ / 1e6:.1f} MB); 3xTF32 design bound ms {tc_ms:.4f} "
        f"({tc_by})")
    del args
    torch.cuda.empty_cache()


def _k8b(dev):
    """K8b (the SSD intra-chunk backward) against its plain version at
    mamba's smoke training shape, two ragged shapes (Q < 256 and no multiple
    of 64, nc > 1, hp < 64, ds < 128, widths no multiple of 4), then at
    mamba2-780m's training shape (the table's row: its time, each kernel's,
    the plain version's and the bounds) and at the prefill shape, with a
    random dy and a nonzero dstates; a repeat bit-equal."""
    import torch

    from repro_torch.kernels.ssd_scan.ops import (
        ssd_intra_chunk_bwd, ssd_intra_chunk_bwd_cost,
        ssd_intra_chunk_bwd_plain,
    )
    from repro_torch.launch.roofline import bound, tf32x3_bound

    row = None
    for label, shape in (("smoke train", (8, 8, 32, 8, 16, 16)),
                         ("ragged", (2, 3, 200, 5, 24, 40)),
                         ("ragged, odd widths", (1, 2, 100, 3, 9, 13)),
                         ("train", MAMBA_TRAIN), ("prefill", MAMBA_PREFILL)):
        B, nc, Q, nh, hp, ds = shape
        args = _k8_inputs(dev, B, nc, Q, nh, hp, ds, nc + 1)
        g = torch.Generator(device=dev).manual_seed(nc + 2)
        dy = torch.randn((B, nc, Q, nh, hp), generator=g, device=dev)
        dst = torch.randn((B, nc, nh, hp, ds), generator=g, device=dev)
        got = ssd_intra_chunk_bwd(*args, dy, dst)
        torch.cuda.synchronize()
        want = ssd_intra_chunk_bwd_plain(*args, dy, dst)
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        del want
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
        require(rel <= K8B_TOL, f"K8b {label}: rel err {rel:.3e} > "
                f"{K8B_TOL} (dx, dcum, ddt, dBc, dCc: "
                + ", ".join(f"{r:.2e}" for _, r in errs) + ")")
        again = ssd_intra_chunk_bwd(*args, dy, dst)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"K8b {label}: two launches differ")
        del again
        ops, bytes_ = ssd_intra_chunk_bwd_cost(B, nc, Q, nh, hp, ds)
        b_ms, b_by = bound(bytes_, ops)
        tc_ms, tc_by = tf32x3_bound(bytes_, ops)
        extra = ""
        if label in ("train", "prefill"):
            call = lambda: ssd_intra_chunk_bwd(*args, dy, dst)  # noqa: E731
            ms = device_ms(call, 5, own=K8B_KERNELS)
            call_ms = time_ms(call, 10)
            extra = (f"; kernel device ms {ms.own:.4f} [{ms.source}] (call "
                     f"ms {call_ms:.4f})")
            if label == "train":
                plain = device_ms(lambda: ssd_intra_chunk_bwd_plain(
                    *args, dy, dst), 3)
                extra += (f" plain device ms {plain.total:.4f} "
                          f"[{plain.source}]")
                row = dict(err=err, ms=ms.own, plain_ms=plain.total,
                           bound_ms=tc_ms, bound_by=tc_by, library_ms=None,
                           fma_bound_ms=b_ms)
                split = own_split_ms(call, 5, K8B_KERNELS)
                extra += " (split, torch.profiler: " + (", ".join(
                    f"{k} {t:.4f}" for k, t in split.items()) if split
                    else "not measured, every record refused") + ")"
            extra += (f" achieved {ops / ms.own / 1e9:.2f} TFLOP/s, "
                      f"{tc_ms / ms.own:.3f} of the 3xTF32 bound")
        log(f"[kernels] K8b ssd_intra_chunk_bwd {label} (B, nc, Q, nh, hp, "
            f"ds) = {shape}: max_abs_err {err:.3e} rel {rel:.3e} (tol "
            f"{K8B_TOL}; dx, dcum, ddt, dBc, dCc "
            + ", ".join(f"{r:.2e}" for _, r in errs)
            + f"), repeat bit-equal{extra}; 3xTF32 design bound ms "
            f"{tc_ms:.4f} ({tc_by}); bound ms {b_ms:.4f} ({b_by}, float32 "
            f"FMAs; {ops:.3e} ops, {bytes_ / 1e6:.1f} MB)")
        del args, dy, dst, got
        torch.cuda.empty_cache()
    log("[kernels] K8b ptxas: " + "; ".join(ptxas_report(k)
                                            for k in K8B_KERNELS))
    return ("ssd_intra_chunk_bwd",
            "src/repro_torch/csrc/ssd_intra_chunk_bwd.cu",
            "src/repro/kernels/ssd_scan/ops.py:66", ssd_intra_chunk_bwd, row)


def _k7b_check(dev, shape, dt, seed):
    """K7b against its plain version (the softmax recompute), from the
    output and log-sum-exp of K7's forward with the log-sum-exp (the output
    held to the plain one at K7's KERNEL_TOL / BF16_TOL, the log-sum-exp at
    LSE_TOL), and a second launch bit-equal; (err, rel, inputs)."""
    import torch

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_lse,
        flash_attention_plain,
    )

    B, S, K, G, hd = shape
    q, k, v = _k7_inputs(dev, B, S, K, G, hd, dt, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device=dev).to(dt)
    scale = hd ** -0.5
    o, lse = flash_attention_lse(q, k, v, scale)
    o_want, lse_want = flash_attention_plain(q, k, v, scale, return_lse=True)
    o_tol = KERNEL_TOL if dt == torch.float32 else BF16_TOL   # K7's own
    _, o_err = rel_err(o, o_want)
    require(o_err <= o_tol, f"K7 {shape} {dt} with the log-sum-exp: output "
            f"rel err {o_err:.3e} > {o_tol}")
    _, lse_err = rel_err(lse, lse_want)
    require(lse_err <= LSE_TOL, f"K7 {shape} {dt}: log-sum-exp rel err "
            f"{lse_err:.3e} > {LSE_TOL}")
    del o_want, lse_want
    got = flash_attention_bwd(q, k, v, o, do, scale, lse)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, o, do, scale)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    del want
    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    tol = K7B_TOL_F32 if dt == torch.float32 else BF16_TOL
    require(rel <= tol, f"K7b {shape} {dt}: rel err {rel:.3e} > {tol} (dq, "
            f"dk, dv: " + ", ".join(f"{r:.2e}" for _, r in errs) + ")")
    again = flash_attention_bwd(q, k, v, o, do, scale, lse)
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"K7b {shape} {dt}: two launches differ")
    return err, rel, (q, k, v, o, do, scale, lse)


def _k7b(dev):
    """K7b (flash-attention backward) against its plain version over hd x G
    x S around the main shapes, then at llama3.2-3b's training shape (the
    table's row: its time, the plain version's, the backward of
    ``scaled_dot_product_attention`` with GQA expanded, and the bound) and
    at the prefill shape."""
    import torch

    from repro_torch.kernels.flash_attention.ops import (
        bwd_route, flash_attention_bwd, flash_attention_bwd_cost,
        flash_attention_bwd_plain,
    )
    from repro_torch.launch.roofline import PEAK_BF16_S, PEAK_F32_S, bound

    n, worst = 0, {torch.float32: 0.0, torch.bfloat16: 0.0}
    wgmma_worst = 0.0
    for hd in (16, 64, 128, 256):
        for G in (1, 3, 6):
            for S in (64, 100, 512):
                for dt in (torch.float32, torch.bfloat16):
                    _, rel, _ = _k7b_check(dev, (1, S, 2, G, hd), dt, n)
                    worst[dt] = max(worst[dt], rel)
                    if bwd_route(dt, hd) == "wgmma":
                        wgmma_worst = max(wgmma_worst, rel)
                    n += 1
    log(f"[kernels] K7b flash_attention_bwd: {n} shapes (hd 16/64/128/256, "
        f"G 1/3/6, S 64/100/512, f32 and bf16) within tolerance, the "
        f"forward's output with the log-sum-exp within the same tolerance "
        f"and its log-sum-exp within {LSE_TOL} of the plain ones, repeats "
        f"bit-equal: worst rel "
        f"f32 {worst[torch.float32]:.3e} (tol {K7B_TOL_F32}) bf16 "
        f"{worst[torch.bfloat16]:.3e} (tol {BF16_TOL:.3e}); the wgmma route "
        f"(P and dS rounded to bf16 once) {wgmma_worst:.3e}")
    row = None
    for shape, label in ((LLAMA_TRAIN, "train"), (LLAMA_PREFILL, "prefill")):
        B, S, K, G, hd = shape
        H = K * G
        for dt in (torch.bfloat16, torch.float32):
            err, rel, (q, k, v, o, do, scale, lse) = _k7b_check(
                dev, shape, dt, 7)
            call = lambda: flash_attention_bwd(  # noqa: E731
                q, k, v, o, do, scale, lse)
            ms = device_ms(call, 5, own=k7b_kernels(hd, dt))
            ops, bytes_ = flash_attention_bwd_cost(B, S, K, G, hd,
                                                   q.element_size())
            b_ms, b_by = bound(bytes_, ops, PEAK_BF16_S
                               if dt == torch.bfloat16 else PEAK_F32_S)
            dname = "bf16" if dt == torch.bfloat16 else "f32"
            extra = ""
            if label == "train":
                plain = device_ms(lambda: flash_attention_bwd_plain(
                    q, k, v, o, do, scale), 3)
                qh = q.reshape(B, S, H, hd).transpose(1, 2).contiguous()
                kh, vh = (t.repeat_interleave(G, dim=2).transpose(1, 2)
                          .contiguous() for t in (k, v))
                leaves = [t.requires_grad_(True) for t in (qh, kh, vh)]
                out = torch.nn.functional.scaled_dot_product_attention(
                    *leaves, is_causal=True)
                doh = do.reshape(B, S, H, hd).transpose(1, 2).contiguous()
                lib = device_ms(lambda: torch.autograd.grad(
                    out, leaves, doh, retain_graph=True), 5)
                extra += (f" plain device ms {plain.total:.4f} "
                          f"[{plain.source}] library device ms "
                          f"{lib.total:.4f} [{lib.source}] "
                          f"(scaled_dot_product_attention backward, causal, "
                          f"K / V expanded to {H} heads)")
                if dt == torch.bfloat16:
                    row = dict(err=err, ms=ms.own, plain_ms=plain.total,
                               bound_ms=b_ms, bound_by=b_by,
                               library_ms=lib.total)
                del out, leaves, qh, kh, vh, doh
            log(f"[kernels] K7b flash_attention_bwd {label} {shape} {dname}: "
                f"max_abs_err {err:.3e} rel {rel:.3e}, repeat bit-equal; "
                f"kernel device ms {ms.own:.4f} [{ms.source}]{extra} bound "
                f"ms {b_ms:.4f} ({b_by}; "
                f"{ops:.3e} ops, {bytes_ / 1e6:.1f} MB) achieved "
                f"{ops / ms.own / 1e9:.2f} TFLOP/s")
            del q, k, v, o, do, lse
            torch.cuda.empty_cache()
    log(f"[kernels] K7b ptxas: {ptxas_report('k7b_wgmma_kernel')}; "
        f"{ptxas_report('k7b_dvec_kernel')}; "
        f"{ptxas_report('k7b_dq_mma_kernel')}; "
        f"{ptxas_report('k7b_dkdv_mma_kernel')}; "
        f"{ptxas_report('k7b_dkdv_kernel')}; "
        f"{ptxas_report('k7b_dq_kernel')}; "
        f"{ptxas_report('k7b_stats_kernel')}")
    return ("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention/ops.py:29",
            flash_attention_bwd, row)


def _lm_fixture_cfg(arch):
    """The fixture's config: smoke width, two blocks; jamba one block of 8
    layers routed in MoE groups of 512 (its 1024-token prompt in two)."""
    from repro_torch.configs import smoke_arch

    base = smoke_arch(arch)
    if base.num_experts:
        return base.replace(moe_seq_chunk=512)
    return base.replace(num_layers=2 * base.block_size)


def _mixer_layers(cfg):
    """(attention layers, mamba layers) of ``cfg``."""
    attn = sum(s.mixer == "attention" for s in cfg.layer_specs())
    return attn * cfg.num_blocks, (cfg.block_size - attn) * cfg.num_blocks


def phase_lm_reference(dev):
    """The JAX fixture ``reference_lm.npz`` on the card (K7, K8, f32):
    prefill logits, and the decode logits fed JAX's greedy tokens, within
    LM_TOL; the card's greedy picks equal JAX's where JAX's top two logits
    differ by more than 1e-3 of their scale."""
    import numpy as np
    import torch

    from repro_torch.interop import lm_params_from_jax
    from repro_torch.launch.serve import _splice_prefill
    from repro_torch.models import transformer as tf

    with np.load(LM_FIXTURE) as f:
        ref = {k: f[k] for k in f.files}
    for arch in LM_FIXTURE_ARCHS:
        cfg = _lm_fixture_cfg(arch)
        pre = f"{arch}:param:"
        params = lm_params_from_jax({k[len(pre):]: v for k, v in ref.items()
                                     if k.startswith(pre)}, cfg, device=dev)
        toks = torch.from_numpy(ref[f"{arch}:prompts"]).to(dev)
        greedy = ref[f"{arch}:tokens"]
        B, P = toks.shape
        T = greedy.shape[1]
        before = _counts()
        logits, caches, idx = tf.prefill(cfg, params, toks)
        launched = {k: v - before[k] for k, v in _counts().items()}
        worst = rel_err(logits.cpu(), torch.from_numpy(
            ref[f"{arch}:prefill_logits"]))[1]
        state = _splice_prefill(cfg, tf.init_decode_state(
            cfg, B, P + T, idx, device=dev), caches, idx)
        prev, checked, equal = ref[f"{arch}:prefill_logits"], 0, 0
        for t in range(T):
            top2 = np.sort(prev, axis=-1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > 1e-3 * np.abs(prev).max()
            mine = logits.argmax(-1).cpu().numpy()
            checked += int(clear.sum())
            equal += int((mine[clear] == greedy[clear, t]).sum())
            logits, state = tf.decode_step(
                cfg, params, state,
                torch.from_numpy(greedy[:, t:t + 1]).to(dev))
            prev = ref[f"{arch}:decode_logits"][t]
            worst = max(worst, rel_err(logits.cpu(),
                                       torch.from_numpy(prev))[1])
        log(f"[lm_reference] {arch} (smoke widths, {cfg.num_layers} layers, "
            f"B={B}, prompt {P}, f32): prefill + {T} decode steps max rel "
            f"err vs JAX {worst:.3e} (tol {LM_TOL}); greedy tokens equal on "
            f"{equal} of {checked} clear picks; prefill launches "
            f"K7 {launched['flash_attention']} K8 "
            f"{launched['ssd_intra_chunk']}")
        require(worst <= LM_TOL, f"lm_reference {arch}: rel err {worst:.3e}")
        require(equal == checked, f"lm_reference {arch}: greedy tokens differ")
        attn, mamba = _mixer_layers(cfg)
        require((launched["flash_attention"], launched["ssd_intra_chunk"])
                == (attn, mamba),
                f"lm_reference {arch}: K7 / K8 launched "
                f"{launched['flash_attention']} / "
                f"{launched['ssd_intra_chunk']} times, not once per "
                f"attention / mamba layer ({attn} / {mamba})")


def _profile_prefill(cfg, params, toks):
    """One prefill of ``toks`` under torch.profiler: the device's busy time,
    K8's share of it and the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as tf

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tf.prefill(cfg, params, toks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_s, top = _device_profile(prof)
    k8 = sum(t for t, key, _ in top if any(k in key for k in K8_KERNELS))
    B, S = toks.shape
    busy = max(busy_s, 1e-12)
    log(f"[lm_serve] {cfg.arch_id} prefill {B}x{S} ({cfg.compute_dtype}) "
        f"under torch.profiler: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy_s * 1e3:.2f} ms, K8 {k8 / 1e3:.2f} ms "
        f"({100 * k8 / 1e6 / busy:.1f} % of busy)")
    for t, key, count in top[:10]:
        log(f"[lm_serve]   {t / 1e3:9.3f} ms {100 * t / 1e6 / busy:5.1f} %  "
            f"x{count:<6d} {key[:70]}")


def _decode_vs_prefill(dev, arch, compute_dtype, tol, num_layers=None):
    """At full width (``num_layers`` cuts the depth): prefill DECODE_SPLIT
    prompt tokens, decode the rest teacher-forced, and hold the last logits
    to the prefill of the whole prompt at its last position; a window of
    decode steps is profiled."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import _splice_prefill
    from repro_torch.models import transformer as tf

    cfg = get_arch(arch).replace(compute_dtype=compute_dtype)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    gen = torch.Generator(device=dev).manual_seed(1)
    params = tf.compute_params(cfg, tf.init_params(cfg, gen, device=dev))
    B, S, P = LM_BATCH, LM_PROMPT, DECODE_SPLIT
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    want, _, _ = tf.prefill(cfg, params, toks)
    if arch.startswith("mamba") and num_layers is None:
        _profile_prefill(cfg, params, toks)
    _, caches, idx = tf.prefill(cfg, params, toks[:, :P])
    state = _splice_prefill(cfg, tf.init_decode_state(cfg, B, S, idx,
                                                      device=dev), caches, idx)
    del caches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(P, S - LM_PROFILE_STEPS):
        logits, state = tf.decode_step(cfg, params, state, toks[:, t:t + 1])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (S - LM_PROFILE_STEPS - P)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(S - LM_PROFILE_STEPS, S):
            logits, state = tf.decode_step(cfg, params, state,
                                           toks[:, t:t + 1])
        torch.cuda.synchronize()
        prof_s = (time.perf_counter() - t0) / LM_PROFILE_STEPS
    busy_s, top = _device_profile(prof)
    busy_step = busy_s / LM_PROFILE_STEPS
    kernels = sum(c for _, _, c in top) / LM_PROFILE_STEPS
    err, rel = rel_err(logits, want)
    agree = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
    log(f"[lm_serve] {arch} ({cfg.num_layers} layers) {compute_dtype} "
        f"decode vs prefill: prefill {P} "
        f"+ decode {S - P} teacher-forced vs prefill {S}, last position: "
        f"max_abs_err {err:.3e} rel {rel:.3e} (tol {tol}) argmax agree "
        f"{agree:.2f}; decode step {step_s * 1e3:.3f} ms ({B / step_s:.1f} "
        f"tok/s); profiled {LM_PROFILE_STEPS} steps: {prof_s * 1e3:.3f} ms a "
        f"step, device busy {busy_step * 1e3:.3f} ms a step (busy share "
        f"{busy_step / prof_s:.3f}), ~{kernels:.0f} device ops a step")
    for t, key, count in top[:8]:
        log(f"[lm_serve]   {t / 1e3 / LM_PROFILE_STEPS:8.3f} ms/step "
            f"{100 * t / 1e6 / max(busy_s, 1e-12):5.1f} %  x{count:<6d} "
            f"{key[:70]}")
    require(rel <= tol, f"{arch} {compute_dtype} decode vs prefill: rel "
            f"{rel:.3e} > {tol}")


def _serve_shape():
    """The serving prefill as a dry-run shape: LM_BATCH prompts of
    LM_PROMPT positions (a vision arch's prefix tokens among them)."""
    from repro_torch.config import KIND_PREFILL, ShapeConfig

    return ShapeConfig("serve_prefill", LM_PROMPT, LM_BATCH, KIND_PREFILL)


def _dry_prediction(label, cfg, shape, tcfg, ms, peak, hold=True):
    """The dry run of one step (``lower_one`` at ``cfg`` and ``shape``, on
    the host) beside the card's measurement of it: its predicted peak
    (arguments + temp) against ``peak`` bytes, its bound against ``ms``
    (the roofline share) and the model FLOPs over ``ms`` at the bf16 peak;
    with ``hold``, the peak within PEAK_TOL and the share at most
    SHARE_MAX."""
    from repro_torch.launch.dryrun import lower_one
    from repro_torch.launch.roofline import PEAK_BF16_S

    t0 = time.perf_counter()
    rec = lower_one(cfg, shape, tcfg)
    m, rl, cost = rec["memory"], rec["roofline"], rec["cost"]
    args, temp = m["argument_bytes_per_device"], m["temp_bytes_per_device"]
    gap = (args + temp) / peak - 1.0
    share = rl["step_time_bound_s"] * 1e3 / ms
    mfu = rec["model_flops"] / (ms / 1e3 * PEAK_BF16_S)
    log(f"[dryrun] {label}: predicted peak {(args + temp) / 2**30:.3f} GiB "
        f"(arguments {args / 2**30:.3f} + temp {temp / 2**30:.3f}) measured "
        f"{peak / 2**30:.3f} GiB, gap {100 * gap:+.2f} % (tol "
        f"{100 * PEAK_TOL:.0f} %); bound {rl['step_time_bound_s'] * 1e3:.3f} "
        f"ms ({rl['dominant']}: compute {rl['compute_s'] * 1e3:.3f} ms, "
        f"memory {rl['memory_s'] * 1e3:.3f} ms; "
        f"{cost['flops_per_device']:.4e} FLOPs "
        f"{json.dumps({k: f'{v:.3e}' for k, v in cost['flops_by_dtype'].items()})}, "
        f"{cost['bytes_per_device']:.4e} bytes) against {ms:.3f} ms "
        f"measured: roofline share {share:.4f} (max {SHARE_MAX}); model "
        f"FLOPs {rec['model_flops']:.4e}, {mfu:.4f} of the bf16 peak; meta "
        f"run {time.perf_counter() - t0:.2f} s"
        + ("" if hold else " (printed, not held)"))
    if hold:
        require(abs(gap) <= PEAK_TOL, f"dry run {label}: predicted peak "
                f"{args + temp} bytes, measured {peak}: gap {gap:+.3f}")
        require(share <= SHARE_MAX, f"dry run {label}: roofline share "
                f"{share:.4f} > {SHARE_MAX}")
    return rec


def _serve_need(cfg):
    """The bytes ``serve.main`` needs for ``cfg`` at chip_smoke's requests,
    by the dry run: the larger of the weights' draw
    (``init_compute_params`` on ``meta``) and the prefill's arguments and
    temp with the decode state of LM_PROMPT + LM_TOKENS positions beside
    them."""
    from repro_torch.config import KIND_DECODE, ShapeConfig
    from repro_torch.launch.dryrun import StepCounter, lower_one
    from repro_torch.models import transformer as tf
    from repro_torch.models.specs import decode_state_specs
    from repro_torch.optim.adamw import tree_leaves

    m = lower_one(cfg, _serve_shape())["memory"]
    init = StepCounter([])
    with init:
        tf.init_compute_params(cfg, None, device="meta")
    state = decode_state_specs(cfg, ShapeConfig(
        "serve_decode", LM_PROMPT + LM_TOKENS, LM_BATCH, KIND_DECODE))
    dstate = sum(t.nbytes for t in tree_leaves(state["caches"]))
    return max(init.peak, m["argument_bytes_per_device"]
               + m["temp_bytes_per_device"] + dstate)


def _serve_depth(arch):
    """The layers ``arch`` serves at on this card, by the dry run: all of
    them where ``_serve_need`` with PEAK_TOL of headroom fits the card's
    memory, else the largest whole number of blocks that does."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.roofline import HBM_BYTES

    cfg = get_arch(arch)
    total = torch.cuda.get_device_properties(0).total_memory
    budget = min(HBM_BYTES, total) / (1 + PEAK_TOL)

    def need(nb):
        return _serve_need(cfg.replace(num_layers=nb * cfg.block_size))

    t0 = time.perf_counter()
    nb, full = cfg.num_blocks, need(cfg.num_blocks)
    if full > budget and nb > 1:
        one = need(1)
        per = (full - one) / (nb - 1)
        nb = max(1, min(nb - 1, int((budget - one) // per) + 1))
        while nb > 1 and need(nb) > budget:
            nb -= 1
        while nb + 1 < cfg.num_blocks and need(nb + 1) <= budget:
            nb += 1
    got = need(nb)
    log(f"[lm_serve] {arch}: the dry run's serving need at all "
        f"{cfg.num_layers} layers {full / 2**30:.3f} GiB against a budget "
        f"of {budget / 2**30:.3f} GiB (the card's {total / 2**30:.3f} GiB / "
        f"{1 + PEAK_TOL}): serving {nb * cfg.block_size} layers, need "
        f"{got / 2**30:.3f} GiB ({time.perf_counter() - t0:.2f} s of meta "
        f"runs)")
    require(got <= budget, f"{arch}: not even one block fits the card")
    return nb * cfg.block_size


def _serve(arch, layers=None, hold=True):
    """``repro_torch.launch.serve.main`` for ``arch`` at full width on
    LM_REQUESTS batches of LM_BATCH x LM_PROMPT + LM_TOKENS tokens (a
    vision arch's prefix tokens among the LM_PROMPT), its depth cut to
    ``layers`` (the launcher's ``get_arch`` narrowed for the call; serve
    has no depth flag, as JAX's has none): rc 0, finite logits, K7 launched
    once per attention layer and prefill and K8 once per mamba layer and
    prefill; then the dry run of the prefill beside the second batch's
    (``_dry_prediction``, held with ``hold``).  Returns the run's launch
    counts."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_arch(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    prompt = LM_PROMPT - (cfg.frontend_tokens if cfg.frontend == "vision"
                          else 0)
    before = _counts()
    recs: list = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    serve.get_arch = lambda a: cfg
    try:
        rc = serve.main(["--arch", arch, "--batch", str(LM_BATCH),
                         "--prompt-len", str(prompt), "--tokens",
                         str(LM_TOKENS), "--requests", str(LM_REQUESTS)],
                        out=recs)
    finally:
        serve.get_arch = get_arch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in _counts().items()}
    for r in recs:
        log(f"[lm_serve] {arch} batch {r['batch']}: prefill "
            f"{LM_BATCH}x{LM_PROMPT} {r['prefill_s'] * 1e3:.2f} ms, decode "
            f"{LM_TOKENS} tokens {r['decode_s'] * 1e3:.2f} ms "
            f"({r['tok_s']:.1f} tok/s), peak memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB, finite logits "
            f"{r['finite']}, sample {r['tokens'][0, :8].tolist()}")
    attn, mamba = _mixer_layers(cfg)
    n = sum(p.numel() for p in tree_leaves(tf.init_params(cfg, None,
                                                          device="meta")))
    log(f"[lm_serve] {arch} ({cfg.num_layers} of {get_arch(arch).num_layers} "
        f"layers, {n / 1e9:.3f} B params, {cfg.compute_dtype}): rc {rc}, "
        f"{len(recs)} batches in {wall:.2f} s (weights drawn on the card "
        f"included); peak memory of the whole call "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{json.dumps({k: v for k, v in launched.items() if v})}")
    require(rc == 0 and len(recs) == LM_REQUESTS,
            f"lm_serve {arch}: rc {rc}")
    require(all(r["finite"] for r in recs),
            f"lm_serve {arch}: non-finite logits")
    require((launched["flash_attention"], launched["ssd_intra_chunk"])
            == (attn * LM_REQUESTS, mamba * LM_REQUESTS),
            f"lm_serve {arch}: K7 / K8 launched "
            f"{launched['flash_attention']} / {launched['ssd_intra_chunk']} "
            f"times, not once per attention / mamba layer ({attn} / "
            f"{mamba}) and prefill")
    r = recs[-1]
    _dry_prediction(f"{arch} ({cfg.num_layers} layers) serve prefill "
                    f"{LM_BATCH} x {LM_PROMPT}, batch {r['batch']}", cfg,
                    _serve_shape(), None, r["prefill_s"] * 1e3,
                    r["prefill_peak_bytes"], hold)
    return launched


def _decode_split(dev):
    """DECODE_SPLIT_CHUNKS: llama3.2-3b's decode with and without JAX's
    split softmax from the same prefilled caches (see the constant)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import _splice_prefill
    from repro_torch.models import transformer as tf

    arch = LM_ARCHS[0]
    cfg = get_arch(arch)
    gen = torch.Generator(device=dev).manual_seed(1)
    params = tf.init_compute_params(cfg, gen, device=dev)
    B, P, T = LM_BATCH, LM_PROMPT, LM_TOKENS
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, P + T)).astype(np.int32)).to(dev)
    _, caches, idx = tf.prefill(cfg, params, toks[:, :P])
    run = {}
    for name, split in (("unsplit", 0), ("split", DECODE_SPLIT_CHUNKS)):
        c = cfg.replace(decode_split=split)
        state = _splice_prefill(c, tf.init_decode_state(
            c, B, P + T, idx, device=dev), caches, idx)
        logits = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(P, P + T):
            lg, state = tf.decode_step(c, params, state, toks[:, t:t + 1])
            logits.append(lg)
        torch.cuda.synchronize()
        run[name] = (torch.stack(logits).float().cpu(),
                     B * T / (time.perf_counter() - t0))
        del state
    got, want = run["split"][0], run["unsplit"][0]
    gaps = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    tol = DECODE_TOL[arch]
    log(f"[lm_serve] {arch} ({cfg.num_layers} layers) {cfg.compute_dtype} "
        f"decode with "
        f"decode_split {DECODE_SPLIT_CHUNKS} ({(P + T) // DECODE_SPLIT_CHUNKS}"
        f" positions a chunk) vs without, {T} teacher-forced steps after a "
        f"{P}-token prefill, batch {B}: logits max rel gap {max(gaps):.3e} "
        f"(tol {tol}; first / last step {gaps[0]:.3e} / {gaps[-1]:.3e}); "
        f"{run['split'][1]:.1f} tok/s split, {run['unsplit'][1]:.1f} "
        f"unsplit (first step included)")
    require(max(gaps) <= tol, f"{arch} decode_split: logit gap "
            f"{max(gaps):.3e} > {tol}")
    del params, caches
    torch.cuda.empty_cache()


def phase_lm_serve(dev):
    """This slice's main path: ``repro_torch.launch.serve.main`` for
    llama3.2-3b and mamba2-780m at full width and depth, for the MoE
    archs at full width and a cut depth (MOE_SERVE), and for DEPTH_ARCHS at
    full width and the depth the dry run picks (``_serve_depth``); then
    the decode-vs-prefill check.  Returns the serve runs' launch counts."""
    import torch

    _zero_counts()
    for arch in LM_ARCHS:
        _serve(arch)
    for arch, layers in MOE_SERVE:
        _serve(arch, layers)
    for arch in DEPTH_ARCHS:
        _serve(arch, _serve_depth(arch), hold=False)
    counts = _counts()
    for arch in LM_ARCHS:
        _decode_vs_prefill(dev, arch, "bfloat16", DECODE_TOL[arch])
        torch.cuda.empty_cache()
        _decode_vs_prefill(dev, arch, "float32", DECODE_TOL_F32,
                           num_layers=DECODE_F32_LAYERS)
        torch.cuda.empty_cache()
    _decode_split(dev)
    return counts


def _train_parity(dev, arch, whole_step=True):
    """One train step of ``arch`` at smoke width, PARITY_LAYERS layers (one
    block where a block is longer), float32, batch 8 x 256, on the card and
    on the CPU in this process from the same weights and batch: the loss
    within LOSS_TOL, every gradient leaf within GRAD_TOL of its norm, the
    parameters after the update within PARAM_TOL of theirs; without
    ``whole_step``, the parameters after the card's optimizer applied to
    the CPU's gradients (the whole step's gap printed beside them)."""
    import torch

    from repro_torch.config import TrainConfig
    from repro_torch.configs import smoke_arch
    from repro_torch.data import TokenStream
    from repro_torch.interop import _flatten
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init, apply_gradients
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten

    cfg = smoke_arch(arch)
    cfg = cfg.replace(num_layers=max(PARITY_LAYERS, cfg.block_size))
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=20, total_steps=30)
    B, S = LLAMA_TRAIN[:2]
    host = tf.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    batch = TokenStream(cfg.vocab_size, S, B, seed=0).next()
    out = {}
    for where in ("cpu", dev):
        params = tree_unflatten(host, [x.to(where).clone()
                                       for x in tree_leaves(host)])
        b = {k: torch.from_numpy(v).to(where) for k, v in batch.items()}
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        grads = torch.autograd.grad(tf.lm_loss(cfg, params, b)[0], leaves)
        state, m = make_train_step(cfg, tcfg)(adamw_init(params, tcfg), b)
        out[str(where)] = (float(m["loss"]),
                           [g.detach().cpu() for g in grads],
                           [p.detach().cpu() for p in tree_leaves(
                               state.params)])
    (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = \
        out["cpu"], out[str(dev)]
    if not whole_step:
        params = tree_unflatten(host, [x.to(dev).clone()
                                       for x in tree_leaves(host)])
        grads = tree_unflatten(host, [g.to(dev) for g in g_cpu])
        state, _ = apply_gradients(adamw_init(params, tcfg), grads, tcfg)
        p_opt = [p.detach().cpu() for p in tree_leaves(state.params)]

    names = list(_flatten(host))         # tree_leaves' order

    def worst(a, b):
        return max((float((x - y).norm()) / max(float(y.norm()), 1e-30),
                    name) for x, y, name in zip(a, b, names))

    loss_gap = abs(l_card - l_cpu) / abs(l_cpu)
    (grad_gap, grad_leaf), (param_gap, param_leaf) = (
        worst(g_card, g_cpu), worst(p_card, p_cpu))
    held = "" if whole_step else " (printed, not held)"
    log(f"[lm_train] step parity ({arch} smoke width, "
        f"{cfg.num_layers} layers, f32, batch {B}x{S}): loss card {l_card:.7f} "
        f"cpu {l_cpu:.7f} rel gap {loss_gap:.3e} (tol {LOSS_TOL}); worst "
        f"gradient leaf |card - cpu| / |cpu| {grad_gap:.3e} ({grad_leaf}; "
        f"tol {GRAD_TOL}); worst parameter leaf after the update "
        f"{param_gap:.3e} ({param_leaf}; tol {PARAM_TOL}){held}")
    require(loss_gap <= LOSS_TOL, f"lm_train parity {arch}: loss gap "
            f"{loss_gap:.3e}")
    require(grad_gap <= GRAD_TOL, f"lm_train parity {arch}: gradient gap "
            f"{grad_gap:.3e}")
    if not whole_step:
        param_gap, param_leaf = worst(p_opt, p_cpu)
        log(f"[lm_train] step parity ({arch}): the card's optimizer on the "
            f"CPU's gradients, worst parameter leaf {param_gap:.3e} "
            f"({param_leaf}; tol {PARAM_TOL})")
    require(param_gap <= PARAM_TOL, f"lm_train parity {arch}: parameter "
            f"gap {param_gap:.3e}")


def _profile_train_steps(cfg, state, dev, steps, tcfg=None):
    """TRAIN_PROFILE_STEPS more steps of the state trained ``steps`` steps
    (under ``tcfg``, by default JAX's CLI defaults), under torch.profiler:
    wall and device busy time a step, the split of the device time (K7,
    K7b, K8, K8b, matmuls, copies, the rest) and the top ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import TrainConfig
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import make_train_step

    B, S = LLAMA_TRAIN[:2]
    step = make_train_step(cfg, tcfg or TrainConfig(learning_rate=3e-4,
                                                    warmup_steps=20,
                                                    total_steps=steps))
    data = TokenStream(cfg.vocab_size, S, B, seed=0)
    data.skip(steps)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                data.next().items()} for _ in range(TRAIN_PROFILE_STEPS)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / TRAIN_PROFILE_STEPS
    busy_s, top = _device_profile(prof)
    require(busy_s > 0, "lm_train: the profile recorded no device time")
    busy = busy_s / TRAIN_PROFILE_STEPS
    split: dict = {}
    for t, key, count in top:
        kind = next((k for k, marks in TRAIN_SPLIT
                     if any(m in key for m in marks)),
                    "other (elementwise, reductions: norms, RoPE, softmax "
                    "CE, casts, AdamW, the SSD scan's torch ops)")
        t0, n0 = split.get(kind, (0.0, 0))
        split[kind] = (t0 + t / 1e6 / TRAIN_PROFILE_STEPS,
                       n0 + count // TRAIN_PROFILE_STEPS)
    ops = sum(c for _, _, c in top) / TRAIN_PROFILE_STEPS
    log(f"[lm_train] {cfg.arch_id} profiled {TRAIN_PROFILE_STEPS} steps: "
        f"{wall * 1e3:.2f} ms a step, device busy {busy * 1e3:.2f} ms a step "
        f"(busy share {busy / wall:.3f}), ~{ops:.0f} device ops a step")
    for kind, (t, n) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        log(f"[lm_train]   split {t * 1e3:9.3f} ms/step {100 * t / busy:5.1f} "
            f"%  x{n:<6d} {kind}")
    for t, key, count in top[:10]:
        log(f"[lm_train]   {t / 1e3 / TRAIN_PROFILE_STEPS:9.3f} ms/step "
            f"{100 * t / 1e6 / busy_s:5.1f} %  x{count:<6d} {key[:70]}")


def _train_resume(dev):
    """RESUME_STEPS steps at full width and RESUME_LAYERS layers, against
    half of them, a checkpoint, and ``--resume auto`` to the end: the
    resumed steps' losses and the final params, moments and step
    bit-equal."""
    import tempfile

    import torch

    from repro_torch.launch.train import main as train_main
    from repro_torch.optim.adamw import tree_leaves

    arch = LM_TRAIN_RUNS[0][0]
    base = ["--arch", arch, "--num-layers", str(RESUME_LAYERS),
            "--log-every", str(RESUME_STEPS)]
    half = RESUME_STEPS // 2
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        whole, resumed = {}, {}
        train_main(base + ["--steps", str(RESUME_STEPS)], out=whole)
        train_main(base + ["--steps", str(half), "--checkpoint-dir", tmp])
        train_main(base + ["--steps", str(RESUME_STEPS), "--checkpoint-dir",
                           tmp, "--resume", "auto"], out=resumed)
        wall = time.perf_counter() - t0
    a, b = whole["state"], resumed["state"]
    loss_eq = ([float(r["loss"]) for r in whole["steps"][half:]]
               == [float(r["loss"]) for r in resumed["steps"]])
    leaves_eq = all(torch.equal(x.detach(), y.detach()) for name in
                    ("params", "mu", "nu") for x, y in zip(
                        tree_leaves(getattr(a, name)),
                        tree_leaves(getattr(b, name))))
    n = sum(p.numel() for p in tree_leaves(a.params))
    log(f"[lm_train] resume ({arch} full width, {RESUME_LAYERS} "
        f"layers, {n / 1e6:.1f} M params): {RESUME_STEPS} steps vs {half} + "
        f"--resume auto from step {resumed['start_step']}: losses "
        f"bit-equal {loss_eq}, params / moments bit-equal {leaves_eq}, step "
        f"{a.step} / {b.step}; {wall:.2f} s with the checkpoint")
    require(resumed["start_step"] == half, "lm_train resume: did not resume")
    require(loss_eq and leaves_eq and a.step == b.step == RESUME_STEPS,
            "lm_train resume: the resumed run differs")


def _train_run(dev, arch, steps, pair):
    """``repro_torch.launch.train.main`` for ``arch`` at full width,
    ``steps`` steps: the backward wrapper of ``pair`` once per layer a
    step, its forward wrapper once and again in the recompute of JAX's
    default remat, the other LM wrappers never; the dry run of its step
    beside the median step and the run's peak (``_dry_prediction``); then
    TRAIN_PROFILE_STEPS profiled steps.  Returns the run's launch
    counts."""
    import statistics

    import torch

    from repro_torch.config import KIND_TRAIN, ShapeConfig, TrainConfig
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import main as train_main
    from repro_torch.optim.adamw import tree_leaves

    cfg = get_arch(arch)
    layers = LM_TRAIN_LAYERS or cfg.num_layers
    argv = ["--arch", arch, "--steps", str(steps), "--log-every", "5"]
    if LM_TRAIN_LAYERS:
        argv += ["--num-layers", str(LM_TRAIN_LAYERS)]
    torch.cuda.empty_cache()
    out: dict = {}
    _zero_counts()
    t0 = time.perf_counter()
    rc = train_main(argv, out=out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    losses = [float(r["loss"]) for r in out["steps"]]
    ms = [r["ms"] for r in out["steps"]]
    med = statistics.median(ms[1:])
    lm = [name for _, _, names in LM_TRAIN_RUNS for name in names]
    per_step = {k: counts[k] / steps for k in lm}
    # the forward kernel runs again in the backward's recompute
    want = {k: layers * (_fwd_runs(cfg) if k == pair[0] else 1)
            if k in pair else 0 for k in lm}
    n = sum(p.numel() for p in tree_leaves(out["state"].params))
    B, S = LLAMA_TRAIN[:2]
    log(f"[lm_train] {arch} full width, {layers} of {cfg.num_layers} layers "
        f"({n / 1e9:.3f} B params, f32 params and moments, "
        f"{cfg.compute_dtype} compute, {_remat_name(cfg)}), batch "
        f"{B}x{S}: rc {rc}, {steps} "
        f"steps in {wall:.2f} s (weights drawn on the card included); step "
        f"ms median after the first {med:.2f} (first {ms[0]:.2f}, min "
        f"{min(ms[1:]):.2f}, max {max(ms[1:]):.2f}), {1e3 / med:.3f} "
        f"steps/s, {B * S * 1e3 / med:.0f} tokens/s; peak memory "
        f"{out.get('peak_bytes', 0) / 2**30:.2f} GiB; loss first "
        f"{losses[0]:.4f} last {losses[-1]:.4f}; launches a step: "
        + ", ".join(f"{k} {v:g}" for k, v in per_step.items())
        + f" (layers: {layers})")
    require(rc == 0, f"lm_train {arch}: rc {rc}")
    require(all(map(math.isfinite, losses)), f"lm_train {arch}: non-finite "
            f"loss")
    require(losses[-1] < losses[0], f"lm_train {arch}: the loss did not "
            f"fall")
    require(per_step == want, f"lm_train {arch}: launches a step "
            f"{per_step}, expected {want} ({layers} layers, "
            f"{_remat_name(cfg)})")
    cut = cfg if not LM_TRAIN_LAYERS else cfg.replace(
        num_layers=LM_TRAIN_LAYERS)
    _dry_prediction(f"{arch} ({layers} layers) train step {B} x {S}, "
                    f"median", cut, ShapeConfig("train", S, B, KIND_TRAIN),
                    TrainConfig(learning_rate=3e-4, warmup_steps=20,
                                total_steps=steps),
                    med, out["peak_bytes"] - out["base_bytes"])
    _profile_train_steps(cut, out["state"], dev, steps)
    del out
    torch.cuda.empty_cache()
    return counts


def _train_moe(dev):
    """MOE_TRAIN: ``launch/steps.make_train_step`` at full width, JAX's CLI
    defaults (lr 3e-4, 20 warmup steps, batch 8 x 256 of the token
    stream) and bf16 moments, the weights drawn on the card from seed 0
    as the train launcher draws them: step ms (median after the first),
    peak memory, the first and last losses (finite), K7 and K7b once per
    attention layer a step and K8 / K8b never; the dry run of its step
    beside the median step and the steps' peak; then two steps profiled
    (``_profile_train_steps``)."""
    import statistics

    import torch

    from repro_torch.config import KIND_TRAIN, ShapeConfig, TrainConfig
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves

    arch, layers, steps = MOE_TRAIN
    cfg = get_arch(arch).replace(num_layers=layers)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=20,
                       total_steps=steps, opt_dtype="bfloat16")
    B, S = LLAMA_TRAIN[:2]
    data = TokenStream(cfg.vocab_size, S, B, seed=0, frontend=cfg.frontend,
                       d_model=cfg.d_model,
                       frontend_tokens=cfg.frontend_tokens)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    state = adamw_init(tf.init_params(cfg, gen, device=dev), tcfg)
    n = sum(p.numel() for p in tree_leaves(state.params))
    step_fn = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, ms = [], []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.next().items()}
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    counts = _counts()
    step_peak = torch.cuda.max_memory_allocated()
    peak = max(init_peak, step_peak)
    attn, mamba = _mixer_layers(cfg)
    per_step = {k: counts[k] / steps for k in (
        "flash_attention", "flash_attention_bwd", "ssd_intra_chunk",
        "ssd_intra_chunk_bwd")}
    med = statistics.median(ms[1:])
    log(f"[lm_train] {arch} full width, {layers} of "
        f"{get_arch(arch).num_layers} layers ({n / 1e9:.3f} B params, f32 "
        f"params and grads, bf16 moments, {cfg.compute_dtype} compute), "
        f"batch {B}x{S}: weights and moments drawn in {init_s:.2f} s; "
        f"{steps} steps, step ms median after the first {med:.2f} (first "
        f"{ms[0]:.2f}, min {min(ms[1:]):.2f}, max {max(ms[1:]):.2f}), "
        f"{B * S * 1e3 / med:.0f} tokens/s; peak memory {peak / 2**30:.2f} "
        f"GiB; loss first {losses[0]:.4f} last {losses[-1]:.4f}; launches "
        f"a step: " + ", ".join(f"{k} {v:g}" for k, v in per_step.items()))
    require(all(map(math.isfinite, losses)), f"lm_train {arch}: non-finite "
            f"loss")
    fwd = _fwd_runs(cfg)
    require(per_step == {"flash_attention": fwd * attn,
                         "flash_attention_bwd": attn,
                         "ssd_intra_chunk": fwd * mamba,
                         "ssd_intra_chunk_bwd": mamba},
            f"lm_train {arch}: launches a step {per_step} "
            f"({_remat_name(cfg)})")
    _dry_prediction(f"{arch} ({layers} layer{'s' * (layers > 1)}, bf16 "
                    f"moments) train step {B} x {S}, median", cfg,
                    ShapeConfig("train", S, B, KIND_TRAIN), tcfg, med,
                    step_peak - base)
    _profile_train_steps(cfg, state, dev, steps, tcfg)
    del state, step_fn
    torch.cuda.empty_cache()


def _fwd_runs(cfg) -> int:
    """How many times a training step runs a layer's forward kernel: once,
    and again in the backward's recompute under remat."""
    return 2 if cfg.remat else 1


def _remat_name(cfg) -> str:
    return f"remat {cfg.remat_policy}" if cfg.remat else "remat off"


def _train_turn(arch, over, argv):
    """``launch.train.main`` for ``arch`` at full width with ``over``
    replacing config fields (the launcher's ``get_arch`` narrowed for
    the call) and ``argv``; (rc, its ``out``, the launch counts)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as train_mod

    cfg = get_arch(arch).replace(**over)
    out: dict = {}
    train_mod.get_arch = lambda a: cfg
    try:
        _zero_counts()
        rc = train_mod.main(["--arch", arch] + argv, out=out)
        counts = _counts()
    finally:
        train_mod.get_arch = get_arch
    return rc, out, counts


def _remat_turns(dev):
    """REMAT_STEPS steps of each REMAT_ARCHS arch under each
    REMAT_POLICIES entry: step ms (median after the first), peak, the
    forward and backward kernels' launches a step (the forward twice a
    layer under remat), the dry run's predicted peak beside the measured
    (held as phase 13's); the largest difference between the policies'
    losses and parameters' leaf sums (printed)."""
    import statistics

    import torch

    from repro_torch.config import KIND_TRAIN, ShapeConfig, TrainConfig
    from repro_torch.configs import get_arch
    from repro_torch.optim.adamw import tree_leaves

    B, S = LLAMA_TRAIN[:2]
    for arch in REMAT_ARCHS:
        pair = next(p for a, _, p in LM_TRAIN_RUNS if a == arch)
        layers = get_arch(arch).num_layers
        seen = {}
        for name, over in REMAT_POLICIES:
            torch.cuda.empty_cache()
            rc, out, counts = _train_turn(
                arch, over, ["--steps", str(REMAT_STEPS), "--log-every",
                             str(REMAT_STEPS)])
            torch.cuda.synchronize()
            cfg = get_arch(arch).replace(**over)
            ms = [r["ms"] for r in out["steps"]]
            med = statistics.median(ms[1:])
            peak = out["peak_bytes"] - out["base_bytes"]
            losses = [float(r["loss"]) for r in out["steps"]]
            sums = [float(p.double().sum())
                    for p in tree_leaves(out["state"].params)]
            per_step = {k: counts[k] / REMAT_STEPS for k in pair}
            want = {pair[0]: _fwd_runs(cfg) * layers, pair[1]: layers}
            log(f"[lm_train] remat turn {arch} ({layers} layers, "
                f"{_remat_name(cfg)}), batch {B}x{S}, {REMAT_STEPS} steps: "
                f"rc {rc}, step ms median after the first {med:.2f} (all "
                f"{' '.join(f'{x:.2f}' for x in ms)}), peak "
                f"{peak / 2**30:.3f} GiB, losses "
                f"{' '.join(f'{x:.6f}' for x in losses)}; launches a step "
                f"{per_step}")
            require(rc == 0 and all(map(math.isfinite, losses)),
                    f"lm_train remat {arch} {name}: rc {rc}, losses {losses}")
            require(per_step == want, f"lm_train remat {arch} {name}: "
                    f"launches a step {per_step}, expected {want}")
            _dry_prediction(f"{arch} ({layers} layers, {_remat_name(cfg)}) "
                            f"train step {B} x {S}, median", cfg,
                            ShapeConfig("train", S, B, KIND_TRAIN),
                            TrainConfig(learning_rate=3e-4, warmup_steps=20,
                                        total_steps=REMAT_STEPS), med, peak)
            seen[name] = (losses, sums)
            del out
        ref_l, ref_s = seen[REMAT_POLICIES[0][0]]
        for name, (losses, sums) in seen.items():
            dl = max(abs(a - b) for a, b in zip(losses, ref_l))
            ds = max(abs(a - b) for a, b in zip(sums, ref_s))
            log(f"[lm_train] remat turn {arch}: {name} vs "
                f"{REMAT_POLICIES[0][0]}: largest loss difference {dl:.3e}, "
                f"largest parameter leaf-sum difference {ds:.3e} after "
                f"{REMAT_STEPS} steps")
    torch.cuda.empty_cache()


def _train_long(dev):
    """llama3.2-3b at 8 x LONG_SEQ tokens, full width and depth, JAX's
    default remat: LONG_STEPS finite steps through ``launch.train.main``,
    K7 twice and K7b once a layer a step, the dry run's predicted peak
    beside the measured (held as phase 13's); without remat the dry run
    predicts more than the card holds (printed)."""
    import statistics

    import torch

    from repro_torch.config import KIND_TRAIN, ShapeConfig, TrainConfig
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import lower_one
    from repro_torch.launch.roofline import HBM_BYTES

    arch = LM_TRAIN_RUNS[0][0]
    cfg = get_arch(arch)
    B = LLAMA_TRAIN[0]
    shape = ShapeConfig("train", LONG_SEQ, B, KIND_TRAIN)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=20,
                       total_steps=LONG_STEPS)
    off = lower_one(cfg.replace(remat=False), shape, tcfg)["memory"]
    off_b = off["argument_bytes_per_device"] + off["temp_bytes_per_device"]
    log(f"[dryrun] {arch} train step {B} x {LONG_SEQ} without remat: "
        f"predicted peak {off_b / 2**30:.3f} GiB against the roofline's "
        f"{HBM_BYTES / 2**30:.1f} GiB card: fits {off['fits']} (not run)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc, out, counts = _train_turn(arch, {}, [
        "--steps", str(LONG_STEPS), "--seq-len", str(LONG_SEQ),
        "--log-every", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = [r["ms"] for r in out["steps"]]
    med = statistics.median(ms[1:])
    losses = [float(r["loss"]) for r in out["steps"]]
    peak = out["peak_bytes"] - out["base_bytes"]
    layers = cfg.num_layers
    per_step = {k: counts[k] / LONG_STEPS for k in (
        "flash_attention", "flash_attention_bwd")}
    log(f"[lm_train] {arch} full width, {layers} layers, "
        f"{_remat_name(cfg)}, batch {B}x{LONG_SEQ}: rc {rc}, {LONG_STEPS} "
        f"steps in {wall:.2f} s, step ms {' '.join(f'{x:.2f}' for x in ms)}"
        f" ({B * LONG_SEQ * 1e3 / med:.0f} tokens/s at the median after the "
        f"first), peak {peak / 2**30:.3f} GiB, losses "
        f"{' '.join(f'{x:.6f}' for x in losses)}; launches a step {per_step}")
    require(rc == 0 and len(losses) == LONG_STEPS
            and all(map(math.isfinite, losses)),
            f"lm_train {arch} 8 x {LONG_SEQ}: rc {rc}, losses {losses}")
    require(per_step == {"flash_attention": 2 * layers,
                         "flash_attention_bwd": layers},
            f"lm_train {arch} 8 x {LONG_SEQ}: launches a step {per_step}")
    _dry_prediction(f"{arch} ({layers} layers, {_remat_name(cfg)}) train "
                    f"step {B} x {LONG_SEQ}, median", cfg, shape, tcfg, med,
                    peak)
    del out
    torch.cuda.empty_cache()


def phase_lm_train(dev):
    """This slice's main path: ``repro_torch.launch.train.main`` at full
    width for llama3.2-3b (K7 twice and K7b once per attention layer a
    step under JAX's default remat) and mamba2-780m (K8 twice and K8b
    once per SSM layer a step); dbrx-132b's MoE training at full width and
    one layer (MOE_TRAIN); the remat turns (REMAT_POLICIES) and llama at 8
    x LONG_SEQ; then the resume check and the step parity with the CPU of
    llama, mamba and jamba, all within LM_TRAIN_DEADLINE s.  Returns the
    launches of K7b (llama's run) and K8b (mamba's run)."""
    import torch

    t0 = time.perf_counter()
    launches = {}
    for arch, steps, pair in LM_TRAIN_RUNS:
        launches[pair[1]] = _train_run(dev, arch, steps, pair)[pair[1]]
    _train_moe(dev)
    _remat_turns(dev)
    _train_long(dev)
    _train_resume(dev)
    torch.cuda.empty_cache()
    for arch, whole_step in PARITY_ARCHS:
        _train_parity(dev, arch, whole_step)
    wall = time.perf_counter() - t0
    require(wall <= LM_TRAIN_DEADLINE, f"lm_train took {wall:.1f} s > "
            f"{LM_TRAIN_DEADLINE}")
    return launches


def _start_dryrun(tmp):
    """``python -m repro_torch.launch.dryrun --all`` in a process of its
    own on the host (no card visible to it), its artifact and log in
    ``tmp``."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    with open(Path(tmp) / "dryrun.log", "w") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--out", str(Path(tmp) / "dryrun.json")],
            stdout=out, stderr=subprocess.STDOUT, env=env, cwd=tmp)


def phase_dryrun(proc, t_start, tmp):
    """The dry run of every (arch x shape) cell (``proc``, started at
    ``t_start``): one line a cell, every applicable cell ``ok`` and
    ``long_500k`` skipped on the pure-attention archs; and the roofline's
    ``HBM_BYTES`` against the card's memory."""
    import torch

    from repro_torch.config import SHAPES, shape_applicable
    from repro_torch.configs import get_arch, list_archs
    from repro_torch.launch.roofline import HBM_BYTES

    total = torch.cuda.get_device_properties(0).total_memory
    log(f"[dryrun] the card's memory {total} bytes ({total / 2**30:.3f} "
        f"GiB), HBM_BYTES {HBM_BYTES} ({HBM_BYTES / 2**30:.3f} GiB): "
        f"{100 * (total / HBM_BYTES - 1):+.2f} %")
    require(abs(total / HBM_BYTES - 1) <= 0.03,
            f"HBM_BYTES {HBM_BYTES} is not the card's {total}")
    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT
                                   - (time.perf_counter() - t_start)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SmokeFailure(f"dryrun --all ran past {DRYRUN_TIMEOUT} s")
    tail = (Path(tmp) / "dryrun.log").read_text().splitlines()[-3:]
    log(f"[dryrun] --all on the host beside the card's phases: rc {rc}, "
        f"read {time.perf_counter() - t_start:.1f} s after its start; "
        + " / ".join(tail))
    require(rc == 0, "dryrun --all failed")
    results = json.loads((Path(tmp) / "dryrun.json").read_text())
    for r in results:
        if r["status"] != "ok":
            log(f"[dryrun] {r['arch']} x {r['shape']}: {r['status']} "
                f"({r.get('reason', r.get('error'))})")
            continue
        m, rl = r["memory"], r["roofline"]
        log(f"[dryrun] {r['arch']} x {r['shape']}: fits {m['fits']}, "
            f"arguments {m['argument_bytes_per_device'] / 2**30:.2f} GiB, "
            f"temp {m['temp_bytes_per_device'] / 2**30:.2f} GiB, "
            f"{r['cost']['flops_per_device']:.4e} FLOPs, compute "
            f"{rl['compute_s']:.4e} s, memory {rl['memory_s']:.4e} s -> "
            f"{rl['dominant']} (useful FLOPs "
            f"{rl['useful_flop_ratio']:.3f}); meta run {r['lower_s']} s")
    want = {(a, sh): "ok" if shape_applicable(get_arch(a), SHAPES[sh])[0]
            else "skipped" for a in list_archs() for sh in SHAPES}
    got = {(r["arch"], r["shape"]): r["status"] for r in results}
    require(got == want, f"dryrun --all: cells {got}, expected {want}")


def phase_lint():
    """``python -m repro_torch.analysis.lint --check-baseline`` on the tree
    this script runs from (no card needed): exit 0, the findings equal to
    the checked-in baseline."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint",
         "--check-baseline"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=LINT_TIMEOUT)
    for line in proc.stdout.splitlines():
        log(f"[lint] {line}")
    log(f"[lint] rc {proc.returncode} in {time.perf_counter() - t0:.2f} s")
    require(proc.returncode == 0,
            "lint --check-baseline failed: a new or stale finding")


def _finite(text):
    return math.isfinite(float(text))


def _check_quickstart(out):
    require(out[0].startswith("== nw: ") and out[0].endswith(
        " kernel invocations =="), f"quickstart: {out[0]!r}")
    head = out.index("method         clusters  reps  error %  speedup")
    rows = [line.split() for line in out[head + 1:]]
    require([r[0] for r in rows] == ["GCL-Sampler", "PKA", "Sieve",
                                     "STEM+ROOT"], f"quickstart rows {rows}")
    for r in rows:
        require(_finite(r[-2]) and _finite(r[-1].rstrip("x")),
                f"quickstart: error / speedup not finite in {r}")


def _check_sampled_simulation(out):
    text = "\n".join(out)
    err = re.search(r"\(err (\S+)%\)", text)
    sp = re.search(r"kernel-time speedup \(eq.6\): (\S+)x", text)
    require(re.search(r"^clusters: \d+  reps: \d+$", text, re.M)
            and err and _finite(err.group(1)) and sp
            and _finite(sp.group(1)), "sampled_simulation: " + text)


def _check_train_sampler(out):
    m = re.match(r"K=\d+ \(silhouette mode: \S+\) -> error (\S+)%, "
                 r"speedup (\S+)x$", out[-1])
    require(m and _finite(m.group(1)) and _finite(m.group(2))
            and any(line.startswith("training done in") for line in out),
            f"train_sampler: {out[-3:]}")


def _check_serve_lm(out):
    require(len(out) == 2 and all(
        line.startswith(f"[serve] batch {i}: prefill 64 toks x4")
        for i, line in enumerate(out)), f"serve_lm: {out}")


def _check_lm_pretrain(out):
    losses = [float(m.group(1)) for m in
              (re.search(r"loss=(\S+)", line) for line in out) if m]
    require(len(losses) == 16 and all(map(math.isfinite, losses))
            and out[-1].startswith("[train] done: 300 steps"),
            f"lm_pretrain: {out[-2:]}")


#: (twin, argv beyond its defaults, hand kernels it must launch, check):
#: the twins run at their defaults, their output paths in a fresh directory
#: so nothing replays
FIT_KERNELS = ("rgcn_fused_flat", "rgcn_fused_bwd", "rgcn_spmm_flat",
               "kmeans_assign_fused_batched", "silhouette_sums")
EXAMPLE_RUNS = (
    ("quickstart", lambda tmp: ["--out", str(Path(tmp) / "quickstart")],
     FIT_KERNELS, _check_quickstart),
    ("sampled_simulation", lambda tmp: [], FIT_KERNELS,
     _check_sampled_simulation),
    ("train_sampler", lambda tmp: [], FIT_KERNELS, _check_train_sampler),
    ("serve_lm", lambda tmp: [], ("ssd_intra_chunk",), _check_serve_lm),
    ("lm_pretrain", lambda tmp: ["--checkpoint-dir", str(Path(tmp) / "ck")],
     ("flash_attention", "flash_attention_bwd"), _check_lm_pretrain),
)


def phase_examples(dev):
    """The five twins ``examples/*_torch.py`` in this process through their
    ``main(argv)`` on the card: exit 0, the lines their originals print
    (finite error and speedup), each hand kernel of the twin's path
    launched (the wrappers' counts, zeroed before each twin), and the
    twin's wall time."""
    import contextlib
    import importlib.util
    import io

    import torch

    for name, extra, kernels, check in EXAMPLE_RUNS:
        path = ROOT / "examples" / f"{name}_torch.py"
        spec = importlib.util.spec_from_file_location(f"_twin_{name}", path)
        twin = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(twin)
        with tempfile.TemporaryDirectory() as tmp:
            argv = extra(tmp)
            buf = io.StringIO()
            torch.cuda.synchronize(dev)
            _zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = twin.main(argv)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            counts = _counts()
        out = buf.getvalue().splitlines()
        for line in out:
            log(f"[examples]   {line}")
        launched = {k: counts[k] for k in kernels}
        log(f"[examples] {name}_torch.main({argv}): rc {rc}, wall "
            f"{wall:.2f} s, launches {launched}")
        require(rc == 0, f"examples: {name} exited {rc}")
        check([line for line in out if line.strip()])
        for k, n in launched.items():
            require(n > 0, f"examples: {name} never launched {k}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir() or not FIXTURE.exists() \
            or not GRID_FIXTURE.exists() or not LM_FIXTURE.exists():
        print("chip_smoke: src/repro_torch (and its reference fixture) must "
              "sit beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.utils.device import resolve_device

    dev = resolve_device("cuda")              # TF32 off, device bound
    t_all = time.perf_counter()
    smi_line = phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        proc = _start_dryrun(tmp)
        try:
            table = _phases(dev, t_all, (proc, time.perf_counter(), tmp),
                            smi_line)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    print(json.dumps(table))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _phases(dev, t_all, dry, smi_line):
    """Every phase after ``device``, in order; the kernel table."""
    t0 = time.perf_counter()
    phase_build()
    log(f"[phase] build {time.perf_counter() - t0:.2f} s")
    rows: list = []
    t0 = time.perf_counter()
    phase_kernels(rows, dev)
    phase_k4(rows, dev)
    phase_lm_kernels(rows, dev)
    log(f"[phase] kernels {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_reference(dev)
    log(f"[phase] reference {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    dense = phase_dense(dev)
    log(f"[phase] dense {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_serve(rows, dev)
    log(f"[phase] serve {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_sweep_batch(dev)
    log(f"[phase] sweep_batch {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_plan_serve(dev)
    log(f"[phase] plan_serve {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_fault(dev)
    log(f"[phase] fault {time.perf_counter() - t0:.2f} s")
    for name, phase in (("train", phase_train), ("resume", phase_resume),
                        ("fit", phase_fit)):
        t0 = time.perf_counter()
        phase(dev)
        log(f"[phase] {name} {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_staging(dev, smi_line)
    log(f"[phase] staging {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_data_parallel(dev, smi_line)
    log(f"[phase] data_parallel {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_model_parallel(rows, dev, smi_line)
    log(f"[phase] model_parallel {time.perf_counter() - t0:.2f} s")
    phase_model_split(rows, dev, smi_line)
    t0 = time.perf_counter()
    phase_model_serve(rows, dev, smi_line)
    log(f"[phase] model_serve 8e {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_fit_serve([r for r in rows if r[0] not in (
        "kmeans_assign", "rgcn_spmm_dense", "flash_attention",
        "flash_attention_bwd", "ssd_intra_chunk", "ssd_intra_chunk_bwd")],
        dev)
    log(f"[phase] fit+serve {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sequential = phase_sequential(dev)
    log(f"[phase] sequential {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches = phase_grid(dev)
    log(f"[phase] grid {time.perf_counter() - t0:.2f} s")
    launches["kmeans_assign"] = sequential["kmeans_assign"]
    launches["rgcn_spmm_dense"] = dense["rgcn_spmm_dense"]
    t0 = time.perf_counter()
    phase_lm_reference(dev)
    log(f"[phase] lm_reference {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    lm = phase_lm_serve(dev)
    log(f"[phase] lm_serve {time.perf_counter() - t0:.2f} s")
    for name in ("flash_attention", "ssd_intra_chunk"):
        launches[name] = lm[name]
    t0 = time.perf_counter()
    launches.update(phase_lm_train(dev))
    log(f"[phase] lm_train {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_dryrun(*dry)
    log(f"[phase] dryrun {time.perf_counter() - t0:.2f} s (waiting included)")
    t0 = time.perf_counter()
    phase_lint()
    log(f"[phase] lint {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_examples(dev)
    log(f"[phase] examples {time.perf_counter() - t0:.2f} s")
    log(f"[phase] total {time.perf_counter() - t_all:.2f} s")
    table = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": repl,
         "launches": launches[name], "max_abs_err": m["err"], "ms": m["ms"],
         "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
         "bound_by": m["bound_by"], "library_ms": m["library_ms"],
         **{k: m[k] for k in ("launches_counted", "fma_bound_ms", "d64_ms",
                              "d64_bound_ms", "b8_ms", "b8_solo_ms",
                              "b8_plain_ms", "b8_library_ms",
                              "b8_bound_ms", "b8_bound_by",
                              "b8_max_abs_err") + TP_KEYS if k in m}}
        for name, source, repl, _, m in rows]}
    return table


if __name__ == "__main__":
    sys.exit(main())
