"""Training launcher (counterpart of ``repro/launch/train.py``):

    python -m repro_torch.launch.train --arch llama3.2-3b --steps 100
    python -m repro_torch.launch.train --arch mamba2-780m --smoke --device cpu \\
        --checkpoint-dir /tmp/ck --resume auto

JAX's flags, plus ``--device`` (``cuda`` unless ``cpu`` is given) and
``--num-layers`` (cut the depth; the width stays the arch's).  A
deterministic token stream (``data.TokenStream``, skipped to the resumed
step), the train step of ``launch/steps.py`` with gradient accumulation
(``--microbatch``) and int8 error-feedback compression
(``--grad-compress``), atomic asynchronous checkpoints every
``--checkpoint-every`` steps and at the end, ``--resume auto`` (or a step
number), a straggler watchdog and a heartbeat file, and one ``[train]
step ... loss= gnorm= lr= ...ms`` line every ``--log-every`` steps.  The
initial weights are drawn from ``--seed`` by a ``torch.Generator`` on the
device.  On the card, attention layers run K7 forward and K7b backward,
SSM layers K8 forward and K8b backward; MoE layers run in torch ops
(``models/moe.py``), their dispatch and combine backwards fixed-order
gathers.

``--mesh debug`` (the default) trains on one device.  ``--mesh pod`` and
``--mesh multipod`` train JAX's (16, 16) / (2, 16, 16) mesh over the
ranks of the ``torch.distributed`` group the process has joined (through
``distributed/group.init_group``, or the default group under
``torchrun``), which must have 256 / 512 ranks; a Python caller passes
any mesh of ranks as ``main(argv, mesh=)`` (e.g.
``launch/mesh.make_debug_mesh(2, 2, group=)``).  On a mesh every rank
draws the whole weights from the seed, keeps its blocks
(``distributed/model_parallel.py``), reads its rows of each batch and
runs ``steps.make_sharded_train_step`` (``--microbatch`` n: its rows of
each of JAX's n micro-batches, accumulated as on one card); checkpoints
are saved whole by
mesh rank 0 and restored onto any mesh, and only mesh rank 0 prints.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import MeshConfig, TrainConfig
from repro_torch.configs import get_arch, smoke_arch
from repro_torch.data import TokenStream
from repro_torch.distributed.fault import Heartbeat, Watchdog
from repro_torch.distributed.model_parallel import Sharding
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh, make_rules
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_leaves
from repro_torch.utils.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_group(args, mesh):
    """The ``Group`` a mesh run is laid over, and the mesh."""
    import torch.distributed as dist

    from repro_torch.distributed.group import Group

    if not dist.is_initialized():
        mc = MeshConfig(multi_pod=args.mesh == "multipod")
        shape = mesh.shape if mesh is not None else mc.shape
        n = mesh.size if mesh is not None else mc.num_devices
        raise ValueError(
            f"--mesh {args.mesh}: a {tuple(shape)} mesh needs a "
            f"torch.distributed group of {n} ranks (join one with "
            f"distributed.group.init_group, or run under torchrun); this "
            f"process has none")
    group = Group()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=args.mesh == "multipod",
                                    group=group)
    return group, mesh


def state_bytes(state) -> int:
    """Bytes of a ``TrainState``'s tensors (params, moments, residual)."""
    return sum(t.numel() * t.element_size()
               for tree in (state.params, state.mu, state.nu,
                            state.compress_err or {})
               for t in tree_leaves(tree))


def main(argv=None, out: dict | None = None, mesh=None) -> int:
    """Train and print the ``[train]`` lines.  ``out``, when given,
    receives ``"steps"`` (one dict a step: step, loss (a 0-d tensor on the
    device), ms), ``"state"`` (the final ``TrainState``: on a mesh, this
    rank's blocks), ``"start_step"``, ``"state_bytes"`` and, on a mesh,
    ``"collective_bytes"`` (what one step carried on this rank: its
    last), ``"info"`` (the step's) and ``"plan"``, and, on the card,
    ``"peak_bytes"`` and ``"base_bytes"`` (what was allocated before the
    weights were drawn).  ``mesh`` (a mesh of ranks of the process's
    ``torch.distributed`` group) runs that mesh."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--mesh", choices=["debug", "pod", "multipod"],
                    default="debug")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", default=None, help="'auto' or a step number")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    sharded = mesh is not None or args.mesh != "debug"
    if sharded:
        group, mesh = _mesh_group(args, mesh)
    cfg = smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    if args.num_layers is not None:
        cfg = cfg.replace(num_layers=args.num_layers)
    tcfg = TrainConfig(
        learning_rate=args.lr, warmup_steps=args.warmup,
        total_steps=args.steps, microbatch=args.microbatch,
        grad_compress=args.grad_compress, seed=args.seed,
    )
    data = TokenStream(
        cfg.vocab_size, args.seq_len, args.batch, seed=args.seed,
        frontend=cfg.frontend, d_model=cfg.d_model,
        frontend_tokens=cfg.frontend_tokens,
    )

    if sharded:
        step_fn = steps_mod.make_sharded_train_step(
            cfg, tcfg, make_rules(mesh, multi_pod=args.mesh == "multipod"),
            group)
        plan, groups = step_fn.plan, step_fn.groups
        sharding = Sharding(plan, groups, dev)
        index = groups.index
    else:
        step_fn, sharding, index = (steps_mod.make_train_step(cfg, tcfg),
                                    None, 0)
    say = index == 0
    ckpt = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir else None
    watchdog = Watchdog(
        on_straggler=lambda t: print(f"[watchdog] step exceeded {t:.1f}s SLO "
                                     f"(straggler suspected)", flush=True)
    )
    hb_name = (f"repro_torch_heartbeat_{args.seed}.json" if not sharded else
               f"repro_torch_heartbeat_{args.seed}_rank{index}.json")
    hb = Heartbeat(os.path.join(tempfile.gettempdir(), hb_name))
    hb.start()

    state, start_step = None, 0
    if ckpt and args.resume:
        step_arg = None if args.resume == "auto" else int(args.resume)
        like = steps_mod.train_state_specs(cfg, tcfg)
        try:
            state, start_step = ckpt.restore(like, step=step_arg, device=dev,
                                             sharding=sharding)
            data.skip(start_step)
            if say:
                print(f"[train] resumed from step {start_step}", flush=True)
        except FileNotFoundError:
            state = None
    if state is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = tf.init_params(cfg, gen, device=dev)
        if sharded:
            params = plan.shard(params, index)   # the whole tree is dropped
        state = adamw_init(params, tcfg)
        del params
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    records, step_bytes = [], None

    t_start = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.next().items()}
        if sharded:
            batch = plan.local_batch(batch, index, tcfg.microbatch)
            carried = groups.bytes
        watchdog.step_start()
        state, metrics = step_fn(state, batch)
        _sync(dev)  # the watchdog's SLO timing needs the step's completion
        dt = watchdog.step_end()
        hb.update(step)
        if sharded:
            step_bytes = groups.bytes - carried
        records.append({"step": step, "loss": metrics["loss"],
                        "ms": dt * 1e3})
        if say and (step % args.log_every == 0 or step == args.steps - 1):
            # lint: allow[R1] CLI reporting, once a log_every steps
            m = {k: float(v) for k, v in metrics.items()}
            print(
                f"[train] step {step:5d} loss={m['loss']:.4f} "
                f"gnorm={m.get('grad_norm', 0):.2f} lr={m.get('lr', 0):.2e} "
                f"{dt * 1e3:.0f}ms", flush=True,
            )
        if ckpt and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, state, sharding=sharding)
    if ckpt:
        ckpt.save(args.steps, state, sharding=sharding)
        ckpt.wait()
    hb.stop()
    total = time.time() - t_start
    if say:
        print(f"[train] done: {args.steps - start_step} steps in "
              f"{total:.1f}s ({watchdog.fired} watchdog events)", flush=True)
    if out is not None:
        out.update(steps=records, state=state, start_step=start_step,
                   state_bytes=state_bytes(state))
        if sharded:
            out.update(collective_bytes=step_bytes, info=step_fn.info,
                       plan=plan)
        if dev.type == "cuda":
            out.update(peak_bytes=torch.cuda.max_memory_allocated(dev),
                       base_bytes=base)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
