"""Host and device time of one LM training step under each remat policy,
on the card: where ``remat_policy="dots"`` spends what ``"full"`` does not.

    python3 scripts/remat_trace.py [--arch llama3.2-3b mamba2-780m]
        [--steps 3] [--device cuda] [--smoke] [--out PATH]

For each arch at full width and depth (8 x 256 tokens, JAX's CLI
defaults for the optimizer), from one seed and one batch, runs the train
step of ``launch/steps.py`` under four modes: remat off, ``"full"``,
``"dots"`` and ``"dots_none"`` (the selective checkpoint of ``"dots"``
whose policy saves nothing: full remat's work, through the selective
checkpoint's dispatch mode).  Per mode, after two warm-up steps:

- ``step_ms``: the median wall time of ``--steps`` steps, the card
  waited on after each;
- ``host_ms``: the median time until the step call returns to the host,
  the card not waited on (the step reads nothing back), so the host's
  share of a step is ``host_ms / step_ms``;
- one step under ``torch.profiler``: ``device_ms`` (the sum of its CUDA
  kernels' times: one stream, so the card's busy time), ``kernels`` and
  ``aten_ops`` (the number of CUDA kernels and of ``aten::`` host
  events), ``dispatch_mode_ms`` (the self time of the selective
  checkpoint's ``PythonDispatchMode`` records: its Python
  ``__torch_dispatch__`` around every aten op of the checkpointed
  forward and recompute) and the host ops with the most self time;
- ``policy_calls`` / ``policy_ms``: the calls of the selective
  checkpoint's policy in one step and the host time spent in it.

Every mode's loss after its steps is printed beside the others (the
recompute re-runs the same kernels: they agree bit for bit).  Prints the
card's name and power limit (``nvidia-smi``) and one JSON line, also
written to ``--out`` where given.  ``--device cpu --smoke``
runs the smoke widths on the CPU (a rehearsal, not a measurement).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

#: mode -> (the config's remat fields, whether the policy saves nothing)
MODES = {"off": ({"remat": False}, False),
         "full": ({"remat": True, "remat_policy": "full"}, False),
         "dots": ({"remat": True, "remat_policy": "dots"}, False),
         "dots_none": ({"remat": True, "remat_policy": "dots"}, True)}
BATCH, SEQ, SEED = 8, 256, 0


def _card_line(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Policy:
    """The ``dots`` policy wrapped to count its calls and their host time;
    with ``none`` every op is recomputed (nothing saved)."""

    def __init__(self, policy, none: bool):
        self.policy, self.none = policy, none
        self.calls, self.seconds = 0, 0.0

    def __call__(self, ctx, op, *args, **kwargs):
        from torch.utils.checkpoint import CheckpointPolicy

        t = time.perf_counter()
        out = (CheckpointPolicy.PREFER_RECOMPUTE if self.none
               else self.policy(ctx, op, *args, **kwargs))
        self.seconds += time.perf_counter() - t
        self.calls += 1
        return out


def _profile(step, state, batch, dev) -> tuple:
    """One step under torch.profiler: (its state, device ms, kernels, aten
    host events, the dispatch mode's self ms, the 8 host ops with the
    most self time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        state, m = step(state, batch)
        _sync(dev)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.time_range.elapsed_us() for e in kernels)
    aten = sum(1 for e in events if e.device_type == DeviceType.CPU
               and e.name.startswith("aten::"))
    host = [(e.key, e.self_cpu_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    mode_ms = sum(ms for key, ms, _ in host if key == "PythonDispatchMode")
    del m
    return (state, device_us / 1e3, len(kernels), aten, mode_ms,
            sorted(host, key=lambda r: -r[1])[:8])


def _run(arch: str, mode: str, args, dev) -> dict:
    import torch

    from repro_torch.config import TrainConfig
    from repro_torch.configs import get_arch, smoke_arch
    from repro_torch.data import TokenStream
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init

    over, none = MODES[mode]
    cfg = (smoke_arch if args.smoke else get_arch)(arch).replace(**over)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=20,
                       total_steps=args.steps + 3, seed=SEED)
    data = TokenStream(cfg.vocab_size, SEQ, BATCH, seed=SEED,
                       frontend=cfg.frontend, d_model=cfg.d_model,
                       frontend_tokens=cfg.frontend_tokens)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.next().items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = adamw_init(tf.init_params(cfg, gen, device=dev), tcfg)
    step = steps_mod.make_train_step(cfg, tcfg)
    policy = _Policy(tf._dots_policy, none)
    saved, tf._dots_policy = tf._dots_policy, policy
    try:
        for _ in range(2):
            state, m = step(state, batch)
        _sync(dev)
        wall, host = [], []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            t1 = time.perf_counter()
            _sync(dev)
            wall.append((time.perf_counter() - t0) * 1e3)
            host.append((t1 - t0) * 1e3)
        loss = float(m["loss"])
        policy.calls, policy.seconds = 0, 0.0
        state, device_ms, kernels, aten, mode_ms, top = _profile(
            step, state, batch, dev)
    finally:
        tf._dots_policy = saved
    del state, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"arch": arch, "mode": mode, "layers": cfg.num_layers,
            "step_ms": statistics.median(wall), "host_ms":
            statistics.median(host), "wall_all": wall, "host_all": host,
            "device_ms": device_ms, "kernels": kernels, "aten_ops": aten,
            "dispatch_mode_ms": mode_ms,
            "policy_calls": policy.calls, "policy_ms": policy.seconds * 1e3,
            "loss": loss, "top_host_ops": top}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+",
                    default=["llama3.2-3b", "mamba2-780m"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke widths (a CPU rehearsal)")
    ap.add_argument("--out", help="a file for the JSON line")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("remat_trace: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    card = _card_line(dev)
    print(f"[remat_trace] card: {card}", flush=True)
    runs = []
    for arch in args.arch:
        for mode in MODES:
            r = _run(arch, mode, args, dev)
            runs.append(r)
            print(f"[remat_trace] {arch} {mode}: step {r['step_ms']:.3f} ms "
                  f"(host {r['host_ms']:.3f}), device {r['device_ms']:.3f} "
                  f"ms in {r['kernels']} kernels, {r['aten_ops']} aten ops, "
                  f"dispatch mode {r['dispatch_mode_ms']:.3f} ms, "
                  f"policy {r['policy_calls']} calls {r['policy_ms']:.3f} "
                  f"ms, loss {r['loss']!r}", flush=True)
            for key, ms, n in r["top_host_ops"]:
                print(f"[remat_trace]     {key}: {ms:.3f} ms self, {n} "
                      f"calls", flush=True)
    line = json.dumps({"card": card, "batch": BATCH, "seq": SEQ,
                       "runs": runs})
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
