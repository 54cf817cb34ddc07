"""One-card dry run (counterpart of ``repro/launch/dryrun.py``).

For every (architecture x input-shape) cell, run the port's own step
(``launch/steps.py``: train, prefill or decode) once on ``meta`` tensors —
no storage is allocated and no card is needed — and record what it would
move and hold on one H100 into a JSON artifact that ``launch/roofline.py``
reads:

- ``cost.flops_per_device``: the aten matmuls by ``torch.utils.
  flop_counter``'s formulas (2mnk), plus each hand kernel by its own
  operation count (``kernels.tally``: K7, K7b, K8, K8b on ``meta``), with
  ``cost.flops_by_dtype`` beside it (the roofline's compute term runs each
  dtype at its own peak);
- ``cost.bytes_per_device``: the input and output bytes of every aten op
  that moves data (views and ``empty`` move none), plus each hand kernel's
  bytes — the counterpart of XLA's "bytes accessed";
- ``memory``: the argument bytes (params, optimizer state, batch, decode
  state), the output bytes (outputs that are not arguments: the train
  step updates its state in place), the temp bytes — the peak of the bytes
  of storages allocated during the step and live at once, counted by
  storage (views share one; autograd's saved tensors live until the
  backward frees them; the step's outputs among them) — and ``fits``,
  argument plus temp bytes against ``HBM_BYTES``;
- ``model_flops``, ``params_total`` and ``params_active`` from
  ``config.py``, and ``roofline`` (``launch/roofline.roofline_terms``).

JAX's scan correction has no counterpart: XLA's cost analysis counts a
``lax.scan`` body once, while an eager ``meta`` run executes every layer.
A training step runs under its config's remat (JAX's default: every
block rematerialised): the temp bytes are the checkpointed step's, and
the FLOPs and bytes count the recompute (K7 / K8 tallied twice a layer),
as XLA's cost analysis of the rematerialised program does.
Nothing is compiled (``compile_s`` and ``code_bytes`` are null), and the
default mesh is the one card (``num_devices`` 1, no collective bytes).

``lower_cell(..., pod=True)`` and ``lower_cell(..., multi_pod=True)``
record a cell on JAX's (16, 16) / (2, 16, 16) production mesh
(``--both-meshes`` / ``--multi-pod``) without running a step: the
per-device parameter bytes from the param specs (``memory``:
``params_per_device``, ``params_bytes_per_device``; a train cell's f32
params and ``optimizer_bytes_per_device``, a prefill or decode cell's
compute params, no optimizer, and its batch rows and decode-state
blocks by JAX's batch and decode-state specs, ``batch_bytes_per_device``
/ ``decode_state_bytes_per_device``, all in
``argument_bytes_per_device``), and the collective bytes a device
carries in one step (``collectives``, ``launch/roofline.
collective_bytes``: gathers, gradient sums, tensor-parallel sums and the
step's scalars; serving's split softmax, SSM state gathers and greedy
token), whose NVLink time is the roofline's collective term.  Their
FLOPs and HBM bytes are not counted (``cost`` None).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out mesh.json
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time
import traceback
from collections import defaultdict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.config import (
    KIND_DECODE, KIND_PREFILL, KIND_TRAIN, SHAPES, ModelConfig, ShapeConfig,
    TrainConfig,
    model_flops, param_counts, shape_applicable,
)
from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (
    MULTIPOD_SHAPE, POD_AXES, POD_SHAPE, make_production_mesh, make_rules,
    rank_mesh,
)
from repro_torch.launch.roofline import (
    HBM_BYTES, collective_bytes, roofline_terms,
)
from repro_torch.models import transformer as tf
from repro_torch.models.specs import batch_specs, decode_state_specs
from repro_torch.optim.adamw import tree_leaves

LARGE_ARCH_PARAMS = 30e9  # bf16 optimizer moments above this (HBM fit)

aten = torch.ops.aten
#: ops that allocate and write nothing
_NO_TRAFFIC = frozenset({aten.empty.memory_format, aten.empty_like.default,
                         aten.empty_strided.default, aten.new_empty.default,
                         aten.new_empty_strided.default})
#: ops that overwrite their first argument without reading it
_WRITE_ONLY = frozenset({aten.copy_.default, aten.fill_.Scalar,
                         aten.fill_.Tensor, aten.zero_.default})


def _train_config(cfg) -> TrainConfig:
    n = param_counts(cfg)["total"]
    return TrainConfig(opt_dtype="bfloat16" if n > LARGE_ARCH_PARAMS else "float32")


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class StepCounter(TorchDispatchMode):
    """Counts the work and the memory of the aten ops run under it on
    ``meta`` tensors, and the hand kernels that ``kernels.tally`` reports.

    Memory is counted by storage: a storage an op returns that is not one
    of ``arguments``' is held from that op until its last reference dies
    (checked with a weak reference to the storage, so views, autograd's
    saved tensors and in-place updates count as what they are).  Frees are
    found lazily: only when the bytes held could exceed the peak are the
    dead storages swept out, which gives the exact peak."""

    def __init__(self, arguments):
        super().__init__()
        self._args = {_key(t) for t in arguments}
        self._live: dict = {}      # storage key -> (weak ref, bytes)
        self._held = 0             # bytes of _live, dead ones until swept
        self.peak = 0
        self.flops: dict = defaultdict(float)       # dtype -> operations
        self.bytes = 0.0
        self.kernels: dict = {}    # name -> {"calls", "flops", "bytes"}

    def kernel(self, name, ops, bytes_, dtype):
        """One hand-kernel call (``kernels.tally``)."""
        self.flops[dtype] += ops
        self.bytes += bytes_
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += ops
        k["bytes"] += bytes_

    def _hold(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self._args or key in self._live:
            return
        nb = s.nbytes()
        self._live[key] = (StorageWeakRef(s), nb)
        self._held += nb
        if self._held > self.peak:
            self._live = {k: e for k, e in self._live.items()
                          if not e[0].expired()}
            self._held = sum(nb for _, nb in self._live.values())
            self.peak = max(self.peak, self._held)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _meta_leaves((*args, *kwargs.values()))
        outs = _meta_leaves(out if isinstance(out, (list, tuple)) else (out,))
        if not outs:
            return out
        count = flop_registry.get(func.overloadpacket)
        if count is not None and ins:
            dt = str(ins[0].dtype).removeprefix("torch.")
            self.flops[dt] += count(*args, **kwargs, out_val=out)
        in_keys = {_key(t) for t in ins}
        moves = func._schema.is_mutable or any(
            _key(t) not in in_keys for t in outs)
        if moves and func not in _NO_TRAFFIC:
            read = ins[1:] if func in _WRITE_ONLY else ins
            self.bytes += sum(min(t.nbytes, t.untyped_storage().nbytes())
                              for t in read)
            self.bytes += sum(t.nbytes for t in outs)
        for t in outs:
            self._hold(t)
        return out


def _meta_leaves(xs) -> list:
    """The ``meta`` tensors among ``xs`` and the lists in it (an aten op's
    arguments or results nest no deeper)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            if x.device.type == "meta":
                out.append(x)
        elif isinstance(x, (list, tuple)):
            out += [y for y in x if isinstance(y, torch.Tensor)
                    and y.device.type == "meta"]
    return out


def _nbytes(tensors) -> int:
    """Bytes of the distinct storages of ``tensors``."""
    seen = {}
    for t in tensors:
        seen[_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


def _meta_tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor) and t.device.type == "meta"]


def _step(cfg: ModelConfig, shape: ShapeConfig, tcfg: TrainConfig):
    """(the step as a thunk, its meta arguments)."""
    batch = batch_specs(cfg, shape)
    if shape.kind == KIND_TRAIN:
        state = steps_mod.train_state_specs(cfg, tcfg)
        step = steps_mod.make_train_step(cfg, tcfg)
        args = [x for tree in (state.params, state.mu, state.nu,
                               state.compress_err or {}, batch)
                for x in tree_leaves(tree)]
        return (lambda: step(state, batch)), args
    params = tf.init_compute_params(cfg, None, device="meta")
    if shape.kind == KIND_PREFILL:
        step = steps_mod.make_prefill_step(cfg)
        return (lambda: step(params, batch)), _meta_tensors((params, batch))
    dstate = decode_state_specs(cfg, shape)
    step = steps_mod.make_decode_step(cfg)
    return ((lambda: step(params, dstate, batch)),
            _meta_tensors((params, dstate, batch)))


def lower_one(cfg: ModelConfig, shape: ShapeConfig,
              tcfg: TrainConfig | None = None) -> dict:
    """Run one step of ``cfg`` at ``shape`` on ``meta`` tensors under a
    ``StepCounter``; the record (JAX's keys) of the cell."""
    tcfg = tcfg or _train_config(cfg)
    t0 = time.time()
    thunk, args = _step(cfg, shape, tcfg)
    arg_bytes = _nbytes(args)
    counter = StepCounter(args)
    with counter:
        out = thunk()
    arg_keys = {_key(t) for t in args}
    out_bytes = _nbytes(t for t in _meta_tensors(out)
                        if _key(t) not in arg_keys)
    del out, thunk
    t_lower = round(time.time() - t0, 1)
    flops = sum(counter.flops.values())
    counts = param_counts(cfg)
    rec = {
        "arch": cfg.arch_id,
        "shape": shape.name,
        "multi_pod": False,
        "status": "ok",
        "num_devices": make_production_mesh().size,
        "lower_s": t_lower,
        "compile_s": None,
        "memory": {
            "argument_bytes_per_device": arg_bytes,
            "output_bytes_per_device": out_bytes,
            "temp_bytes_per_device": counter.peak,
            "code_bytes": None,
            "fits": arg_bytes + counter.peak <= HBM_BYTES,
        },
        "cost_scanned": {"flops": flops, "bytes": counter.bytes, "coll": 0},
        "cost": {
            "flops_per_device": flops,
            "bytes_per_device": counter.bytes,
            "flops_by_dtype": dict(counter.flops),
            "kernels": counter.kernels,
        },
        "collectives": {"per_device_bytes": 0, "by_kind_bytes": {},
                        "op_counts": {}},
        "model_flops": model_flops(cfg, shape),
        "params_total": counts["total"],
        "params_active": counts["active"],
    }
    rec["roofline"] = roofline_terms(rec)
    return rec


def lower_mesh(cfg: ModelConfig, shape: ShapeConfig, *,
               multi_pod: bool = False,
               tcfg: TrainConfig | None = None, rules_kw=None) -> dict:
    """The record of a cell on JAX's production mesh, from the specs
    alone: per-device params and optimizer bytes (train) or params, batch
    rows and decode state (prefill, decode), and the collective bytes of
    one step.  ``rules_kw`` replaces ``MeshRules`` fields (JAX's
    ``make_rules(**rules_kw)``: ``fsdp``, the model-axis preferences;
    ``seq_shard`` raises).  Nothing is lowered and no card is needed."""
    from repro_torch.distributed.model_parallel import ShardPlan

    tcfg = tcfg or _train_config(cfg)
    t0 = time.time()
    mesh = (rank_mesh(MULTIPOD_SHAPE, POD_AXES) if multi_pod
            else rank_mesh(POD_SHAPE))
    rules = make_rules(mesh, multi_pod=multi_pod, **(rules_kw or {}))
    plan = ShardPlan(cfg, rules)
    n = plan.block_numel()
    coll = collective_bytes(cfg, shape, rules, tcfg)
    counts = param_counts(cfg)
    if shape.kind == KIND_TRAIN:
        pz = torch.empty((), dtype=plan.param_dtype).element_size()
        oz = torch.empty((), dtype=getattr(torch, tcfg.opt_dtype)
                         ).element_size()
        params = n * pz
        opt = n * (2 * oz + (4 if tcfg.grad_compress else 0))
        serve = {}
    else:
        params, opt = plan.serve_param_bytes(), 0
        rows = plan.serve_batch(batch_specs(cfg, shape), 0)
        serve = {"batch_bytes_per_device": sum(
                     t.numel() * t.element_size() for t in rows.values()),
                 "decode_state_bytes_per_device": (
                     plan.state_bytes(shape.global_batch, shape.seq_len)
                     if shape.kind == KIND_DECODE else 0)}
    rec = {
        "arch": cfg.arch_id,
        "shape": shape.name,
        "multi_pod": multi_pod,
        "status": "ok",
        "num_devices": mesh.size,
        "lower_s": round(time.time() - t0, 1),
        "compile_s": None,
        "memory": {
            "argument_bytes_per_device": params + opt + sum(serve.values()),
            "output_bytes_per_device": None,
            "temp_bytes_per_device": None,
            "code_bytes": None,
            "fits": None,
            "params_per_device": n,
            "params_bytes_per_device": params,
            "optimizer_bytes_per_device": opt,
            **serve,
        },
        "cost_scanned": {"flops": None, "bytes": None,
                         "coll": coll["total"]},
        "cost": {"flops_per_device": None, "bytes_per_device": None},
        "collectives": {"per_device_bytes": coll["total"],
                        "by_kind_bytes": {k: v for k, v in coll.items()
                                          if k != "total"},
                        "op_counts": {}},
        "model_flops": model_flops(cfg, shape),
        "params_total": counts["total"],
        "params_active": counts["active"],
    }
    rec["roofline"] = roofline_terms(rec)
    return rec


def lower_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
               pod: bool = False, rules_kw=None, cfg_kw=None):
    """The record of one (arch, shape) cell on the one card or, with
    ``pod`` / ``multi_pod``, on JAX's (16, 16) / (2, 16, 16) mesh of
    ranks under ``make_rules(**rules_kw)``; ``cfg_kw`` replaces config
    fields (``num_layers`` cuts the depth, ``remat`` / ``remat_policy``
    set the training step's rematerialisation)."""
    cfg = get_arch(arch_id)
    if cfg_kw:
        cfg = cfg.replace(**cfg_kw)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch_id, "shape": shape_name,
                "multi_pod": multi_pod, "status": "skipped", "reason": why}
    if pod or multi_pod:
        return lower_mesh(cfg, shape, multi_pod=multi_pod, rules_kw=rules_kw)
    return lower_one(cfg, shape)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)
    # the one card by default; JAX's mesh flags pick its production meshes
    meshes = ([("pod", False), ("multipod", True)] if args.both_meshes
              else [("multipod", True)] if args.multi_pod
              else [("card", False)])

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    t0 = time.time()
    results = []
    # resume from existing artifact (incremental)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        done = {(r["arch"], r["shape"], r["multi_pod"], r.get("mesh", "card"))
                for r in results if r.get("status") in ("ok", "skipped")}

    for arch, shape, (mesh, mp) in itertools.product(archs, shapes, meshes):
        if (arch, shape, mp, mesh) in done:
            continue
        print(f"[dryrun] {arch} x {shape} ({mesh}) ...", flush=True)
        try:
            rec = lower_cell(arch, shape, multi_pod=mp, pod=mesh == "pod")
        except Exception as e:  # a bug in the system — record it
            rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                   "status": "error", "error": repr(e),
                   "trace": traceback.format_exc()[-2000:]}
        if mesh != "card":
            rec["mesh"] = mesh
        results.append(rec)
        status = rec["status"]
        if status == "ok" and mesh != "card":
            m = rec["memory"]
            print(f"  ok: {rec['num_devices']} devices, params "
                  f"{m['params_per_device']} a device, params + optimizer "
                  f"{_gb(m['argument_bytes_per_device'])}, collectives "
                  f"{_gb(rec['collectives']['per_device_bytes'])} a step "
                  f"({rec['roofline']['collective_s']:.3e} s on NVLink)",
                  flush=True)
        elif status == "ok":
            m, rl = rec["memory"], rec["roofline"]
            print(
                f"  ok: {rec['lower_s']}s meta run, "
                f"args {_gb(m['argument_bytes_per_device'])}, "
                f"temp {_gb(m['temp_bytes_per_device'])}, "
                f"fits {m['fits']}, "
                f"flops/dev {rec['cost']['flops_per_device']:.3g}, "
                f"comp {rl['compute_s']:.3e}s mem {rl['memory_s']:.3e}s "
                f"-> {rl['dominant']}",
                flush=True,
            )
        else:
            print(f"  {status}: {rec.get('reason', rec.get('error'))}",
                  flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    n_err = sum(1 for r in results if r["status"] == "error")
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors in "
          f"{time.time() - t0:.1f} s")
    return 1 if n_err else 0


def _gb(x):
    return f"{x / 1e9:.2f}GB" if x is not None else "?"


if __name__ == "__main__":
    raise SystemExit(main())
