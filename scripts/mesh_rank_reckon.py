"""What one rank of a (data, model) mesh holds and carries in a sharded LM
train step, counted from the plan (``distributed/model_parallel.ShardPlan``)
on the CPU, with no card and no group: the rank's parameters, its state
(params and moments), the collective bytes of one step by kind, and a
reckoning of its peak: the state, the float32 gradient of its blocks,
and the compute-dtype copy of every leaf as the step uses it (its block,
its model slice, or the whole leaf), as if all were alive at once (the
backward frees copies as it makes gradients, so the card's peak may be
lower).  Activations, the gathers' buffers and the optimizer's
temporaries are not counted.

    PYTHONPATH=src python scripts/mesh_rank_reckon.py --arch dbrx-132b \
        --layers 1 --mesh 1x4 --opt-dtype bfloat16

One JSON line on stdout.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from repro_torch.config import TrainConfig
from repro_torch.configs import get_arch
from repro_torch.distributed.model_parallel import ShardPlan
from repro_torch.distributed.sharding import block_shape
from repro_torch.launch import mesh as mesh_mod


def reckon(arch: str, layers: int, mesh: tuple, batch: int, seq: int,
           opt_dtype: str = "float32") -> dict:
    cfg = get_arch(arch).replace(num_layers=layers)
    plan = ShardPlan(cfg, mesh_mod.make_rules(mesh_mod.rank_mesh(mesh)))
    tcfg = TrainConfig(opt_dtype=opt_dtype)
    pz = torch.empty((), dtype=plan.param_dtype).element_size()
    oz = torch.empty((), dtype=getattr(torch, tcfg.opt_dtype)).element_size()
    cz = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                     ).element_size()
    n = plan.block_numel()
    used = 0
    for lf in plan.leaves:
        one = math.prod(plan.out_shape(lf))
        used += one * (lf.shape[0] if lf.stacked else 1)
    state = n * (pz + 2 * oz)
    grads = n * 4
    return {
        "arch": arch, "layers": layers, "mesh": list(mesh),
        "batch": [batch, seq], "opt_dtype": opt_dtype,
        "rank_params": n,
        "whole_params": sum(math.prod(lf.shape) for lf in plan.leaves),
        "state_bytes": state, "grad_bytes": grads,
        "compute_copy_bytes": used * cz,
        "peak_reckoned_bytes": state + grads + used * cz,
        "collective_bytes": plan.collective_bytes(batch, seq),
        "split": plan.split_leaves,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--mesh", default="2x2", help="data x model, e.g. 1x4")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--opt-dtype", default="float32")
    args = ap.parse_args(argv)
    mesh = tuple(int(x) for x in args.mesh.split("x"))
    print(json.dumps(reckon(args.arch, args.layers, mesh, args.batch,
                            args.seq_len, args.opt_dtype)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
