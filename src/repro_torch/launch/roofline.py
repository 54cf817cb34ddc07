"""Roofline terms of a dry-run record on one NVIDIA H100 (counterpart of
``repro/launch/roofline.py``).

Per (arch x shape) cell, from the dry run's counts (``launch/dryrun.py``):

  compute    = sum over dtypes of FLOPs / that dtype's peak
               [989 TFLOP/s bf16 tensor cores; 67 TFLOP/s float32, which
               the port runs with TF32 off (``utils/device.py``); a 3xTF32
               kernel's operations three times over at 495 TFLOP/s]
  memory     = bytes / HBM bandwidth                      [3.35 TB/s]
  collective = collective bytes a device / NVLink 4    [450 GB/s a
               direction]

The peaks are the H100 SXM data sheet's dense rates at its 700 W limit
(NVLink 4: 18 links, 900 GB/s both directions together).  JAX's HLO
parser (``_shape_bytes``, ``collective_bytes_from_hlo``) has no
counterpart: an eager step has no HLO.  ``collective_bytes(cfg, shape,
rules)`` counts instead, from the param specs and the sharded step's
schedule (``distributed/model_parallel.ShardPlan.collective_bytes``), the
bytes each gather, gradient sum and tensor-parallel sum carries on a
device in one train, prefill or decode step; a one-card step carries
none.  A record whose
``cost`` was not counted (the dry run's mesh records, which lower
nothing) has no compute or memory term.

``bound`` and ``tf32x3_bound`` are the least time of one kernel call, by
the same peaks; ``chip_smoke.py``'s kernel table and the dry run divide by
these numbers.
"""

from __future__ import annotations

import json

PEAK_BYTES_S = 3.35e12  # HBM3 bytes/s
PEAK_F32_S = 67e12      # float32 FLOP/s outside the tensor cores
PEAK_BF16_S = 989e12    # dense bf16 tensor-core FLOP/s
PEAK_TF32_S = 495e12    # dense TF32 tensor-core FLOP/s
HBM_BYTES = 80 * 2**30  # the card's memory ("80 GB")
NVLINK_BYTES_S = 450e9  # NVLink 4 bytes/s, one direction

#: FLOP/s by the dtype that runs the operations (``cost.flops_by_dtype``);
#: "tf32x3" counts a 3xTF32 kernel's operations once, run three times
RATES = {"bfloat16": PEAK_BF16_S, "float16": PEAK_BF16_S,
         "float32": PEAK_F32_S, "tf32x3": PEAK_TF32_S / 3}


def bound(bytes_, ops, peak=PEAK_F32_S):
    """(ms, "bytes" or "operations"): the larger of ``bytes_`` over the HBM
    bandwidth and ``ops`` over ``peak``."""
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tf32x3_bound(bytes_, ops):
    """(ms, by) of a 3xTF32 design: three tensor-core passes over the
    operations at the TF32 rate, against the bytes."""
    return bound(bytes_, 3 * ops, PEAK_TF32_S)


def collective_bytes(cfg, shape, rules, tcfg=None) -> dict:
    """The bytes each kind of collective carries on a device in one step
    of ``cfg`` at ``shape`` (global batch x seq; its kind: train, prefill
    or decode) over ``rules.mesh``, and their ``total``."""
    from repro_torch.distributed.model_parallel import ShardPlan

    return ShardPlan(cfg, rules).collective_bytes(
        shape.global_batch, shape.seq_len, tcfg, kind=shape.kind)


def roofline_terms(rec: dict) -> dict:
    """The three terms (seconds) and the bottleneck of a dry-run record.  A
    record without ``cost.flops_by_dtype`` (JAX's) is taken as all bf16,
    as JAX's terms take it; one whose cost is None (not counted) has no
    compute and memory terms."""
    chips = rec["num_devices"]
    counted = rec["cost"].get("flops_per_device", 0.0) is not None
    fpd = rec["cost"].get("flops_per_device") or 0.0
    bpd = rec["cost"].get("bytes_per_device") or 0.0
    by_dtype = rec["cost"].get("flops_by_dtype") or {"bfloat16": fpd}
    coll = (rec.get("collectives") or {}).get("per_device_bytes") or 0.0
    # a dtype without a rate of its own runs at float32's
    terms = {"compute_s": sum(n / RATES.get(dt, PEAK_F32_S)
                              for dt, n in by_dtype.items()),
             "memory_s": bpd / PEAK_BYTES_S,
             "collective_s": coll / NVLINK_BYTES_S}
    if not counted:
        terms.update(compute_s=None, memory_s=None)
    known = {k: v for k, v in terms.items() if v is not None}
    dominant = max(known, key=known.get)
    t_max = max(known.values())
    total_flops = fpd * chips
    useful = rec.get("model_flops", 0.0)
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "hlo_flops_total": total_flops if counted else None,
        "model_flops": useful,
        "useful_flop_ratio": ((useful / total_flops) if total_flops
                              else None),
        "step_time_bound_s": t_max,
        "roofline_fraction": (min(1.0, terms["compute_s"] / t_max)
                              if t_max and counted else None),
    }


def summarize(path: str = "dryrun_results.json"):
    with open(path) as f:
        results = json.load(f)
    rows = []
    for r in results:
        if r.get("status") != "ok":
            rows.append((r["arch"], r["shape"], r["multi_pod"],
                         r["status"], r.get("reason", r.get("error", ""))[:60]))
            continue
        rl = r["roofline"]
        rows.append((
            r["arch"], r["shape"], r["multi_pod"], "ok",
            f"comp {_s(rl['compute_s'])} mem {_s(rl['memory_s'])} "
            f"coll {rl['collective_s']:.3e}s -> {rl['dominant']}"
            f" (useful {100 * (rl['useful_flop_ratio'] or 0):.0f}%)",
        ))
    return rows


def _s(t) -> str:
    return "n/a" if t is None else f"{t:.3e}s"


if __name__ == "__main__":
    import sys

    for row in summarize(sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.json"):
        print(*row)
