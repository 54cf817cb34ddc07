"""One-command reproduction of the paper's sampling table on the card
(counterpart of ``repro/launch/sample.py``).

Sweeps the full method x program x platform grid through the port's
``repro_torch.sampling`` API and writes a machine-readable results JSON
(schema ``repro.sampling.results/v2``, the JAX package's) plus reusable
artifacts/plans:

  PYTHONPATH=src python -m repro_torch.launch.sample \\
      --method gcl,pka,sieve,stem_root --platforms P1,P2,P3 --out runs/table
  PYTHONPATH=src python -m repro_torch.launch.sample --method gcl,pka \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sample --suite scenarios \\
      --families iterative,pipeline,long_tail --scenario-seeds 0,1

``--device`` (default ``cuda``) is where ``gcl`` fits and embeds and where
``gcl`` and ``pka`` cluster; ``--device cpu`` runs the kernels' plain
versions.

``--suite scenarios`` sweeps a seeded generated scenario matrix
(repro_torch.workloads) instead of the fixed paper table; rows carry the scenario
``family`` and the doc gains a method x family ``family_summary``.

Per the paper's cross-architecture protocol, clustering decisions are made
once (on the method's decision platform, P1 by default) and the same plan
is evaluated on every ``--platforms`` entry.  Artifacts are content-hash
cached under ``<out>/artifacts`` — a second sweep over an overlapping grid
replays trained encoders instead of refitting.

Each method's program axis runs in two stages: every program is prepared
(trained/profiled) first, then ALL plans are served through the method's
``plan_batch`` — engine-backed methods (gcl, pka) dispatch many programs
per call (``repro_torch.sampling.PlanEngine``: one sweep per chunk of up to
``max_batch`` programs of a bucket, K2 per Lloyd step and K3 per candidate
for the whole chunk) and full simulations are evaluated vectorized per
program.  The results add ``method_wall_s``: each method's seconds in
prepare, plan and evaluate.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

from repro_torch.sampling import (
    ArtifactStore, available_methods, evaluate_metrics, get_method,
)
from repro_torch.sim.hardware import PLATFORMS
from repro_torch.sim.simulate import METRIC_NAMES, simulate_program
from repro_torch.tracing.programs import PAPER_PROGRAMS, get_program
from repro_torch.workloads import (
    scenario_families, scenario_family_of, scenario_matrix,
)

RESULTS_SCHEMA = "repro.sampling.results/v2"
SUITES = ("paper", "scenarios", "modelzoo")
SMOKE_PROGRAMS = ["3mm", "backprop"]
# modelzoo-suite smoke: one small arch, both phases (the full suite is
# repro_torch.workloads.zoo_names(): every zoo arch x prefill/decode)
SMOKE_MODELZOO = ["model:llama3.2-3b:prefill", "model:llama3.2-3b:decode"]
SMOKE_GCL = dict(steps=10, batch_size=4, cap_instr=48)
# scenario-suite smoke: 3 families x 1 seed, small phase sizes
SMOKE_SCENARIOS = dict(families=("iterative", "pipeline", "long_tail"),
                       seeds=(0,), phases=2, phase_len=6)


def _method_kwargs(method_id: str, *, smoke: bool = False,
                   gcl_steps: int = 0, seed: int = 0,
                   suite: str = "paper", checkpoint_every: int = 0,
                   resume: bool = True, ingest_workers: int = 0,
                   graph_cache: bool = True, device=None) -> dict:
    if method_id == "pka":
        return dict({"seed": seed} if seed else {}, device=device)
    if method_id != "gcl":
        return {}  # sieve / stem_root are deterministic, no seed
    kw: dict = dict(SMOKE_GCL) if smoke else {}
    kw["device"] = device
    if suite in ("scenarios", "modelzoo"):
        # generated populations / 10-100x model-zoo graphs flow through the
        # bounded-memory trace->graph path regardless of per-program size
        kw["streaming"] = True
    if ingest_workers:
        kw["ingest_workers"] = ingest_workers
    if not graph_cache:
        kw["graph_cache"] = False
    if gcl_steps:
        kw["steps"] = gcl_steps
    if seed:
        kw["seed"] = seed
    if checkpoint_every:
        # encoder-fit snapshots under <out>/artifacts/checkpoints: an
        # interrupted sweep rerun resumes mid-fit instead of refitting
        kw["checkpoint_every"] = checkpoint_every
    if not resume:
        kw["resume"] = False
    return kw


def split_programs(arg: str) -> list[str]:
    """Split a comma-separated --programs list, keeping multi-field
    scenario names intact: `scn:` spec fields are themselves
    comma-separated (`scn:long_tail:seed=3,phase_len=24`), so a fragment
    that is a bare `key=value` belongs to the preceding scenario name."""
    from repro_torch.workloads.spec import ScenarioSpec
    from dataclasses import fields

    spec_keys = tuple(f"{f.name}=" for f in fields(ScenarioSpec)
                      if f.name != "family")
    out: list[str] = []
    for part in (p.strip() for p in arg.split(",") if p.strip()):
        if out and out[-1].startswith("scn:") and part.startswith(spec_keys):
            out[-1] += f",{part}"
        else:
            out.append(part)
    return out


def _family_summary(results: list[dict]) -> list[dict]:
    """Aggregate method x scenario-family: mean cycles error, geometric-mean
    speedup, cell count (the `--suite scenarios` headline table)."""
    groups: dict[tuple, list[dict]] = {}
    for row in results:
        groups.setdefault((row["method_id"], row["family"]), []).append(row)
    out = []
    for (method_id, family), rows in sorted(groups.items()):
        errs = [r["error_pct"]["cycles"] for r in rows]
        spd = [r["speedup"] for r in rows]
        out.append({
            "method_id": method_id,
            "family": family,
            "cells": len(rows),
            "mean_error_pct": float(sum(errs) / len(errs)),
            "geomean_speedup": float(
                math.exp(sum(math.log(max(s, 1e-12)) for s in spd) / len(spd))
            ),
        })
    return out


def run_grid(methods: list[str], programs: list[str], platforms: list[str],
             out_dir: str, *, smoke: bool = False, gcl_steps: int = 0,
             seed: int = 0, suite: str = "paper",
             checkpoint_every: int = 0, resume: bool = True,
             ingest_workers: int = 0, graph_cache: bool = True,
             device=None, verbose: bool = True) -> dict:
    """Run every (method, program) cell once, evaluate on every platform.
    ``device``: where gcl and pka run (the card unless ``"cpu"``)."""
    store = ArtifactStore(os.path.join(out_dir, "artifacts"))
    results: list[dict] = []
    failures: list[dict] = []
    batch_plan_errors: list[dict] = []  # plan_batch -> per-cell fallbacks
    method_wall_s: dict = {}  # method -> seconds in prepare / plan / evaluate
    metrics_cache: dict = {}  # (program, platform) -> full simulation

    def metrics_for(program_name, program, platform):
        key = (program_name, platform)
        if key not in metrics_cache:
            metrics_cache[key] = simulate_program(program, platform)
        return metrics_cache[key]

    t_start = time.time()
    for method_id in methods:
        method = get_method(
            method_id,
            **_method_kwargs(method_id, smoke=smoke, gcl_steps=gcl_steps,
                             seed=seed, suite=suite,
                             checkpoint_every=checkpoint_every,
                             resume=resume, ingest_workers=ingest_workers,
                             graph_cache=graph_cache, device=device))
        t_prepare = time.time()
        # stage 1: prepare (train/profile/featurize) the whole program axis
        prepared = []  # (program_name, program, artifacts, prepare_s)
        for program_name in programs:
            cell = f"{method_id} x {program_name}"
            try:
                program = get_program(program_name)
                t0 = time.time()
                artifacts = method.run_prepare(program, store=store)
                prepared.append((program_name, program, artifacts,
                                 time.time() - t0))
            except Exception as e:  # a broken cell must not kill the sweep
                failures.append({"cell": cell,
                                 "error": f"{type(e).__name__}: {e}"})
                if verbose:
                    print(f"  [{cell}] FAILED: {e}", flush=True)
        # stage 2: serve every prepared program's plan — engine-backed
        # methods plan the whole program axis through one PlanEngine
        t0 = time.time()
        prepare_s = t0 - t_prepare
        try:
            plans = method.plan_batch(
                [(prog, art) for _, prog, art, _ in prepared])
            plans = list(zip(prepared, plans))
        except Exception as e:  # batched serving failed: re-plan per cell
            # the degradation must be loud — a batching-only bug would
            # otherwise hide behind the per-cell fallback forever
            batch_plan_errors.append({
                "method_id": method_id,
                "error": f"{type(e).__name__}: {e}"})
            if verbose:
                print(f"  [{method_id}] plan_batch FAILED "
                      f"({type(e).__name__}: {e}); falling back to "
                      f"per-cell planning", flush=True)
            plans = []
            for item in prepared:
                program_name, program, artifacts, _ = item
                try:
                    plans.append((item, method.plan(program, artifacts)))
                except Exception as e:
                    failures.append({
                        "cell": f"{method_id} x {program_name}",
                        "error": f"{type(e).__name__}: {e}"})
                    if verbose:
                        print(f"  [{method_id} x {program_name}] FAILED: {e}",
                              flush=True)
        t_eval = time.time()
        plan_s = (t_eval - t0) / max(len(plans), 1)
        # plans are served; artifact payloads (encoder params, embeddings)
        # are persisted in the store and no longer needed — don't pin
        # O(programs x encoder) memory through the evaluation stage
        for _, _, artifacts, _ in prepared:
            artifacts.payload.clear()
        # stage 3: persist + evaluate every (plan, platform)
        for (program_name, program, artifacts, prep_s), plan in plans:
            cell = f"{method_id} x {program_name}"
            try:
                store.save_plan(plan, method_id, artifacts.key)
                fit_s = prep_s + plan_s
                if verbose:
                    print(f"  [{cell}] K={plan.num_clusters} "
                          f"reps={len(plan.rep_indices())} ({fit_s:.1f}s)",
                          flush=True)
                for platform in platforms:
                    res = evaluate_metrics(
                        plan, metrics_for(program_name, program, platform),
                        program=program.name, platform=platform)
                    row = res.to_dict()
                    row.update(method_id=method_id, fit_s=fit_s,
                               artifact_key=artifacts.key,
                               family=scenario_family_of(program_name))
                    results.append(row)
            except Exception as e:
                failures.append({"cell": cell,
                                 "error": f"{type(e).__name__}: {e}"})
                if verbose:
                    print(f"  [{cell}] FAILED: {e}", flush=True)
        method_wall_s[method_id] = {
            "prepare_s": prepare_s, "plan_s": t_eval - t0,
            "evaluate_s": time.time() - t_eval}
    return {
        "schema": RESULTS_SCHEMA,
        "created_unix": time.time(),
        "grid": {"methods": methods, "programs": programs,
                 "platforms": platforms, "smoke": smoke, "suite": suite},
        "wall_time_s": time.time() - t_start,
        "results": results,
        "family_summary": _family_summary(results),
        "failures": failures,
        "batch_plan_errors": batch_plan_errors,
        "method_wall_s": method_wall_s,
    }


def validate_results(doc: dict) -> None:
    """Schema check for the results JSON; raises ValueError on violation."""
    def fail(msg):
        raise ValueError(f"results JSON invalid: {msg}")

    if doc.get("schema") != RESULTS_SCHEMA:
        fail(f"schema is {doc.get('schema')!r}, want {RESULTS_SCHEMA!r}")
    grid = doc.get("grid")
    if not isinstance(grid, dict):
        fail("missing grid")
    for key in ("methods", "programs", "platforms"):
        if not isinstance(grid.get(key), list) or not grid[key]:
            fail(f"grid.{key} must be a non-empty list")
    if grid.get("suite") not in SUITES:
        fail(f"grid.suite must be one of {SUITES}")
    if not isinstance(doc.get("results"), list):
        fail("results must be a list")
    if not isinstance(doc.get("failures"), list):
        fail("failures must be a list")
    if not isinstance(doc.get("batch_plan_errors", []), list):
        fail("batch_plan_errors must be a list")
    if not isinstance(doc.get("family_summary"), list):
        fail("family_summary must be a list")
    for i, row in enumerate(doc["family_summary"]):
        where = f"family_summary[{i}]"
        for key in ("method_id", "family"):
            if not isinstance(row.get(key), str) or not row[key]:
                fail(f"{where}.{key} must be a non-empty string")
        if not isinstance(row.get("cells"), int) or row["cells"] <= 0:
            fail(f"{where}.cells must be a positive int")
        for key in ("mean_error_pct", "geomean_speedup"):
            if not isinstance(row.get(key), (int, float)) or row[key] < 0:
                fail(f"{where}.{key} must be a number >= 0")
    for i, row in enumerate(doc["results"]):
        where = f"results[{i}]"
        for key in ("method", "method_id", "program", "platform", "family"):
            if not isinstance(row.get(key), str) or not row[key]:
                fail(f"{where}.{key} must be a non-empty string")
        if row["method_id"] not in grid["methods"]:
            fail(f"{where}.method_id {row['method_id']!r} not in grid")
        if row["platform"] not in grid["platforms"]:
            fail(f"{where}.platform {row['platform']!r} not in grid")
        for key in ("num_kernels", "num_clusters", "num_reps"):
            if not isinstance(row.get(key), int) or row[key] <= 0:
                fail(f"{where}.{key} must be a positive int")
        err = row.get("error_pct")
        if not isinstance(err, dict):
            fail(f"{where}.error_pct must be a dict")
        for name in METRIC_NAMES:
            v = err.get(name)
            if not isinstance(v, (int, float)) or v < 0:
                fail(f"{where}.error_pct[{name!r}] must be a float >= 0")
        for key in ("speedup", "sim_speedup"):
            if not isinstance(row.get(key), (int, float)) or row[key] <= 0:
                fail(f"{where}.{key} must be a positive number")
        for key in ("sim_time_full_s", "sim_time_sampled_s", "fit_s"):
            if not isinstance(row.get(key), (int, float)) or row[key] < 0:
                fail(f"{where}.{key} must be a number >= 0")


def _print_table(doc: dict) -> None:
    wide = max([len(r["program"]) for r in doc["results"]] + [8]) + 2
    print(f"\n{'method':14s}{'program':{wide}s}{'plat':>5s}{'K':>5s}"
          f"{'reps':>6s}{'err %':>8s}{'speedup':>9s}")
    for row in doc["results"]:
        print(f"{row['method']:14s}{row['program']:{wide}s}"
              f"{row['platform']:>5s}"
              f"{row['num_clusters']:5d}{row['num_reps']:6d}"
              f"{row['error_pct']['cycles']:8.2f}{row['speedup']:8.1f}x")
    if doc["grid"].get("suite") == "scenarios" and doc["family_summary"]:
        print(f"\n{'method':14s}{'family':14s}{'cells':>6s}"
              f"{'mean err %':>12s}{'gm speedup':>12s}")
        for s in doc["family_summary"]:
            print(f"{s['method_id']:14s}{s['family']:14s}{s['cells']:6d}"
                  f"{s['mean_error_pct']:12.2f}{s['geomean_speedup']:11.1f}x")
    if doc["failures"]:
        print(f"\n{len(doc['failures'])} cell(s) FAILED:")
        for f in doc["failures"]:
            print(f"  {f['cell']}: {f['error']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.sample",
        description="Sweep sampling methods over programs and platforms.")
    ap.add_argument("--method", default="all",
                    help="comma-separated method ids, or 'all' "
                         f"(known: {','.join(available_methods())})")
    ap.add_argument("--suite", default="paper", choices=SUITES,
                    help="program axis: the paper's fixed 11-program table, "
                         "or a seeded generated scenario matrix "
                         "(repro_torch.workloads)")
    ap.add_argument("--programs", default="",
                    help="comma-separated program names — overrides --suite "
                         "(default: smoke set with --smoke, else all paper "
                         f"programs: {','.join(PAPER_PROGRAMS)}; scenario "
                         "specs like scn:pipeline:seed=1 also work)")
    ap.add_argument("--families", default="",
                    help="scenario families for --suite scenarios "
                         f"(known: {','.join(scenario_families())}; "
                         "default: smoke subset with --smoke, else all)")
    ap.add_argument("--scenario-seeds", default="0",
                    help="comma-separated spec seeds for --suite scenarios")
    ap.add_argument("--platforms", default="P1",
                    help=f"comma-separated platforms (known: "
                         f"{','.join(PLATFORMS)})")
    ap.add_argument("--out", default="runs/sample",
                    help="run directory (artifacts, plans, results.json)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny GCL config + small default programs")
    ap.add_argument("--gcl-steps", type=int, default=0,
                    help="override GCL contrastive training steps")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot GCL encoder fits every N steps under "
                         "<out>/artifacts/checkpoints; a rerun of an "
                         "interrupted sweep resumes mid-fit (0 = off)")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore existing fit checkpoints (refit from "
                         "scratch; snapshots are still written)")
    ap.add_argument("--seed", type=int, default=0,
                    help="reseed the stochastic methods (gcl, pka); "
                         "sieve/stem_root are deterministic")
    ap.add_argument("--ingest-workers", type=int, default=0,
                    help="concurrent trace->graph ingest workers for gcl "
                         "(0 = sequential; output is bit-identical at any "
                         "worker count)")
    ap.add_argument("--device", default="cuda",
                    help="where gcl fits/embeds and gcl/pka cluster: cuda "
                         "(the hand-written kernels) or cpu (their plain "
                         "PyTorch versions)")
    ap.add_argument("--no-graph-cache", action="store_true",
                    help="skip the on-disk packed-graph cache (always "
                         "re-trace; warm runs normally re-trace nothing)")
    args = ap.parse_args(argv)

    methods = (available_methods() if args.method == "all"
               else [m.strip() for m in args.method.split(",") if m.strip()])
    for m in methods:
        if m not in available_methods():
            ap.error(f"unknown method {m!r}; known: {available_methods()}")
    if args.programs:
        programs = split_programs(args.programs)
    elif args.suite == "scenarios":
        families = [f.strip() for f in args.families.split(",") if f.strip()]
        for f in families:
            if f not in scenario_families():
                ap.error(f"unknown family {f!r}; known: "
                         f"{scenario_families()}")
        seeds = tuple(int(s) for s in args.scenario_seeds.split(",") if s)
        if args.smoke:
            sm = dict(SMOKE_SCENARIOS)
            programs = scenario_matrix(
                families or sm["families"], seeds or sm["seeds"],
                phases=sm["phases"], phase_len=sm["phase_len"])
        else:
            programs = scenario_matrix(families or None, seeds or (0,))
    elif args.suite == "modelzoo":
        from repro_torch.workloads import zoo_names

        programs = SMOKE_MODELZOO if args.smoke else zoo_names()
    else:
        programs = SMOKE_PROGRAMS if args.smoke else list(PAPER_PROGRAMS)
    platforms = [p.strip() for p in args.platforms.split(",") if p.strip()]
    for p in platforms:
        if p not in PLATFORMS:
            ap.error(f"unknown platform {p!r}; known: {list(PLATFORMS)}")

    print(f"== sampling grid [{args.suite}]: {len(methods)} method(s) x "
          f"{len(programs)} program(s) x {len(platforms)} platform(s) "
          f"-> {args.out} ==")
    doc = run_grid(methods, programs, platforms, args.out, smoke=args.smoke,
                   gcl_steps=args.gcl_steps, seed=args.seed,
                   suite=args.suite, checkpoint_every=args.checkpoint_every,
                   resume=not args.no_resume,
                   ingest_workers=args.ingest_workers,
                   graph_cache=not args.no_graph_cache, device=args.device)
    validate_results(doc)
    os.makedirs(args.out, exist_ok=True)
    results_path = os.path.join(args.out, "results.json")
    with open(results_path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    _print_table(doc)
    print(f"\nresults JSON: {results_path} "
          f"({len(doc['results'])} rows, {doc['wall_time_s']:.0f}s)")
    return 1 if doc["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
