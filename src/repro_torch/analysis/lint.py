"""CLI driver for the port's invariant linter (counterpart of
``repro/analysis/lint.py``): ``python -m repro_torch.analysis.lint``.

Scans ``src/repro_torch`` (or the given paths): its Python files through
rules R1–R5 over a repo-wide call graph, and its CUDA sources
(``*.cu`` / ``*.cuh``) through R4's float-atomics scan; drops waivers
(``# lint: allow[...] reason``, ``// lint: allow[...] reason``), and diffs
the remaining findings against the checked-in baseline
(``src/repro_torch/analysis/baseline.json``).  Exit status is 0 iff the
run matches the baseline exactly — any NEW finding fails, and so does a
STALE baseline entry (a finding that was fixed but not removed from the
baseline, which keeps the baseline honest).

Usage:
    python -m repro_torch.analysis.lint                   # diff vs baseline
    python -m repro_torch.analysis.lint --json            # machine-readable
    python -m repro_torch.analysis.lint --check-baseline  # explicit CI mode
    python -m repro_torch.analysis.lint --write-baseline  # accept findings
    python -m repro_torch.analysis.lint --no-baseline src/repro_torch/core

Paths in findings are relative to the working directory, so run it from
the repository root.  Baseline identity is line-insensitive (rule, path,
symbol, message), so unrelated edits never churn it; the file stores a
count per key so adding a *second* instance of an accepted finding still
fails.
"""

from __future__ import annotations

import argparse
import ast
import json
import sys
from collections import Counter
from pathlib import Path
from typing import Optional

from repro_torch.analysis.callgraph import ModuleIndex, build_graph
from repro_torch.analysis.rules import (
    Finding, RuleContext, apply_waivers, check_cuda, parse_waivers,
    run_rules, unexplained_waivers,
)

BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"
BASELINE_VERSION = 1
CUDA_SUFFIXES = (".cu", ".cuh")


def module_name_for(path: Path, root: Optional[Path] = None) -> str:
    """Derive the import path: src/repro_torch/core/train.py ->
    repro_torch.core.train.  Files outside a src/ tree fall back to their
    stem."""
    parts = path.with_suffix("").parts
    if "src" in parts:
        parts = parts[parts.index("src") + 1:]
    elif root is not None:
        try:
            parts = path.with_suffix("").relative_to(root).parts
        except ValueError:
            parts = (path.stem,)
    else:
        parts = (path.stem,)
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or path.stem


def _rel(path: Path) -> str:
    try:
        return path.resolve().relative_to(Path.cwd()).as_posix()
    except ValueError:
        return path.as_posix()


def collect_files(paths: list) -> list:
    """The Python and CUDA sources under ``paths`` (files or dirs)."""
    files: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(f for f in p.rglob("*")
                                if f.suffix in (".py", *CUDA_SUFFIXES)))
        elif p.suffix in (".py", *CUDA_SUFFIXES):
            files.append(p)
    return files


def lint_paths(paths: list, *, module_names: Optional[dict] = None
               ) -> list[Finding]:
    """Index every Python file, link the call graph, run all rules, scan
    the CUDA sources, apply waivers.  ``module_names`` optionally overrides
    path -> module."""
    indexes: list[ModuleIndex] = []
    sources: dict[str, str] = {}
    findings: list[Finding] = []
    for path in collect_files(paths):
        source = path.read_text()
        rel = _rel(path)
        if path.suffix in CUDA_SUFFIXES:
            findings.extend(apply_waivers(check_cuda(rel, source),
                                          parse_waivers(source, cuda=True),
                                          None))
            findings.extend(unexplained_waivers(rel, source, cuda=True))
            continue
        module = (module_names or {}).get(rel) or module_name_for(path)
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as exc:
            raise SystemExit(f"lint: cannot parse {rel}: {exc}") from exc
        indexes.append(ModuleIndex(rel, module, tree))
        sources[rel] = source
    funcs = build_graph(indexes)
    # register cross-module dotted aliases (repro_torch.core.rgcn.encode)
    # alongside the canonical fids (repro_torch.core.rgcn:encode)
    by_name = dict(funcs)
    for fid, info in funcs.items():
        mod, qual = fid.split(":", 1)
        by_name.setdefault(f"{mod}.{qual}", info)
    for idx in indexes:
        ctx = RuleContext(idx, by_name)
        raw = run_rules(ctx)
        findings.extend(apply_waivers(raw, parse_waivers(sources[idx.path]),
                                      ctx))
        findings.extend(unexplained_waivers(idx.path, sources[idx.path]))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def load_baseline(path: Path) -> Counter:
    if not path.exists():
        return Counter()
    data = json.loads(path.read_text())
    if data.get("version") != BASELINE_VERSION:
        raise SystemExit(
            f"lint: unsupported baseline version in {path}: "
            f"{data.get('version')!r}")
    return Counter(data.get("findings", {}))


def write_baseline(path: Path, findings: list) -> None:
    counts = Counter(f.key for f in findings)
    payload = {
        "version": BASELINE_VERSION,
        "findings": {k: counts[k] for k in sorted(counts)},
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")


def diff_baseline(findings: list, baseline: Counter):
    """Split findings into (new, accepted) and report stale baseline keys."""
    counts = Counter(f.key for f in findings)
    budget = Counter(baseline)
    new: list[Finding] = []
    accepted: list[Finding] = []
    for f in findings:
        if budget[f.key] > 0:
            budget[f.key] -= 1
            accepted.append(f)
        else:
            new.append(f)
    stale = sorted(k for k in baseline if baseline[k] > counts.get(k, 0))
    return new, accepted, stale


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="the PyTorch/H100 port's invariant linter (rules R1-R5)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to scan (default: src/repro_torch)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit machine-readable JSON")
    ap.add_argument("--baseline", type=Path, default=BASELINE_PATH,
                    help=f"baseline file (default: {BASELINE_PATH.name} "
                         f"next to this module)")
    ap.add_argument("--check-baseline", action="store_true",
                    help="CI mode: fail on any new or stale finding "
                         "(also the default when a baseline exists)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current findings as the baseline")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline; report everything")
    args = ap.parse_args(argv)

    paths = args.paths or ["src/repro_torch"]
    findings = lint_paths(paths)

    if args.write_baseline:
        write_baseline(args.baseline, findings)
        print(f"lint: wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    baseline = Counter() if args.no_baseline else load_baseline(args.baseline)
    new, accepted, stale = diff_baseline(findings, baseline)

    if args.as_json:
        accepted_ids = {id(f) for f in accepted}
        payload = {
            "findings": [{
                "rule": f.rule, "path": f.path, "line": f.line,
                "col": f.col, "symbol": f.symbol, "message": f.message,
                "key": f.key, "baselined": id(f) in accepted_ids,
            } for f in findings],
            "stale_baseline": stale,
            "summary": {"total": len(findings), "new": len(new),
                        "baselined": len(accepted), "stale": len(stale)},
        }
        print(json.dumps(payload, indent=2))
    else:
        for f in new:
            print(f.render())
        for key in stale:
            print(f"stale baseline entry (fixed? remove it): {key}")
        print(f"lint: {len(findings)} finding(s) — {len(accepted)} "
              f"baselined, {len(new)} new, {len(stale)} stale")

    strict = args.check_baseline or not args.no_baseline
    if strict and (new or stale):
        return 1
    if args.no_baseline and findings:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
