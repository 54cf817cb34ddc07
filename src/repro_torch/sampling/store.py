"""Copy of ``repro/sampling/store.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``), without the
in-process ``cache=`` option, which no caller of the port sets.  The port's
``gcl`` method stores its encoder in the JAX ``flatten_tree`` layout
(``repro_torch.interop.params_to_numpy``) under JAX's content keys, so a
store written by either package replays in the other.

Content-addressed artifact + plan store for the sampling API.

Layout (one directory per artifact, atomic publish like the checkpoint
manager: write to ``<dir>.tmp`` then rename):

    <root>/<method>/<config_hash>-<program_fp>/
        meta.json        # method, program, config_hash, timings, meta,
                         # payload manifest (tree paths + shapes/dtypes)
        payload.npz      # every array leaf, keyed by "<name>/<tree path>"

    <root>/plans/<method>-<program_fp>-<config_hash>/
        plan.json        # reps, method string, json-safe extra
        plan.npz         # labels

Payload values may be numpy arrays or pytrees of arrays (nested dict/list
— e.g. trained RGCN params); they are flattened to '/'-joined key paths and
rebuilt on load, so no pickling is involved.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np

from repro_torch.sampling.base import Artifacts
from repro_torch.sim.simulate import SamplingPlan
from repro_torch.tracing.programs import Program

_SEP = "/"


def program_fingerprint(program: Program) -> str:
    """Stable CONTENT id for a traced program.

    Hashes name + per-kernel (name, seq, template, params, seed) + the
    program's `fingerprint_extra` (generated programs put their
    ScenarioSpec hash there).  Kernel names alone are not enough: two
    generated programs can share every name while differing in params or
    trace seed, and their artifacts must not collide in the store.
    The human-readable prefix is sanitized for filesystem use (scenario
    names contain ':' / '=' / ',').
    """
    h = hashlib.sha1(program.name.encode())
    for k in program.kernels:
        params = sorted(getattr(k, "params", {}).items())
        h.update(
            f"{k.name}:{k.seq}:{getattr(k, 'template', '')}"
            f":{params}:{getattr(k, 'seed', '')};".encode()
        )
    extra = getattr(program, "fingerprint_extra", "")
    if extra:
        h.update(f"|{extra}".encode())
    safe_name = re.sub(r"[^A-Za-z0-9_.-]", "_", program.name)
    return f"{safe_name}-{h.hexdigest()[:10]}"


# -- pytree <-> flat arrays ---------------------------------------------------

def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten nested dict/list/array pytrees to {path: array}."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in tree:
            if _SEP in str(k):
                raise ValueError(f"tree key {k!r} contains {_SEP!r}")
            out.update(flatten_tree(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = np.asarray(tree)
    return out


def unflatten_tree(flat: dict[str, np.ndarray]) -> Any:
    """Inverse of flatten_tree: digit-only key levels rebuild lists."""
    if list(flat) == [""]:
        return flat[""]
    nest: dict = {}
    for path, arr in flat.items():
        parts = path.split(_SEP)
        node = nest
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [rebuild(node[str(i)]) for i in range(len(node))]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(nest)


def _json_safe(obj: Any) -> Any:
    """Best-effort conversion of `extra`-style dicts to JSON-safe values;
    drops entries that cannot be represented."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return repr(obj)


class ArtifactStore:
    """Save/load `Artifacts` and `SamplingPlan`s under a run directory;
    every save and load goes through the disk."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._graph_store = None

    def graph_store(self):
        """The run's packed-graph cache (`repro_torch.ingest.GraphStore`), living
        beside the artifacts under ``<root>/graphs/`` — one per store, so
        every method/program sharing this run directory shares traced
        graphs."""
        if self._graph_store is None:
            from repro_torch.ingest.store import GraphStore  # lazy: no cycle

            self._graph_store = GraphStore(os.path.join(self.root, "graphs"))
        return self._graph_store

    # -- artifacts -----------------------------------------------------------
    def _artifact_dir(self, method: str, key: str) -> str:
        return os.path.join(self.root, method, key)

    def checkpoint_dir(self, method: str, key: str) -> str:
        """Directory for a method's in-flight fit checkpoints (the trainer
        resume protocol, DESIGN.md §6).  Lives NEXT TO the artifacts under
        the same content key, so an interrupted ``prepare`` resumed later
        finds its snapshots; once the finished artifact is published the
        checkpoints are just a warm cache for refits."""
        return os.path.join(self.root, "checkpoints", method, key)

    def has(self, method: str, key: str) -> bool:
        return os.path.exists(
            os.path.join(self._artifact_dir(method, key), "meta.json"))

    def save(self, artifacts: Artifacts) -> str:
        final = self._artifact_dir(artifacts.method, artifacts.key)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)

        flat: dict[str, np.ndarray] = {}
        manifest = {}
        for name, value in artifacts.payload.items():
            sub = flatten_tree(value, f"{name}{_SEP}")
            manifest[name] = sorted(sub)
            flat.update(sub)
        if flat:
            np.savez(os.path.join(tmp, "payload.npz"), **flat)
        meta = {
            "method": artifacts.method,
            "program": artifacts.program,
            "config_hash": artifacts.config_hash,
            "provenance": artifacts.provenance,
            "timings": _json_safe(artifacts.timings),
            "meta": _json_safe(artifacts.meta),
            "payload_manifest": manifest,
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
        shutil.rmtree(final, ignore_errors=True)
        os.makedirs(os.path.dirname(final), exist_ok=True)
        os.rename(tmp, final)
        return final

    def load(self, method: str, key: str) -> Optional[Artifacts]:
        """Returns None when absent (the prepare-or-replay idiom)."""
        d = self._artifact_dir(method, key)
        if not self.has(method, key):
            return None
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        payload: dict[str, Any] = {}
        npz_path = os.path.join(d, "payload.npz")
        flat: dict[str, np.ndarray] = {}
        if os.path.exists(npz_path):
            with np.load(npz_path) as z:
                flat = {k: z[k] for k in z.files}
        for name, paths in meta["payload_manifest"].items():
            sub = {p[len(name) + 1:]: flat[p] for p in paths}
            payload[name] = unflatten_tree(sub)
        return Artifacts(
            method=meta["method"], program=meta["program"],
            config_hash=meta["config_hash"], payload=payload,
            timings=meta["timings"], meta=meta["meta"],
            provenance=meta.get("provenance", ""),
        )

    # -- plans ---------------------------------------------------------------
    def _plan_dir(self, method: str, key: str) -> str:
        return os.path.join(self.root, "plans", f"{method}-{key}")

    def save_plan(self, plan: SamplingPlan, method: str, key: str) -> str:
        final = self._plan_dir(method, key)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "plan.npz"), labels=plan.labels)
        doc = {
            "method": plan.method,
            "reps": {str(c): [int(i) for i in v] for c, v in plan.reps.items()},
            "extra": _json_safe(plan.extra),
        }
        with open(os.path.join(tmp, "plan.json"), "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        shutil.rmtree(final, ignore_errors=True)
        os.makedirs(os.path.dirname(final), exist_ok=True)
        os.rename(tmp, final)
        return final

    def load_plan(self, method: str, key: str) -> Optional[SamplingPlan]:
        d = self._plan_dir(method, key)
        if not os.path.exists(os.path.join(d, "plan.json")):
            return None
        with open(os.path.join(d, "plan.json")) as f:
            doc = json.load(f)
        with np.load(os.path.join(d, "plan.npz")) as z:
            labels = z["labels"]
        return SamplingPlan(
            labels=labels,
            reps={int(c): list(v) for c, v in doc["reps"].items()},
            method=doc["method"], extra=doc["extra"],
        )
