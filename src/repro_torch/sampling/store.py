"""Copy of ``program_fingerprint``, ``flatten_tree`` and ``unflatten_tree``
from ``repro/sampling/store.py`` for the PyTorch port.

The original's on-disk ``ArtifactStore`` is not copied yet; these three
functions are what the port's artifact keys and the JAX-parameter interop
(``repro_torch.interop``) need.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any

import numpy as np

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
