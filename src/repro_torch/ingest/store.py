"""Copy of ``repro/ingest/store.py`` for the PyTorch port (imports rewritten to
``repro_torch``; the port imports nothing of ``repro``).

On-disk content-hash store for built kernel graphs.

Layout (atomic publish like ArtifactStore: write tmp, then rename):

    <root>/kernels/<kk[:2]>/<kk>.npz      # one entry per UNIQUE kernel
    <root>/programs/<fp>-cw..-ci..-g..-p...json   # ordered key manifest

A kernel entry is keyed on everything that determines the traced graph's
bits: (template, params, seed) — the `_rng_for` inputs — plus the trace
window (`cap_warps`/`cap_instr`) and the graph/pack schema versions, so a
cached graph can never be replayed across differing trace caps or a packing
change (the caps are folded into the key derivation).
Kernel name/seq are deliberately NOT in the key: two invocations of the
same (template, params, seed) share one entry, which is exactly the dedup
the ingest engine exploits.

Every entry carries a sha1 checksum over its array bytes; a short read,
bit-flip, or truncated npz is rejected on load (counted in ``stats``) and
the caller falls back to re-tracing — a corrupt cache can slow a run down
but never change its output.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from typing import Optional

import numpy as np

from repro_torch.core.batching import PACK_SCHEMA
from repro_torch.core.graphs import KernelGraph

#: bump when KernelGraph's array layout changes (invalidates every entry)
GRAPH_SCHEMA = 1

_FIELDS = ("node_type", "token", "pc_norm", "vstats", "warp_id",
           "edge_src", "edge_dst", "edge_type")


def kernel_graph_key(inv, cap_warps: int, cap_instr: int) -> str:
    """Content key for one kernel's graph: trace identity x window x schema."""
    h = hashlib.sha1(
        f"{inv.template}|{sorted(inv.params.items())}|{inv.seed}"
        f"|cw{int(cap_warps)}|ci{int(cap_instr)}"
        f"|g{GRAPH_SCHEMA}|p{PACK_SCHEMA}".encode()
    )
    return h.hexdigest()[:20]


def _digest(arrays: dict) -> str:
    h = hashlib.sha1()
    for f in _FIELDS + ("n_warps",):
        a = np.ascontiguousarray(arrays[f])
        h.update(f.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


class GraphStore:
    """Save/load built `KernelGraph`s under a run directory.

    ``stats`` counts ``hits`` / ``misses`` / ``corrupt`` / ``writes`` —
    the warm-run acceptance gate is ``traced == 0`` on the engine side,
    which this store makes possible."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "kernels"), exist_ok=True)
        os.makedirs(os.path.join(root, "programs"), exist_ok=True)
        self._lock = threading.Lock()  # ingest workers share one store
        self.stats = {"hits": 0, "misses": 0, "corrupt": 0, "writes": 0}

    def _bump(self, field: str):
        with self._lock:
            self.stats[field] += 1

    # -- kernel entries ------------------------------------------------------
    def _kernel_path(self, key: str) -> str:
        return os.path.join(self.root, "kernels", key[:2], f"{key}.npz")

    def has_kernel(self, key: str) -> bool:
        return os.path.exists(self._kernel_path(key))

    def save_kernel(self, key: str, g: KernelGraph) -> str:
        path = self._kernel_path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        arrays = {f: getattr(g, f) for f in _FIELDS}
        arrays["n_warps"] = np.asarray(g.n_warps, np.int64)
        arrays["checksum"] = np.asarray(_digest(arrays))
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, path)  # concurrent writers race benignly:
        except BaseException:      # same key -> same bytes, last rename wins
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._bump("writes")
        return path

    def load_kernel(self, key: str) -> Optional[KernelGraph]:
        """None on miss OR on a corrupt entry (caller re-traces)."""
        path = self._kernel_path(key)
        if not os.path.exists(path):
            self._bump("misses")
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                arrays = {f: z[f] for f in _FIELDS}
                arrays["n_warps"] = z["n_warps"]
                stored = str(z["checksum"][()])
        except Exception:
            self._bump("corrupt")
            return None
        if _digest(arrays) != stored:
            self._bump("corrupt")
            return None
        self._bump("hits")
        return KernelGraph(
            **{f: arrays[f] for f in _FIELDS}, n_warps=int(arrays["n_warps"])
        )

    # -- program manifests ---------------------------------------------------
    def _manifest_path(self, program, cap_warps: int, cap_instr: int) -> str:
        from repro_torch.sampling.store import program_fingerprint  # lazy: no cycle

        fp = program_fingerprint(program)
        return os.path.join(
            self.root, "programs",
            f"{fp}-cw{int(cap_warps)}-ci{int(cap_instr)}"
            f"-g{GRAPH_SCHEMA}-p{PACK_SCHEMA}.json",
        )

    def save_manifest(self, program, cap_warps: int, cap_instr: int,
                      keys: list[str]) -> str:
        path = self._manifest_path(program, cap_warps, cap_instr)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"keys": list(keys)}, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    def load_manifest(self, program, cap_warps: int,
                      cap_instr: int) -> Optional[list[str]]:
        path = self._manifest_path(program, cap_warps, cap_instr)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return list(json.load(f)["keys"])
        except Exception:
            return None

    def warm(self, program, cap_warps: int, cap_instr: int) -> bool:
        """True when a completed ingest of this program at these caps is on
        disk (manifest present and every kernel entry exists)."""
        keys = self.load_manifest(program, cap_warps, cap_instr)
        if keys is None:
            return False
        return all(self.has_kernel(k) for k in keys)
