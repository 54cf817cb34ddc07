"""Hand-written Hopper kernels of the port, built at first use.

rgcn_fused     K1: one-pass RGCN message + degree norm + scatter + basis
               contraction (replaces ``repro/kernels/rgcn_fused``), as an
               autograd function whose backward is K1b (``jax.vjp`` of the
               oracle in the JAX package) plus two ``torch.matmul``s
rgcn_spmm      K5 / K6: the flat and the dense pre-basis aggregates
               (replace ``repro/kernels/rgcn_spmm``)
kmeans_assign  K2: fused masked K-Means assignment + per-cluster sums,
               over a batch of programs and candidates;
               K3: blocked silhouette sums over a batch of programs; K4: the unmasked assignment of
               the sequential reference (replace
               ``repro/kernels/kmeans_assign``)
flash_attention
               K7: GQA causal flash attention (replaces
               ``repro/kernels/flash_attention``), as an autograd
               function whose backward is K7b (``jax.vjp`` of the oracle
               in the JAX package)
ssd_scan       K8: the Mamba-2 SSD intra-chunk outputs and chunk states,
               with the inter-chunk recurrence around it in torch
               (replaces ``repro/kernels/ssd_scan``), as an autograd
               function whose backward is K8b (``jax.vjp`` of the oracle
               in the JAX package)

The CUDA C++ sources live in ``repro_torch/csrc/*.cu`` and expose a plain C
interface (no PyTorch headers), so ``nvcc`` builds them in seconds: one
``nvcc -c`` per source, all started together, then one link into a shared
library under ``build/repro_torch/`` at the repository root, loaded with
``ctypes``.  The library's file name carries a hash of the sources and
flags, so an edited source never loads a stale build.

Each kernel module keeps a plain PyTorch version beside its wrapper.  The
wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C signature of every exported launcher (all return cudaGetLastError())
SIGNATURES = {
    "rgcn_fused_flat": [_P, _I, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _P],
    "kmeans_assign_fused_batched": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _P],
    "silhouette_sums": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "kmeans_assign": [_P, _P, _P, _P, _I, _I, _I, _P],
    "rgcn_spmm_flat": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "rgcn_spmm_dense": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rgcn_fused_bwd": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _P],
    "flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
                            _I, _I, _I, _I, _I, _I, _F, _P],
    "ssd_intra_chunk": [_P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _P],
    "ssd_intra_chunk_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _P, _P, _P,
                            _P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: calls of ``build`` in this process (``builds()``)
_builds = 0
#: what the last build did: seconds, the library path and nvcc's
#: ``-Xptxas -v`` report (registers, shared memory, spills per kernel)
BUILD_INFO: dict = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("repro_torch: nvcc not found (needed to build the "
                           "CUDA kernels; CUDA toolkit at /usr/local/cuda)")
    return exe


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def builds() -> int:
    """How many times this process has built the kernel library or found
    its build for these sources: one count per ``build`` call, which
    ``library`` makes when it loads the library.  The port's counterpart
    of the JAX engines' executable builds (``analysis.recompile_guard``
    reads it)."""
    return _builds


def build() -> Path:
    """Compile every source in parallel and link them into one shared
    library (skipped when a library for the same sources exists)."""
    global _builds
    _builds += 1
    sources = _sources()
    lib_path = BUILD_DIR / f"libreprotorch-{_digest(sources)}.so"
    if lib_path.exists():
        BUILD_INFO.update(seconds=0.0, path=str(lib_path), cached=True)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        reports, failed = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            reports.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                               + "\n".join(reports))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builds agree
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(lib_path),
                      cached=False, ptxas="\n".join(reports))
    return lib_path


def loaded() -> bool:
    """Whether the kernel library is loaded in this process."""
    return _lib is not None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use; thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call one exported launcher on PyTorch's current stream and raise when
    the launch was refused (``cudaGetLastError()`` != 0)."""
    fn = getattr(library(), name)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def check(name: str, t: torch.Tensor, *, dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless ``t`` has the dtype(s), shape, device and contiguity the
    kernel takes."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected "
                        f"{' or '.join(map(str, dtypes))}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def tally(name: str, ops: float, bytes_: float, dtype: str) -> None:
    """Count one kernel call made on ``meta`` tensors (which launch
    nothing) in every active dispatch mode that takes kernel tallies (the
    dry run's ``launch/dryrun.StepCounter``): its operations, run at
    ``dtype``'s rate (``launch/roofline.RATES``), and its bytes."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        record = getattr(mode, "kernel", None)
        if record is not None:
            record(name, ops, bytes_, dtype)


def route(t: torch.Tensor) -> str:
    """'cuda' -> launch the kernel; 'cpu' -> the plain version.  Anything
    else raises: there is no third path."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"repro_torch kernels run on cuda or cpu, not "
                     f"{t.device}")


class EdgeCSR(NamedTuple):
    """CSR view of a flat edge list by one endpoint: ``perm`` (Q,) int32 is
    the stable order of the live edges by that endpoint, ``rowptr`` (P+1,)
    int32 the offsets of each node's run in ``perm``."""
    perm: torch.Tensor
    rowptr: torch.Tensor


def edge_csr(index: torch.Tensor, live: torch.Tensor, num_nodes: int
             ) -> EdgeCSR:
    """CSR of the edges by ``index`` (dst or src).  Dead edges (``live``
    False: zero weight, which adds exactly zero for finite inputs) are
    keyed past the last row, so no warp walks them — left in, pack_graphs'
    padded tail (src = dst = 0) would all land in row 0.  No host sync."""
    P = int(num_nodes)
    key = torch.where(live, index, torch.full_like(index, P))
    sorted_key, perm = torch.sort(key, stable=True)
    rowptr = torch.searchsorted(
        sorted_key, torch.arange(P + 1, dtype=index.dtype,
                                 device=index.device), out_int32=True)
    return EdgeCSR(perm.to(torch.int32), rowptr)


def weight_csr(index: torch.Tensor, w: torch.Tensor, num_nodes: int
               ) -> EdgeCSR:
    """``edge_csr`` keyed on nonzero weight: an edge is live when any of
    its weights ``w`` (Q, nb) is nonzero.  A zero-weight edge adds exactly
    zero to a sum over the edges of a row for finite inputs, so no row's
    run is longer than the edges of nonzero weight it holds (the padded
    edges that pack_graphs and pad_batch put on node 0 all leave it)."""
    return edge_csr(index, (w != 0).any(1), num_nodes)


def dense_edge_csr(dst: torch.Tensor, live: torch.Tensor, num_nodes: int
                   ) -> EdgeCSR:
    """CSR of a dense batch's edges (B, E) by destination over the
    flattened (B*N) rows: the key is b*N + dst, so each graph's rows follow
    the last graph's and the runs of consecutive rows are contiguous in
    ``perm``, across graphs too.  Dead edges (``live`` False) are keyed
    B*N, past the last row, so no row walks them (pad_batch pads and
    truncates edges to src = dst = 0).  ``perm`` indexes the flattened
    edges; ``rowptr`` has B*N+1 entries.  No host sync."""
    B, N = dst.shape[0], int(num_nodes)
    base = torch.arange(B, dtype=torch.int64, device=dst.device) * N
    key = torch.where(live, dst.long() + base[:, None], B * N)
    sorted_key, perm = torch.sort(key.reshape(-1), stable=True)
    rowptr = torch.searchsorted(
        sorted_key, torch.arange(B * N + 1, dtype=torch.int64,
                                 device=dst.device), out_int32=True)
    return EdgeCSR(perm.to(torch.int32), rowptr)


def check_endpoints(src, dst, num_nodes: int, name: str = "edges") -> None:
    """Raise IndexError unless every edge endpoint lies in [0, num_nodes).
    Numpy arrays are checked on the host (the trainer and the embedder do
    so once per staged batch, before upload); a CUDA tensor costs one
    device-to-host sync, which is why the staged paths skip it."""
    P = int(num_nodes)
    if isinstance(src, np.ndarray):
        bad = src.size and (src.min() < 0 or src.max() >= P
                            or dst.min() < 0 or dst.max() >= P)
    else:
        bad = src.numel() and bool(
            ((src < 0) | (src >= P) | (dst < 0) | (dst >= P)).any())
    if bad:
        raise IndexError(f"{name}: edge endpoint outside [0, {P})")
