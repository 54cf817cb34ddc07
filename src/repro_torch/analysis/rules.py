"""The port's invariant rules R1–R5 (counterpart of
``repro/analysis/rules.py``; the ids are JAX's, restated for eager torch on
one card and its hand-written kernels).

R1  host-sync hazard      ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                          ``.numpy()``, ``float/int/bool(<tensor>)``,
                          ``np.asarray/np.array(<tensor>)``,
                          ``torch.cuda.synchronize`` in a hot function or
                          the fit's step loop, or the same call applied to
                          a hot call's output inside a loop; an ingestion
                          root reachable from a hot entry
R2  build hazard          ``ctypes.CDLL``, an ``nvcc`` subprocess or
                          ``torch.utils.cpp_extension.load*`` outside
                          ``kernels.build`` / ``kernels.library``; any
                          ``torch.compile`` / ``torch.jit.script`` /
                          ``torch.jit.trace``
R3  RNG discipline        a draw from torch's or numpy's global RNG in
                          library code (no ``generator=``), seeding a
                          global RNG, or a literal seed for a generator
                          outside defaults and CLIs
R4  order-dependent sums  ``index_add(_)``, ``scatter_add(_)``,
                          ``scatter_reduce(_)``, ``index_put_(...,
                          accumulate=True)``, ``F.embedding`` and
                          ``index_select`` (whose backwards scatter with
                          float atomics on the card); a float, double, half
                          or bfloat16 ``atomicAdd`` in ``csrc/*.cu`` /
                          ``*.cuh``
R5  kernel conformance    a fallback (an ``except`` that calls a plain
                          version, or swallows the error, around a kernel
                          build / library / launch / route; a branch on
                          ``torch.cuda.is_available()`` that picks the CPU;
                          a device default other than ``cuda``); a library
                          kernel (``F.scaled_dot_product_attention``,
                          ``torch.cdist``, ``torch.sparse.mm``) outside a
                          plain version; an import of ``jax``, ``jaxlib`` or
                          ``repro``; a direct bfloat16 cast outside
                          ``core/precision.py`` and the models'
                          compute-dtype path (``models/layers.py``)

JAX's R3 also flags a PRNG key reused across samplers.  A torch
``Generator`` advances its own state with every draw, so two draws from one
generator never repeat each other: key reuse has no counterpart here.
JAX's R4 (a buffer read after donation) has none either, since torch does
not donate buffers; its slot holds the port's "fixed-order sums" rule.

Waiver syntax: a ``# lint: allow[R1] reason`` comment on the finding line,
the line above it, or the enclosing ``def`` line (function-wide)
suppresses the named rule(s); in a CUDA source the comment is
``// lint: allow[R4] reason``.  A waiver must give its reason: one
without is itself a finding.  Waivers are for *genuine* exceptions (a
plain version that only the CPU runs, the sequential per-K reference, a
CLI's report) — fix true positives instead of waiving them.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass
from typing import Optional

from repro_torch.analysis.callgraph import (
    KERNEL_CALLS, FunctionInfo, ModuleIndex, dotted,
)

RULES = {
    "R1": "host-sync hazard",
    "R2": "build hazard",
    "R3": "RNG discipline",
    "R4": "order-dependent sums",
    "R5": "kernel conformance",
}

#: numpy functions that copy a device tensor to the host when handed one
_NP_SYNC = {"asarray", "array", "ascontiguousarray", "copy", "save",
            "savez", "savez_compressed"}
#: torch functions that return a Python value computed on the device
_TORCH_SYNC = {"torch.cuda.synchronize", "torch.equal", "torch.allclose",
               "torch.is_nonzero"}
#: tensor methods whose results are not tensors on the tensor's device
_HOST_METHODS = {"size", "dim", "numel", "nelement", "ndimension", "item",
                 "tolist", "data_ptr", "element_size", "is_contiguous",
                 "stride", "storage_offset", "numpy", "get_device",
                 "is_floating_point", "is_complex", "untyped_storage", "cpu",
                 "type", "equal", "allclose", "is_pinned", "register_hook",
                 "backward"}
_TENSOR_ATTRS = {"T", "mT", "H", "mH", "data", "grad", "real", "imag"}
#: torch callables (prefixes) that return something other than a tensor
_NON_TENSOR_TORCH = (
    "torch.device", "torch.Generator", "torch.finfo", "torch.iinfo",
    "torch.dtype", "torch.Size", "torch.is_", "torch.no_grad",
    "torch.enable_grad", "torch.inference_mode", "torch.set_",
    "torch.manual_seed", "torch.get_", "torch.cuda.", "torch.backends.",
    "torch.profiler.", "torch.utils.", "torch.jit.", "torch.compile",
    "torch.library.", "torch.testing.", "torch.distributed.",
    "torch.autograd.Function", "torch.autograd.graph", "torch.numel",
    "torch.result_type", "torch.promote_types", "torch.can_cast",
    "torch.typename", "torch.equal", "torch.allclose", "torch.nn.Module",
)

#: torch samplers that draw from the global RNG unless given generator=
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
                "randn_like", "randint_like", "bernoulli", "multinomial",
                "normal", "poisson"}
#: dropout never takes a generator: it always draws from the global RNG
_TORCH_GLOBAL_ONLY = {
    "torch.nn.functional.dropout", "torch.nn.functional.dropout1d",
    "torch.nn.functional.dropout2d", "torch.nn.functional.dropout3d",
    "torch.nn.functional.alpha_dropout",
    "torch.nn.functional.feature_alpha_dropout", "torch.nn.Dropout",
    "torch.dropout",
}
_INPLACE_DRAWS = {"normal_", "uniform_", "bernoulli_", "exponential_",
                  "random_", "geometric_", "cauchy_", "log_normal_"}
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                 "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                 "numpy.random.seed"}
#: numpy.random names that are not draws from the global RNG
_NP_RANDOM_OK = {"default_rng", "Generator", "RandomState", "SeedSequence",
                 "BitGenerator", "PCG64", "PCG64DXSM", "MT19937", "Philox",
                 "SFC64"}

#: calls whose sums run in a run-dependent order on the card
_SCATTERS = {"index_add", "index_add_", "scatter_add", "scatter_add_",
             "scatter_reduce", "scatter_reduce_"}
_NO_GRAD = {"torch.no_grad", "torch.inference_mode"}

_LIBRARY_KERNELS = {"torch.nn.functional.scaled_dot_product_attention",
                    "torch.cdist", "torch.sparse.mm", "torch.sparse.addmm"}
_FORBIDDEN_IMPORTS = {"jax", "jaxlib", "repro"}
_BUILD_CALLS = {"ctypes.CDLL", "ctypes.PyDLL", "ctypes.cdll.LoadLibrary"}
_COMPILERS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
              "torch.jit.trace_module"}
_PROCESS_CALLS = ("subprocess.", "os.system", "os.popen")
#: the one place that may build and load the kernel library
_BUILD_HOME = ("repro_torch/kernels/__init__.py", {"build", "library"})
#: where a bfloat16 cast is the policy, not a bypass of it
_BF16_HOMES = ("core/precision.py", "models/layers.py")

_WAIVE_RE = re.compile(r"lint:\s*allow\[([A-Za-z0-9_,\s]+)\]")
_WAIVE_REASON_RE = re.compile(r"lint:\s*allow\[[A-Za-z0-9_,\s]+\]\s*(\S?)")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str      # repo-relative, forward slashes
    line: int
    col: int
    symbol: str    # enclosing function qualname or "<module>"
    message: str

    @property
    def key(self) -> str:
        """Baseline identity — line-insensitive so unrelated edits that
        shift code never churn the baseline."""
        return f"{self.rule} :: {self.path} :: {self.symbol} :: {self.message}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.symbol}] {self.message}")


def _comments(source: str, cuda: bool):
    """(line, comment text) of every comment of a Python or CUDA source."""
    if cuda:
        for i, text in enumerate(source.splitlines(), start=1):
            if "//" in text:
                yield i, text[text.index("//"):]
        return
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except tokenize.TokenError:
        return


def parse_waivers(source: str, cuda: bool = False) -> dict[int, set]:
    """line -> set of waived rule ids, from ``# lint: allow[...]`` comments
    (``// lint: allow[...]`` in a CUDA source)."""
    out: dict[int, set] = {}
    for line, text in _comments(source, cuda):
        m = _WAIVE_RE.search(text)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            out.setdefault(line, set()).update(rules)
    return out


def unexplained_waivers(path: str, source: str,
                        cuda: bool = False) -> list[Finding]:
    """One finding per waiver comment that gives no reason after its
    ``allow[...]``, under each rule it names."""
    out = []
    if "lint:" not in source:
        return out
    for line, text in _comments(source, cuda):
        m = _WAIVE_RE.search(text)
        if m and not _WAIVE_REASON_RE.search(text).group(1):
            for rule in sorted({r.strip() for r in m.group(1).split(",")
                                if r.strip()}):
                out.append(Finding(rule, path, line, 0, "<waiver>",
                                   "waiver without a reason — say why the "
                                   "exception is genuine"))
    return out


def _snippet(node: ast.AST, limit: int = 48) -> str:
    try:
        text = ast.unparse(node)
    except Exception:
        text = "<expr>"
    text = " ".join(text.split())
    return text if len(text) <= limit else text[: limit - 3] + "..."


def iter_own(node: ast.AST):
    """Walk a function body WITHOUT descending into nested functions or
    lambdas (those are indexed — and judged — separately)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
            stack.extend(ast.iter_child_nodes(child))


def _names_in(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _assigned_names(target: ast.AST) -> set:
    out = set()
    for n in ast.walk(target):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            out.add(n.id)
    return out


def _mentions_tensor(annotation: Optional[ast.AST]) -> bool:
    return annotation is not None and "Tensor" in _snippet(annotation, 400)


def _is_plain(qual: str) -> bool:
    """A plain version: the torch-op reference a kernel is held to."""
    name = qual.split(".")[-1]
    return "_plain" in name or name.endswith("_ref")


class RuleContext:
    """Everything one module's rule passes need: the index, the global
    function map (after fixed points), and resolution helpers."""

    def __init__(self, idx: ModuleIndex, funcs: dict[str, FunctionInfo]):
        self.idx = idx
        self.funcs = funcs
        self.posix = idx.path.replace("\\", "/")
        #: node -> owning FunctionInfo (module-level nodes are absent)
        self.owner: dict[int, FunctionInfo] = {}
        for info in idx.functions.values():
            for child in iter_own(info.node):
                self.owner.setdefault(id(child), info)
        self._tensors: dict[str, set] = {}

    def symbol(self, node: ast.AST) -> str:
        info = self.owner.get(id(node))
        return info.qual if info is not None else "<module>"

    def owner_info(self, node: ast.AST) -> Optional[FunctionInfo]:
        return self.owner.get(id(node))

    def call_name(self, node: ast.Call) -> Optional[str]:
        return self.idx.call_names.get(node)

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule, path=self.idx.path, line=node.lineno,
                       col=node.col_offset, symbol=self.symbol(node),
                       message=message)

    def lookup(self, name: Optional[str]) -> Optional[FunctionInfo]:
        """Map a resolved callee (fid or cross-module dotted path) to a
        scanned function."""
        if name is None:
            return None
        return self.funcs.get(name)

    # -- tensor inference ----------------------------------------------------
    def tensor_names(self, fn: FunctionInfo) -> set:
        """Names in ``fn`` that may hold a tensor: parameters annotated
        ``torch.Tensor`` and names assigned a tensor-valued expression
        (flow-insensitive, to a fixed point)."""
        if fn.fid in self._tensors:
            return self._tensors[fn.fid]
        names: set = set()
        self._tensors[fn.fid] = names
        args = getattr(fn.node, "args", None)
        if args is not None:
            for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
                if _mentions_tensor(a.annotation):
                    names.add(a.arg)
        nodes = list(iter_own(fn.node))
        changed = True
        while changed:
            size = len(names)
            for node in nodes:
                if isinstance(node, ast.Assign):
                    if self.is_tensor(node.value, names):
                        for tgt in node.targets:
                            names |= _assigned_names(tgt)
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                    if (node.value is not None
                            and self.is_tensor(node.value, names)) or (
                            isinstance(node, ast.AnnAssign)
                            and _mentions_tensor(node.annotation)):
                        names |= _assigned_names(node.target)
                elif isinstance(node, ast.NamedExpr):
                    if self.is_tensor(node.value, names):
                        names.add(node.target.id)
                elif isinstance(node, (ast.For, ast.comprehension)):
                    if self.is_tensor(node.iter, names):
                        names |= _assigned_names(node.target)
            changed = len(names) != size
        return names

    def is_tensor(self, node: ast.AST, names: set) -> bool:
        """May ``node`` evaluate to a tensor on the device?"""
        if isinstance(node, ast.Name):
            return node.id in names
        if isinstance(node, ast.Call):
            name = self.call_name(node)
            if name is not None and name.startswith("torch."):
                return not name.startswith(_NON_TENSOR_TORCH)
            target = self.lookup(name)
            if target is not None:
                return _mentions_tensor(getattr(target.node, "returns",
                                                None))
            func = node.func
            return (isinstance(func, ast.Attribute)
                    and func.attr not in _HOST_METHODS
                    and self.is_tensor(func.value, names))
        if isinstance(node, ast.Attribute):
            return (node.attr in _TENSOR_ATTRS
                    and self.is_tensor(node.value, names))
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value, names)
        if isinstance(node, ast.BinOp):
            return (self.is_tensor(node.left, names)
                    or self.is_tensor(node.right, names))
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand, names)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(self.is_tensor(n, names)
                       for n in [node.left, *node.comparators])
        if isinstance(node, ast.IfExp):
            return (self.is_tensor(node.body, names)
                    or self.is_tensor(node.orelse, names))
        return False

    def _host_value(self, node: ast.AST) -> bool:
        """Provably a host value: a numpy call or a device-to-host copy."""
        if isinstance(node, ast.Call):
            name = self.call_name(node) or ""
            if name.startswith("numpy."):
                return True
            return (isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("cpu", "numpy", "tolist"))
        return isinstance(node, (ast.List, ast.Tuple, ast.Constant,
                                 ast.ListComp, ast.Dict))

    def sync_kind(self, node: ast.Call, names: Optional[set]
                  ) -> Optional[str]:
        """Classify a call as a host sync (None if not one).  With
        ``names`` (the caller's tensor names) casts and numpy conversions
        count only on tensor-valued arguments; with None (a dispatch loop's
        taint decides instead) every non-constant argument counts."""
        func = node.func
        name = self.call_name(node)
        if name in _TORCH_SYNC:
            return name
        if (isinstance(func, ast.Name) and func.id in ("float", "int", "bool")
                and name is None and len(node.args) == 1
                and not isinstance(node.args[0], ast.Constant)):
            if names is None or self.is_tensor(node.args[0], names):
                return f"{func.id}()"
        if name is not None and name.startswith("numpy.") and node.args \
                and name.split(".")[-1] in _NP_SYNC:
            if names is None or self.is_tensor(node.args[0], names):
                return f"np.{name.split('.')[-1]}"
        if isinstance(func, ast.Attribute) and name is None:
            if func.attr == "synchronize":
                return ".synchronize()"
            if func.attr in ("item", "tolist", "cpu", "numpy") \
                    and not self._host_value(func.value):
                return f".{func.attr}()"
        return None

    # -- dispatch-source classification -------------------------------------
    def local_executables(self, fn: FunctionInfo) -> set:
        """Names in ``fn`` bound to a hot step a factory returned
        (``step_fn = steps_mod.make_train_step(cfg, tcfg)``)."""
        out: set = set()
        for node in iter_own(fn.node):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                target = self.lookup(self.call_name(node.value))
                if target is not None and target.returns_hot:
                    for tgt in node.targets:
                        out |= _assigned_names(tgt)
        return out

    def is_dispatch_call(self, node: ast.Call, local_exec: set) -> bool:
        """Does this call put work on the card (a hot function, or one
        that reaches a kernel launch)?"""
        name = self.call_name(node)
        if name is None and node in self.idx.submit_targets:
            worker = self.lookup(self.idx.submit_targets.get(node))
            return worker is not None and worker.dispatching
        target = self.lookup(name)
        if target is not None:
            return target.dispatching
        if name is not None:
            return False  # resolved external (torch.*, np.*) — not ours
        return isinstance(node.func, ast.Name) and node.func.id in local_exec


# ---------------------------------------------------------------------------
# R1 — host-sync hazard
# ---------------------------------------------------------------------------


def _loop_nodes(info: FunctionInfo):
    """The outermost loops of a function, each with every node inside it
    (nested loops included; nested functions are judged on their own)."""
    stack = list(ast.iter_child_nodes(info.node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            yield node, [n for stmt in node.body
                         for n in [stmt, *iter_own(stmt)]]
        elif not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def check_r1(ctx: RuleContext) -> list[Finding]:
    out: list[Finding] = []
    # R1c: registered host-only ingestion roots reached by the hot fixed
    # point
    for info in ctx.idx.functions.values():
        if info.host_entry and info.hot:
            out.append(ctx.finding(
                "R1", info.node,
                f"registered host-only ingestion entry `{info.qual}` is "
                f"reachable from a hot entry — trace->graph ingestion must "
                f"stay on host threads"))
    flagged: set = set()
    for info in ctx.idx.functions.values():
        # R1a: sync primitives inside hot functions
        if info.hot:
            names = ctx.tensor_names(info)
            for node in iter_own(info.node):
                if isinstance(node, (ast.If, ast.While, ast.IfExp,
                                     ast.Assert)) \
                        and ctx.is_tensor(node.test, names):
                    out.append(ctx.finding(
                        "R1", node.test,
                        f"host sync: `{_snippet(node.test)}` tested as a "
                        f"Python bool inside hot `{info.qual}` (it waits "
                        f"for the card on every call)"))
                if isinstance(node, ast.Call):
                    kind = ctx.sync_kind(node, names)
                    if kind is not None:
                        flagged.add(id(node))
                        out.append(ctx.finding(
                            "R1", node,
                            f"host sync `{_snippet(node)}` inside hot "
                            f"`{info.qual}` ({kind} waits for the card on "
                            f"every call)"))
            continue
        # the pinned step loops: every sync inside runs once per step
        if info.dispatch_loop:
            names = ctx.tensor_names(info)
            for _, body in _loop_nodes(info):
                for node in body:
                    if isinstance(node, ast.Call) and id(node) not in flagged:
                        kind = ctx.sync_kind(node, names)
                        if kind is not None:
                            flagged.add(id(node))
                            out.append(ctx.finding(
                                "R1", node,
                                f"host sync `{_snippet(node)}` inside the "
                                f"step loop of `{info.qual}` ({kind} waits "
                                f"for the card on every step)"))
        # R1b: sync on a hot call's output inside a dispatch loop
        local_exec = None
        for _, body in _loop_nodes(info):
            if local_exec is None:
                local_exec = ctx.local_executables(info)
            out.extend(_check_dispatch_loop(ctx, info, body, local_exec,
                                            flagged))
    return out


def _check_dispatch_loop(ctx: RuleContext, info: FunctionInfo, body: list,
                         local_exec: set, flagged: set) -> list[Finding]:
    tainted: set = set()
    dispatch_names: set = set()
    for node in body:
        if isinstance(node, ast.Assign):
            calls = [c for c in ast.walk(node.value)
                     if isinstance(c, ast.Call)
                     and ctx.is_dispatch_call(c, local_exec)]
            if calls:
                for tgt in node.targets:
                    tainted |= _assigned_names(tgt)
                dispatch_names |= {_snippet(c.func, 32) for c in calls}
    if not tainted:
        return []
    # comprehension variables iterating over tainted values inherit taint
    for node in body:
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            for gen in node.generators:
                if _names_in(gen.iter) & tainted:
                    tainted |= _assigned_names(gen.target)
    out = []
    for node in body:
        if not isinstance(node, ast.Call) or id(node) in flagged:
            continue
        kind = ctx.sync_kind(node, None)
        if kind is None:
            continue
        refs = set()
        for arg in [*node.args, *[k.value for k in node.keywords]]:
            refs |= _names_in(arg)
        if isinstance(node.func, ast.Attribute):
            refs |= _names_in(node.func.value)
        if refs & tainted:
            flagged.add(id(node))
            out.append(ctx.finding(
                "R1", node,
                f"host sync `{_snippet(node)}` on kernel output "
                f"(from {'/'.join(sorted(dispatch_names))}) inside the "
                f"dispatch loop of `{info.qual}` — one device round trip "
                f"per iteration"))
    return out


# ---------------------------------------------------------------------------
# R2 — build hazard
# ---------------------------------------------------------------------------


def _mentions_nvcc(node: ast.Call) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and "nvcc" in n.value:
            return True
        if isinstance(n, ast.Name) and "nvcc" in n.id.lower():
            return True
    return False


def check_r2(ctx: RuleContext) -> list[Finding]:
    out: list[Finding] = []
    home = ctx.posix.endswith(_BUILD_HOME[0])
    for node, name in ctx.idx.call_names.items():
        if name is None:
            continue
        if name in _COMPILERS:
            out.append(ctx.finding(
                "R2", node,
                f"`{name}` generates kernels from torch ops — the port's "
                f"kernels are hand-written (csrc/) and its plain versions "
                f"stay eager"))
            continue
        builds = (name in _BUILD_CALLS
                  or name.startswith("torch.utils.cpp_extension.load")
                  or (name.startswith(_PROCESS_CALLS)
                      and _mentions_nvcc(node)))
        if builds and not (home and ctx.symbol(node) in _BUILD_HOME[1]):
            out.append(ctx.finding(
                "R2", node,
                f"kernel build `{_snippet(node)}` outside kernels.build / "
                f"kernels.library — every such site compiles or loads its "
                f"own copy; launch through kernels.launch"))
    for info in ctx.idx.functions.values():
        for dec in getattr(info.node, "decorator_list", []):
            name = ctx.idx.resolve(dec.func if isinstance(dec, ast.Call)
                                   else dec)
            if name in _COMPILERS and not isinstance(dec, ast.Call):
                out.append(ctx.finding(
                    "R2", dec,
                    f"`{name}` generates kernels from torch ops — the "
                    f"port's kernels are hand-written (csrc/) and its plain "
                    f"versions stay eager"))
    return out


# ---------------------------------------------------------------------------
# R3 — RNG discipline
# ---------------------------------------------------------------------------


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords)


def check_r3(ctx: RuleContext) -> list[Finding]:
    out: list[Finding] = []
    for node, name in ctx.idx.call_names.items():
        func = node.func
        if name is not None and (
                name in _TORCH_GLOBAL_ONLY
                or (name.startswith("torch.")
                    and name.split(".")[-1] in _TORCH_DRAWS
                    and name.count(".") == 1 and not _has_generator(node))):
            out.append(ctx.finding(
                "R3", node,
                f"`{_snippet(node)}` draws from torch's global RNG — pass "
                f"a torch.Generator seeded from the config so callers "
                f"control determinism"))
        elif name is None and isinstance(func, ast.Attribute) \
                and func.attr in _INPLACE_DRAWS and not _has_generator(node):
            out.append(ctx.finding(
                "R3", node,
                f"`{_snippet(node)}` draws from torch's global RNG — pass "
                f"generator= seeded from the config"))
        elif name in _GLOBAL_SEEDS:
            out.append(ctx.finding(
                "R3", node,
                f"`{_snippet(node)}` seeds a process-wide RNG — library "
                f"code owns its generator (torch.Generator / "
                f"np.random.default_rng)"))
        elif name is not None and name.startswith("numpy.random.") \
                and name.count(".") == 2 \
                and name.split(".")[-1] not in _NP_RANDOM_OK:
            out.append(ctx.finding(
                "R3", node,
                f"`{_snippet(node)}` draws from numpy's global RNG — use "
                f"np.random.default_rng(seed)"))
        elif (name == "numpy.random.default_rng"
              or (name is None and isinstance(func, ast.Attribute)
                  and func.attr == "manual_seed")) \
                and node.args and isinstance(node.args[0], ast.Constant) \
                and ctx.symbol(node).split(".")[-1] != "main":
            out.append(ctx.finding(
                "R3", node,
                f"hard-coded seed in `{_snippet(node)}` in library code — "
                f"take the seed from the config or the caller"))
    return out


# ---------------------------------------------------------------------------
# R4 — order-dependent sums
# ---------------------------------------------------------------------------


def _no_grad_nodes(ctx: RuleContext) -> set:
    """ids of nodes inside ``with torch.no_grad()`` / ``inference_mode()``
    blocks (no autograd graph: a gather there has no backward)."""
    out: set = set()
    for node in ast.walk(ctx.idx.tree):
        if isinstance(node, ast.With) and any(
                isinstance(it.context_expr, ast.Call)
                and ctx.call_name(it.context_expr) in _NO_GRAD
                for it in node.items):
            for stmt in node.body:
                out.update(id(n) for n in ast.walk(stmt))
    return out


def check_r4(ctx: RuleContext) -> list[Finding]:
    out: list[Finding] = []
    no_grad = None
    for node, name in ctx.idx.call_names.items():
        func = node.func
        attr = func.attr if isinstance(func, ast.Attribute) else None
        tail = (name or "").split(".")[-1] if name and name.startswith(
            "torch.") else None
        if (name is None and attr in _SCATTERS) or tail in _SCATTERS:
            out.append(ctx.finding(
                "R4", node,
                f"order-dependent sum `{_snippet(node)}` — on the card it "
                f"adds with float atomics in a run-dependent order; use a "
                f"CSR walk, a one-hot matmul or a fixed-order gather"))
        elif (attr == "index_put_" or name == "torch.index_put") and any(
                kw.arg == "accumulate" and not (
                    isinstance(kw.value, ast.Constant)
                    and kw.value.value is False)
                for kw in node.keywords):
            out.append(ctx.finding(
                "R4", node,
                f"order-dependent sum `{_snippet(node)}` — accumulate=True "
                f"adds with float atomics on the card; use a CSR walk or a "
                f"one-hot matmul"))
        elif (name is None and attr == "index_select") or \
                name in ("torch.index_select",
                         "torch.nn.functional.embedding"):
            info = ctx.owner_info(node)
            if info is not None and info.autograd:
                continue   # no autograd graph inside a custom Function
            if no_grad is None:
                no_grad = _no_grad_nodes(ctx)
            if id(node) in no_grad:
                continue
            out.append(ctx.finding(
                "R4", node,
                f"`{_snippet(node)}` on a gradient path — its backward "
                f"scatters with index_add_ (float atomics on the card); "
                f"use a gather with a fixed-order backward "
                f"(models.layers.take_rows)"))
    return out


_CUDA_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_ATOMIC_RE = re.compile(r"\b(?:unsafeAtomicAdd|atomicAdd\w*)\s*\(")
_FLOAT_TYPES = r"(?:float|double|__half2?|half2?|__nv_bfloat162?|nv_bfloat16|bf16)"
_FLOAT_CAST_RE = re.compile(r"\(\s*" + _FLOAT_TYPES + r"\s*\*")
_FLOAT_LIT_RE = re.compile(r"^\s*-?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?[fF]\s*$")
_PTX_FLOAT_RE = re.compile(
    r"\b(?:red|atom)(?:\.\w+)*\.add(?:\.\w+)*\.(?:f16x2|f16|bf16x2|bf16|f32|f64)\b")
_FUNC_RE = re.compile(r"\b(?:__global__|__device__)\b[^;{]*?\b(\w+)\s*\(")


def _blank_comments(source: str) -> str:
    """Comments replaced by spaces (newlines kept, so offsets and lines
    stay)."""
    return _CUDA_COMMENT_RE.sub(
        lambda m: re.sub(r"[^\n]", " ", m.group(0)), source)


def _call_args(text: str, start: int) -> list[str]:
    """The top-level comma-separated arguments of the call whose ``(`` is
    at ``start``."""
    depth, args, cur = 0, [], []
    for ch in text[start:]:
        if ch in "([{":
            depth += 1
            if depth == 1:
                continue
        elif ch in ")]}":
            depth -= 1
            if depth == 0:
                args.append("".join(cur))
                return args
        elif ch == "," and depth == 1:
            args.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    return args


def _float_pointer(name: str, code: str) -> bool:
    """Is ``name`` declared in ``code`` as a float-type pointer or array?"""
    decl = re.compile(_FLOAT_TYPES + r"\b[\w\s*&]*?[\s*&]" + re.escape(name)
                      + r"\s*(?:\[|[,;)=])")
    return bool(decl.search(code))


def check_cuda(path: str, source: str) -> list[Finding]:
    """R4 over a CUDA source: every float, double, half or bfloat16
    ``atomicAdd`` (or PTX ``red`` / ``atom`` ``.add`` on a float type)."""
    code = _blank_comments(source)
    out = []

    def finding(pos: int, what: str) -> Finding:
        line = code.count("\n", 0, pos) + 1
        col = pos - (code.rfind("\n", 0, pos) + 1)
        fn = None
        for m in _FUNC_RE.finditer(code, 0, pos):
            fn = m.group(1)
        return Finding(
            "R4", path, line, col, fn or "<file>",
            f"float atomic `{what}` — float adds land in a run-dependent "
            f"order; sum per-thread partials, then in a fixed order")

    for m in _ATOMIC_RE.finditer(code):
        args = _call_args(code, m.end() - 1)
        if not args:
            continue
        dest = args[0]
        ident = re.findall(r"[A-Za-z_]\w*", dest.replace("&", " "))
        is_float = (bool(_FLOAT_CAST_RE.search(dest))
                    or (len(args) > 1 and bool(_FLOAT_LIT_RE.match(args[1])))
                    or (bool(ident) and _float_pointer(ident[0], code)))
        if is_float:
            what = " ".join(f"{m.group(0)}{', '.join(args)})".split())
            out.append(finding(m.start(), what[:48]))
    for m in _PTX_FLOAT_RE.finditer(code):
        out.append(finding(m.start(), m.group(0)))
    return out


# ---------------------------------------------------------------------------
# R5 — kernel conformance
# ---------------------------------------------------------------------------


def _launches(ctx: RuleContext, tree: list) -> bool:
    """Does this code build, load, route to or launch a kernel?"""
    for stmt in tree:
        for n in ast.walk(stmt):
            if not isinstance(n, ast.Call):
                continue
            name = ctx.call_name(n)
            if name is None:
                continue
            fid = name
            if name.startswith("repro_torch.kernels.") \
                    and name.count(".") == 2:
                fid = "repro_torch.kernels:" + name.rsplit(".", 1)[1]
            if fid in KERNEL_CALLS:
                return True
            target = ctx.lookup(name)
            if target is not None and target.dispatching:
                return True
    return False


def _handler_falls_back(ctx: RuleContext, handler: ast.ExceptHandler
                        ) -> Optional[str]:
    """'plain' if the handler calls a plain version, 'swallow' if it
    neither raises nor keeps the exception, else None."""
    for n in ast.walk(handler):
        if isinstance(n, ast.Call):
            name = ctx.call_name(n) or (
                n.func.attr if isinstance(n.func, ast.Attribute) else "")
            if _is_plain(name.replace(":", ".")):
                return "plain"
    raises = any(isinstance(n, ast.Raise) for n in ast.walk(handler))
    keeps = handler.name is not None and any(
        isinstance(n, ast.Name) and n.id == handler.name
        for stmt in handler.body for n in ast.walk(stmt))
    return None if raises or keeps else "swallow"


def _picks_cpu(branch: list) -> bool:
    for stmt in branch:
        if isinstance(stmt, ast.Raise):
            return False
        for n in ast.walk(stmt):
            if isinstance(n, ast.Constant) and n.value == "cpu":
                return True
    return False


def _device_default_ok(value: ast.AST) -> bool:
    if isinstance(value, ast.Constant):
        return value.value is None or (isinstance(value.value, str)
                                       and value.value.startswith("cuda"))
    return True   # a computed default is judged where it is computed


def check_r5(ctx: RuleContext) -> list[Finding]:
    out: list[Finding] = []
    # (c) imports of the JAX side
    for node in ast.walk(ctx.idx.tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            mods = [node.module or ""]
        for mod in mods:
            if mod.split(".")[0] in _FORBIDDEN_IMPORTS:
                out.append(ctx.finding(
                    "R5", node,
                    f"import of `{mod}` — the port imports nothing of JAX "
                    f"or the JAX package (copies, not imports)"))
        # (a) a branch on torch.cuda.is_available() that picks the CPU
        if isinstance(node, (ast.If, ast.IfExp)) and any(
                isinstance(n, ast.Call)
                and ctx.call_name(n) == "torch.cuda.is_available"
                for n in ast.walk(node.test)):
            body = node.body if isinstance(node.body, list) else [
                ast.Expr(node.body)]
            orelse = node.orelse if isinstance(node.orelse, list) else [
                ast.Expr(node.orelse)]
            if _picks_cpu(body) or _picks_cpu(orelse):
                out.append(ctx.finding(
                    "R5", node,
                    f"fallback: `{_snippet(node.test)}` picks the CPU — "
                    f"without a card an entry point raises"))
        # (a) an except around a kernel that falls back or carries on
        if isinstance(node, ast.Try) and _launches(ctx, node.body):
            for handler in node.handlers:
                how = _handler_falls_back(ctx, handler)
                if how is not None:
                    what = ("runs a plain version" if how == "plain"
                            else "carries on")
                    out.append(ctx.finding(
                        "R5", handler,
                        f"fallback: an except around a kernel {what} — a "
                        f"CUDA tensor reaches its kernel or the call "
                        f"raises"))
    for node, name in ctx.idx.call_names.items():
        if name is None and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "add_argument" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value == "--device":
            for kw in node.keywords:
                if kw.arg == "default" and not _device_default_ok(kw.value):
                    out.append(ctx.finding(
                        "R5", node,
                        f"fallback: `--device` defaults to "
                        f"{_snippet(kw.value)} — entry points default to "
                        f"cuda"))
        # (b) a library kernel outside a plain version
        if name in _LIBRARY_KERNELS and not _is_plain(ctx.symbol(node)):
            out.append(ctx.finding(
                "R5", node,
                f"library kernel `{name}` outside a plain version — the "
                f"port's path runs its hand-written kernel"))
        # (d) bf16 casts outside the precision policy
        if not ctx.posix.endswith(_BF16_HOMES) and _bf16_cast(node):
            out.append(ctx.finding(
                "R5", node,
                f"direct bfloat16 cast `{_snippet(node)}` bypasses the "
                f"precision policy — cast through the config's compute "
                f"dtype (core.precision / models.layers.dtype_of)"))
    # (a) a device parameter that defaults to anything but the card
    for info in ctx.idx.functions.values():
        args = getattr(info.node, "args", None)
        if args is None:
            continue
        pos = [*args.posonlyargs, *args.args]
        pairs = list(zip(pos[len(pos) - len(args.defaults):], args.defaults))
        pairs += [(a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults)
                  if d is not None]
        for a, default in pairs:
            if a.arg == "device" and not _device_default_ok(default):
                out.append(ctx.finding(
                    "R5", default,
                    f"fallback: `{info.qual}` defaults device to "
                    f"{_snippet(default)} — entry points default to cuda"))
    return out


def _is_bf16(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "bfloat16"
    parts = dotted(node)
    return bool(parts) and parts[-1] == "bfloat16"


def _bf16_cast(node: ast.Call) -> bool:
    func = node.func
    if isinstance(func, ast.Attribute):
        if func.attr == "bfloat16" and not node.args:
            return True
        if func.attr in ("to", "type") and node.args \
                and _is_bf16(node.args[0]):
            return True
    return any(kw.arg == "dtype" and _is_bf16(kw.value)
               for kw in node.keywords)


ALL_CHECKS = (check_r1, check_r2, check_r3, check_r4, check_r5)


def run_rules(ctx: RuleContext) -> list[Finding]:
    findings: list[Finding] = []
    for check in ALL_CHECKS:
        findings.extend(check(ctx))
    return findings


def apply_waivers(findings: list[Finding], waivers: dict[int, set],
                  ctx: Optional[RuleContext]) -> list[Finding]:
    """Drop findings waived on their line, the line above, or the
    enclosing def line (``ctx`` None: a CUDA source, line waivers only)."""
    def_lines: dict[str, int] = {} if ctx is None else {
        info.qual: info.node.lineno for info in ctx.idx.functions.values()}
    kept = []
    for f in findings:
        lines = [f.line, f.line - 1]
        if f.symbol in def_lines:
            # on the def line or its own line just above -> function-wide
            lines.extend((def_lines[f.symbol], def_lines[f.symbol] - 1))
        waived = any(f.rule in waivers.get(ln, ()) or
                     "ALL" in waivers.get(ln, ()) for ln in lines)
        if not waived:
            kept.append(f)
    return kept
