"""Module indexing + hot-path call graph for the port's invariant linter
(counterpart of ``repro/analysis/callgraph.py``).

The rules need to know, for every function of ``repro_torch``, whether it
runs once per step of a hot path (R1 host-sync) and whether it launches
work on the card (the dispatch-loop taint analysis).  This module builds
that knowledge from the AST alone:

- :class:`ModuleIndex` parses one file and records every function
  (including nested defs and lambdas), resolves call targets through the
  import aliases and local scopes (``rgcn_mod.encode_packed`` ->
  ``repro_torch.core.rgcn.encode_packed``, ``self._upload`` ->
  ``Class._upload``, ``_FusedAggFlat.apply`` -> its ``forward`` and
  ``backward``), and marks the ``forward`` / ``backward`` of every
  ``torch.autograd.Function`` subclass as a hot entry;
- :func:`build_graph` links the per-module indexes into one call graph,
  pins :data:`HOT_ENTRIES` (the fit step, the sweep, the sweep's dispatch,
  the LM prefill / decode and train steps) and the calls inside the loops
  of :data:`DISPATCH_LOOPS` (the fit's step loop), and runs two fixed
  points: **hot** (a callee of a hot function is hot) and
  **dispatching** (a function that directly or transitively launches a
  kernel or calls a hot function).

Where JAX marks a region traced because ``jax.jit`` / ``lax.scan`` /
``pallas_call`` wrap it, the port has no tracer: eager torch runs every
line of a step on every step, so the step's entry points are pinned by
name, and a function is hot when a pinned entry reaches it through calls
inside ``repro_torch``.  Both properties over-approximate — a function
reachable from a hot entry is hot even if some call sites are host-only.
That is the point of the waiver syntax (``# lint: allow[R1] reason``):
the analysis stays sound and the human records why an exception is
genuine.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Optional

#: the rematerialisation wrapper: ``checkpoint(fn, *args)`` calls ``fn``
CHECKPOINT = "torch.utils.checkpoint.checkpoint"

#: fully-qualified fids of the port's hot entries: every line of these runs
#: once per fit step, Lloyd sweep, served dispatch, prefill, decode step or
#: LM train step.  ``forward`` / ``backward`` of every
#: ``torch.autograd.Function`` subclass are hot entries too (found by
#: their base class, see ``ModuleIndex.visit_ClassDef``).
HOT_ENTRIES = {
    "repro_torch.core.train:train_step",
    "repro_torch.core.clustering:_sweep_core",
    "repro_torch.sampling.engine:PlanEngine._dispatch_chunk",
    "repro_torch.models.transformer:prefill",
    "repro_torch.models.transformer:decode_step",
    "repro_torch.launch.steps:make_train_step.train_step",
    "repro_torch.launch.steps:make_sharded_prefill_step.prefill_step",
    "repro_torch.launch.steps:make_sharded_decode_step.decode_step",
}

#: fids of functions whose loops are dispatch loops: each statement inside
#: a loop runs once per step, so every call made there is a hot edge and a
#: host sync there is an R1 finding, whatever it reads
DISPATCH_LOOPS = {
    "repro_torch.core.train:ContrastiveTrainer._fit_steps",
}

#: fully-qualified fids of the trace->graph ingestion roots: these run the
#: numpy RNG tracer on HOST threads — on pool workers via ``pool.submit`` —
#: and must NEVER become reachable from a hot entry (a step that traces
#: programs stalls the card for the whole trace).  ``build_graph`` pins them
#: as ``host_entry`` and R1 flags any of them that the hot fixed point
#: reaches.  The ``.submit`` hop itself is a call edge (see visit_Call).
INGEST_ENTRIES = {
    "repro_torch.ingest.engine:IngestEngine.iter_graphs",
    "repro_torch.ingest.engine:IngestEngine._build_one",
    "repro_torch.tracing.tracer:trace_kernel",
    "repro_torch.tracing.tracer:trace_kernel_loop",
}

#: the kernel library's entry points (``repro_torch/kernels/__init__.py``):
#: a function that reaches ``launch`` puts work on the card
KERNEL_LAUNCH = "repro_torch.kernels:launch"
KERNEL_CALLS = {"repro_torch.kernels:build", "repro_torch.kernels:library",
                KERNEL_LAUNCH, "repro_torch.kernels:route"}

AUTOGRAD_FUNCTION = "torch.autograd.Function"


def dotted(node: ast.AST) -> Optional[list[str]]:
    """Flatten ``a.b.c`` into ``["a", "b", "c"]`` (None if not a pure
    name/attribute chain)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return parts[::-1]


@dataclass
class FunctionInfo:
    """One function/lambda, with everything the rules need to know."""

    fid: str                       # "repro_torch.core.train:train_step"
    module: str
    path: str
    qual: str
    node: ast.AST                  # FunctionDef / AsyncFunctionDef / Lambda
    cls: Optional[str] = None      # enclosing class name, if a method
    calls: set = field(default_factory=set)          # resolved callee ids
    loop_calls: set = field(default_factory=set)     # ... made inside loops
    hot_entry: bool = False        # pinned, or an autograd forward/backward
    autograd: bool = False         # forward/backward of an autograd.Function
    dispatch_loop: bool = False    # pinned in DISPATCH_LOOPS
    host_entry: bool = False       # registered host-only ingestion root
    returns_hot: bool = False      # returns a hot nested function
    hot: bool = False              # fixed-point result
    dispatching: bool = False      # fixed-point result


class ModuleIndex(ast.NodeVisitor):
    """Per-file AST index; see module docstring."""

    def __init__(self, path: str, module: str, tree: ast.Module):
        self.path = path
        self.module = module
        self.tree = tree
        self.functions: dict[str, FunctionInfo] = {}
        self.imports: dict[str, str] = {}
        #: names of this module's torch.autograd.Function subclasses
        self.autograd_classes: set = set()
        #: resolution of every Call node's callee to a dotted string
        self.call_names: dict[ast.Call, Optional[str]] = {}
        #: pool.submit(fn, ...) call -> resolved worker fn
        self.submit_targets: dict[ast.Call, Optional[str]] = {}
        self._scopes: list[dict] = [{}]
        self._quals: list[str] = []
        self._cls: list[str] = []
        self._fn: list[FunctionInfo] = []
        self._loops = 0
        self._prescan(tree)
        self.visit(tree)

    # -- symbol tables -------------------------------------------------------
    def _prescan(self, tree: ast.Module) -> None:
        """Module-level names must resolve regardless of definition order."""
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scopes[0][node.name] = ("func", node.name)
            elif isinstance(node, ast.ClassDef):
                self._scopes[0][node.name] = ("class", node.name)

    def _bind(self, name: str, ref: tuple) -> None:
        self._scopes[-1][name] = ref

    def _lookup(self, name: str) -> Optional[tuple]:
        for scope in reversed(self._scopes):
            if name in scope:
                return scope[name]
        if name in self.imports:
            return ("ext", self.imports[name])
        return None

    def _qual(self, name: str) -> str:
        return ".".join(self._quals + [name]) if self._quals else name

    def _fid(self, qual: str) -> str:
        return f"{self.module}:{qual}"

    # -- name resolution -----------------------------------------------------
    def resolve(self, node: ast.AST) -> Optional[str]:
        """Resolve a callee expression to a dotted string: either an
        external path ("torch.cuda.synchronize", "numpy.asarray") or a
        local id ("<module>:<qual>").  ``self.x`` resolves within the
        enclosing class; ``functools.partial(f, ...)`` and
        ``torch.utils.checkpoint.checkpoint(f, ...)`` unwrap to ``f``."""
        if isinstance(node, ast.Call):
            inner = self.resolve(node.func)
            if inner in ("functools.partial", CHECKPOINT) and node.args:
                return self.resolve(node.args[0])
            return None
        parts = dotted(node)
        if parts is None:
            return None
        base, rest = parts[0], parts[1:]
        if base == "self" and self._cls and rest:
            return self._fid(f"{self._cls[-1]}.{rest[0]}")
        ref = self._lookup(base)
        if ref is None:
            return None
        kind, target = ref
        if kind == "ext":
            return ".".join([target] + rest)
        if kind == "func":
            return self._fid(target) if not rest else None
        if kind == "class":
            return self._fid(".".join([target] + rest)) if rest else None
        return None

    def _resolve_local_function(self, node: ast.AST) -> Optional[str]:
        r = self.resolve(node)
        if r is not None and r.startswith(f"{self.module}:"):
            return r
        return None

    # -- visitors ------------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.imports[a.asname or a.name.split(".")[0]] = (
                a.name if a.asname else a.name.split(".")[0])

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module is None or node.level:
            return
        for a in node.names:
            self.imports[a.asname or a.name] = f"{node.module}.{a.name}"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if any(self.resolve(b) == AUTOGRAD_FUNCTION for b in node.bases):
            self.autograd_classes.add(node.name)
        self._cls.append(node.name)
        self._quals.append(node.name)
        self._scopes.append({})
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scopes[-1][item.name] = (
                    "func", f"{node.name}.{item.name}")
        self.generic_visit(node)
        self._scopes.pop()
        self._quals.pop()
        self._cls.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_function(node, node.name)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_function(node, node.name)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._visit_function(node, f"<lambda:{node.lineno}>")

    def _visit_function(self, node, name: str) -> None:
        qual = self._qual(name)
        cls = self._cls[-1] if self._cls else None
        info = FunctionInfo(fid=self._fid(qual), module=self.module,
                            path=self.path, qual=qual, node=node, cls=cls)
        # a method defined directly in an autograd.Function subclass
        if (cls in self.autograd_classes and self._quals == [cls]
                and name in ("forward", "backward")):
            info.autograd = info.hot_entry = True
        self.functions[qual] = info
        if self._quals:  # nested defs resolve by name in the parent scope
            self._scopes[-1].setdefault(name, ("func", info.qual))
        self._quals.append(name)
        self._scopes.append({})
        self._fn.append(info)
        loops, self._loops = self._loops, 0
        body = node.body if isinstance(node.body, list) else [node.body]
        for item in body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scopes[-1][item.name] = (
                    "func", f"{info.qual}.{item.name}")
        for item in body:
            self.visit(item)
        self._loops = loops
        self._fn.pop()
        self._scopes.pop()
        self._quals.pop()
        if not isinstance(node, ast.Lambda):
            self._finish_function(node, info)

    def _finish_function(self, node, info: FunctionInfo) -> None:
        """Mark factories of hot steps: a function that returns one of its
        own nested functions that is pinned hot (``make_train_step``)."""
        for ret in ast.walk(node):
            if isinstance(ret, ast.Return) and isinstance(ret.value,
                                                          ast.Name):
                fid = self._fid(f"{info.qual}.{ret.value.id}")
                if fid in HOT_ENTRIES:
                    info.returns_hot = True

    def _visit_loop(self, node) -> None:
        self._loops += 1
        self.generic_visit(node)
        self._loops -= 1

    visit_For = visit_AsyncFor = visit_While = _visit_loop

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        # alias: name = other_local_function / partial(fn, ...)
        value = node.value
        target_ref = None
        if isinstance(value, (ast.Name, ast.Attribute)):
            r = self._resolve_local_function(value)
            if r is not None:
                target_ref = ("func", r.split(":", 1)[1])
        elif isinstance(value, ast.Call):
            if self.resolve(value.func) == "functools.partial" and value.args:
                r = self._resolve_local_function(value.args[0])
                if r is not None:
                    target_ref = ("func", r.split(":", 1)[1])
        if target_ref is not None:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self._bind(tgt.id, target_ref)

    def _add_call(self, name: str) -> None:
        fn = self._fn[-1]
        fn.calls.add(name)
        if self._loops:
            fn.loop_calls.add(name)

    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        name = self.resolve(node.func)
        self.call_names[node] = name
        if self._fn and name is not None:
            self._add_call(name)
            # Function.apply(...) runs forward now and backward later
            if name.startswith(f"{self.module}:") and name.endswith(".apply"):
                cls = name.split(":", 1)[1][:-len(".apply")]
                if cls in self.autograd_classes:
                    self._add_call(self._fid(f"{cls}.forward"))
                    self._add_call(self._fid(f"{cls}.backward"))
        # checkpoint(fn, ...) runs fn now (and again in the backward):
        # the rematerialised block is a callee of the caller
        if name == CHECKPOINT and self._fn:
            target = self.resolve(node)
            if target is not None:
                self._add_call(target)
        # worker-pool hop: pool.submit(fn, ...) runs fn on an executor
        # thread; record the worker fn as a callee so the fixed points see
        # through the executor
        if (name is None and node.args
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "submit"):
            target = self.resolve(node.args[0])
            self.submit_targets[node] = target
            if target is not None and self._fn:
                self._add_call(target)


def index_module(path: str, module: str, source: str) -> ModuleIndex:
    return ModuleIndex(path, module, ast.parse(source, filename=path))


def build_graph(indexes: list[ModuleIndex]) -> dict[str, FunctionInfo]:
    """Link per-module indexes and run the hot/dispatching fixed points.
    Returns the global fid -> FunctionInfo map (mutated in place)."""
    funcs: dict[str, FunctionInfo] = {}
    modnames = set()
    for idx in indexes:
        modnames.add(idx.module)
        for info in idx.functions.values():
            funcs[info.fid] = info
    for fid in HOT_ENTRIES:
        if fid in funcs:
            funcs[fid].hot_entry = True
    for fid in DISPATCH_LOOPS:
        if fid in funcs:
            funcs[fid].dispatch_loop = True
    for fid in INGEST_ENTRIES:
        if fid in funcs:
            funcs[fid].host_entry = True

    def to_fid(callee: str) -> Optional[str]:
        """Map a resolved dotted path to a known function id."""
        if callee in funcs:
            return callee
        if ":" in callee:
            return None
        # external-style path into a scanned module:
        # repro_torch.core.rgcn.encode_packed
        parts = callee.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:cut])
            if mod in modnames:
                fid = f"{mod}:{'.'.join(parts[cut:])}"
                return fid if fid in funcs else None
        return None

    edges: dict[str, set] = {}
    loop_edges: dict[str, set] = {}
    for info in funcs.values():
        edges[info.fid] = {f for f in map(to_fid, info.calls) if f}
        loop_edges[info.fid] = {f for f in map(to_fid, info.loop_calls) if f}

    # hot: hot entries, the callees of dispatch loops, and everything they
    # (transitively) call
    work = [f.fid for f in funcs.values() if f.hot_entry]
    for info in funcs.values():
        if info.dispatch_loop:
            work.extend(loop_edges[info.fid])
    for fid in work:
        funcs[fid].hot = True
    while work:
        fid = work.pop()
        for callee in edges[fid]:
            if not funcs[callee].hot:
                funcs[callee].hot = True
                work.append(callee)

    # dispatching: launches a kernel or runs a hot function (directly or
    # transitively)
    for info in funcs.values():
        info.dispatching = info.fid == KERNEL_LAUNCH or info.hot_entry
    changed = True
    while changed:
        changed = False
        for info in funcs.values():
            if info.dispatching:
                continue
            if any(funcs[c].dispatching or funcs[c].returns_hot
                   for c in edges[info.fid]):
                info.dispatching = True
                changed = True
    return funcs
