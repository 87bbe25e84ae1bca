"""The AST lint of the port: capture-reachability and the per-module rules.

Counterpart of ``stmgcn_tpu/analysis/lint.py``, in two sweeps per module.
Sweep one builds a module index: import aliases (so ``np.asarray``
resolves to ``numpy.asarray`` whatever the alias), every function and
method definition by its simple name, and the *capture-reachability*
seeds. Where the JAX lint seeds the functions handed to ``jax.jit``,
``lax.scan`` and the other tracing transforms, the port seeds the
functions whose body is captured into a CUDA graph
(:mod:`stmgcn_tpu_torch.graphs`):

- the first argument of ``CapturedProgram(...)`` and ``Program(...)``
  (the eager route runs the same body) and of ``GraphPool.capture(...)``,
  a nested ``def`` passed by name included (the trainer's, the serving
  engine's and the continual loop's ``body``);
- every function called by name inside a ``with torch.cuda.graph(...)``
  block, whose own statements are checked as captured too.

Reachability then propagates through same-module calls by name; the
whole-program mode (:func:`lint_package`, the default) adds the
functions that :mod:`.program_db`'s global call graph reaches through
statically resolved imports, each with its root-to-function chain. A
``torch.nn.Module``'s methods are not seeded (the JAX lint seeds a flax
module's, which always run under trace; a torch module runs eagerly
unless a captured body calls it). Sweep two emits the findings:

- ``host-sync-in-jit``: ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``float(<computed>)``, ``np.asarray`` or
  ``torch.cuda.synchronize`` inside a capture-reachable function (or a
  captured ``with`` block): a readback that fails the capture on the card,
  where no CPU test sees it;
- ``traced-control-flow``: a Python ``if``/``while`` whose test calls a
  ``torch.*`` function that returns a tensor (the ``torch.is_*`` and
  ``torch.*.get_*`` predicates and getters return host values and are
  exempt) or ``.any()``/``.all()`` on a tensor, capture-reachable: a
  hidden readback;
- ``unfenced-timing`` (a warning): a ``time.perf_counter``/``time.time``/
  ``time.monotonic`` span around a dispatch (``replay``, ``apply``,
  ``step``, ``*_step``, ``train_batch``, ``predict`` or a
  capture-reachable function) with no fence: a host sync above,
  ``Event.synchronize``/``Stream.synchronize``/``elapsed_time``, or
  :func:`stmgcn_tpu_torch.utils.profiling.fence`;
- ``partition-axis-name`` (the JAX ``sharding_check.py`` rule in torch
  terms): a string-literal axis given to a
  :mod:`stmgcn_tpu_torch.utils.comm` collective (``all_reduce``,
  ``all_gather``, ``reduce_scatter``, ``ring_exchange``, ``broadcast``)
  that is neither one of the mesh axes (:data:`MESH_AXES`, those of
  ``stmgcn_tpu_torch/parallel/mesh.py``) nor ``"world"``: the group lookup
  raises on the mesh, at full scale;
- ``unparseable-module``: a file the parser rejects (the JAX lint files it
  under ``jax-compat-import``, which has no counterpart here).

The JAX lint's rules without a counterpart, none of them registered:

- ``jax-compat-import``: the port imports no JAX, so no JAX version range
  to guard;
- ``missing-donate``, ``recompile-hazard``, ``closure-identity``: they
  guard ``jax.jit``'s buffer donation and trace cache; a captured graph
  replays into static buffers and has no trace cache;
- ``partition-rank``: the port's ``MeshPlacement`` slices by array kind
  and has no ``PartitionSpec`` table to hold to operand ranks;
- ``fp64-promotion``, ``weak-type-output``, ``primitive-budget``,
  ``accum-dtype``, ``implicit-cast``, ``pallas-blockspec``,
  ``pallas-vmem``: they walk traced jaxprs and Pallas calls, which the
  port has not (its kernels' budgets are ``kernel-smem``/``kernel-shape``).

Suppression: ``# stmgcn: ignore[rule-id]`` (or bare ``# stmgcn: ignore``)
on the finding's reported line; ``include_suppressed=True`` keeps them,
marked and never counted.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

from stmgcn_tpu_torch.analysis.report import Finding
from stmgcn_tpu_torch.analysis.rules import RULES

__all__ = ["lint_package", "lint_paths", "lint_source"]

#: calls whose first argument is captured into a CUDA graph (by the
#: dotted name's last segment)
_CAPTURE_WRAPPERS = {"CapturedProgram", "Program", "capture"}

_TIME_CALLS = {"time.time", "time.perf_counter", "time.monotonic"}

#: tensor methods that copy to the host (and wait for the device)
_READBACKS = ("item", "cpu", "tolist", "numpy")

#: dispatch names of ``unfenced-timing`` (besides ``*_step``)
_DISPATCH = {"apply", "step", "replay", "train_batch", "predict"}

#: fence names of ``unfenced-timing`` (besides the host syncs)
_FENCES = {"fence", "synchronize", "elapsed_time"}

#: the collectives of :mod:`stmgcn_tpu_torch.utils.comm` -> positional
#: index of their axis argument (None: keyword only)
_COMM = "stmgcn_tpu_torch.utils.comm"
_AXIS_ARG = {"all_reduce": 1, "all_gather": 1, "reduce_scatter": 1, "ring_exchange": 2,
             "broadcast": None}

_SUPPRESS_RE = re.compile(r"#\s*stmgcn:\s*ignore(?:\[([\w\-, ]+)\])?")


def _suppressions(source: str) -> Dict[int, Optional[Set[str]]]:
    """``line -> suppressed rule ids`` (``None`` = every rule)."""
    out: Dict[int, Optional[Set[str]]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = (
                {r.strip() for r in m.group(1).split(",")} if m.group(1) else None
            )
    return out


def _apply_suppressions(findings: Iterable[Finding], suppress_by_path: Dict[str, dict],
                        include_suppressed: bool) -> List[Finding]:
    """Drop (or, with ``include_suppressed``, mark) the findings suppressed
    at their reported line."""
    out = []
    for f in findings:
        rules = suppress_by_path.get(f.path, {}).get(f.line, ...)
        live = rules is ... or (rules is not None and f.rule not in rules)
        if live:
            out.append(f)
        elif include_suppressed:
            out.append(dataclasses.replace(f, suppressed=True))
    return out


#: the mesh axes (``stmgcn_tpu_torch/parallel/mesh.py``'s ``AXES``, copied
#: so the lint imports no torch; a test holds the two equal) and ``"world"``,
#: the group of every rank
MESH_AXES = ("dp", "region", "branch")
_COMM_AXES = frozenset(MESH_AXES) | {"world"}


class _ModuleIndex(ast.NodeVisitor):
    """Sweep one: aliases, function defs, capture-root seeds, call edges."""

    def __init__(self):
        self.aliases: Dict[str, str] = {}  # local name -> dotted module
        self.funcs: Dict[str, ast.AST] = {}  # simple name -> def node
        self.calls: Dict[str, Set[str]] = {}  # caller name -> callee names
        self.roots: Set[str] = set()
        #: ``(with node, enclosing function name or "")`` of each captured block
        self.capture_blocks: List[tuple] = []
        #: names called inside a captured block (seeded when they name a def)
        self.capture_callees: Set[str] = set()
        self._stack: List[str] = []

    # -- imports ---------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = (
                a.name if a.asname else a.name.split(".")[0]
            )
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for a in node.names:
            if node.module:
                self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        self.generic_visit(node)

    # -- resolution helpers ----------------------------------------------
    def dotted(self, node: ast.AST) -> Optional[str]:
        """Resolve an attribute chain to a dotted path through the alias
        map (``np.asarray`` -> ``numpy.asarray``); None for non-name roots."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.aliases.get(node.id, node.id)
        return ".".join([root] + list(reversed(parts)))

    def is_capture_wrapper(self, func: ast.AST) -> bool:
        d = self.dotted(func)
        if d is None and isinstance(func, ast.Attribute):
            d = func.attr  # ``self.ops.capture`` / ``pool().capture``
        return bool(d) and d.split(".")[-1] in _CAPTURE_WRAPPERS

    def is_capture_context(self, item: ast.withitem) -> bool:
        """Whether ``item`` is ``torch.cuda.graph(...)``: its block is captured."""
        expr = item.context_expr
        return isinstance(expr, ast.Call) and self.dotted(expr.func) == "torch.cuda.graph"

    # -- defs --------------------------------------------------------------
    def _handle_func(self, node) -> None:
        name = node.name
        self.funcs.setdefault(name, node)
        self.calls.setdefault(name, set())
        self._stack.append(name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _handle_func
    visit_AsyncFunctionDef = _handle_func

    def visit_With(self, node) -> None:
        if any(self.is_capture_context(item) for item in node.items):
            self.capture_blocks.append((node, self._stack[-1] if self._stack else ""))
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        f = sub.func
                        name = (f.id if isinstance(f, ast.Name)
                                else f.attr if isinstance(f, ast.Attribute) else None)
                        if name:
                            self.capture_callees.add(name)
        self.generic_visit(node)

    # -- call edges + root seeding ----------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        callee = None
        if isinstance(node.func, ast.Name):
            callee = node.func.id
        elif isinstance(node.func, ast.Attribute):
            callee = node.func.attr  # self.foo() / mod.foo(): match by name
        if self._stack and callee:
            self.calls[self._stack[-1]].add(callee)
        # a local function handed to a capture becomes a root
        if node.args and self.is_capture_wrapper(node.func):
            for sub in ast.walk(node.args[0]):
                if isinstance(sub, ast.Name) and sub.id in self.funcs:
                    self.roots.add(sub.id)
        self.generic_visit(node)

    def seeds(self) -> Set[str]:
        return (self.roots | self.capture_callees) & set(self.funcs)

    def reachable(self) -> Set[str]:
        seen = set(self.seeds())
        frontier = list(seen)
        while frontier:
            fn = frontier.pop()
            for callee in self.calls.get(fn, ()):
                if callee in self.funcs and callee not in seen:
                    seen.add(callee)
                    frontier.append(callee)
        return seen


class _Linter:
    def __init__(self, tree: ast.Module, path: str,
                 extra_reachable: Optional[Dict[str, tuple]] = None,
                 index: Optional[_ModuleIndex] = None):
        self.path = path
        self.findings: List[Finding] = []
        if index is None:
            index = _ModuleIndex()
            index.visit(tree)
        self.index = index
        self.reachable = self.index.reachable()
        # whole-program promotion: functions reachable only through the
        # global call graph, each carrying its root->function chain
        self.chains: Dict[str, tuple] = dict(extra_reachable or {})
        self.reachable |= set(self.chains) & set(self.index.funcs)
        self.tree = tree

    def _emit(self, rule: str, node: ast.AST, message: str, chain: tuple = ()) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.path, line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", -1) + 1, message=message,
            severity=RULES[rule].severity, chain=chain))

    def run(self) -> List[Finding]:
        for name, fn in self.index.funcs.items():
            self._check_timing_span(fn)
            if name in self.reachable:
                chain = self.chains.get(fn.name, ())
                via = " (cross-module)" if chain else ""
                self._check_captured(ast.walk(fn), f"capture-reachable `{fn.name}`{via}", chain)
        for block, owner in self.index.capture_blocks:
            where = "a captured `with torch.cuda.graph` block" + (
                f" in `{owner}`" if owner else "")
            self._check_captured((sub for stmt in block.body for sub in ast.walk(stmt)), where)
        self._check_axis_names()
        return self.findings

    # -- host-sync-in-jit / traced-control-flow ---------------------------
    def _is_host_sync(self, node: ast.Call) -> Optional[str]:
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in _READBACKS and not node.args and not node.keywords:
                return f".{f.attr}() readback"
            d = self.index.dotted(f)
            if d == "torch.cuda.synchronize":
                return "torch.cuda.synchronize() device sync"
            if d is not None and d.startswith("numpy.") and f.attr == "asarray":
                return "np.asarray device->host copy"
        elif isinstance(f, ast.Name) and f.id == "float":
            if len(node.args) == 1 and not isinstance(node.args[0], ast.Constant):
                return "float() readback of a computed value"
        return None

    def _check_captured(self, nodes, where: str, chain: tuple = ()) -> None:
        for node in nodes:
            if isinstance(node, ast.Call):
                why = self._is_host_sync(node)
                if why:
                    self._emit("host-sync-in-jit", node, f"{why} inside {where}", chain=chain)
            elif isinstance(node, (ast.If, ast.While)):
                traced = self._traced_test(node.test)
                if traced:
                    kw = "if" if isinstance(node, ast.If) else "while"
                    self._emit(
                        "traced-control-flow", node,
                        f"Python `{kw}` on a device value ({traced}) inside {where} — a "
                        "hidden readback that fails under capture; use torch.where or move "
                        "the decision out of the captured body", chain=chain)

    def _traced_test(self, test: ast.AST) -> Optional[str]:
        """A test expression that reads a device tensor back as a bool."""
        for sub in ast.walk(test):
            if not isinstance(sub, ast.Call):
                continue
            d = self.index.dotted(sub.func)
            if d and d.startswith("torch."):
                leaf = d.rsplit(".", 1)[-1]
                host = (leaf.startswith(("is_", "get_")) and leaf != "is_nonzero") or d in (
                    "torch.device", "torch.dtype", "torch.Size", "torch.finfo", "torch.iinfo")
                if not host:
                    return d
            if (isinstance(sub.func, ast.Attribute) and sub.func.attr in ("any", "all")
                    and not (d and d.startswith("numpy."))):
                return f".{sub.func.attr}()"
        return None

    # -- unfenced-timing ---------------------------------------------------
    def _check_timing_span(self, fn) -> None:
        starts: Set[str] = set()
        closing: List[ast.AST] = []
        dispatch = fence = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                if self.index.dotted(node.value.func) in _TIME_CALLS:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            starts.add(t.id)
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub):
                if (isinstance(node.left, ast.Call)
                        and self.index.dotted(node.left.func) in _TIME_CALLS
                        and isinstance(node.right, ast.Name) and node.right.id in starts):
                    closing.append(node)
            if isinstance(node, ast.Call):
                if self._is_host_sync(node) is not None:
                    fence = True
                f = node.func
                name = (f.id if isinstance(f, ast.Name)
                        else f.attr if isinstance(f, ast.Attribute) else "")
                if name in _FENCES:
                    fence = True
                if name in _DISPATCH or name.endswith("_step") or name in self.reachable:
                    dispatch = True
        if closing and dispatch and not fence:
            self._emit(
                "unfenced-timing", closing[0],
                f"timing span in `{fn.name}` brackets device dispatch with no readback "
                "fence — times the launch, not the work; fence the result "
                "(stmgcn_tpu_torch.utils.profiling.fence) or time with CUDA events")

    # -- partition-axis-name ----------------------------------------------
    def _check_axis_names(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            d = self.index.dotted(node.func)
            if not d or d.rpartition(".")[0] != _COMM or d.rpartition(".")[2] not in _AXIS_ARG:
                continue
            pos = _AXIS_ARG[d.rpartition(".")[2]]
            args = [kw.value for kw in node.keywords if kw.arg == "axis"]
            if pos is not None and len(node.args) > pos:
                args.append(node.args[pos])
            for arg in args:
                if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
                    continue  # a name held in a variable: out of static reach
                if arg.value not in _COMM_AXES:
                    self._emit(
                        "partition-axis-name", arg,
                        f"collective axis {arg.value!r} of `{d}` is not a mesh axis "
                        f"({sorted(_COMM_AXES)}) — the group lookup raises on the mesh")


def lint_source(source: str, path: str = "<string>", *,
                extra_reachable: Optional[Dict[str, tuple]] = None,
                include_suppressed: bool = False) -> List[Finding]:
    """Lint one module's source text. ``extra_reachable`` maps function
    names to cross-module call chains (whole-program promotion);
    ``include_suppressed`` keeps suppressed findings, marked, instead of
    dropping them."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(rule="unparseable-module", path=path, line=e.lineno or 0,
                        message=f"unparseable module: {e.msg}",
                        severity=RULES["unparseable-module"].severity)]
    return _lint_tree(tree, source, path, extra_reachable, include_suppressed)


def _lint_tree(tree: ast.Module, source: str, path: str, extra_reachable, include_suppressed,
               index: Optional[_ModuleIndex] = None) -> List[Finding]:
    findings = _Linter(tree, path, extra_reachable=extra_reachable, index=index).run()
    return _apply_suppressions(findings, {path: _suppressions(source)}, include_suppressed)


def _rel(f: Path) -> str:
    rel = os.path.relpath(f, os.getcwd())
    return f.as_posix() if rel.startswith("..") else Path(rel).as_posix()


def lint_paths(paths: Iterable, *, include_suppressed: bool = False) -> List[Finding]:
    """Lint ``.py`` files / directory trees, per module; paths become
    relative to the working directory."""
    findings: List[Finding] = []
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    for f in files:
        findings.extend(lint_source(f.read_text(), _rel(f),
                                    include_suppressed=include_suppressed))
    return findings


def package_root() -> str:
    """The ``stmgcn_tpu_torch`` package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_package(root: Optional[str] = None, *, whole_program: bool = True,
                 include_suppressed: bool = False, db=None) -> List[Finding]:
    """Lint the shipped ``stmgcn_tpu_torch`` package (or the package at
    ``root``).

    ``whole_program=True`` (the default) first builds the program database
    (:mod:`.program_db`, type-informed), promotes the functions that are
    capture-reachable only through resolved cross-module calls (their
    findings carry the root-to-function chain), and runs the four
    concurrency rules (:mod:`.concurrency_check`) off the same database;
    ``db`` passes one already built. ``whole_program=False`` is the
    per-module escape hatch (``lint --no-whole-program``): no database, no
    concurrency pass."""
    root = root or package_root()
    if not whole_program:
        return lint_paths([root], include_suppressed=include_suppressed)

    from stmgcn_tpu_torch.analysis.concurrency_check import check_concurrency
    from stmgcn_tpu_torch.analysis.program_db import ProgramDB

    db = db if db is not None else ProgramDB.from_root(root, type_informed=True)
    findings: List[Finding] = []
    for name, entry in sorted(db.modules.items()):
        findings.extend(_lint_tree(entry.tree, entry.source, entry.path, db.module_extras(name),
                                   include_suppressed, index=entry.index))
    findings.extend(check_concurrency(db, include_suppressed=include_suppressed))
    # files the parser rejected never made it into the database: lint them
    # per module so the unparseable-module finding still surfaces
    indexed = {e.path for e in db.modules.values()}
    for f in sorted(Path(root).rglob("*.py")):
        if _rel(f) not in indexed:
            findings.extend(lint_source(f.read_text(), _rel(f),
                                        include_suppressed=include_suppressed))
    return findings
