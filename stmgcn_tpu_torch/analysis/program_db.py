"""The program database behind the port's whole-program lint.

A copy of ``stmgcn_tpu/analysis/program_db.py``. The per-module AST lint
(:mod:`.lint`) stops at module boundaries: its capture-reachability seeds
propagate through same-module calls only, so a readback inside a helper
that *another* module's captured body calls is invisible there. This
module builds the global view, one parse of every ``.py`` file of the
package, then:

- **resolved import aliases**: each module's ``import``/``from-import``
  bindings resolved to absolute dotted targets, relative imports and
  re-export chains through package ``__init__`` modules included;
- **a global call graph over qualnames** (``module:function``) whose
  cross-module edges exist *only* where a callee resolves statically
  through the alias map: a ``Name`` call bound by an import, or a dotted
  ``module.attr(...)`` call. Dynamic dispatch (``self.foo()``, attributes
  of unknown objects) stays a same-module by-name edge, never a
  cross-module guess: the precision contract, that whole-program mode adds
  no false positive on a tree the per-module pass reports clean;
- **global capture-reachability with call chains**: the union of every
  module's roots (the functions whose body is captured into a CUDA graph:
  the first argument of ``CapturedProgram``/``Program``/``GraphPool.capture``
  and the functions called in a ``with torch.cuda.graph(...)`` block,
  :mod:`.lint`), *imported* functions handed to a capture included, which
  no per-module index can seed; BFS'd over the global graph with parent
  tracking, so each reachable function carries its root-to-function chain.

:meth:`ProgramDB.module_extras` is the lint's integration point: for one
module, the functions that are globally capture-reachable but locally
invisible, with their chains; :meth:`ProgramDB.cross_module_gain` lists
them all.

Every module's classes are modelled as :class:`ClassInfo`: methods,
attributes assigned in any method, and synchronization fields recognized
from their ``threading.Lock``/``RLock``/``Condition``/``Event``/``Thread``
/``queue.Queue`` constructor calls. On top sits the **type-informed
resolution mode** (``type_informed=True``): ``self.method()``,
``self.attr.method()`` where the attribute's class is unambiguous from
``__init__``/annotation evidence, calls through a single-class-annotated
parameter, and calls on module-level singleton instances resolve to real
``module:method`` edges, only when exactly one class can be the receiver
(conflicting assignments poison the evidence). Edges that exist only
through typed resolution are kept in :attr:`ProgramDB.typed_edges`. The
concurrency pass (:mod:`.concurrency_check`) reads the same class model.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from stmgcn_tpu_torch.analysis.lint import _ModuleIndex

__all__ = ["ClassInfo", "ModuleEntry", "ProgramDB"]

#: re-export chains longer than this are a cycle, not a design
_MAX_ALIAS_DEPTH = 8

#: constructor dotted path -> synchronization-field kind
_SYNC_CTORS = {
    "threading.Lock": "lock",
    "threading.RLock": "lock",
    "threading.Condition": "condvar",
    "threading.Event": "event",
    "threading.Thread": "thread",
    "threading.Timer": "thread",
    "queue.Queue": "queue",
    "queue.LifoQueue": "queue",
    "queue.PriorityQueue": "queue",
    "queue.SimpleQueue": "queue",
}


def _dotted_expr(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name-rooted attribute chain; None otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _self_attr(node: ast.AST) -> Optional[str]:
    """``X`` when ``node`` is exactly ``self.X``; None otherwise."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


@dataclasses.dataclass
class ClassInfo:
    """One class: methods, ``self`` attributes, typed synchronization
    fields, and the attribute types that are unambiguous from
    ``__init__``/annotation evidence (the dispatch-resolution basis)."""

    qualname: str  # "module:Class"
    module: str
    name: str
    node: ast.ClassDef
    methods: Dict[str, ast.AST] = dataclasses.field(default_factory=dict)
    attrs: Set[str] = dataclasses.field(default_factory=set)
    locks: Set[str] = dataclasses.field(default_factory=set)
    #: condvar field -> owning lock field (None = owns its own lock)
    condvars: Dict[str, Optional[str]] = dataclasses.field(default_factory=dict)
    events: Set[str] = dataclasses.field(default_factory=set)
    queues: Set[str] = dataclasses.field(default_factory=set)
    #: thread field -> daemon flag (None = not statically knowable)
    threads: Dict[str, Optional[bool]] = dataclasses.field(default_factory=dict)
    #: attr -> "module:Class" — only when exactly one class is possible
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def sync_fields(self) -> Set[str]:
        return (
            self.locks
            | set(self.condvars)
            | self.events
            | self.queues
            | set(self.threads)
        )


@dataclasses.dataclass
class ModuleEntry:
    """One parsed module: source, tree, per-module index, import map."""

    name: str  # absolute dotted module name
    path: str  # repo-relative posix path (what findings report)
    source: str
    tree: ast.Module
    index: _ModuleIndex
    imports: Dict[str, str]  # local binding -> absolute dotted target
    is_package: bool  # an __init__.py


def _module_imports(
    tree: ast.Module, mod_name: str, is_package: bool
) -> Dict[str, str]:
    """Local name -> absolute dotted target, relative imports resolved."""
    out: Dict[str, str] = {}
    pkg_parts = mod_name.split(".") if is_package else mod_name.split(".")[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    # `import a.b.c` binds only `a` — and `a` names the
                    # top-level package, which resolve_symbol then walks
                    out[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                if not base and node.level > 0:
                    continue  # relative import above the package root
                prefix = ".".join(base + ([node.module] if node.module else []))
            else:
                prefix = node.module or ""
            if not prefix:
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{prefix}.{a.name}"
    return out


class ProgramDB:
    """Module graph + resolved aliases + global capture-reachability."""

    def __init__(
        self, entries: Dict[str, ModuleEntry], *, type_informed: bool = False
    ):
        self.modules = entries
        self.type_informed = type_informed
        self.roots: Set[str] = set()
        self.edges: Dict[str, Set[str]] = {}
        #: "module:Class" -> ClassInfo, for every class in every module
        self.classes: Dict[str, ClassInfo] = {}
        #: module -> {global name -> "module:Class"} singleton instances
        self._globals: Dict[str, Dict[str, str]] = {}
        #: (caller, callee) edges that exist only via typed resolution
        self.typed_edges: Set[Tuple[str, str]] = set()
        #: id(function node) -> the names it assigns or deletes
        self._bound: Dict[int, Set[str]] = {}
        self._build_classes()
        self._build_graph()
        self._reach: Optional[Dict[str, Tuple[str, ...]]] = None

    # -- construction ------------------------------------------------------
    @classmethod
    def from_root(
        cls,
        root: str,
        package: Optional[str] = None,
        *,
        type_informed: bool = False,
    ) -> "ProgramDB":
        """Parse every ``.py`` under ``root`` (a package directory)."""
        root_path = Path(root)
        package = package or root_path.name
        cwd = os.getcwd()
        entries: Dict[str, ModuleEntry] = {}
        for f in sorted(root_path.rglob("*.py")):
            rel_mod = f.relative_to(root_path)
            parts = [package] + list(rel_mod.parts[:-1])
            is_package = f.name == "__init__.py"
            if not is_package:
                parts.append(f.stem)
            name = ".".join(parts)
            rel = os.path.relpath(f, cwd)
            rel = f.as_posix() if rel.startswith("..") else Path(rel).as_posix()
            source = f.read_text()
            entry = cls._entry(name, rel, source, is_package)
            if entry is not None:
                entries[name] = entry
        return cls(entries, type_informed=type_informed)

    @classmethod
    def from_sources(
        cls, sources: Dict[str, str], *, type_informed: bool = False
    ) -> "ProgramDB":
        """Build from ``{dotted module name: source}`` (test fixtures)."""
        entries: Dict[str, ModuleEntry] = {}
        for name, src in sources.items():
            path = name.replace(".", "/") + ".py"
            entry = cls._entry(name, path, src, is_package=False)
            if entry is not None:
                entries[name] = entry
        return cls(entries, type_informed=type_informed)

    @staticmethod
    def _entry(
        name: str, path: str, source: str, is_package: bool
    ) -> Optional[ModuleEntry]:
        try:
            tree = ast.parse(source)
        except SyntaxError:
            return None  # the per-module lint reports unparseable files
        index = _ModuleIndex()
        index.visit(tree)
        return ModuleEntry(
            name=name,
            path=path,
            source=source,
            tree=tree,
            index=index,
            imports=_module_imports(tree, name, is_package),
            is_package=is_package,
        )

    # -- symbol resolution -------------------------------------------------
    def resolve_symbol(self, dotted: str, _depth: int = 0) -> Optional[str]:
        """Absolute dotted path -> ``module:function`` qualname, following
        re-export chains; None when it doesn't land on a known def."""
        if _depth > _MAX_ALIAS_DEPTH:
            return None
        parts = dotted.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:i])
            if mod not in self.modules:
                continue
            rest = parts[i:]
            if len(rest) != 1:
                return None  # attribute chain below a symbol: dynamic
            entry = self.modules[mod]
            sym = rest[0]
            if sym in entry.index.funcs:
                return f"{mod}:{sym}"
            if sym in entry.imports:
                return self.resolve_symbol(entry.imports[sym], _depth + 1)
            return None
        return None

    def _resolve_local(self, entry: ModuleEntry, dotted: str) -> Optional[str]:
        """Resolve a dotted expression rooted at one of ``entry``'s local
        bindings (``conv_mod.make_conv`` / imported ``make_conv``)."""
        root, _, rest = dotted.partition(".")
        target = entry.imports.get(root)
        if target is None:
            return None
        full = f"{target}.{rest}" if rest else target
        return self.resolve_symbol(full)

    # -- class modeling ----------------------------------------------------
    def _build_classes(self) -> None:
        # phase A: shells first, so cross-module class references resolve
        # whatever the module iteration order
        for name, entry in self.modules.items():
            for node in entry.tree.body:
                if isinstance(node, ast.ClassDef):
                    qual = f"{name}:{node.name}"
                    ci = ClassInfo(
                        qualname=qual, module=name, name=node.name, node=node
                    )
                    for item in node.body:
                        if isinstance(
                            item, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ):
                            ci.methods[item.name] = item
                    self.classes[qual] = ci
        # phase B: field analysis (needs resolve_class over the shells)
        for name, entry in self.modules.items():
            for qual, ci in list(self.classes.items()):
                if ci.module == name:
                    self._analyze_fields(entry, ci)
            self._globals[name] = self._module_globals(entry)

    def _abs_ctor(self, entry: ModuleEntry, func: ast.AST) -> Optional[str]:
        """Absolute dotted path of a call's constructor through the
        import map (``Condition`` -> ``threading.Condition``)."""
        d = _dotted_expr(func)
        if d is None:
            return None
        root, _, rest = d.partition(".")
        base = entry.imports.get(root, root)
        return f"{base}.{rest}" if rest else base

    def resolve_class(self, dotted: str, _depth: int = 0) -> Optional[str]:
        """Absolute dotted path -> ``module:Class`` qualname, following
        re-export chains; None when it doesn't land on a known class."""
        if _depth > _MAX_ALIAS_DEPTH:
            return None
        parts = dotted.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = ".".join(parts[:i])
            if mod not in self.modules:
                continue
            rest = parts[i:]
            if len(rest) != 1:
                return None
            sym = rest[0]
            if f"{mod}:{sym}" in self.classes:
                return f"{mod}:{sym}"
            imports = self.modules[mod].imports
            if sym in imports:
                return self.resolve_class(imports[sym], _depth + 1)
            return None
        return None

    def _annotation_class(
        self, entry: ModuleEntry, ann: Optional[ast.AST]
    ) -> Optional[str]:
        """``module:Class`` named by an annotation; ``Optional[X]``
        unwraps to ``X``; anything else ambiguous returns None."""
        if ann is None:
            return None
        if isinstance(ann, ast.Subscript):
            base = _dotted_expr(ann.value)
            if base and base.split(".")[-1] == "Optional":
                return self._annotation_class(entry, ann.slice)
            return None
        d = _dotted_expr(ann)
        if d is None:
            return None
        if "." not in d and f"{entry.name}:{d}" in self.classes:
            return f"{entry.name}:{d}"
        root, _, rest = d.partition(".")
        base = entry.imports.get(root)
        if base is None:
            return None
        return self.resolve_class(f"{base}.{rest}" if rest else base)

    def _called_class(
        self, entry: ModuleEntry, value: ast.AST
    ) -> Optional[str]:
        """``module:Class`` when ``value`` is a direct constructor call."""
        if not isinstance(value, ast.Call):
            return None
        d = self._abs_ctor(entry, value.func)
        if d is None or d in _SYNC_CTORS:
            return None
        if "." not in d and f"{entry.name}:{d}" in self.classes:
            return f"{entry.name}:{d}"
        return self.resolve_class(d)

    def _analyze_fields(self, entry: ModuleEntry, ci: ClassInfo) -> None:
        init = ci.methods.get("__init__")
        init_params: Dict[str, Optional[ast.AST]] = {}
        if init is not None:
            args = init.args
            for a in args.posonlyargs + args.args + args.kwonlyargs:
                init_params[a.arg] = a.annotation
        evidence: Dict[str, Set[str]] = {}  # attr -> candidate class quals
        poisoned: Set[str] = set()  # attrs with a non-None untyped (re)assign
        for mname, method in ci.methods.items():
            for node in ast.walk(method):
                targets: List[ast.AST] = []
                value: Optional[ast.AST] = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign):
                    targets, value = [node.target], node.value
                elif isinstance(node, ast.AugAssign):
                    targets = [node.target]
                for t in targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    ci.attrs.add(attr)
                    if isinstance(node, ast.AnnAssign):
                        t_cls = self._annotation_class(entry, node.annotation)
                        if t_cls is not None:
                            evidence.setdefault(attr, set()).add(t_cls)
                        if value is None:
                            continue
                    kind = (
                        _SYNC_CTORS.get(self._abs_ctor(entry, value.func))
                        if isinstance(value, ast.Call)
                        else None
                    )
                    if kind == "lock":
                        ci.locks.add(attr)
                    elif kind == "condvar":
                        owner = None
                        if value.args:
                            owner = _self_attr(value.args[0])
                        ci.condvars[attr] = owner
                    elif kind == "event":
                        ci.events.add(attr)
                    elif kind == "queue":
                        ci.queues.add(attr)
                    elif kind == "thread":
                        daemon: Optional[bool] = False
                        for kw in value.keywords:
                            if kw.arg == "daemon":
                                daemon = (
                                    kw.value.value
                                    if isinstance(kw.value, ast.Constant)
                                    and isinstance(kw.value.value, bool)
                                    else None
                                )
                        ci.threads[attr] = daemon
                    else:
                        t_cls = self._called_class(entry, value)
                        if t_cls is None and (
                            mname == "__init__"
                            and isinstance(value, ast.Name)
                            and value.id in init_params
                        ):
                            t_cls = self._annotation_class(
                                entry, init_params[value.id]
                            )
                        if t_cls is not None:
                            evidence.setdefault(attr, set()).add(t_cls)
                        elif not (
                            isinstance(value, ast.Constant)
                            and value.value is None
                        ):
                            # a real untyped (re)assignment: the attribute's
                            # class is no longer unambiguous (None keeps the
                            # Optional[field] idiom typed)
                            poisoned.add(attr)
        for attr, cands in evidence.items():
            if len(cands) == 1 and attr not in poisoned:
                ci.attr_types[attr] = next(iter(cands))

    def _module_globals(self, entry: ModuleEntry) -> Dict[str, str]:
        """Module-level ``NAME = SomeClass()`` singleton instances."""
        out: Dict[str, str] = {}
        for node in entry.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            t_cls = self._called_class(entry, node.value)
            if t_cls is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = t_cls
        return out

    def instance_type(
        self, entry: ModuleEntry, name: str, _depth: int = 0
    ) -> Optional[str]:
        """``module:Class`` of a bare name that statically names a
        module-level singleton (local or imported); None otherwise."""
        if _depth > _MAX_ALIAS_DEPTH:
            return None
        local = self._globals.get(entry.name, {}).get(name)
        if local is not None:
            return local
        dotted = entry.imports.get(name)
        if dotted is None:
            return None
        mod, _, sym = dotted.rpartition(".")
        if mod in self.modules:
            target = self._globals.get(mod, {}).get(sym)
            if target is not None:
                return target
            if sym in self.modules[mod].imports:
                return self.instance_type(self.modules[mod], sym, _depth + 1)
        return None

    def receiver_type(
        self,
        entry: ModuleEntry,
        cls_qual: Optional[str],
        fn_node: Optional[ast.AST],
        recv: ast.AST,
    ) -> Optional[str]:
        """``module:Class`` of a call receiver expression, using only
        unambiguous evidence: ``self`` inside a known class, ``self.attr``
        with a single-class attr type, a single-class-annotated parameter
        of the enclosing function (unless locally reassigned), or a
        module-level singleton instance."""
        if isinstance(recv, ast.Name):
            if recv.id == "self":
                return cls_qual
            if fn_node is not None:
                args = fn_node.args
                for a in args.posonlyargs + args.args + args.kwonlyargs:
                    if a.arg == recv.id:
                        if a.annotation is None or self._locally_bound(
                            fn_node, recv.id
                        ):
                            return None
                        return self._annotation_class(entry, a.annotation)
                if self._locally_bound(fn_node, recv.id):
                    return None
            return self.instance_type(entry, recv.id)
        attr = _self_attr(recv)
        if attr is not None and cls_qual is not None:
            ci = self.classes.get(cls_qual)
            if ci is not None:
                return ci.attr_types.get(attr)
        return None

    def _locally_bound(self, fn_node: ast.AST, name: str) -> bool:
        """Whether ``fn_node`` assigns or deletes ``name`` (the names are
        collected once per function)."""
        bound = self._bound.get(id(fn_node))
        if bound is None:
            bound = self._bound[id(fn_node)] = {
                sub.id for sub in ast.walk(fn_node)
                if isinstance(sub, ast.Name) and isinstance(sub.ctx, (ast.Store, ast.Del))}
        return name in bound

    def typed_method_target(
        self,
        entry: ModuleEntry,
        cls_qual: Optional[str],
        fn_node: Optional[ast.AST],
        call: ast.Call,
    ) -> Optional[Tuple[str, str]]:
        """``("module:Class", method)`` for ``obj.m(...)`` when the
        receiver's class is unambiguous and defines ``m``; else None."""
        if not isinstance(call.func, ast.Attribute):
            return None
        t = self.receiver_type(entry, cls_qual, fn_node, call.func.value)
        if t is None:
            return None
        ci = self.classes.get(t)
        if ci is None or call.func.attr not in ci.methods:
            return None
        return t, call.func.attr

    # -- the global graph --------------------------------------------------
    def _build_graph(self) -> None:
        # register every def first — edge targets must exist before any
        # module's walker runs, whatever the module iteration order
        for name, entry in self.modules.items():
            for fn in entry.index.funcs:
                self.edges.setdefault(f"{name}:{fn}", set())
            for root_fn in entry.index.seeds():
                self.roots.add(f"{name}:{root_fn}")
        for entry in self.modules.values():
            _GraphWalker(self, entry).visit(entry.tree)

    def global_reachability(self) -> Dict[str, Tuple[str, ...]]:
        """``qualname -> root→...→qualname chain`` for every globally
        capture-reachable function (roots map to one-element chains)."""
        if self._reach is not None:
            return self._reach
        parent: Dict[str, Optional[str]] = {}
        seen: Set[str] = set()
        frontier: List[str] = []
        for r in sorted(self.roots):
            if r in self.edges:  # root must be a known def
                seen.add(r)
                parent[r] = None
                frontier.append(r)
        while frontier:
            q = frontier.pop()
            for callee in sorted(self.edges.get(q, ())):
                if callee not in seen:
                    seen.add(callee)
                    parent[callee] = q
                    frontier.append(callee)
        out: Dict[str, Tuple[str, ...]] = {}
        for q in seen:
            chain: List[str] = []
            cur: Optional[str] = q
            while cur is not None:
                chain.append(cur)
                cur = parent[cur]
            out[q] = tuple(reversed(chain))
        self._reach = out
        return out

    # -- lint integration views --------------------------------------------
    def module_extras(
        self, mod_name: str
    ) -> Dict[str, Tuple[str, ...]]:
        """Functions of ``mod_name`` that are globally capture-reachable but
        invisible to the per-module pass, with their call chains."""
        entry = self.modules[mod_name]
        local = entry.index.reachable()
        out: Dict[str, Tuple[str, ...]] = {}
        for q, chain in self.global_reachability().items():
            mod, _, fn = q.partition(":")
            if mod == mod_name and fn not in local:
                out[fn] = chain
        return out

    def cross_module_gain(self) -> Dict[str, Tuple[str, ...]]:
        """Every globally reachable qualname the per-module pass misses."""
        out: Dict[str, Tuple[str, ...]] = {}
        for mod_name in self.modules:
            for fn, chain in self.module_extras(mod_name).items():
                out[f"{mod_name}:{fn}"] = chain
        return out


class _GraphWalker(ast.NodeVisitor):
    """Per-module sweep adding this module's edges to the global graph.

    Same attribution discipline as the local index (calls belong to the
    innermost enclosing def), but callees resolve through the import map
    first; only unresolved names fall back to same-module by-name edges.
    """

    def __init__(self, db: ProgramDB, entry: ModuleEntry):
        self.db = db
        self.entry = entry
        self._stack: List[str] = []
        self._fn_nodes: List[ast.AST] = []
        self._cls: List[str] = []

    def _handle_func(self, node) -> None:
        self._stack.append(node.name)
        self._fn_nodes.append(node)
        self.generic_visit(node)
        self._fn_nodes.pop()
        self._stack.pop()

    visit_FunctionDef = _handle_func
    visit_AsyncFunctionDef = _handle_func

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._cls.append(f"{self.entry.name}:{node.name}")
        self.generic_visit(node)
        self._cls.pop()

    def _add_edge(self, callee_q: str) -> None:
        if self._stack and callee_q in self.db.edges:
            caller_q = f"{self.entry.name}:{self._stack[-1]}"
            self.db.edges.setdefault(caller_q, set()).add(callee_q)

    def visit_Call(self, node: ast.Call) -> None:
        entry = self.entry
        target: Optional[str] = None
        if isinstance(node.func, ast.Name):
            name = node.func.id
            if name in entry.imports:
                target = self.db.resolve_symbol(entry.imports[name])
            if target is None and name in entry.index.funcs:
                target = f"{entry.name}:{name}"
        elif isinstance(node.func, ast.Attribute):
            dotted = entry.index.dotted(node.func)
            if dotted:
                target = self._resolve_dotted(dotted)
            if target is None and node.func.attr in entry.index.funcs:
                # self.foo() / unknown-object attr: the per-module rule
                target = f"{entry.name}:{node.func.attr}"
        if target is not None:
            self._add_edge(target)

        # opt-in type-informed dispatch: obj.m() resolves through the
        # class model when the receiver class is unambiguous; edges that
        # only exist this way are recorded apart (typed_edges)
        if self.db.type_informed and isinstance(node.func, ast.Attribute):
            tm = self.db.typed_method_target(
                entry,
                self._cls[-1] if self._cls else None,
                self._fn_nodes[-1] if self._fn_nodes else None,
                node,
            )
            if tm is not None:
                callee_q = f"{tm[0].split(':', 1)[0]}:{tm[1]}"
                if callee_q != target and self._stack:
                    caller_q = f"{entry.name}:{self._stack[-1]}"
                    if callee_q in self.db.edges and callee_q not in (
                        self.db.edges.get(caller_q, set())
                    ):
                        self.db.typed_edges.add((caller_q, callee_q))
                    self._add_edge(callee_q)

        # an *imported* function handed to a capture becomes a global root —
        # the seed no per-module index can plant
        if node.args and entry.index.is_capture_wrapper(node.func):
            self._seed_imported(ast.walk(node.args[0]))
        self.generic_visit(node)

    def visit_With(self, node) -> None:
        # an imported function called in a captured block is a root too
        if any(self.entry.index.is_capture_context(item) for item in node.items):
            self._seed_imported(sub.func for stmt in node.body for sub in ast.walk(stmt)
                                if isinstance(sub, ast.Call))
        self.generic_visit(node)

    def _seed_imported(self, nodes) -> None:
        for sub in nodes:
            if isinstance(sub, ast.Name) and sub.id in self.entry.imports:
                q = self.db.resolve_symbol(self.entry.imports[sub.id])
                if q is not None:
                    self.db.roots.add(q)

    def _resolve_dotted(self, dotted: str) -> Optional[str]:
        q = self.db.resolve_symbol(dotted)
        if q is not None:
            return q
        return self.db._resolve_local(self.entry, dotted)
