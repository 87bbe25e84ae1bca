"""Static concurrency analysis over the program database.

A copy of ``stmgcn_tpu/analysis/concurrency_check.py``. The port's serving,
observability and training stacks are threaded: the micro-batcher's two
condvars, the checkpoint watcher, the async checkpoint writer, the
prefetcher, the graph pools' locks and the process-wide metrics registry
all rely on hand-written lock discipline. This pass checks it statically,
using :class:`~.program_db.ProgramDB`'s class model (lock, condvar, event,
thread and queue fields recognized from their constructors, plus
type-informed dispatch). Four rules, repo-wide:

- ``unguarded-attr``: an attribute written under ``with self._lock`` in
  one method and read or written lock-free in another method of the same
  class; the finding carries the guarding writer -> lock-free access
  chain. Lock context propagates through private helpers called *only*
  with the lock held (a fixpoint over intra-class call sites).
- ``lock-order-cycle``: a global lock-acquisition-order graph across
  modules, an edge ``A -> B`` whenever ``B`` can be acquired while ``A``
  is held, through resolved cross-class calls too; any cycle.
- ``condvar-discipline``: ``Condition.wait()`` outside a ``while``
  predicate loop, ``wait``/``notify`` without the condvar's owning lock.
- ``thread-lifecycle``: a non-daemon ``Thread`` started without a
  reachable ``join()``/``cancel()``, and any blocking call made while
  holding a lock: ``queue.get/put``, ``time.sleep``, ``Thread.join``,
  ``Event.wait``, and the device syncs. Where the JAX pass lists
  ``block_until_ready`` and ``jax.device_get``, the port adds its own:
  ``torch.cuda.synchronize()``, a CUDA event's or stream's
  ``.synchronize()``, and the tensor readbacks ``.item()``, ``.cpu()``,
  ``.tolist()`` and ``.numpy()``, on any receiver but ``self`` itself.
  ``Condition.wait()`` is exempt for its owning lock, which it releases.

Everything fires only on evidence the class model proves: unknown
receiver types, non-constant ``daemon=`` flags and threads that escape
their function are skipped, never guessed. Suppression is the lint's
``# stmgcn: ignore[rule-id]`` on the *reported* line (for a cross-method
finding, the offending access, not the guarding writer).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from stmgcn_tpu_torch.analysis.lint import _apply_suppressions, _suppressions
from stmgcn_tpu_torch.analysis.program_db import (
    ClassInfo,
    ModuleEntry,
    ProgramDB,
    _dotted_expr,
    _self_attr,
)
from stmgcn_tpu_torch.analysis.report import Finding
from stmgcn_tpu_torch.analysis.rules import RULES

__all__ = ["check_concurrency"]

#: absolute dotted calls that block the calling thread
_BLOCKING_CALLS = {
    "time.sleep": "time.sleep()",
    "jax.block_until_ready": "jax.block_until_ready() device sync",
    "jax.device_get": "jax.device_get() device readback",
    "torch.cuda.synchronize": "torch.cuda.synchronize() device sync",
}

#: tensor methods that copy to the host, waiting for the device
_READBACKS = ("item", "cpu", "tolist", "numpy")


def _device_sync(node: ast.Call) -> Optional[str]:
    """The port's device syncs by method name: a CUDA event's or stream's
    ``.synchronize()`` and the tensor readbacks (no arguments)."""
    m = node.func.attr
    if m == "synchronize":
        return ".synchronize() device sync"
    if m in _READBACKS and not node.args and not node.keywords:
        return f".{m}() device readback"
    return None

#: method calls that mutate their receiver in place — a write for
#: guarded-by purposes (``self._pending.append(...)``)
_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "remove", "discard", "add", "clear", "update",
    "setdefault", "sort", "reverse",
}


@dataclasses.dataclass
class _Access:
    attr: str
    write: bool
    line: int
    col: int
    held: Tuple[str, ...]
    method: str


@dataclasses.dataclass
class _Acquire:
    lock: str
    held: Tuple[str, ...]
    line: int
    col: int
    method: str


@dataclasses.dataclass
class _CallSite:
    owner: str  # "module:Class" of the callee
    method: str
    held: Tuple[str, ...]
    line: int
    col: int
    from_method: str


@dataclasses.dataclass
class _CondOp:
    field: str
    op: str  # "wait" | "notify"
    in_while: bool
    held: Tuple[str, ...]
    line: int
    col: int
    method: str


@dataclasses.dataclass
class _Blocking:
    what: str
    held: Tuple[str, ...]
    line: int
    col: int
    method: str


@dataclasses.dataclass
class _ClassFacts:
    ci: ClassInfo
    entry: ModuleEntry
    accesses: List[_Access] = dataclasses.field(default_factory=list)
    acquires: List[_Acquire] = dataclasses.field(default_factory=list)
    calls: List[_CallSite] = dataclasses.field(default_factory=list)
    cond_ops: List[_CondOp] = dataclasses.field(default_factory=list)
    blocking: List[_Blocking] = dataclasses.field(default_factory=list)
    #: thread field -> (line, col, method) of its .start()
    starts: Dict[str, Tuple[int, int, str]] = dataclasses.field(
        default_factory=dict
    )
    joins: Set[str] = dataclasses.field(default_factory=set)
    #: method -> locks guaranteed held on entry (call-site fixpoint)
    inherited: Dict[str, frozenset] = dataclasses.field(default_factory=dict)

    def lock_id(self, field: str) -> str:
        """Normalized lock identity: condvars map to their owning lock."""
        owner = field
        if field in self.ci.condvars:
            owner = self.ci.condvars[field] or field
        return f"{self.ci.qualname}.{owner}"

    def held_for(self, method: str, held: Tuple[str, ...]) -> frozenset:
        return frozenset(held) | self.inherited.get(method, frozenset())


class _MethodWalker:
    """One method's sweep: attribute accesses, lock acquisitions, calls,
    condvar ops, and blocking calls — each tagged with the syntactic
    with-lock context it happens under. Nested defs/lambdas run later,
    so their bodies are walked with an *empty* held set."""

    def __init__(
        self, db: ProgramDB, facts: _ClassFacts, method: str, fn_node
    ):
        self.db = db
        self.facts = facts
        self.method = method
        self.fn_node = fn_node
        self.held: List[str] = []
        self.while_depth = 0

    # -- recording helpers -------------------------------------------------
    def _tagged(self) -> Tuple[str, ...]:
        return tuple(self.held)

    def _access(self, attr: str, write: bool, node: ast.AST) -> None:
        ci = self.facts.ci
        if attr in ci.sync_fields or attr not in ci.attrs:
            return
        self.facts.accesses.append(
            _Access(
                attr=attr, write=write, line=node.lineno,
                col=node.col_offset + 1, held=self._tagged(),
                method=self.method,
            )
        )

    # -- the walk ----------------------------------------------------------
    def walk(self, node: ast.AST) -> None:
        handler = getattr(self, f"_walk_{type(node).__name__}", None)
        if handler is not None:
            handler(node)
        else:
            for child in ast.iter_child_nodes(node):
                self.walk(child)

    def walk_body(self) -> None:
        for stmt in self.fn_node.body:
            self.walk(stmt)

    def _walk_With(self, node) -> None:
        acquired = 0
        for item in node.items:
            field = _self_attr(item.context_expr)
            ci = self.facts.ci
            if field is not None and (
                field in ci.locks or field in ci.condvars
            ):
                lid = self.facts.lock_id(field)
                self.facts.acquires.append(
                    _Acquire(
                        lock=lid, held=self._tagged(),
                        line=item.context_expr.lineno,
                        col=item.context_expr.col_offset + 1,
                        method=self.method,
                    )
                )
                self.held.append(lid)
                acquired += 1
            else:
                self.walk(item.context_expr)
        for stmt in node.body:
            self.walk(stmt)
        for _ in range(acquired):
            self.held.pop()

    _walk_AsyncWith = _walk_With

    def _walk_While(self, node: ast.While) -> None:
        self.walk(node.test)
        self.while_depth += 1
        for stmt in node.body:
            self.walk(stmt)
        self.while_depth -= 1
        for stmt in node.orelse:
            self.walk(stmt)

    def _nested_def(self, node) -> None:
        # runs later, on some other stack: no lock is held at entry
        saved_held, saved_while = self.held, self.while_depth
        self.held, self.while_depth = [], 0
        for child in ast.iter_child_nodes(node):
            self.walk(child)
        self.held, self.while_depth = saved_held, saved_while

    _walk_FunctionDef = _nested_def
    _walk_AsyncFunctionDef = _nested_def
    _walk_Lambda = _nested_def

    def _write_target(self, target: ast.AST) -> None:
        attr = _self_attr(target)
        if attr is not None:
            self._access(attr, True, target)
            return
        if isinstance(target, ast.Subscript):
            attr = _self_attr(target.value)
            if attr is not None:
                self._access(attr, True, target)
            else:
                self.walk(target.value)
            self.walk(target.slice)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._write_target(elt)
        elif isinstance(target, ast.Starred):
            self._write_target(target.value)
        elif isinstance(target, ast.Attribute):
            self.walk(target.value)

    def _walk_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._write_target(t)
        self.walk(node.value)

    def _walk_AugAssign(self, node: ast.AugAssign) -> None:
        self._write_target(node.target)
        self.walk(node.value)

    def _walk_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._write_target(node.target)
            self.walk(node.value)

    def _walk_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._write_target(t)

    def _walk_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is None:
            self.walk(node.value)
            return
        ci = self.facts.ci
        if attr in ci.methods:
            # property read / bound-method reference: executes the method
            self.facts.calls.append(
                _CallSite(
                    owner=ci.qualname, method=attr, held=self._tagged(),
                    line=node.lineno, col=node.col_offset + 1,
                    from_method=self.method,
                )
            )
            return
        self._access(attr, False, node)

    def _walk_Call(self, node: ast.Call) -> None:
        self._handle_call(node)
        for arg in node.args:
            self.walk(arg)
        for kw in node.keywords:
            self.walk(kw.value)

    def _handle_call(self, node: ast.Call) -> None:
        func = node.func
        facts, ci, entry = self.facts, self.facts.ci, self.facts.entry
        held = self._tagged()
        line, col = func.lineno, func.col_offset + 1
        if not isinstance(func, ast.Attribute):
            # plain name call: blocking only via an imported binding
            if isinstance(func, ast.Name):
                what = _BLOCKING_CALLS.get(entry.imports.get(func.id, ""))
                if what is not None:
                    facts.blocking.append(
                        _Blocking(what, held, line, col, self.method)
                    )
            else:
                self.walk(func)
            return

        m = func.attr
        recv_field = _self_attr(func.value)
        if recv_field is not None:
            if recv_field in ci.condvars:
                if m in ("wait", "wait_for"):
                    facts.cond_ops.append(
                        _CondOp(
                            field=recv_field, op="wait",
                            in_while=self.while_depth > 0 or m == "wait_for",
                            held=held, line=line, col=col,
                            method=self.method,
                        )
                    )
                elif m in ("notify", "notify_all"):
                    facts.cond_ops.append(
                        _CondOp(
                            field=recv_field, op="notify", in_while=False,
                            held=held, line=line, col=col,
                            method=self.method,
                        )
                    )
            elif recv_field in ci.locks:
                if m == "acquire":
                    facts.acquires.append(
                        _Acquire(
                            lock=facts.lock_id(recv_field), held=held,
                            line=line, col=col, method=self.method,
                        )
                    )
            elif recv_field in ci.threads:
                if m == "start":
                    facts.starts.setdefault(
                        recv_field, (line, col, self.method)
                    )
                elif m in ("join", "cancel"):
                    facts.joins.add(recv_field)
                    if m == "join":
                        facts.blocking.append(
                            _Blocking(
                                "Thread.join()", held, line, col, self.method
                            )
                        )
            elif recv_field in ci.events:
                if m == "wait":
                    facts.blocking.append(
                        _Blocking(
                            "Event.wait()", held, line, col, self.method
                        )
                    )
            elif recv_field in ci.queues:
                if m in ("get", "put", "join"):
                    facts.blocking.append(
                        _Blocking(
                            f"queue .{m}()", held, line, col, self.method
                        )
                    )
            else:
                # a plain attribute receiver: a read — or a write when
                # the call mutates the receiver in place — plus a
                # resolved cross-class call when the attr's class is known
                self._access(recv_field, m in _MUTATORS, func.value)
                what = _device_sync(node)
                if what is not None:
                    facts.blocking.append(_Blocking(what, held, line, col, self.method))
                t = ci.attr_types.get(recv_field)
                if t is not None:
                    target_ci = self.db.classes.get(t)
                    if target_ci is not None and m in target_ci.methods:
                        facts.calls.append(
                            _CallSite(
                                owner=t, method=m, held=held, line=line,
                                col=col, from_method=self.method,
                            )
                        )
            return

        if isinstance(func.value, ast.Name) and func.value.id == "self":
            if m in ci.methods:
                facts.calls.append(
                    _CallSite(
                        owner=ci.qualname, method=m, held=held, line=line,
                        col=col, from_method=self.method,
                    )
                )
            return

        # non-self receiver: device sync by method name, module-level
        # blocking calls by dotted path, typed resolution for the rest
        if m == "block_until_ready":
            facts.blocking.append(
                _Blocking(
                    ".block_until_ready() device sync", held, line, col,
                    self.method,
                )
            )
        dotted = _dotted_expr(func)
        what = None
        if dotted is not None:
            root, _, rest = dotted.partition(".")
            absd = entry.imports.get(root, root) + (f".{rest}" if rest else "")
            what = _BLOCKING_CALLS.get(absd)
            if what is not None:
                facts.blocking.append(
                    _Blocking(what, held, line, col, self.method)
                )
        # the port's syncs by method name, where no dotted entry named it
        sync = _device_sync(node) if what is None else None
        if sync is not None:
            facts.blocking.append(_Blocking(sync, held, line, col, self.method))
        tm = self.db.typed_method_target(
            entry, ci.qualname, self.fn_node, node
        )
        if tm is not None:
            facts.calls.append(
                _CallSite(
                    owner=tm[0], method=tm[1], held=held, line=line,
                    col=col, from_method=self.method,
                )
            )
        self.walk(func.value)


def _collect_class_facts(db: ProgramDB) -> Dict[str, _ClassFacts]:
    out: Dict[str, _ClassFacts] = {}
    for qual, ci in db.classes.items():
        entry = db.modules[ci.module]
        facts = _ClassFacts(ci=ci, entry=entry)
        for mname, mnode in ci.methods.items():
            _MethodWalker(db, facts, mname, mnode).walk_body()
        _propagate_held(facts)
        out[qual] = facts
    return out


def _propagate_held(facts: _ClassFacts) -> None:
    """Fixpoint: a private method called *only* with lock L held inherits
    L. Public methods never inherit (external callers are unknown)."""
    sites: Dict[str, List[Tuple[str, frozenset]]] = {}
    for c in facts.calls:
        if c.owner == facts.ci.qualname:
            sites.setdefault(c.method, []).append(
                (c.from_method, frozenset(c.held))
            )
    inherited = {m: frozenset() for m in facts.ci.methods}
    for _ in range(len(facts.ci.methods) + 2):
        changed = False
        for m in facts.ci.methods:
            if not m.startswith("_") or m.startswith("__"):
                continue
            m_sites = sites.get(m)
            if not m_sites:
                continue
            eff: Optional[frozenset] = None
            for caller, held in m_sites:
                s = held | inherited.get(caller, frozenset())
                eff = s if eff is None else (eff & s)
            eff = eff or frozenset()
            if eff != inherited[m]:
                inherited[m] = eff
                changed = True
        if not changed:
            break
    facts.inherited = inherited


def _emit(
    findings: List[Finding],
    rule: str,
    entry: ModuleEntry,
    line: int,
    col: int,
    message: str,
    chain: tuple = (),
) -> None:
    findings.append(
        Finding(
            rule=rule, path=entry.path, line=line, col=col, message=message,
            severity=RULES[rule].severity, chain=chain,
        )
    )


def _check_unguarded(
    facts: _ClassFacts, findings: List[Finding]
) -> None:
    ci = facts.ci
    if not ci.locks and not ci.condvars:
        return
    guards: Dict[str, Set[str]] = {}
    guard_writer: Dict[str, Tuple[str, int]] = {}
    for a in facts.accesses:
        if a.method == "__init__" or not a.write:
            continue
        eff = facts.held_for(a.method, a.held)
        if eff:
            guards.setdefault(a.attr, set()).update(eff)
            guard_writer.setdefault(a.attr, (a.method, a.line))
    for a in facts.accesses:
        if a.method == "__init__":
            continue
        locks = guards.get(a.attr)
        if not locks:
            continue
        if facts.held_for(a.method, a.held) & locks:
            continue
        writer, wline = guard_writer[a.attr]
        lock_names = ", ".join(
            sorted(lock.rsplit(".", 1)[-1] for lock in locks)
        )
        kind = "written" if a.write else "read"
        _emit(
            findings, "unguarded-attr", facts.entry, a.line, a.col,
            f"attribute `self.{a.attr}` of `{ci.name}` is written under "
            f"`self.{lock_names}` (in `{writer}`, line {wline}) but {kind} "
            f"lock-free in `{a.method}` — a data race; guard the access or "
            "document + suppress the lock-free protocol",
            chain=(
                f"{ci.qualname}.{writer}",
                f"{ci.qualname}.{a.method}",
            ),
        )


def _check_condvars(facts: _ClassFacts, findings: List[Finding]) -> None:
    ci = facts.ci
    for op in facts.cond_ops:
        owner = facts.lock_id(op.field)
        eff = facts.held_for(op.method, op.held)
        if op.op == "wait":
            if not op.in_while:
                _emit(
                    findings, "condvar-discipline", facts.entry, op.line,
                    op.col,
                    f"`self.{op.field}.wait()` in `{ci.name}.{op.method}` "
                    "is not inside a `while` predicate loop — spurious "
                    "wakeups and missed notifies silently break the "
                    "protocol; re-test the predicate in a while loop",
                    chain=(f"{ci.qualname}.{op.method}",),
                )
            if owner not in eff:
                _emit(
                    findings, "condvar-discipline", facts.entry, op.line,
                    op.col,
                    f"`self.{op.field}.wait()` in `{ci.name}.{op.method}` "
                    f"without holding its owning lock "
                    f"`{owner.rsplit('.', 1)[-1]}` — raises RuntimeError "
                    "at runtime",
                    chain=(f"{ci.qualname}.{op.method}",),
                )
            extra = eff - {owner}
            if extra:
                names = ", ".join(sorted(x.rsplit(".", 1)[-1] for x in extra))
                _emit(
                    findings, "thread-lifecycle", facts.entry, op.line,
                    op.col,
                    f"`self.{op.field}.wait()` in `{ci.name}.{op.method}` "
                    f"blocks while still holding `{names}` — wait() only "
                    "releases its owning lock; any other lock held across "
                    "it starves every contender",
                    chain=(f"{ci.qualname}.{op.method}",),
                )
        else:  # notify
            if owner not in eff:
                _emit(
                    findings, "condvar-discipline", facts.entry, op.line,
                    op.col,
                    f"`self.{op.field}.{'notify'}()` in "
                    f"`{ci.name}.{op.method}` outside the owning lock "
                    f"`{owner.rsplit('.', 1)[-1]}` — raises RuntimeError "
                    "at runtime (and the woken waiter races the predicate)",
                    chain=(f"{ci.qualname}.{op.method}",),
                )


def _check_thread_fields(
    facts: _ClassFacts, findings: List[Finding]
) -> None:
    ci = facts.ci
    for field, (line, col, method) in facts.starts.items():
        daemon = ci.threads.get(field)
        if daemon is not False:  # daemon or not statically knowable
            continue
        if field in facts.joins:
            continue
        _emit(
            findings, "thread-lifecycle", facts.entry, line, col,
            f"non-daemon thread `self.{field}` of `{ci.name}` is started "
            f"in `{method}` but no method ever joins or cancels it — "
            "process shutdown hangs on it; join it, make it daemon, or "
            "add a stop path",
            chain=(f"{ci.qualname}.{method}",),
        )
    for b in facts.blocking:
        eff = facts.held_for(b.method, b.held)
        if not eff:
            continue
        names = ", ".join(sorted(x.rsplit(".", 1)[-1] for x in eff))
        _emit(
            findings, "thread-lifecycle", facts.entry, b.line, b.col,
            f"blocking call {b.what} in `{ci.name}.{b.method}` while "
            f"holding `{names}` — every contender stalls for the full "
            "blocking duration; move the call outside the critical "
            "section",
            chain=(f"{ci.qualname}.{b.method}",),
        )


def _check_lock_order(
    db: ProgramDB,
    all_facts: Dict[str, _ClassFacts],
    findings: List[Finding],
) -> None:
    # transitive closure of locks each method can acquire
    direct: Dict[str, Set[str]] = {}
    calls: Dict[str, List[_CallSite]] = {}
    for qual, facts in all_facts.items():
        for a in facts.acquires:
            direct.setdefault(f"{qual}.{a.method}", set()).add(a.lock)
        for c in facts.calls:
            calls.setdefault(f"{qual}.{c.from_method}", []).append(c)

    closure_memo: Dict[str, Set[str]] = {}

    def closure(mk: str, seen: frozenset) -> Set[str]:
        if mk in closure_memo:
            return closure_memo[mk]
        if mk in seen:
            return set()
        out = set(direct.get(mk, ()))
        for c in calls.get(mk, ()):
            out |= closure(f"{c.owner}.{c.method}", seen | {mk})
        if not seen:  # memo only complete (non-cycle-truncated) results
            closure_memo[mk] = out
        return out

    # edges: lock A held while lock B is acquired (directly or via calls)
    edges: Dict[str, Set[str]] = {}
    sites: Dict[Tuple[str, str], Tuple[str, int, int, str]] = {}

    def add_edge(
        src: str, dst: str, entry: ModuleEntry, line: int, col: int,
        method_qual: str,
    ) -> None:
        if src == dst:
            return
        edges.setdefault(src, set()).add(dst)
        edges.setdefault(dst, set())
        sites.setdefault((src, dst), (entry.path, line, col, method_qual))

    for qual, facts in all_facts.items():
        for a in facts.acquires:
            eff = facts.held_for(a.method, a.held)
            for l in eff:
                add_edge(
                    l, a.lock, facts.entry, a.line, a.col,
                    f"{qual}.{a.method}",
                )
        for c in facts.calls:
            eff = facts.held_for(c.from_method, c.held)
            if not eff:
                continue
            for l2 in closure(f"{c.owner}.{c.method}", frozenset()):
                for l in eff:
                    add_edge(
                        l, l2, facts.entry, c.line, c.col,
                        f"{qual}.{c.from_method}",
                    )

    # cycle extraction: DFS with a gray stack; canonicalize by rotation
    color: Dict[str, int] = {n: 0 for n in edges}
    stack: List[str] = []
    seen_cycles: Set[Tuple[str, ...]] = set()

    def dfs(n: str) -> None:
        color[n] = 1
        stack.append(n)
        for m in sorted(edges.get(n, ())):
            if color.get(m, 0) == 0:
                dfs(m)
            elif color.get(m) == 1:
                cyc = stack[stack.index(m):]
                k = min(range(len(cyc)), key=lambda j: cyc[j])
                canon = tuple(cyc[k:] + cyc[:k])
                if canon in seen_cycles:
                    continue
                seen_cycles.add(canon)
                edge_pairs = [
                    (canon[i], canon[(i + 1) % len(canon)])
                    for i in range(len(canon))
                ]
                path, line, col, _ = sites[edge_pairs[0]]
                entry = next(
                    e for e in (
                        f.entry for f in all_facts.values()
                    ) if e.path == path
                )
                order = " -> ".join(canon + (canon[0],))
                legs = "; ".join(
                    f"`{dst}` acquired under `{src}` at "
                    f"{sites[(src, dst)][0]}:{sites[(src, dst)][1]}"
                    for src, dst in edge_pairs
                )
                _emit(
                    findings, "lock-order-cycle", entry, line, col,
                    f"lock acquisition order cycle {order} — two threads "
                    f"taking the locks in opposite orders deadlock ({legs})",
                    chain=tuple(sites[p][3] for p in edge_pairs),
                )
        stack.pop()
        color[n] = 2

    for n in sorted(edges):
        if color.get(n, 0) == 0:
            dfs(n)


class _LocalThreads(ast.NodeVisitor):
    """Function-local thread lifecycle: a non-daemon Thread/Timer bound
    to a local name (directly or inside a list) and started must have a
    ``join()``/``cancel()`` somewhere in the function — through the name
    itself or a for-loop alias over the list. Threads that escape (are
    returned, yielded, or passed to another call) are skipped."""

    def __init__(self, db: ProgramDB, entry: ModuleEntry):
        self.db = db
        self.entry = entry
        #: var -> (daemon, line, col)
        self.threads: Dict[str, Tuple[Optional[bool], int, int]] = {}
        self.aliases: Dict[str, str] = {}  # for-target -> collection var
        self.started: Set[str] = set()
        self.joined: Set[str] = set()
        self.escaped: Set[str] = set()

    def _ctor_daemon(self, call: ast.Call) -> Optional[Tuple[Optional[bool]]]:
        """(daemon,) when ``call`` constructs a Thread/Timer, else None."""
        d = _dotted_expr(call.func)
        if d is None:
            return None
        root, _, rest = d.partition(".")
        absd = self.entry.imports.get(root, root) + (
            f".{rest}" if rest else ""
        )
        if absd not in ("threading.Thread", "threading.Timer"):
            return None
        daemon: Optional[bool] = False
        for kw in call.keywords:
            if kw.arg == "daemon":
                daemon = (
                    kw.value.value
                    if isinstance(kw.value, ast.Constant)
                    and isinstance(kw.value.value, bool)
                    else None
                )
        return (daemon,)

    def _thread_ctor_in(self, value: ast.AST) -> Optional[Tuple[Optional[bool]]]:
        """A thread constructor directly, in a list literal, or as a
        list-comprehension element."""
        if isinstance(value, ast.Call):
            return self._ctor_daemon(value)
        if isinstance(value, (ast.List, ast.Tuple)):
            for elt in value.elts:
                if isinstance(elt, ast.Call):
                    got = self._ctor_daemon(elt)
                    if got is not None:
                        return got
        if isinstance(value, ast.ListComp) and isinstance(
            value.elt, ast.Call
        ):
            return self._ctor_daemon(value.elt)
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        got = self._thread_ctor_in(node.value)
        if got is not None:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.threads[t.id] = (
                        got[0], node.value.lineno, node.value.col_offset + 1
                    )
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        if isinstance(node.target, ast.Name) and isinstance(
            node.iter, ast.Name
        ):
            base = self.aliases.get(node.iter.id, node.iter.id)
            if base in self.threads:
                self.aliases[node.target.id] = base
        self.generic_visit(node)

    def _base(self, name: str) -> Optional[str]:
        base = self.aliases.get(name, name)
        return base if base in self.threads else None

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and isinstance(
            func.value, ast.Name
        ):
            base = self._base(func.value.id)
            if base is not None:
                if func.attr == "start":
                    self.started.add(base)
                elif func.attr in ("join", "cancel"):
                    self.joined.add(base)
                elif func.attr == "append":
                    # collection.append(Thread(...)) — stays tracked
                    pass
        # a thread handed to another call escapes local analysis
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Name):
                base = self._base(arg.id)
                if base is not None:
                    self.escaped.add(base)
        self.generic_visit(node)

    def _escape(self, node) -> None:
        if node.value is not None:
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name):
                    base = self._base(sub.id)
                    if base is not None:
                        self.escaped.add(base)
        self.generic_visit(node)

    visit_Return = _escape
    visit_Yield = _escape

    def findings(self, findings: List[Finding]) -> None:
        for var in sorted(self.started - self.joined - self.escaped):
            daemon, line, col = self.threads[var]
            if daemon is not False:
                continue
            _emit(
                findings, "thread-lifecycle", self.entry, line, col,
                f"non-daemon thread `{var}` is started but never joined "
                "or cancelled in this function — the process cannot exit "
                "while it runs; join it or pass daemon=True",
            )


def _check_local_threads(
    db: ProgramDB, entry: ModuleEntry, findings: List[Finding]
) -> None:
    for node in entry.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            lt = _LocalThreads(db, entry)
            lt.visit(node)
            lt.findings(findings)
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    lt = _LocalThreads(db, entry)
                    lt.visit(item)
                    lt.findings(findings)


def check_concurrency(
    db: Optional[ProgramDB] = None, *, include_suppressed: bool = False
) -> List[Finding]:
    """Run the four concurrency rules repo-wide over ``db`` (built from the
    ``stmgcn_tpu_torch`` package when omitted). Suppressions apply at each
    finding's reported line, exactly as in the AST lint."""
    if db is None:
        from stmgcn_tpu_torch.analysis.lint import package_root

        db = ProgramDB.from_root(package_root(), type_informed=True)

    findings: List[Finding] = []
    all_facts = _collect_class_facts(db)
    for facts in all_facts.values():
        _check_unguarded(facts, findings)
        _check_condvars(facts, findings)
        _check_thread_fields(facts, findings)
    _check_lock_order(db, all_facts, findings)
    for entry in db.modules.values():
        _check_local_threads(db, entry, findings)
    # suppression: the reported line governs, mirroring lint_source
    return _apply_suppressions(
        findings, {e.path: _suppressions(e.source) for e in db.modules.values()},
        include_suppressed)
