"""The port's static concurrency pass (``stmgcn_tpu_torch/analysis/
concurrency_check.py``) against the JAX package's.

- each rule's fire/pass pair on ``tests/test_analysis.py``
  ``TestConcurrencyRules``' fixtures (an unguarded read, a condvar wait
  outside ``while`` and a notify outside its lock, a started thread never
  joined, a sleep under a lock, a two-module lock-order cycle through the
  class model's singletons), each with findings equal to the JAX pass's
  (rule, severity, path, line, column, chain and message), and the
  suppression cases of ``TestConcurrencySuppression``;
- the blocking calls the port adds (``torch.cuda.synchronize()``, an
  event's or stream's ``.synchronize()``, the tensor readbacks) fire under
  a lock and not outside one, where the JAX pass stays silent;
- the pass over ``stmgcn_tpu_torch/`` (type-informed and not, suppressed
  findings included) equals the JAX pass over the same tree, except the
  findings that come only from those torch blocking calls, which the test
  names (none on the shipped tree).
"""

import textwrap

import pytest

from stmgcn_tpu.analysis.concurrency_check import check_concurrency as jax_check
from stmgcn_tpu.analysis.program_db import ProgramDB as JaxDB
from stmgcn_tpu_torch.analysis.concurrency_check import check_concurrency
from stmgcn_tpu_torch.analysis.lint import package_root
from stmgcn_tpu_torch.analysis.program_db import ProgramDB
from stmgcn_tpu_torch.analysis.rules import RULES


def _src(text):
    return textwrap.dedent(text)


def _line_of(src, snippet):
    hits = [i for i, ln in enumerate(src.splitlines(), 1) if snippet in ln]
    assert len(hits) == 1, (snippet, hits)
    return hits[0]


def _rec(f):
    return (f.rule, f.severity, f.path, f.line, f.col, tuple(f.chain), f.message, f.suppressed)


def _both(sources, typed=True, **kw):
    """``(port findings, JAX findings)`` over the same sources."""
    got = check_concurrency(ProgramDB.from_sources(sources, type_informed=typed), **kw)
    want = jax_check(JaxDB.from_sources(sources, type_informed=typed), **kw)
    return got, want


UNGUARDED = _src("""
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._n = 0

        def bump(self):
            with self._lock:
                self._n += 1

        def read(self):
            return self._n
    """)

CONDVAR = _src("""
    import threading

    class Q:
        def __init__(self):
            self._lock = threading.Lock()
            self._cond = threading.Condition(self._lock)
            self._items = []

        def put(self, x):
            with self._cond:
                self._items.append(x)
                self._cond.notify()

        def get_good(self):
            with self._cond:
                while not self._items:
                    self._cond.wait()
                return self._items.pop()
    """)

THREAD = _src("""
    import threading
    import time

    class Worker:
        def __init__(self):
            self._t = threading.Thread(target=self._run)

        def start(self):
            self._t.start()

        def _run(self):
            pass
    """)

SLEEPER = _src("""
    import threading
    import time

    class Sleeper:
        def __init__(self):
            self._lock = threading.Lock()

        def nap(self):
            with self._lock:
                time.sleep(1)
    """)

CYCLE_A = _src("""
    import threading

    from pkg.b import OTHER

    class A:
        def __init__(self):
            self._lock = threading.Lock()

        def poke(self):
            with self._lock:
                pass

        def cross(self):
            with self._lock:
                OTHER.poke()

    ROOT = A()
    """)

CYCLE_B = _src("""
    import threading

    from pkg.a import ROOT

    class B:
        def __init__(self):
            self._lock = threading.Lock()

        def poke(self):
            with self._lock:
                pass

        def cross(self):
            with self._lock:
                ROOT.poke()

    OTHER = B()
    """)

LOCAL_THREADS = _src("""
    import threading

    def fire_and_forget(fn):
        t = threading.Thread(target=fn)
        t.start()

    def fan_out(fn):
        ts = [threading.Thread(target=fn) for _ in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    """)

#: name -> (sources, [(rule, file, snippet of the reported line)])
CASES = {
    "unguarded-read": ({"pkg.box": UNGUARDED},
                       [("unguarded-attr", "pkg.box", "return self._n")]),
    "guarded-twin": ({"pkg.box": UNGUARDED.replace(
        "def read(self):\n        return self._n",
        "def read(self):\n        with self._lock:\n            return self._n")}, []),
    "wait-outside-while": ({"pkg.q": CONDVAR.replace(
        "            while not self._items:\n                self._cond.wait()",
        "            self._cond.wait()  # BAD")}, [("condvar-discipline", "pkg.q", "# BAD")]),
    "notify-outside-lock": ({"pkg.q": CONDVAR.replace(
        "    def put(self, x):",
        "    def kick(self):\n        self._cond.notify()  # BAD\n\n    def put(self, x):")},
        [("condvar-discipline", "pkg.q", "# BAD")]),
    "condvar-twin": ({"pkg.q": CONDVAR}, []),
    "thread-never-joined": ({"pkg.w": THREAD}, [("thread-lifecycle", "pkg.w", "self._t.start()")]),
    "daemon-twin": ({"pkg.w": THREAD.replace("threading.Thread(target=self._run)",
                                             "threading.Thread(target=self._run, daemon=True)")},
                    []),
    "joined-twin": ({"pkg.w": THREAD.replace(
        "    def _run(self):", "    def stop(self):\n        self._t.join()\n\n    def _run(self):")},
        []),
    "sleep-under-lock": ({"pkg.s": SLEEPER}, [("thread-lifecycle", "pkg.s", "time.sleep(1)")]),
    "lock-order-cycle": ({"pkg.a": CYCLE_A, "pkg.b": CYCLE_B},
                         [("lock-order-cycle", "pkg.a", "OTHER.poke()")]),
    "consistent-order-twin": ({"pkg.a": CYCLE_A, "pkg.b": CYCLE_B.replace(
        "    def cross(self):\n        with self._lock:\n            ROOT.poke()",
        "    def cross(self):\n        ROOT.poke()")}, []),
    "local-threads": ({"pkg.l": LOCAL_THREADS},
                      [("thread-lifecycle", "pkg.l", "t = threading.Thread(target=fn)")]),
}


@pytest.mark.parametrize("typed", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_fires_as_jax(case, typed):
    sources, want = CASES[case]
    got, jax_got = _both(sources, typed)
    assert [_rec(f) for f in got] == [_rec(f) for f in jax_got]
    assert [(f.rule, f.path, f.line) for f in got] == [
        (rule, mod.replace(".", "/") + ".py", _line_of(sources[mod], snippet))
        for rule, mod, snippet in want]
    assert all(f.severity == "error" for f in got)


def test_chains_and_messages():
    (f,) = check_concurrency(ProgramDB.from_sources({"pkg.box": UNGUARDED}))
    assert f.chain == ("pkg.box:Box.bump", "pkg.box:Box.read")
    assert "`self._n`" in f.message and "`self._lock`" in f.message
    (f,) = check_concurrency(ProgramDB.from_sources({"pkg.a": CYCLE_A, "pkg.b": CYCLE_B},
                                                    type_informed=True))
    assert f.chain == ("pkg.a:A.cross", "pkg.b:B.cross")
    assert "pkg.a:A._lock -> pkg.b:B._lock -> pkg.a:A._lock" in f.message
    for rule in ("unguarded-attr", "lock-order-cycle", "condvar-discipline", "thread-lifecycle"):
        assert RULES[rule].severity == "error"


@pytest.mark.parametrize("where,gone", [("return self._n", True), ("self._n += 1", False)])
def test_suppression_at_the_reported_line_as_jax(where, gone):
    src = UNGUARDED.replace(where, where + "  # stmgcn: ignore[unguarded-attr]")
    got, want = _both({"pkg.box": src})
    assert [_rec(f) for f in got] == [_rec(f) for f in want]
    assert (got == []) == gone
    got, want = _both({"pkg.box": src}, include_suppressed=True)
    assert [_rec(f) for f in got] == [_rec(f) for f in want]
    assert [(f.rule, f.suppressed) for f in got] == [("unguarded-attr", gone)]


TORCH_BLOCKING = _src("""
    import threading

    import torch

    class Syncer:
        def __init__(self, event):
            self._lock = threading.Lock()
            self._event = event
            self._out = None

        def under_lock(self, out, stream):
            with self._lock:
                CALL

        def outside(self, out, stream):
            CALL
    """)


@pytest.mark.parametrize("call,what", [
    ("torch.cuda.synchronize()", "torch.cuda.synchronize() device sync"),
    ("self._event.synchronize()", ".synchronize() device sync"),
    ("stream.synchronize()", ".synchronize() device sync"),
    ("out.item()", ".item() device readback"), ("out.cpu()", ".cpu() device readback"),
    ("self._out.tolist()", ".tolist() device readback"),
    ("out.numpy()", ".numpy() device readback"),
])
def test_the_ports_blocking_calls_under_a_lock(call, what):
    src = TORCH_BLOCKING.replace("CALL", call)
    got, want = _both({"pkg.sync": src})
    assert want == []  # the JAX pass knows none of them
    assert [(f.rule, f.line) for f in got] == [("thread-lifecycle", 14)]
    assert f"blocking call {what} in `Syncer.under_lock` while holding `_lock`" in got[0].message
    assert check_concurrency(ProgramDB.from_sources(
        {"pkg.sync": src.replace("with self._lock:", "if True:")})) == []


def test_readbacks_with_arguments_are_not_syncs():
    src = TORCH_BLOCKING.replace("CALL", "out.cpu(non_blocking=True)")
    assert check_concurrency(ProgramDB.from_sources({"pkg.sync": src})) == []


#: findings of the port's pass over its own tree that come only from the
#: torch blocking calls, ``(path, line)``: none on the shipped tree
TORCH_ONLY: set = set()


@pytest.fixture(scope="module")
def tree():
    """The port's tree in both packages' databases, each built once:
    ``tree(cls, typed)``."""
    built = {}

    def db(cls, typed):
        if (cls, typed) not in built:
            built[cls, typed] = cls.from_root(package_root(), type_informed=typed)
        return built[cls, typed]

    return db


@pytest.mark.parametrize("typed", [True, False])
def test_the_tree_equals_the_jax_pass(tree, typed):
    got = check_concurrency(tree(ProgramDB, typed), include_suppressed=True)
    want = jax_check(tree(JaxDB, typed), include_suppressed=True)
    extra = {(f.path, f.line) for f in got} - {(f.path, f.line) for f in want}
    assert extra == TORCH_ONLY
    assert sorted(_rec(f) for f in got if (f.path, f.line) not in TORCH_ONLY) == sorted(
        _rec(f) for f in want)
    assert [f for f in got if not f.suppressed] == []


def test_the_tree_class_model_as_jax(tree):
    db, jdb = tree(ProgramDB, True), tree(JaxDB, True)
    assert db.typed_edges == jdb.typed_edges and len(db.typed_edges) >= 10
    assert set(db.classes) == set(jdb.classes)
    for qual, ci in db.classes.items():
        j = jdb.classes[qual]
        assert (ci.locks, ci.condvars, ci.events, ci.queues, ci.threads, ci.attr_types) == (
            j.locks, j.condvars, j.events, j.queues, j.threads, j.attr_types), qual
    mb = db.classes["stmgcn_tpu_torch.serving.microbatch:MicroBatcher"]
    assert mb.locks == {"_lock"} and mb.condvars == {"_cond": "_lock", "_done": "_lock"}
    assert mb.threads == {"_worker": True}
