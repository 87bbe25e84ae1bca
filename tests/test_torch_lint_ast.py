"""The port's whole-program AST lint (``stmgcn_tpu_torch/analysis/lint.py``
and ``program_db.py``).

- ``ProgramDB`` gives the JAX database's answers on shared fixture
  sources, given to ``from_sources`` in both packages: ``resolve_symbol``
  and ``resolve_class`` through re-export chains, the class model's fields
  (``tests/test_analysis.py`` ``TestClassModel``'s fixtures), the typed
  edges, and ``global_reachability`` with its chains, each fixture marking
  its roots for both (``jax.jit``/``lax.scan`` for the JAX package,
  ``CapturedProgram``/``GraphPool.capture`` for the port);
- each AST rule's fire/pass pair on small sources: a readback in a body
  handed to ``CapturedProgram`` fires and the same call outside it is
  clean, a ``with torch.cuda.graph`` block, the control-flow, timing and
  axis-name rules, a cross-module chain, bare and ruled suppressions and
  ``include_suppressed``, an unparseable file;
- the shipped tree: the trainer's, the serving engine's and the continual
  loop's captured bodies are roots by name, ``lint_package()`` is clean
  (its suppressions are the ones ``CHANGES.md`` lists), per module too;
- the CLI's ``paths``, ``--no-contracts``, ``--no-whole-program``,
  ``--include-suppressed`` and exit codes, and one full ``lint`` in a
  subprocess within the JAX lint's 60 s budget.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import time

import pytest

from stmgcn_tpu.analysis.program_db import ProgramDB as JaxDB
from stmgcn_tpu_torch.analysis import lint as port_lint
from stmgcn_tpu_torch.analysis.lint import lint_package, lint_paths, lint_source
from stmgcn_tpu_torch.analysis.program_db import ProgramDB
from stmgcn_tpu_torch.analysis.report import render_json
from stmgcn_tpu_torch.cli import main


def _src(text):
    return textwrap.dedent(text)


# -- ProgramDB against the JAX database ----------------------------------------------

#: shared fixtures: each marks its roots for both packages
DB_FIXTURES = {
    "cross-module": {
        "pkg.model": _src("""
            import jax
            from stmgcn_tpu_torch.graphs import CapturedProgram
            from pkg.helpers import readback

            def step(x):
                return readback(x)

            def build(pool):
                jax.jit(step)
                return CapturedProgram(step, {}, pool)
            """),
        "pkg.helpers": "def readback(x):\n    return float(x)\n",
    },
    "reexport": {
        "pkg.ops": "from pkg.ops_impl import make\n",
        "pkg.ops_impl": "def make():\n    return 1\n",
        "pkg.user": _src("""
            import jax
            from pkg.ops import make
            from stmgcn_tpu_torch.graphs import Program

            def step(x):
                return make()

            def build(ops):
                jax.jit(step)
                return Program(step, {}, ops)
            """),
    },
    "imported-root": {
        "pkg.body": "def body(c, x):\n    return c, float(x)\n",
        "pkg.runner": _src("""
            import jax
            from pkg.body import body

            def run(xs, pool):
                jax.lax.scan(body, 0, xs)
                return pool.capture(body)
            """),
    },
    "dynamic-dispatch": {
        "pkg.a": _src("""
            import jax

            def step(obj):
                return obj.readback(1)

            def build(pool):
                jax.jit(step)
                pool.capture(step)
            """),
        "pkg.b": "def readback(x):\n    return float(x)\n",
    },
    "class-model": {
        "pkg.m": _src("""
            import threading
            import queue

            class Stats:
                def __init__(self):
                    self.n = 0

                def record(self):
                    self.n += 1

            class Engine:
                def __init__(self, poll):
                    self._lock = threading.Lock()
                    self._cond = threading.Condition(self._lock)
                    self._q = queue.Queue()
                    self._t = threading.Thread(target=self._run, daemon=True)
                    self._stats = Stats()
                    self._w = None

                def go(self):
                    self._w = threading.Thread(target=self.go)
                    self._stats.record()

                def attach(self, other):
                    self._other = Stats()
                    self._other = other

                def _run(self):
                    pass

            ENGINE = Engine(1)
            """),
        "pkg.user": _src("""
            from pkg.m import ENGINE, Stats

            def poke():
                ENGINE.go()
            """),
    },
}


def _db_view(db):
    classes = {q: (sorted(c.methods), sorted(c.attrs), sorted(c.locks), c.condvars,
                   sorted(c.events), sorted(c.queues), c.threads, c.attr_types)
               for q, c in db.classes.items()}
    return {"roots": db.roots, "edges": db.edges, "typed": db.typed_edges,
            "reach": db.global_reachability(), "classes": classes,
            "extras": {m: db.module_extras(m) for m in db.modules},
            "imports": {m: e.imports for m, e in db.modules.items()}}


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("name", sorted(DB_FIXTURES))
def test_program_db_answers_as_jax(name, typed):
    srcs = DB_FIXTURES[name]
    got = _db_view(ProgramDB.from_sources(srcs, type_informed=typed))
    want = _db_view(JaxDB.from_sources(srcs, type_informed=typed))
    assert got == want


def test_program_db_fixture_answers():
    db = ProgramDB.from_sources(DB_FIXTURES["cross-module"])
    assert db.module_extras("pkg.helpers") == {
        "readback": ("pkg.model:step", "pkg.helpers:readback")}
    db = ProgramDB.from_sources(DB_FIXTURES["reexport"])
    assert db.resolve_symbol("pkg.ops.make") == "pkg.ops_impl:make"
    assert "pkg.ops_impl:make" in db.global_reachability()
    db = ProgramDB.from_sources(DB_FIXTURES["imported-root"])
    assert db.roots == {"pkg.body:body"}
    assert ProgramDB.from_sources(DB_FIXTURES["dynamic-dispatch"]).module_extras("pkg.b") == {}
    db = ProgramDB.from_sources(DB_FIXTURES["class-model"], type_informed=True)
    for qual in ("pkg.m:Engine", "pkg.m:Stats"):
        assert db.resolve_class(qual.replace(":", ".")) == qual
        assert JaxDB.from_sources(DB_FIXTURES["class-model"]).resolve_class(
            qual.replace(":", ".")) == qual
    eng = db.classes["pkg.m:Engine"]
    assert (eng.locks, eng.condvars, eng.queues) == ({"_lock"}, {"_cond": "_lock"}, {"_q"})
    assert eng.threads == {"_t": True, "_w": False}
    assert eng.attr_types == {"_stats": "pkg.m:Stats"}  # _other poisoned
    assert ("pkg.user:poke", "pkg.m:go") in db.typed_edges


# -- the AST rules: fire/pass pairs ------------------------------------------------

CAPTURED = _src("""
    import numpy as np
    import torch
    from stmgcn_tpu_torch.graphs import CapturedProgram

    def build(pool, x):
        def body(v):
            return CALL
        return CapturedProgram(body, {}, pool)

    def outside(x):
        return CALL
    """)


@pytest.mark.parametrize("call", ["v['x'].item()", "v['x'].cpu()", "v['x'].tolist()",
                                  "v['x'].numpy()", "float(v['x'].sum())",
                                  "np.asarray(v['x'])", "torch.cuda.synchronize()"])
def test_host_sync_in_a_captured_body_fires_and_outside_is_clean(call):
    src = CAPTURED.replace("CALL", call, 1).replace("CALL", call.replace("v['x']", "x"))
    f = lint_source(src, "m.py")
    assert [(x.rule, x.line) for x in f] == [("host-sync-in-jit", 8)]
    assert "capture-reachable `body`" in f[0].message and f[0].severity == "error"
    clean = src.replace("CapturedProgram(body", "CapturedProgram.eager(body")
    assert lint_source(clean, "m.py") == []


def test_roots_by_wrapper_and_by_name():
    cases = {
        "Program(body, {}, ops)": True,
        "pool.capture(lambda: body(v))": True,
        "run(body)": False,
        "CapturedProgram(spec, body)": False,  # only the first argument is captured
    }
    for wrap, fires in cases.items():
        src = _src(f"""
            import torch

            def body(v):
                return v.item()

            def build(pool, ops, v, spec):
                return {wrap}
            """)
        assert bool(lint_source(src, "m.py")) == fires, wrap


def test_a_captured_with_block_and_its_callees():
    src = _src("""
        import torch

        def helper(x):
            return x.item()

        def unrelated(x):
            return x.item()

        def capture(g, x):
            with torch.cuda.graph(g):
                y = helper(x)
                z = x.tolist()
            return x.cpu(), y, z
        """)
    f = lint_source(src, "m.py")
    assert sorted((x.rule, x.line) for x in f) == [("host-sync-in-jit", 5),
                                                   ("host-sync-in-jit", 13)]
    assert any("captured `with torch.cuda.graph` block in `capture`" in x.message for x in f)


@pytest.mark.parametrize("test,fires", [
    ("torch.isnan(v).any()", True), ("v.any()", True), ("(v > 0).all()", True),
    ("torch.equal(v, v)", True), ("torch.is_nonzero(v)", True),
    ("torch.is_grad_enabled()", False), ("torch.cuda.is_current_stream_capturing()", False),
    ("torch.distributed.get_rank() == 0", False), ("np.any(w)", False), ("flag", False),
])
def test_traced_control_flow(test, fires):
    src = _src(f"""
        import numpy as np
        import torch

        def body(v, w, flag):
            if {test}:
                return v
            while {test}:
                break
            return v

        def build(pool):
            return pool.capture(body)
        """)
    f = lint_source(src, "m.py")
    assert [(x.rule, x.line) for x in f] == (
        [("traced-control-flow", 6), ("traced-control-flow", 8)] if fires else [])
    if fires:
        assert "device value" in f[0].message and "`if`" in f[0].message


@pytest.mark.parametrize("dispatch,fence,fires", [
    ("prog.replay()", "", True), ("engine.train_batch(b)", "", True),
    ("fc.predict(h)", "", True), ("opt.apply(s)", "", True), ("t.block_step(b)", "", True),
    ("prog.replay()", "torch.cuda.synchronize()", False),
    ("prog.replay()", "out.item()", False), ("prog.replay()", "end.synchronize()", False),
    ("prog.replay()", "ms = start.elapsed_time(end)", False),
    ("prog.replay()", "fence(out)", False), ("build(x)", "", False),
])
def test_unfenced_timing(dispatch, fence, fires):
    src = _src(f"""
        import time
        import torch
        from stmgcn_tpu_torch.utils.profiling import fence

        def timed(prog, engine, fc, opt, t, b, h, s, x, out, start, end):
            t0 = time.perf_counter()
            {dispatch}
            {fence}
            return time.perf_counter() - t0
        """)
    f = lint_source(src, "m.py")
    assert [(x.rule, x.severity) for x in f] == ([("unfenced-timing", "warning")] if fires else [])


@pytest.mark.parametrize("call,fires", [
    ('comm.all_reduce(t, "regoin", mesh)', True), ('comm.all_reduce(t, "region", mesh)', False),
    ('comm.all_gather(t, "world", mesh)', False), ('comm.all_gather(t, "dpp", mesh, dim=1)', True),
    ('comm.reduce_scatter(t, axis="brnch", mesh=mesh)', True),
    ('comm.ring_exchange(a, b, "ring", mesh)', True), ('comm.ring_exchange(a, b, "region", mesh)',
                                                       False),
    ('comm.broadcast(t, mesh, axis="all")', True), ('comm.all_reduce(t, axis, mesh)', False),
    ('all_reduce(t, "nodes", mesh)', True), ('other.all_reduce(t, "nodes", mesh)', False),
])
def test_partition_axis_name(call, fires):
    src = _src(f"""
        from stmgcn_tpu_torch.utils import comm
        from stmgcn_tpu_torch.utils.comm import all_reduce

        def f(t, a, b, mesh, axis, other):
            return {call}
        """)
    f = lint_source(src, "m.py")
    assert [x.rule for x in f] == (["partition-axis-name"] if fires else [])


def test_mesh_axes_are_the_meshs():
    from stmgcn_tpu_torch.parallel.mesh import AXES

    assert port_lint.MESH_AXES == AXES


# -- the whole-program chain, suppressions, unparseable files -----------------------

def test_cross_module_chain_and_its_suppression():
    srcs = DB_FIXTURES["cross-module"]
    db = ProgramDB.from_sources(srcs)
    extras = db.module_extras("pkg.helpers")
    f = lint_source(srcs["pkg.helpers"], "pkg/helpers.py", extra_reachable=extras)
    assert [x.rule for x in f] == ["host-sync-in-jit"]
    assert f[0].chain == ("pkg.model:step", "pkg.helpers:readback")
    assert "(cross-module)" in f[0].message
    assert lint_source(srcs["pkg.helpers"], "pkg/helpers.py") == []  # per module: invisible
    for mark, gone in (("  # stmgcn: ignore[host-sync-in-jit]", True),
                       ("  # stmgcn: ignore", True),
                       ("  # stmgcn: ignore[unguarded-attr]", False),
                       ("  # stmgcn: ignore[traced-control-flow, host-sync-in-jit]", True)):
        src = srcs["pkg.helpers"].replace("return float(x)", "return float(x)" + mark)
        assert (lint_source(src, "pkg/helpers.py", extra_reachable=extras) == []) == gone, mark
        f = lint_source(src, "pkg/helpers.py", extra_reachable=extras, include_suppressed=True)
        assert len(f) == 1 and f[0].suppressed == gone
    payload = json.loads(render_json(f))  # the last mark's: suppressed
    assert payload["errors"] == 0 and payload["findings"][0]["suppressed"] is True


def test_an_unparseable_file(tmp_path):
    (f,) = lint_source("def broken(:\n    pass\n", "bad.py")
    assert (f.rule, f.severity, f.path, f.line) == ("unparseable-module", "error", "bad.py", 1)
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "ok.py").write_text("def f(x):\n    return x\n")
    (pkg / "bad.py").write_text("def broken(:\n")
    assert [x.rule for x in lint_paths([str(pkg)])] == ["unparseable-module"]
    for whole in (True, False):
        got = lint_package(str(pkg), whole_program=whole)
        assert [(x.rule, x.path.endswith("pkg/bad.py")) for x in got] == [
            ("unparseable-module", True)]


# -- the shipped tree ------------------------------------------------------------

@pytest.fixture(scope="module")
def tree_db():
    return ProgramDB.from_root(port_lint.package_root(), type_informed=True)


#: the shipped tree's suppressions, as ``CHANGES.md`` lists them: (file,
#: rule) -> count
SUPPRESSED = {
    ("stmgcn_tpu_torch/ops/spmm.py", "host-sync-in-jit"): 1,
    ("stmgcn_tpu_torch/train/step.py", "host-sync-in-jit"): 1,
    ("stmgcn_tpu_torch/serving/bench.py", "unfenced-timing"): 4,
}


def test_the_captured_bodies_are_roots_by_name(tree_db):
    pkg = "stmgcn_tpu_torch"
    for root in ("train.trainer:body", "serving.engine:body", "train.continual:body"):
        assert f"{pkg}.{root}" in tree_db.roots
    reach = tree_db.global_reachability()
    assert reach[f"{pkg}.train.step:train_step"] == (f"{pkg}.train.trainer:body",
                                                     f"{pkg}.train.step:train_step")
    assert reach[f"{pkg}.serving.engine:forward"][0] == f"{pkg}.serving.engine:body"
    gain = tree_db.cross_module_gain()
    assert f"{pkg}.train.step:masked_loss" in gain
    for q, chain in gain.items():
        assert chain[-1] == q and len(chain) >= 2


def test_the_tree_lints_clean(tree_db, monkeypatch):
    monkeypatch.chdir(os.path.dirname(port_lint.package_root()))
    assert lint_package(db=tree_db) == []
    got = lint_package(db=tree_db, include_suppressed=True)
    counts = {}
    for f in got:
        assert f.suppressed
        counts[f.path, f.rule] = counts.get((f.path, f.rule), 0) + 1
    assert counts == SUPPRESSED
    assert lint_package(whole_program=False) == []


# -- the CLI ---------------------------------------------------------------------

@pytest.fixture
def small_pkg(tmp_path, monkeypatch):
    """A two-module package standing in for the shipped one (the CLI's
    default target), with one error and one warning."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "model.py").write_text(_src("""
        from pkg.helpers import readback

        def body(v):
            return readback(v)

        def build(pool):
            return pool.capture(body)
        """))
    (pkg / "helpers.py").write_text(_src("""
        import time

        def readback(x):
            return x.item()

        def timed(prog):
            t0 = time.perf_counter()
            prog.replay()
            return time.perf_counter() - t0
        """))
    monkeypatch.setattr(port_lint, "package_root", lambda: str(pkg))
    monkeypatch.chdir(tmp_path)
    return pkg


def _run(capsys, *argv):
    rc = main(["lint", "--format", "json", *argv])
    out = capsys.readouterr()
    return rc, json.loads(out.out), out.err


def test_cli_flags_and_exit_codes(small_pkg, capsys, monkeypatch):
    from stmgcn_tpu_torch import analysis

    rc, rep, err = _run(capsys, "--no-contracts")
    assert rc == 1 and (rep["errors"], rep["warnings"]) == (1, 1)
    assert sorted((f["rule"], f["path"], f["chain"]) for f in rep["findings"]) == [
        ("host-sync-in-jit", "pkg/helpers.py", ["pkg.model:body", "pkg.helpers:readback"]),
        ("unfenced-timing", "pkg/helpers.py", [])]
    assert "program database of 3 modules, 0 classes" in err
    # per module: the cross-module readback is invisible, no database is built
    rc, rep, err = _run(capsys, "--no-contracts", "--no-whole-program")
    assert rc == 0 and [f["rule"] for f in rep["findings"]] == ["unfenced-timing"]
    assert err == ""
    # paths: the AST rules alone, never the config passes
    monkeypatch.setattr(analysis, "run_passes", lambda configs=None: 1 / 0)
    rc, rep, _ = _run(capsys, str(small_pkg / "helpers.py"))
    assert rc == 0 and [f["rule"] for f in rep["findings"]] == ["unfenced-timing"]
    with pytest.raises(ZeroDivisionError):
        main(["lint", "--no-whole-program"])
    capsys.readouterr()
    # suppressed: listed with --include-suppressed, never counted
    helpers = small_pkg / "helpers.py"
    helpers.write_text(helpers.read_text().replace("x.item()", "x.item()  # stmgcn: ignore"))
    rc, rep, _ = _run(capsys, "--no-contracts", "--include-suppressed")
    assert rc == 0 and (rep["errors"], rep["warnings"]) == (0, 1)
    assert [(f["rule"], f["suppressed"]) for f in rep["findings"]] == [
        ("host-sync-in-jit", True), ("unfenced-timing", False)]
    rc, rep, _ = _run(capsys, "--no-contracts")
    assert rc == 0 and [f["rule"] for f in rep["findings"]] == ["unfenced-timing"]
    assert main(["lint", "--preset", "nope"]) == 2


def test_rules_are_listed(capsys):
    assert main(["lint", "--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("collective-shape", "spmd-shard-footprint", "spmd-collective-manifest",
                 "spmd-wire-budget", "unguarded-attr", "lock-order-cycle",
                 "condvar-discipline", "thread-lifecycle", "host-sync-in-jit",
                 "traced-control-flow", "unfenced-timing", "partition-axis-name"):
        assert rule in out


def test_full_lint_within_the_jax_budget():
    """One full ``lint`` (whole-program AST, concurrency, every config
    pass on every preset) in a fresh process, within the JAX lint's 60 s
    (``tests/test_analysis.py`` ``TestLintWallTime``)."""
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "stmgcn_tpu_torch.cli", "lint", "--format",
                           "json"], capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "PYTHONPATH": "."},
                          cwd=os.path.dirname(port_lint.package_root()))
    elapsed = time.monotonic() - t0
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout) == {"version": 3, "errors": 0, "warnings": 0,
                                       "findings": []}
    modules, classes = map(int, re.search(r"database of (\d+) modules, (\d+) classes",
                                          proc.stderr).groups())
    assert modules > 80 and classes > 100
    assert elapsed < 60.0, f"lint took {elapsed:.1f}s"
