"""The contract pass over the port's traced step programs
(``stmgcn_tpu_torch/analysis/programs.py``, ``program_check.py``), against
the JAX contract pass (``stmgcn_tpu/analysis/jaxpr_check.py``; its tests
are ``tests/test_analysis.py``'s ``TestContractChecks`` and
``TestRebaseline``, mirrored here):

- each rule fires on a seeded fault (a float64 cast, a float64 constant, a
  node count over budget) and names the port's source line of the node;
- the shipped tree is clean on the CPU route: 13 programs, every node
  count under its budget, and the only suppressed findings the float64
  node pooling's, on its annotated lines;
- ``--rebaseline`` rewrites a temporary copy of each literal (the traced
  route's entry, the other route's kept), in the CLI too;
- tracing leaves every parameter, gradient and moment bit for bit as it
  was, and runs no kernel and no plain version (the operators' fake
  implementations answer);
- ``torch.library.opcheck`` passes for each kernel operator's CPU
  implementation in each form (B1-B5).

One traced registry per process (``traced_programs``' cache) serves the
file.
"""

import copy
import importlib
import json
import math
import os

import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

import stmgcn_tpu_torch.analysis.precision_check as pc
import stmgcn_tpu_torch.analysis.program_check as prc
from stmgcn_tpu_torch.analysis import contract_pass, programs
from stmgcn_tpu_torch.analysis.cli import main
from stmgcn_tpu_torch.analysis.dtype_flow import flow_program, program_flows
from stmgcn_tpu_torch.analysis.programs import PROGRAMS, kernel_nodes, traced_programs
from stmgcn_tpu_torch.analysis.rules import RULES
from stmgcn_tpu_torch.ops.tiling import plan_tiling

torch.set_num_threads(1)

FL = importlib.import_module("stmgcn_tpu_torch.ops.fused_lstm")
SP = importlib.import_module("stmgcn_tpu_torch.ops.spmm")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOLING = "stmgcn_tpu_torch/models/cg_lstm.py"


def _flow(fn, *tensors, name="toy"):
    return flow_program(name, make_fx(fn, tracing_mode="fake")(*tensors))


def _rules(findings):
    return {f.rule for f in findings}


# -- the rules on seeded faults ------------------------------------------------------

def test_primitive_budget_fires():
    flow = _flow(lambda x: torch.sin(torch.cos(x)) + x, torch.ones(4))
    assert flow.node_count >= 3
    findings = prc._check_one(flow, budget=1)
    assert _rules(findings) == {"primitive-budget"}
    assert findings[0].path == "<contract:toy>"
    assert prc._check_one(flow, budget=flow.node_count) == []


def test_fp64_promotion_fires_on_a_cast():
    flow = _flow(lambda x: x.to(torch.float64) * 2, torch.ones(4))
    findings = prc._check_one(flow, budget=None)
    assert _rules(findings) == {"fp64-promotion"}
    assert any("aten._to_copy to float64 from float32" in f.message for f in findings)
    assert any("produces a float64 value" in f.message for f in findings)


def test_fp64_promotion_fires_on_a_float64_constant():
    flow = _flow(lambda x: (x * torch.tensor([0.5, 0.25, 2.0, 1.0], dtype=torch.float64)).sum(),
                 torch.ones(4))
    assert "fp64-promotion" in _rules(prc._check_one(flow, budget=None))


def test_fp64_finding_names_the_port_line_and_is_suppressed_there():
    """The float64 node pooling of the contextual gate at float32 compute
    (``models/cg_lstm.py``, deliberate): its nodes, forward and backward,
    name the annotated lines, where ``# stmgcn: ignore`` suppresses them."""
    from stmgcn_tpu_torch.models.cg_lstm import ContextualGate

    gate = ContextualGate(2, 5, generator=torch.Generator().manual_seed(0))
    params = [p.detach().requires_grad_(True) for p in gate.parameters()]

    def run(tensors):
        ps, (sup, obs) = tensors[:len(params)], tensors[len(params):]
        with programs._swapped(gate, ps, [None] * len(ps)):
            out = gate(sup, obs)
        out.sum().backward()
        return [("prediction", out)] + [("grad", p.grad) for p in ps]

    inputs = ([("param", p) for p in params]
              + [("supports", torch.rand(2, 6, 6)), ("window", torch.rand(3, 5, 6, 1))])
    graph, ins, outs = programs._trace(run, inputs)
    flow = flow_program("gate", graph, ins, outs)
    raw = prc.contract_findings({"gate": flow})
    assert raw and _rules(raw) == {"fp64-promotion"}
    assert {f.path for f in raw} == {POOLING}
    lines = open(os.path.join(REPO, POOLING)).read().splitlines()
    for f in raw:
        assert "stmgcn: ignore[fp64-promotion" in lines[f.line - 1], f
    # the backward's float64 nodes (the mean's gradient) name the forward's line
    backward = [e for e in flow.fp64_events if e["op"] in ("aten.expand", "aten.div")]
    assert backward and all(e["path"] == POOLING for e in backward)
    assert prc.suppress(raw) == []
    kept = prc.suppress(raw, include_suppressed=True)
    assert len(kept) == len(raw) and all(f.suppressed for f in kept)


# -- the shipped tree -----------------------------------------------------------------

def test_smoke_programs_pass():
    assert contract_pass("cpu") == []


def test_every_program_traced_within_its_budget():
    assert tuple(traced_programs("cpu")) == PROGRAMS and len(PROGRAMS) == 13
    counts = prc.measured_node_counts("cpu")
    assert set(counts) == set(prc.PRIMITIVE_BUDGETS["cpu"]) == set(PROGRAMS)
    for name, count in counts.items():
        assert 0 < count <= prc.PRIMITIVE_BUDGETS["cpu"][name], name


def test_suppressed_findings_are_the_float64_pooling_alone():
    kept = contract_pass("cpu", include_suppressed=True)
    assert kept and all(f.suppressed for f in kept)
    assert _rules(kept) == {"fp64-promotion", "implicit-cast"}
    assert {f.path for f in kept} == {POOLING}
    lines = open(os.path.join(REPO, POOLING)).read().splitlines()
    assert all("stmgcn: ignore[" in lines[f.line - 1] for f in kept)
    # float64 only in the float32 programs (the bf16 gate pools in float32)
    programs_with_f64 = {f.message.split(":")[0] for f in kept}
    assert programs_with_f64 == {n for n in PROGRAMS if not n.endswith("_bf16")}


def test_block_programs_record_their_steps_and_grow_with_them():
    traced = traced_programs("cpu")
    assert traced["train_step"].steps == 1
    assert traced["train_series_superstep"].steps == programs.BLOCK_STEPS == 2
    one, two = (prc.measured_node_counts("cpu")[n]
                for n in ("train_step", "train_series_superstep"))
    assert 1.8 * one < two < 2.2 * one  # the body unrolls its steps


def test_kernel_operators_are_one_node_each_where_the_cpu_takes_them():
    """On the CPU the float32 LSTM takes its layered plain path, the bf16
    one the kernel route: one B1 and one B2 node a step."""
    for name, prog in traced_programs("cpu").items():
        nodes = kernel_nodes(prog.graph)
        if name.endswith("_bf16"):
            assert nodes == {"fused_lstm_fwd": prog.steps, "fused_lstm_bwd": prog.steps}, name
        else:
            assert nodes == {}, name


def test_program_edges_carry_their_roles():
    traced = traced_programs("cpu")
    step = traced["train_series_superstep"]
    n = sum(1 for label in step.in_labels if label == "param")
    assert n > 0 and step.in_labels[:4 * n] == (("param",) * n + ("grad",) * n
                                                + ("opt_state",) * (2 * n))
    assert {"supports", "series", "index", "mask", "scalars"} <= set(step.in_labels)
    assert step.out_labels[0] == "loss" and step.out_labels.count("param") == n
    assert traced["train_series_superstep_health"].out_labels[0] == "stats"
    assert traced["serve_fleet_bucket"].out_labels == ("prediction",)
    assert traced["eval_step"].out_labels == ("loss", "prediction")


def test_cuda_entries_cover_every_program():
    """The ``cuda`` entries (measured on the card by ``lint --rebaseline
    --device cuda``): every program, the CPU route's float dtypes, and the
    kernels as one node each, B1 and B2 S times in each training program
    and B1 once in each serving program and ``eval_step``."""
    budgets, census = prc.PRIMITIVE_BUDGETS["cuda"], pc.PRECISION_BASELINES["cuda"]
    assert set(budgets) == set(census) == set(PROGRAMS)
    cpu = pc.PRECISION_BASELINES["cpu"]
    for name in PROGRAMS:
        floats = {d for d in census[name]["bytes"] if d.startswith(("float", "bfloat"))}
        assert floats == {d for d in cpu[name]["bytes"] if d.startswith(("float", "bfloat"))}
        s = census[name]["steps"]
        want = ({"fused_lstm_bwd": s, "fused_lstm_fwd": s} if name.startswith("train_")
                else {"fused_lstm_fwd": 1})
        assert census[name]["kernels"] == want, name
        assert census[name]["nodes"] <= budgets[name]


def test_weak_type_output_has_no_counterpart():
    assert "weak-type-output" not in RULES
    from stmgcn_tpu_torch.analysis import lint

    assert "weak-type-output" in lint.__doc__ and "recaptures_after_warmup" in lint.__doc__


def test_cuda_route_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traced_programs("cuda")
    with pytest.raises(ValueError, match="route"):
        traced_programs("tpu")


# -- tracing leaves the state alone and runs nothing ---------------------------------

def test_tracing_leaves_the_state_bit_identical_and_runs_nothing(monkeypatch):
    built = {}
    make = programs._trainers

    def keep(*args):
        built.update(make(*args))
        return built

    monkeypatch.setattr(programs, "_trainers", keep)
    calls = []
    for mod, name in ((FL, "fused_lstm_reference"), (FL, "fused_lstm_bwd_reference"),
                      (SP, "_stack_plain"), (SP, "_stack_bwd_plain"), (SP, "_spmm_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    registry = programs._registry(programs.CONTRACT_PRESET, torch.device("cpu"))

    def state(trainer):
        opt = trainer.optimizer
        return [t.detach().clone() for t in (
            *trainer.model.state_dict().values(), *(p.grad for p in opt.params),
            *opt.exp_avg, *opt.exp_avg_sq)] + [opt.count]

    before = {k: state(t) for k, t in built.items()}
    launches = {k: copy.copy(vars(fn)) for k, fn in (("B1", FL.fused_lstm),
                                                      ("B2", FL.fused_lstm_bwd))}
    for name, (run, inputs, _) in registry.items():
        programs._trace(run, inputs)
    assert calls == []  # the operators' fake implementations answered
    for key, trainer in built.items():
        after = state(trainer)
        assert len(after) == len(before[key])
        for a, b in zip(before[key][:-1], after[:-1]):
            assert a.dtype == b.dtype and torch.equal(a, b), key
        assert after[-1] == before[key][-1]
        assert all(p.grad is not None and not isinstance(p.grad, torch._subclasses.FakeTensor)
                   for p in trainer.optimizer.params)
    assert {k: vars(fn) for k, fn in (("B1", FL.fused_lstm),
                                      ("B2", FL.fused_lstm_bwd))} == launches


# -- --rebaseline ----------------------------------------------------------------------

def _literal(path, name):
    line = next(x for x in open(path).read().splitlines() if x.startswith(f"{name} = "))
    ns = {}
    exec(line, ns)
    return ns[name]


@pytest.fixture
def copies(tmp_path, monkeypatch):
    """Both literal-holding modules pointed at temporary copies, their
    in-memory literals restored afterwards."""
    saved = [(mod, json.loads(json.dumps(lit))) for mod, lit in (
        (prc, prc.PRIMITIVE_BUDGETS), (pc, pc.PRECISION_BASELINES))]
    paths = {}
    for mod in (prc, pc):
        target = tmp_path / os.path.basename(mod.__file__)
        target.write_text(open(mod.__file__).read())
        monkeypatch.setattr(mod, "__file__", str(target))
        paths[mod] = str(target)
    yield paths
    for mod, lit in saved:
        live = prc.PRIMITIVE_BUDGETS if mod is prc else pc.PRECISION_BASELINES
        live.clear()
        live.update(lit)


def test_rebaseline_rewrites_the_route_and_keeps_the_other(copies):
    prc.PRIMITIVE_BUDGETS["cuda"] = {"train_step": 123}
    result = prc.rebaseline("cpu", headroom=3.0)
    assert result["path"] == copies[prc] and result["route"] == "cpu"
    assert result["budgets"] == {name: int(math.ceil(c * 3.0 / 10.0) * 10)
                                 for name, c in result["counts"].items()}
    assert set(result["counts"]) == set(PROGRAMS)
    written = _literal(copies[prc], "PRIMITIVE_BUDGETS")
    assert written == {"cpu": result["budgets"], "cuda": {"train_step": 123}}
    assert prc.PRIMITIVE_BUDGETS == written  # later checks see the new budgets


def test_rebaseline_precision_round_trips(copies):
    result = pc.rebaseline_precision("cpu")
    written = _literal(copies[pc], "PRECISION_BASELINES")
    assert written["cpu"] == result["census"] == pc.measured_census("cpu")
    assert pc.PRECISION_BASELINES == written
    assert set(written["cpu"]) == set(PROGRAMS)
    assert written["cpu"]["train_step_bf16"]["kernels"] == {"fused_lstm_bwd": 1,
                                                            "fused_lstm_fwd": 1}


def test_rebaseline_rejects_shrinking_headroom():
    with pytest.raises(ValueError, match="headroom"):
        prc.rebaseline(headroom=0.5)


def test_missing_literal_raises(tmp_path):
    target = tmp_path / "no_literal.py"
    target.write_text("x = 1\n")
    for fn, name in ((prc.rebaseline, "PRIMITIVE_BUDGETS"),
                     (pc.rebaseline_precision, "PRECISION_BASELINES")):
        before = json.loads(json.dumps(prc.PRIMITIVE_BUDGETS)), json.loads(
            json.dumps(pc.PRECISION_BASELINES))
        with pytest.raises(RuntimeError, match=name):
            fn(path=str(target))
        assert (prc.PRIMITIVE_BUDGETS, pc.PRECISION_BASELINES) == before


def test_cli_rebaseline_rewrites_both_literals(copies, capsys):
    assert main(["lint", "--rebaseline", "--format", "json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["route"] == "cpu" and out["precision"]["route"] == "cpu"
    assert _literal(copies[prc], "PRIMITIVE_BUDGETS")["cpu"] == out["budgets"]
    assert _literal(copies[pc], "PRECISION_BASELINES")["cpu"] == out["precision"]["census"]
    assert main(["lint", "--rebaseline"]) == 0
    text = capsys.readouterr().out
    assert "train_step_bf16: measured" in text and "rewrote the cpu entries" in text


def test_budget_overflow_after_a_tight_rebaseline(copies):
    prc.rebaseline("cpu", headroom=1.0)
    prc.PRIMITIVE_BUDGETS["cpu"]["train_step"] -= 20
    findings = prc.contract_findings(program_flows("cpu"), "cpu")
    assert [(f.rule, f.path) for f in findings if f.rule == "primitive-budget"] == [
        ("primitive-budget", "<contract:train_step>")]


# -- the operators ---------------------------------------------------------------------

def _lstm_operands(dtype, L=2, M=2, R=6, T=3, H=8, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return (torch.rand(*shape, generator=g) * 2 - 1) * 0.3

    ops = (r(M, R, T, 4 * H), r(M, L, H, 4 * H), r(M, max(L - 1, 1), H, 4 * H),
           r(M, max(L - 1, 1), 4 * H))
    return tuple(t.to(dtype) for t in ops)


@pytest.mark.parametrize("form", [0, 1, 2], ids=["fp32", "bf16", "xla"])
def test_opcheck_lstm_operators(form):
    ops = _lstm_operands(torch.bfloat16 if form == 1 else torch.float32)
    for res in (False, True):
        torch.library.opcheck(torch.ops.stmgcn.fused_lstm_fwd.default, (*ops, form, res))
    out, h_fin, c_fin, hseq, cseq = torch.ops.stmgcn.fused_lstm_fwd(*ops, form, True)
    g = torch.Generator().manual_seed(1)
    cots = tuple(torch.randn(t.shape, generator=g).to(t.dtype) for t in (out, h_fin, c_fin))
    for round_wx in ((False, True) if form == 2 else (False,)):
        torch.library.opcheck(torch.ops.stmgcn.fused_lstm_bwd.default,
                              (*ops, hseq, cseq, *cots, form, round_wx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_opcheck_spmm_operators(dtype):
    rng = np.random.default_rng(3)
    dense = (rng.random((2, 3, 20, 20)) < 0.2).astype(np.float32) * rng.random((2, 3, 20, 20),
                                                                                dtype=np.float32)
    st = plan_tiling(dense, tile=8).as_stack().astype(dtype)  # (M, K, ...) branch stack
    g = torch.Generator().manual_seed(4)
    for x in (torch.randn(20, 5, generator=g), torch.randn(2, 20, 5, generator=g)):
        torch.library.opcheck(torch.ops.stmgcn.spmm_stack_fwd.default,
                              (st.data, st.idx, st.nblk, st.row_order, x.to(dtype), 20, 20, 8))
    gy = torch.randn(2, 3, 20, 5, generator=g).to(dtype)
    for shared in (True, False):
        torch.library.opcheck(torch.ops.stmgcn.spmm_stack_bwd.default,
                              (st.data_t, st.idx_t, st.nblk_t, st.row_order_t, gy, 20, 20, 8,
                               shared))
    bs = SP.from_dense(dense[0, 1], tile=8).astype(dtype)
    x = torch.randn(20, 5, generator=g).to(dtype)
    for data, idx, nblk, order in ((bs.data, bs.idx, bs.nblk, bs.row_order),
                                   (bs.data_t, bs.idx_t, bs.nblk_t, bs.row_order_t)):
        torch.library.opcheck(torch.ops.stmgcn.spmm.default, (data, idx, nblk, order, x, 20, 8))


def test_operators_keep_the_wrappers_results():
    """The wrappers' CPU results through the operators equal the plain
    versions they always returned (B1-B5)."""
    ops = _lstm_operands(torch.float32)
    got = FL.fused_lstm(*ops, with_residuals=True)
    want = FL.fused_lstm_reference(*ops, with_residuals=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    out, hf, cf, hseq, cseq = got
    cots = (torch.ones_like(out), None, torch.ones_like(cf))
    got = FL.fused_lstm_bwd(*ops, hseq, cseq, *cots)
    want = FL.fused_lstm_bwd_reference(*ops, hseq, cseq, *cots)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dense = (np.random.default_rng(5).random((3, 20, 20)) < 0.2).astype(np.float32)
    st = SP.stack_from_dense(dense, tile=8)
    x = torch.randn(20, 4)
    assert torch.equal(SP.stack_forward(st, x), SP.spmm_stack_reference(st, x))
    gy = torch.randn(3, 20, 4)
    assert torch.equal(SP.spmm_stack_bwd(st, gy, shared=True),
                       SP.spmm_stack_bwd_reference(st, gy, shared=True))
    bs = SP.from_dense(dense[1], tile=8)
    for t in (False, True):
        assert torch.equal(SP.block_spmm(bs, x, transpose=t),
                           SP.spmm_reference(bs, x, transpose=t))
