"""The dtype-flow walk and the precision rules over the port's traced
programs (``stmgcn_tpu_torch/analysis/dtype_flow.py``,
``precision_check.py``), mirroring ``tests/test_precision.py``:

1. every rule fires on a seeded known-bad fixture and stays quiet on its
   known-good twin (a bf16 sum against its float32 accumulation, an
   undeclared float cast, a bf16 product under a float32-only policy, a
   bfloat16 master parameter);
2. the policy and census machinery: provenance chains, a program missing
   from coverage, census drift;
3. the shipped tree: every registered program walks with zero findings;
4. parity with the JAX package: for each of the 13 programs the set of
   float dtypes in the port's census equals the set in the JAX package's
   ``program_flows("smoke")``, but for float64, which the port's float32
   programs hold at the suppressed node pooling alone; every bf16 twin
   holds bfloat16 and no float32 program does. (The node counts differ from
   the JAX eqn counts by construction, so only dtype sets are compared.)
"""

import json
import os

import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from stmgcn_tpu.analysis.dtype_flow import program_flows as jax_program_flows
from stmgcn_tpu_torch.analysis import precision_check as pc
from stmgcn_tpu_torch.analysis.dtype_flow import FLOAT_DTYPES, flow_program, program_flows
from stmgcn_tpu_torch.analysis.precision_check import (
    PRECISION_BASELINES,
    check_flow,
    check_precision,
    precision_summary,
)
from stmgcn_tpu_torch.analysis.programs import PROGRAMS
from stmgcn_tpu_torch.config import PrecisionPolicy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOLING = "stmgcn_tpu_torch/models/cg_lstm.py"
XS = torch.ones(8)


def _flow(fn, *tensors, name="fixture", in_labels=None, out_labels=None):
    return flow_program(name, make_fx(fn, tracing_mode="fake")(*tensors), in_labels,
                        out_labels)


def _rules(findings):
    return {f.rule for f in findings}


# -- accum-dtype ---------------------------------------------------------------------

def test_bf16_sum_fires_naming_the_node():
    flow = _flow(lambda x: x.to(torch.bfloat16).sum(), XS, name="bf16_accum")
    findings = check_flow(flow, PrecisionPolicy())
    assert _rules(findings) == {"accum-dtype"}
    [f] = findings
    site = next(s for s in flow.sites if s.role == "reduce_sum")
    assert f"node #{site.index} {site.node} (aten.sum)" in f.message
    assert "bfloat16" in f.message and "reduction_f32_roles" in f.message
    assert f.path == "<contract:precision:bf16_accum>"  # no line of the port made it


def test_f32_accumulation_twin_passes():
    flow = _flow(lambda x: x.to(torch.bfloat16).sum(dtype=torch.float32), XS, name="f32_twin")
    assert check_flow(flow, PrecisionPolicy()) == []
    assert [s.dtype for s in flow.sites if s.role == "reduce_sum"] == ["float32"]


def test_bf16_mean_and_norm_are_accumulations():
    for fn in (lambda x: x.to(torch.bfloat16).mean(),
               lambda x: torch.linalg.vector_norm(x.to(torch.bfloat16))):
        assert _rules(check_flow(_flow(fn, XS), PrecisionPolicy())) == {"accum-dtype"}


def test_bf16_max_is_an_order_statistic_not_an_accumulation():
    flow = _flow(lambda x: x.to(torch.bfloat16).amax(), XS, name="rmax")
    assert check_flow(flow, PrecisionPolicy()) == []
    assert any(s.role == "reduce_order" for s in flow.sites)


def test_naked_bf16_matmul_is_a_bf16_accumulator():
    """A plain bf16 product returns (so accumulates, as the graph states it)
    in bf16: an ``accum-dtype`` finding, as a JAX bf16 dot without
    ``preferred_element_type``; float32 results pass."""
    m = torch.ones(4, 4)
    naked = _flow(lambda a: a.to(torch.bfloat16) @ a.to(torch.bfloat16), m)
    assert _rules(check_flow(naked, PrecisionPolicy())) == {"accum-dtype"}
    wide = _flow(lambda a: a.to(torch.bfloat16).float() @ a.to(torch.bfloat16).float(), m)
    assert check_flow(wide, PrecisionPolicy()) == []


# -- implicit-cast -------------------------------------------------------------------

def test_unwhitelisted_cast_fires():
    flow = _flow(lambda x: x.to(torch.bfloat16) * 1, XS, name="cast")
    findings = check_flow(flow, PrecisionPolicy(cast_whitelist=()))
    assert _rules(findings) == {"implicit-cast"}
    assert "float32->bfloat16" in findings[0].message
    assert "cast_whitelist" in findings[0].message


def test_whitelisted_cast_passes():
    flow = _flow(lambda x: x.to(torch.bfloat16) * 1, XS, name="cast")
    assert check_flow(flow, PrecisionPolicy()) == []


def test_undeclared_float16_cast_fires_under_the_default_policy():
    flow = _flow(lambda x: x.to(torch.float16) * 1, XS, name="half")
    assert _rules(check_flow(flow, PrecisionPolicy())) == {"implicit-cast"}


def test_f64_cast_belongs_to_fp64_promotion():
    flow = _flow(lambda x: x.to(torch.float64), XS, name="to64")
    policy = PrecisionPolicy(cast_whitelist=())
    assert "implicit-cast" not in _rules(check_flow(flow, policy))
    assert any(e["kind"] == "convert" for e in flow.fp64_events)


# -- precision-policy ----------------------------------------------------------------

def _lstm_program(form):
    """One B1 launch in ``form`` (its fake implementation, traced)."""
    dtype = torch.bfloat16 if form == 1 else torch.float32
    ops = (torch.ones(5, 3, 32), torch.ones(2, 8, 32), torch.ones(1, 8, 32), torch.ones(1, 32))
    return _flow(lambda *t: torch.ops.stmgcn.fused_lstm_fwd(*t, form, False)[0],
                 *(t.to(dtype) for t in ops), name=f"lstm{form}")


def test_bf16_kernel_products_outside_the_role_allowance_fire():
    policy = PrecisionPolicy(role_dtypes={"dot_general": ("float32",)})
    for form in (1, 2):  # bf16 storage, and the xla form's bf16 products
        findings = check_flow(_lstm_program(form), policy)
        assert _rules(findings) == {"precision-policy"}
        assert any("role_dtypes['dot_general']" in f.message and "kernel products" in f.message
                   for f in findings)
    assert check_flow(_lstm_program(0), policy) == []


def test_bf16_kernel_products_pass_the_default_policy():
    """The kernels' contract: bf16 products, float32 sums and cell math."""
    flow = _lstm_program(1)
    assert check_flow(flow, PrecisionPolicy()) == []
    roles = {(s.role, s.dtype) for s in flow.sites}
    assert {("dot_general", "bfloat16"), ("dot_general_accum", "float32")} <= roles


def test_master_param_boundary():
    def step(p, x):
        return p - 0.1 * x.to(p.dtype), x.sum()

    flow = _flow(step, torch.ones(8, dtype=torch.bfloat16), XS, name="halfmaster",
                 in_labels=("param", "window"), out_labels=("param", "loss"))
    findings = check_flow(flow, PrecisionPolicy())
    assert any("master_param_dtype" in f.message and "param[0]" in f.message
               for f in findings)
    loss64 = _flow(lambda x: x.sum(dtype=torch.float64), XS, name="loss64",
                   in_labels=("window",), out_labels=("loss",))
    assert any("loss[0]" in f.message for f in check_flow(loss64, PrecisionPolicy()))


# -- provenance, coverage and census -------------------------------------------------

def test_chain_names_input_label_and_cast_steps():
    flow = _flow(lambda w, x: (w.to(torch.bfloat16) * x.to(torch.bfloat16)).sum(),
                 torch.ones(8), torch.ones(8), name="prov", in_labels=("param", "window"))
    cast = next(s for s in flow.sites if s.role == "cast")
    assert cast.provenance[0] == "input:param[0]"
    assert cast.provenance[-1] == "cast:float32->bfloat16"
    rendered = cast.describe()
    assert "input:param[0] -> cast:float32->bfloat16" in rendered
    assert f"node #{cast.index}" in rendered


def test_label_arity_mismatch_raises():
    with pytest.raises(ValueError, match="in_labels"):
        _flow(lambda x: x * 1, XS, in_labels=("a", "b"))


def test_policy_violations_become_findings():
    findings = check_precision("cpu", policy=PrecisionPolicy(master_param_dtype="float8"),
                               flows=program_flows("cpu"))
    assert any(f.rule == "precision-policy" and "PrecisionPolicy" in f.message
               for f in findings)


def test_missing_program_is_a_coverage_finding():
    flows = dict(program_flows("cpu"))
    flows.pop("train_step")
    findings = check_precision("cpu", flows=flows)
    assert [f.path for f in findings] == ["<contract:precision:train_step>"]
    assert "coverage hole" in findings[0].message


def test_census_drift_is_a_finding():
    flow = program_flows("cpu")["train_step"]
    baseline = json.loads(json.dumps(PRECISION_BASELINES["cpu"]["train_step"]))
    assert pc._census_findings("train_step", flow.census, baseline) == []
    baseline["bytes"].pop("float64")
    assert any("drifted" in f.message
               for f in pc._census_findings("train_step", flow.census, baseline))
    baseline = dict(PRECISION_BASELINES["cpu"]["train_step"], casts=1)
    assert any("casts > budget" in f.message
               for f in pc._census_findings("train_step", flow.census, baseline))
    missing = pc._census_findings("train_step", flow.census, None)
    assert any("--rebaseline" in f.message for f in missing)


def test_census_records_steps_nodes_and_kernels():
    census = program_flows("cpu")["train_series_superstep_bf16"].census
    assert census["steps"] == 2 and census["nodes"] > 0
    assert census["kernels"] == {"fused_lstm_bwd": 2, "fused_lstm_fwd": 2}
    assert census["casts"] > 0 and census["flops"]["bfloat16"] > 0


# -- the shipped tree ----------------------------------------------------------------

def test_every_registered_program_walks_with_zero_findings():
    flows = program_flows("cpu")
    assert tuple(flows) == PROGRAMS
    assert check_precision("cpu", flows=flows) == []


def test_summary_shape_for_the_gate():
    summary = precision_summary()
    assert summary == {"programs": 13, "bf16_programs": 4,
                       "sites": sum(len(f.sites) for f in program_flows("cpu").values()),
                       "findings": 0}


def test_no_precision_suppression_outside_the_pooling():
    """The precision rules hold with no ``# stmgcn: ignore`` in the port but
    the float64 pooling's ``implicit-cast`` ones."""
    import re

    pat = re.compile(r"stmgcn:\s*ignore\[[^\]]*(precision-policy|accum-dtype|implicit-cast)")
    root = os.path.join(REPO, "stmgcn_tpu_torch")
    hits = set()
    for dirpath, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(dirpath, n)) as f:
                    if pat.search(f.read()):
                        hits.add(os.path.relpath(os.path.join(dirpath, n), REPO))
    assert hits == {POOLING}


# -- parity with the JAX package ---------------------------------------------------------

@pytest.fixture(scope="module")
def jax_flows():
    return jax_program_flows("smoke")


def _floats(census):
    return {d for d in census["bytes"] if d in FLOAT_DTYPES}


@pytest.mark.parametrize("name", PROGRAMS)
def test_float_dtypes_match_the_jax_programs(name, jax_flows):
    port = program_flows("cpu")[name]
    jax_set = _floats(jax_flows[name].census)
    port_set = _floats(port.census)
    assert port_set - {"float64"} == jax_set, (port_set, jax_set)
    assert "float64" not in jax_set
    assert ("bfloat16" in port_set) == name.endswith("_bf16")
    # float64 at the suppressed node pooling alone
    lines = open(os.path.join(REPO, POOLING)).read().splitlines()
    sites = {(e["path"], e["line"]) for e in port.fp64_events}
    assert ("float64" in port_set) == bool(sites) == (not name.endswith("_bf16"))
    for path, line in sites:
        assert path == POOLING and "stmgcn: ignore[fp64-promotion" in lines[line - 1], (
            path, line)
