"""The port's lint (``stmgcn_tpu_torch/analysis``) against the JAX package's.

``tests/test_analysis.py``'s config rules for the port:

- every ported pure-config pass gives the JAX pass's findings (rule id,
  severity, config name and path, count) on the same config, each case a
  preset with a section edited the same way in both packages (the
  messages are the sections' ``violations()``, whose wording the port
  adapts in places: "no program" for "no compiled program"); the
  ``precision-policy`` pass's messages are the JAX ``PrecisionPolicy``'s
  violations;
- the port's four presets lint clean, through the functions and the
  ``lint`` subcommand (text, JSON, SARIF, ``--list-rules``,
  ``--preset``);
- the kernel-budget pass: its mirror of the CUDA launch plans against
  figures the built kernels reported on an H100, every preset's launches
  within sm_90's budgets, H=512 and ``tile_size=256`` flagged, a 5-layer
  LSTM (two chained groups) and H=48 (padded to 64) clean;
- the report shapes, the rule registry's JAX ids and texts, and an
  ``import stmgcn_tpu_torch.analysis`` that pulls in neither JAX nor the
  port's model stack.
"""

import json
import subprocess
import sys

import pytest

from stmgcn_tpu import analysis as jax_analysis
from stmgcn_tpu.analysis.rules import RULES as JAX_RULES
from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu_torch import analysis
from stmgcn_tpu_torch.analysis import kernel_check as kc
from stmgcn_tpu_torch.analysis import RULES, Finding, render_json, render_sarif, render_text
from stmgcn_tpu_torch.cli import main
from stmgcn_tpu_torch.config import PRESETS, preset

PASSES = {
    "serving-bucket-shape": "check_serving_buckets",
    "serving-slo": "check_serving_slo",
    "obs-overhead": "check_obs_overhead",
    "health-overhead": "check_health_overhead",
    "continual-config": "check_continual_config",
    "federation-config": "check_federation_config",
    "resident-memory": "check_resident_memory",
    "fleet-shape-class": "check_fleet_shape_classes",
    "tile-plan": "check_tile_plan",
}

# (rule, preset, {section: {field: value}}): the same edit in both packages
CASES = {
    "ladder-not-increasing": ("serving-bucket-shape", "smoke",
                              {"serving": {"buckets": (4, 2, 1), "max_batch": 4}}),
    "ladder-below-max-batch": ("serving-bucket-shape", "smoke",
                               {"serving": {"buckets": (1, 4, 16), "max_batch": 64}}),
    "ladder-pad-waste": ("serving-bucket-shape", "default",
                         {"serving": {"buckets": (1, 16), "max_batch": 16,
                                      "max_pad_waste": 0.5}}),
    "slo-deadline-floor": ("serving-slo", "smoke",
                           {"serving": {"buckets": (1, 2, 4), "max_batch": 4,
                                        "max_delay_ms": 5.0, "deadline_ms": 5.0}}),
    "slo-queue-bound": ("serving-slo", "smoke",
                        {"serving": {"buckets": (1, 2, 4), "max_batch": 4,
                                     "queue_bound_rows": 3}}),
    "slo-degrade-rung": ("serving-slo", "default",
                         {"serving": {"buckets": (1, 2, 4), "max_batch": 4,
                                      "shed_policy": "degrade", "degrade_rung": 3}}),
    "slo-shed-policy": ("serving-slo", "smoke",
                        {"serving": {"shed_policy": "retry"}}),
    "obs-reservoir": ("obs-overhead", "smoke", {"obs": {"reservoir": 8193}}),
    "obs-ring": ("obs-overhead", "default", {"obs": {"trace": True, "ring_capacity": 0}}),
    "health-sketch": ("health-overhead", "smoke", {"health": {"sketch_size": 0}}),
    "health-drift-baseline": ("health-overhead", "multicity",
                              {"health": {"drift": True, "baseline": False}}),
    "continual-ring-window": ("continual-config", "smoke", {"continual": {"ring_capacity": 168}}),
    "continual-reorder": ("continual-config", "smoke",
                          {"continual": {"ring_capacity": 200, "reorder_window": 200}}),
    "continual-duty": ("continual-config", "default",
                       {"continual": {"enabled": True, "cadence_s": 10.0,
                                      "superstep_ms": 626.0}}),
    "continual-cadence": ("continual-config", "smoke",
                          {"continual": {"enabled": True, "cadence_s": 0.0}}),
    "federation-replicas": ("federation-config", "smoke",
                            {"federation": {"enabled": True, "replicas": 2}}),
    "federation-vnodes": ("federation-config", "multicity",
                          {"federation": {"enabled": True, "replicas": 1, "vnodes": 15}}),
    "federation-global-bound": ("federation-config", "smoke",
                                {"federation": {"enabled": True, "replicas": 1,
                                                "global_queue_bound_rows": 15}}),
    "resident-series-over-budget": ("resident-memory", "smoke",
                                    {"train": {"data_placement": "resident"},
                                     "data": {"n_timesteps": 3_000_000}}),
    "resident-mesh-materialized": ("resident-memory", "multicity",
                                   {"train": {"data_placement": "resident",
                                              "window_free": False}}),
    "resident-fits": ("resident-memory", "longhorizon",
                      {"train": {"data_placement": "resident", "window_free": False}}),
    "fleet-max-classes": ("fleet-shape-class", "multicity",
                          {"train": {"fleet": True, "fleet_max_classes": 0}}),
    "fleet-pad-waste-knob": ("fleet-shape-class", "multicity",
                             {"train": {"fleet": True, "fleet_max_pad_waste": 1.0}}),
    "fleet-homogeneous": ("fleet-shape-class", "smoke", {"train": {"fleet": True}}),
    "fleet-stream": ("fleet-shape-class", "multicity",
                     {"train": {"fleet": True, "data_placement": "stream"}}),
    "fleet-unassigned": ("fleet-shape-class", "multicity",
                         {"train": {"steps_per_superstep": 4, "fleet_max_classes": 1,
                                    "fleet_max_pad_waste": 0.1}}),
    "fleet-class-over-budget": ("fleet-shape-class", "multicity",
                                {"train": {"fleet": True},
                                 "data": {"city_timesteps": (2_000_000, 2_000_000)}}),
    "tile-sparse": ("tile-plan", "default", {"model": {"tiled": True, "sparse": True}}),
    "tile-size-zero": ("tile-plan", "default", {"model": {"tiled": True, "tile_size": 0}}),
    "tile-waste-budget": ("tile-plan", "default",
                          {"model": {"tiled": True, "tile_waste_budget": 0.0}}),
    "tile-padding-waste": ("tile-plan", "default",
                           {"model": {"tiled": True, "tile_size": 64},
                            "data": {"rows": 3}}),
    "tile-mesh": ("tile-plan", "multicity", {"model": {"tiled": True}}),
    "tile-clean": ("tile-plan", "default", {"model": {"tiled": True, "tile_size": 64}}),
}


def _edited(make, name, edits):
    cfg = make(name)
    for section, fields in edits.items():
        for field, value in fields.items():
            setattr(getattr(cfg, section), field, value)
    return cfg


def _records(findings):
    return sorted((f.rule, f.severity, f.path, f.message.split(":")[0]) for f in findings)


@pytest.mark.parametrize("case", sorted(CASES))
def test_findings_match_the_jax_pass(case):
    rule, name, edits = CASES[case]
    fn = PASSES[rule]
    want = getattr(jax_analysis, fn)([(case, _edited(jax_preset, name, edits))])
    got = getattr(analysis, fn)([(case, _edited(preset, name, edits))])
    assert _records(got) == _records(want)
    assert all(f.rule == rule for f in got)
    if case.endswith(("fits", "clean")):
        assert got == []
    else:
        assert got, case


def test_resident_materialized_over_budget_matches_jax_but_its_hint():
    """The materialized windows over the budget while the series fits: the
    same finding, whose hint names only ``window_free=False`` (the JAX
    pass's also names heterogeneous cities, which the port's trainer
    serves window-free)."""
    edits = {"train": {"data_placement": "resident", "window_free": False},
             "data": {"n_timesteps": 500_000}}
    want = jax_analysis.check_resident_memory([("big", _edited(jax_preset, "smoke", edits))])
    got = analysis.check_resident_memory([("big", _edited(preset, "smoke", edits))])
    assert [(f.rule, f.severity, f.path) for f in got] == [
        (f.rule, f.severity, f.path) for f in want]
    assert "materialized windows" in got[0].message and "window_free=False" in got[0].message
    assert got[0].message.split(" (the")[0] == want[0].message.split(" (the")[0]
    from stmgcn_tpu.analysis.resident_check import estimate_resident_bytes

    est = analysis.estimate_resident_bytes(_edited(preset, "smoke", edits))
    jax_est = estimate_resident_bytes(_edited(jax_preset, "smoke", edits))
    assert est == jax_est and est["series_bytes"] <= (1 << 30) < est["materialized_bytes"]


@pytest.mark.parametrize("policy", [
    {"master_param_dtype": "bfloat16"},
    {"master_param_dtype": "int8"},
    {"role_dtypes": {"dot_general": ("float32",), "mystery": ("float32",)}},
    {"role_dtypes": {"reduce_sum": ("bfloat16",)}},
    {"role_dtypes": {"loss": ()}},
    {"reduction_f32_roles": ()},
    {"cast_whitelist": (("float32", "float64"), ("float32", "float32"))},
    {},
], ids=["bf16-masters", "int8-masters", "unknown-role", "narrow-accumulation",
        "empty-role", "no-f32-roles", "bad-casts", "default"])
def test_precision_policy_matches_jax(policy):
    from stmgcn_tpu.config import PrecisionPolicy as JaxPolicy

    from stmgcn_tpu_torch.config import PrecisionPolicy

    want = JaxPolicy(**policy).violations()
    assert PrecisionPolicy(**policy).violations() == want
    cfg = preset("default")
    cfg.precision = PrecisionPolicy(**policy)
    got = analysis.check_precision_policy([("p", cfg)])
    assert [f.message for f in got] == [f"p: PrecisionPolicy: {v}" for v in want]
    assert all(f.rule == "precision-policy" and f.path == "<contract:precision:p>" for f in got)


def test_precision_section_round_trips_a_jax_config():
    jax_cfg = jax_preset("default")
    jax_cfg.precision.master_param_dtype = "float64"
    cfg = type(preset("default")).from_dict(jax_cfg.to_dict())
    assert cfg.precision.master_param_dtype == "float64"
    assert cfg.precision.violations() == jax_cfg.precision.violations()
    assert json.loads(json.dumps(cfg.to_dict()["precision"])) == json.loads(
        json.dumps(jax_cfg.to_dict()["precision"]))


# -- the presets and the CLI ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_lint_clean(name):
    assert analysis.run_passes([(name, preset(name))]) == []


def test_every_pass_defaults_to_the_presets():
    for fn in list(PASSES.values()) + ["check_precision_policy", "check_kernel_budgets"]:
        assert getattr(analysis, fn)() == [], fn
    assert analysis.run_passes() == []


def test_configs_without_the_section_are_skipped():
    for fn in ("check_serving_buckets", "check_serving_slo", "check_obs_overhead",
               "check_health_overhead", "check_federation_config",
               "check_precision_policy"):
        assert getattr(analysis, fn)([("none", object())]) == [], fn


def test_lint_cli_json_exit_zero(capsys):
    assert main(["lint", "--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload == {"version": 3, "errors": 0, "warnings": 0, "findings": []}


def test_lint_cli_text_sarif_and_rules(capsys):
    assert main(["lint"]) == 0
    assert capsys.readouterr().out.strip() == "stmgcn lint: clean"
    assert main(["lint", "--format", "sarif", "--preset", "default"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["version"] == "2.1.0" and len(doc["runs"]) == 1
    assert doc["runs"][0]["results"] == []
    assert main(["lint", "--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rule in out for rule in RULES)
    assert main(["lint", "--preset", "nope"]) == 2


def test_lint_cli_gates_on_an_error(monkeypatch, capsys):
    bad = preset("default")
    bad.model.lstm_hidden_dim = 512
    monkeypatch.setitem(PRESETS, "default", lambda: bad)
    assert main(["lint", "--preset", "default", "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["errors"] == 1
    assert [f["rule"] for f in payload["findings"]] == ["kernel-shape"]


def test_lint_subprocess_needs_no_gpu():
    proc = subprocess.run([sys.executable, "-m", "stmgcn_tpu_torch.cli", "lint", "--format",
                           "json"], capture_output=True, text=True, timeout=300,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "PYTHONPATH": "."})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["errors"] == 0


def test_import_pulls_in_neither_jax_nor_the_model_stack():
    code = ("import sys, stmgcn_tpu_torch.analysis; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'stmgcn_tpu', 'flax') or m.startswith(('stmgcn_tpu_torch.models', "
            "'stmgcn_tpu_torch.train', 'stmgcn_tpu_torch.ops', 'stmgcn_tpu_torch.serving', "
            "'stmgcn_tpu_torch.experiment'))))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "."})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# -- the kernel budgets ----------------------------------------------------------

#: what the built kernels reported on an NVIDIA H100 80GB HBM3 (chip_smoke.py
#: phase 2: ``stmgcn_lstm_fwd_smem``, ``stmgcn_lstm_bwd_smem``,
#: ``stmgcn_spmm_plan``): form, H -> bytes at L = 1..4 of the forward, the
#: sweep and (one figure) the weight-gradient kernel
CARD_LSTM = {
    ("fp32", 64): ([102400, 137216, 172032, 206848], [191488, 207872, 224256, 222208], 79872),
    ("fp32", 256): ([165376, 198656, 231936, 232192], [221952] * 4, 79872),
    ("bf16", 128): ([83968, 101376, 118784, 136192], [181760, 198144, 214528, 230912], 79872),
    ("bf16", 256): ([148992, 165888, 182784, 199680], [221952, 205568, 205568, 205568], 79872),
    ("xla", 32): ([55296, 75776, 96256, 116736], [143360, 159744, 176128, 192512], 79872),
    ("xla", 64): ([86016, 104448, 122880, 141312], [175104, 191488, 207872, 224256], 79872),
}
#: (tile, F, bf16) -> (column tile, stages, bytes, warp rows, warp cols)
CARD_SPMM = {
    (64, 10, False): (16, 4, 94208, 16, 8), (64, 128, False): (128, 4, 208896, 32, 32),
    (128, 20, False): (32, 4, 180224, 16, 32), (128, 37, False): (64, 4, 212992, 32, 32),
    (128, 128, False): (128, 3, 208896, 64, 32), (64, 37, True): (64, 4, 73728, 16, 32),
    (128, 10, True): (16, 4, 86016, 16, 16), (128, 128, True): (128, 4, 143360, 64, 32),
}


@pytest.mark.parametrize("form,H", sorted(CARD_LSTM))
def test_lstm_plan_mirror_equals_the_card(form, H):
    fwd, sweep, wgrad = CARD_LSTM[form, H]
    assert [kc.lstm_fwd_smem(L, H, form) for L in range(1, 5)] == fwd
    assert [kc.lstm_bwd_smem(L, H, form) for L in range(1, 5)] == sweep
    assert kc.lstm_bwd_smem(0, H, form) == wgrad
    assert kc.lstm_block_rows(H) == {32: 128, 64: 64, 128: 32, 256: 16}[H]


@pytest.mark.parametrize("tile,F,bf16", sorted(CARD_SPMM))
def test_spmm_plan_mirror_equals_the_card(tile, F, bf16):
    plan = kc.spmm_plan(tile, F, bf16)
    assert tuple(plan[k] for k in ("column_tile", "stages", "smem_bytes", "warp_rows",
                                   "warp_cols")) == CARD_SPMM[tile, F, bf16]


def test_mirror_constants_are_the_wrappers():
    import importlib

    fused_lstm = importlib.import_module("stmgcn_tpu_torch.ops.fused_lstm")
    spmm = importlib.import_module("stmgcn_tpu_torch.ops.spmm")

    assert kc.KERNEL_HIDDEN == fused_lstm.KERNEL_HIDDEN
    assert kc.KERNEL_MAX_LAYERS == fused_lstm.KERNEL_MAX_LAYERS
    assert kc.KERNEL_TILES == spmm.KERNEL_TILES and kc.SPARSE_TILE == spmm.TILE
    assert [fused_lstm.kernel_width(h) for h in (1, 32, 33, 64, 65, 200, 256)] == [
        32, 32, 64, 64, 128, 256, 256]
    assert kc.register_budget(512) == 128 and kc.register_budget(256) == 255


def test_every_plan_fits_sm90():
    for form in kc.FORMS:
        for H in kc.KERNEL_HIDDEN:
            for L in range(kc.KERNEL_MAX_LAYERS + 1):
                assert kc.lstm_bwd_smem(L, H, form) <= kc.SM90["smem_per_block"]
                if L:
                    assert kc.lstm_fwd_smem(L, H, form) <= kc.SM90["smem_per_block"]
    for tile in kc.KERNEL_TILES:
        for F in (16, 32, 64, 128):
            for bf16 in (False, True):
                assert kc.spmm_plan(tile, F, bf16)["smem_bytes"] <= kc.SM90["smem_per_block"]


def test_default_launches():
    launches, problems = kc.config_launches(preset("default"))
    assert problems == []
    got = {(k.kernel, k.form, k.shape): (k.threads, k.smem_bytes) for k in launches}
    assert got == {("lstm_fwd_kernel", "fp32", (3, 64)): (256, 172032),
                   ("lstm_bwd_sweep", "fp32", (3, 64)): (512, 224256),
                   ("lstm_bwd_wgrad", "fp32", (0, 64)): (256, 79872)}
    bf16 = preset("default")
    bf16.train.precision = "bf16"
    forms = {k.form for k in kc.config_launches(bf16)[0]}
    assert forms == {"fp32", "xla"}  # serves fp32, trains the xla form
    bf16.model.lstm_backend = "pallas"
    assert {k.form for k in kc.config_launches(bf16)[0]} == {"fp32", "bf16"}


def test_flags_h512_and_tile_256():
    wide = preset("default")
    wide.model.lstm_hidden_dim = 512
    f = analysis.check_kernel_budgets([("wide", wide)])
    assert [(x.rule, x.severity, x.path) for x in f] == [
        ("kernel-shape", "error", "<contract:kernels:wide>")]
    assert "512" in f[0].message and "256" in f[0].message
    tiled = preset("default")
    tiled.model.tiled, tiled.model.tile_size = True, 256
    f = analysis.check_kernel_budgets([("t256", tiled)])
    assert [x.rule for x in f] == ["kernel-shape"] and "tile_size=256" in f[0].message
    plan = analysis.check_tile_plan([("t256", tiled)])
    assert [x.rule for x in plan] == ["tile-plan"] and "(64, 128)" in plan[0].message
    # the JAX pass's VMEM model clears 256; the CUDA kernels do not take it
    jax_tiled = jax_preset("default")
    jax_tiled.model.tiled, jax_tiled.model.tile_size = True, 256
    assert jax_analysis.check_tile_plan([("t256", jax_tiled)]) == []


def test_passes_five_layers_and_padded_widths():
    deep = preset("default")
    deep.model.lstm_num_layers = 5
    launches, problems = kc.config_launches(deep)
    assert problems == [] and analysis.check_kernel_budgets([("deep", deep)]) == []
    assert sorted({k.shape for k in launches if k.kernel == "lstm_fwd_kernel"}) == [
        (1, 64), (4, 64)]  # groups of four and one
    narrow = preset("default")
    narrow.model.lstm_hidden_dim = 48
    assert {k.shape[1] for k in kc.config_launches(narrow)[0]} == {64}
    tiled = preset("default")
    tiled.model.tiled, tiled.model.tile_size = True, 128
    spmm = [k for k in kc.config_launches(tiled)[0] if k.kernel.startswith("spmm")]
    # the gate conv's B x 5 and the graph conv's B x 64 at batch 32 and rungs 1, 4, 16, 64
    assert {k.shape for k in spmm} == {(128, 16), (128, 32), (128, 64), (128, 128)}
    assert analysis.check_kernel_budgets([("tiled", tiled)]) == []


def test_smem_past_the_limit_is_flagged(monkeypatch):
    monkeypatch.setitem(kc.SM90, "smem_per_block", 100_000)
    f = analysis.check_kernel_budgets([("default", preset("default"))])
    assert {x.rule for x in f} == {"kernel-smem"}
    assert any("lstm_bwd_sweep" in x.message and "224,256" in x.message for x in f)


# -- report and registry ---------------------------------------------------------

def test_report_json_shape_is_the_jax_one():
    from stmgcn_tpu.analysis.report import render_json as jax_render_json

    assert json.loads(render_json([])) == json.loads(jax_render_json([]))
    f = Finding(rule="r", path="p.py", line=1, message="m", chain=("a:f", "b:g"),
                suppressed=True)
    rec = json.loads(render_json([f]))
    assert rec["findings"][0]["chain"] == ["a:f", "b:g"] and rec["errors"] == 0
    assert "[via a:f -> b:g]" in str(f) and "(suppressed)" in str(f)
    fs = [Finding(rule="b", path="z.py", line=9, message="m"),
          Finding(rule="a", path="a.py", line=3, message="m", severity="warning")]
    payload = json.loads(render_json(fs))
    assert [x["path"] for x in payload["findings"]] == ["a.py", "z.py"]
    assert (payload["errors"], payload["warnings"]) == (1, 1)
    assert render_text(fs).splitlines()[-1] == "stmgcn lint: 1 error(s), 1 warning(s)"


def test_sarif_lists_each_rule_once():
    fs = [Finding(rule="kernel-smem", path="<contract:kernels:x>", line=0, message="m"),
          Finding(rule="kernel-smem", path="<contract:kernels:y>", line=0, message="n")]
    doc = json.loads(render_sarif(fs))
    run = doc["runs"][0]
    assert [r["id"] for r in run["tool"]["driver"]["rules"]] == ["kernel-smem"]
    assert run["tool"]["driver"]["rules"][0]["fullDescription"]["text"] == RULES[
        "kernel-smem"].description
    assert [r["locations"][0]["physicalLocation"]["region"]["startLine"]
            for r in run["results"]] == [1, 1]


def test_rules_carry_the_jax_ids_severities_and_summaries():
    for rid in PASSES:
        assert RULES[rid].severity == JAX_RULES[rid].severity
        if rid != "tile-plan":  # the CUDA kernels' tiles replace the VMEM estimate
            assert RULES[rid].summary == JAX_RULES[rid].summary, rid
    assert RULES["precision-policy"].severity == JAX_RULES["precision-policy"].severity
    assert {RULES[r].severity for r in ("kernel-smem", "kernel-shape",
                                        "unparseable-module")} == {"error"}
    assert not set(RULES) - set(JAX_RULES) - {"kernel-smem", "kernel-shape",
                                              "unparseable-module"}
    for rid in ("collective-shape", "spmd-shard-footprint", "spmd-collective-manifest",
                "spmd-wire-budget", "unguarded-attr", "lock-order-cycle", "condvar-discipline",
                "thread-lifecycle", "host-sync-in-jit", "traced-control-flow",
                "unfenced-timing", "partition-axis-name"):
        assert RULES[rid].severity == JAX_RULES[rid].severity, rid
