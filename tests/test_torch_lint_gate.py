"""The port's lint gate (``scripts/lint_gate_torch.sh``,
``stmgcn_tpu_torch/analysis/gate.py``) against the JAX gate
(``scripts/lint_gate.sh``).

- the verdict: a passing set of section outputs gives ``"gate": "PASS"``
  and exit 0; each fail condition of the port's gate (one case per
  condition, an unparseable section among them) turns it to ``FAIL``,
  exit 1, with one JSON line on stdout; the sections run through a stand-in
  for their processes, so no section runs;
- the same section outputs through the JAX gate's own verdict (the last
  program of ``scripts/lint_gate.sh``, run as the script runs it, on the
  same section JSON): the same keys, and the same verdict on every case
  but those of ``spmd_exec`` (whose rule differs on purpose: six ranks and
  the port's loss rtol 2e-5 instead of eight devices and bit-equality) and
  the span and declared-collective counts, which only the port's gate
  reads;
- the config sections' counts (``spmd_summary``, ``precision_summary``);
  ``precision`` has the JAX meaning: the traced step programs (13), their
  ``_bf16`` twins (4), their dtype sites and findings, so a registry without
  a bf16 program, or a policy that bans its bf16 products, fails the gate;
- ``--device cuda`` with no card fails a device section and runs nothing
  on the CPU;
- (slow, as the JAX gate's test) the whole gate on the CPU prints exactly
  one passing JSON line, mirroring ``tests/test_analysis.py``'s
  ``TestLintGateScript``.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from stmgcn_tpu_torch.analysis import dtype_flow, gate
from stmgcn_tpu_torch.analysis.precision_check import precision_summary
from stmgcn_tpu_torch.analysis.programs import CONTRACT_PRESET, PROGRAMS
from stmgcn_tpu_torch.analysis.spmd_check import PROGRAM_SPECS, declared_manifests, spmd_summary
from stmgcn_tpu_torch.config import PRESETS

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

#: one passing output of each section, as its process prints it
PASSING = {
    "lint": {"version": 3, "errors": 0, "warnings": 0, "findings": []},
    "concurrency": {"classes": 148, "typed_edges": 49, "findings": 0},
    "obs": {"recaptures_after_warmup": 0, "trace_spans": 120, "health_nonfinite": 0,
            "health_records": 20, "health_findings": 0},
    "continual": {"promotions": 1, "rejections": 1, "nonfinite": 0},
    "federation": {"hung": 0, "cross_generation": 0, "kills": 1, "recovered": 4, "cities": 4,
                   "findings": 0},
    "spmd": {"programs": 8, "collectives": 21, "findings": 0},
    "spmd_exec": {"program": "series_superstep", "n_devices": 6, "parity_drift": 3e-7,
                  "recompiles_after_warmup": 0},
    "precision": {"programs": 13, "bf16_programs": 4, "sites": 2074, "findings": 0},
}

#: each fail condition: (section, key, value); key "exit" is the process's
#: exit code, key None an unparseable stdout
FAILS = [
    ("lint", "exit", 1), ("lint", "errors", 2),
    ("concurrency", "findings", 1), ("concurrency", "classes", 0),
    ("ruff", "exit", 1),
    ("obs", "recaptures_after_warmup", 1), ("obs", "trace_spans", 0), ("obs", "exit", 1),
    ("obs", "health_nonfinite", 3), ("obs", "health_records", 0),
    ("obs", "health_findings", 1),
    ("continual", "promotions", 0), ("continual", "rejections", 2),
    ("continual", "nonfinite", 1), ("continual", "exit", 1),
    ("federation", "hung", 1), ("federation", "cross_generation", 1),
    ("federation", "kills", 0), ("federation", "recovered", 3),
    ("federation", "findings", 1), ("federation", "exit", 1),
    ("spmd", "programs", 0), ("spmd", "collectives", 0), ("spmd", "findings", 1),
    ("spmd_exec", "exit", 1), ("spmd_exec", "program", "per_step"),
    ("spmd_exec", "n_devices", 8), ("spmd_exec", "parity_drift", 3e-5),
    ("spmd_exec", "recompiles_after_warmup", 1),
    ("precision", "programs", 0), ("precision", "bf16_programs", 0),
    ("precision", "findings", 1), ("precision", "exit", 1),
    ("obs", None, None), ("lint", None, None),
]

#: fail conditions of the port's gate that the JAX gate's verdict lacks: it
#: never reads ``trace_spans`` or ``spmd.collectives`` (the port's gate
#: fails on no span and on no declared collective)
PORT_ONLY = {("obs", "trace_spans"), ("spmd", "collectives")}


def _case(section=None, key=None, value=None):
    """``(outputs, exits, ruff)``: the passing outputs with one condition
    broken (``key`` None: that section's stdout unparseable)."""
    outs = {k: dict(v) for k, v in PASSING.items()}
    exits = {k: 0 for k in PASSING}
    ruff = {"available": False, "exit": None}
    if section == "ruff":
        ruff = {"available": True, "exit": value}
    elif key == "exit":
        exits[section] = value
    elif key is None and section is not None:
        outs[section] = None
    elif section is not None:
        outs[section][key] = value
    return outs, exits, ruff


def _run_gate(monkeypatch, capsys, outs, exits, ruff, report=None):
    """``gate.run_gate`` with each section's process replaced by its
    canned output: (exit code, stdout lines)."""

    def fake_run(cmd, **kwargs):
        name = "lint" if "lint" in cmd else cmd[cmd.index("--section") + 1]
        out = outs[name]
        stdout = "not json\n" if out is None else (
            json.dumps(out, indent=2) if name == "lint" else f"{json.dumps(out)}\n")
        return subprocess.CompletedProcess(cmd, exits[name], stdout=stdout)

    monkeypatch.setattr(gate.subprocess, "run", fake_run)
    monkeypatch.setattr(gate, "_ruff", lambda: ruff)
    code = gate.run_gate("cpu", report)
    return code, capsys.readouterr().out.splitlines()


def test_passing_sections_pass(monkeypatch, capsys):
    code, lines = _run_gate(monkeypatch, capsys, *_case())
    assert code == 0 and len(lines) == 1
    payload = json.loads(lines[0])
    assert payload["gate"] == "PASS"
    assert payload["spmd_exec"] == {"exit": 0, **PASSING["spmd_exec"]}
    assert payload["obs"] == {"exit": 0, "recompiles_after_warmup": 0, "trace_spans": 120}
    assert payload["health"] == {"exit": 0, "nonfinite": 0, "records": 20, "findings": 0}
    assert payload["ruff"] == {"available": False, "exit": None}


def test_report_lands_in_a_directory_not_yet_made(monkeypatch, capsys, tmp_path):
    """``--report`` into a new directory: the report lands and the one line
    is printed (a missing directory once lost the line after every section
    had passed)."""
    report = tmp_path / "new" / "report.json"
    code, lines = _run_gate(monkeypatch, capsys, *_case(), report=str(report))
    assert code == 0 and len(lines) == 1 and json.loads(lines[0])["gate"] == "PASS"
    rep = json.loads(report.read_text())
    assert set(rep["seconds"]) == {*gate.SECTIONS, "ruff", "gate"} and rep["device"] == "cpu"


@pytest.mark.parametrize("section,key,value", FAILS,
                         ids=[f"{s}-{k or 'unparseable'}" for s, k, _ in FAILS])
def test_each_fail_condition_fails_the_gate(monkeypatch, capsys, section, key, value):
    outs, exits, ruff = _case(section, key, value)
    code, lines = _run_gate(monkeypatch, capsys, outs, exits, ruff)
    assert code == 1 and len(lines) == 1
    payload = json.loads(lines[0])
    assert payload["gate"] == "FAIL"
    assert gate.gate_failures({n: {"exit": exits[n], "out": outs[n]} for n in PASSING}
                              | {"ruff": ruff})
    if section == "ruff":
        assert payload["ruff"] == ruff
    elif key is None:  # the section's keys read None, its exit its process's
        assert payload[section]["exit"] == 0
        assert {v for k, v in payload[section].items() if k != "exit"} == {None}


def _jax_verdict(outs, exits, ruff) -> dict:
    """The JAX gate's verdict program (the last ``"$PY" - <<'EOF'`` of
    ``scripts/lint_gate.sh``) on the same section outputs, passed as the
    script passes them (each section's stdout and exit in the environment;
    ``health`` rides ``obs`` as there)."""
    script = (REPO / "scripts" / "lint_gate.sh").read_text()
    program = re.findall(r"<<'EOF'\n(.*?)\nEOF", script, re.S)[-1]
    names = {"lint": "LINT", "concurrency": "CONC", "obs": "OBS", "continual": "CONTINUAL",
             "federation": "FEDERATION", "spmd": "SPMD", "spmd_exec": "SPMD_EXEC",
             "precision": "PRECISION"}
    env = {"RUFF_AVAILABLE": "true" if ruff["available"] else "false",
           "RUFF_EXIT": "null" if ruff["exit"] is None else str(ruff["exit"])}
    for name, var in names.items():
        out = outs[name]
        if name == "obs" and out is not None:  # the JAX key of a recapture's count
            out = dict(out, recompiles_after_warmup=out["recaptures_after_warmup"])
        if name == "spmd_exec" and out is not None:  # the JAX gate's own passing values
            jax_ok = {"program": "series_superstep", "n_devices": 8, "parity_drift": 0.0,
                      "recompiles_after_warmup": 0}
            out = {k: (jax_ok[k] if v == PASSING["spmd_exec"][k] else v)
                   for k, v in out.items()}
        env[f"{var}_JSON"] = "not json" if out is None else json.dumps(out)
        env[f"{var}_EXIT"] = str(exits[name])
    proc = subprocess.run([sys.executable, "-c", program], env={**os.environ, **env},
                          capture_output=True, text=True, timeout=60)
    return json.loads(proc.stdout.splitlines()[-1]) | {"_exit": proc.returncode}


@pytest.mark.parametrize("section,key,value", [(None, None, None)] + FAILS,
                         ids=["pass"] + [f"{s}-{k or 'unparseable'}" for s, k, _ in FAILS])
def test_verdict_matches_the_jax_gate(section, key, value):
    outs, exits, ruff = _case(section, key, value)
    want = _jax_verdict(outs, exits, ruff)
    got = gate.gate_payload({n: {"exit": exits[n], "out": outs[n]} for n in PASSING}
                            | {"ruff": ruff})
    assert set(got) == set(want) - {"_exit"}
    for name in got:
        if name != "gate":
            assert set(got[name]) == set(want[name]), name
    if section == "spmd_exec" or (section, key) in PORT_ONLY:
        assert got["gate"] == "FAIL"
        return
    assert got["gate"] == want["gate"]
    assert want["_exit"] == (0 if want["gate"] == "PASS" else 1)


def test_config_section_counts():
    spmd = spmd_summary()
    manifests = declared_manifests()
    assert spmd == {"programs": len(PROGRAM_SPECS),
                    "collectives": sum(len(m.decls) for m in manifests.values()),
                    "findings": 0}
    assert spmd["collectives"] > 0
    prec = precision_summary()
    assert prec["programs"] == len(PROGRAMS) == 13
    assert prec["bf16_programs"] == sum(name.endswith("_bf16") for name in PROGRAMS) == 4
    assert prec["sites"] > 0 and prec["findings"] == 0


@pytest.mark.parametrize("drop", ["dtype", "policy"])
def test_no_bf16_config_fails_the_precision_section(drop, monkeypatch):
    """With the registry's bf16 twins gone (``dtype``), the section counts no
    bf16 program; with the contract preset's policy no longer admitting
    bfloat16 at ``dot_general`` (``policy``), the twins' bf16 products are
    findings. Either way the gate fails on the section, and on it alone."""
    flows = dtype_flow.program_flows()
    if drop == "dtype":
        monkeypatch.setattr(dtype_flow, "program_flows", lambda route="cpu": {
            name: f for name, f in flows.items() if not name.endswith("_bf16")})
    else:
        smoke = PRESETS[CONTRACT_PRESET]()
        smoke.precision.role_dtypes["dot_general"] = ("float32",)
        monkeypatch.setitem(PRESETS, CONTRACT_PRESET, lambda: smoke)
    prec = precision_summary()
    if drop == "dtype":
        assert prec["programs"] == len(PROGRAMS) - 4 and prec["bf16_programs"] == 0
    else:
        assert prec["programs"] == len(PROGRAMS) and prec["findings"] > 0
    outs, exits, ruff = _case()
    outs["precision"] = prec
    why = gate.gate_failures({n: {"exit": exits[n], "out": outs[n]} for n in PASSING}
                             | {"ruff": ruff})
    assert len(why) == 1 and why[0].startswith("precision:"), why


def test_cuda_without_a_card_fails_a_device_section():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the section would run on it")
    proc = subprocess.run(
        [sys.executable, "-m", "stmgcn_tpu_torch.analysis.gate", "--section", "continual",
         "--device", "cuda"], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


@pytest.mark.slow
def test_gate_on_the_cpu_prints_one_passing_json_line():
    proc = subprocess.run(
        ["bash", str(REPO / "scripts" / "lint_gate_torch.sh"), "--device", "cpu"],
        capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHON": sys.executable})
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    payload = json.loads(lines[0])
    assert payload["gate"] == "PASS"
    assert payload["lint"] == {"exit": 0, "errors": 0, "warnings": 0, "version": 3}
    conc = payload["concurrency"]
    assert conc["exit"] == 0 and conc["findings"] == 0
    assert conc["classes"] > 0 and conc["typed_edges"] > 0
    assert set(payload["ruff"]) == {"available", "exit"}
    # on the CPU nothing is captured: the recapture count guards nothing here
    assert payload["obs"] == {"exit": 0, "recompiles_after_warmup": 0,
                              "trace_spans": payload["obs"]["trace_spans"]}
    assert payload["obs"]["trace_spans"] > 0
    health = payload["health"]
    assert health["exit"] == 0 and health["nonfinite"] == 0 and health["findings"] == 0
    assert health["records"] > 0
    assert payload["continual"] == {"exit": 0, "promotions": 1, "rejections": 1,
                                    "nonfinite": 0}
    fed = payload["federation"]
    assert fed["exit"] == 0 and fed["hung"] == 0 and fed["cross_generation"] == 0
    assert fed["kills"] == 1 and fed["recovered"] == fed["cities"] > 0
    assert fed["findings"] == 0
    assert payload["spmd"] == {"exit": 0, "programs": len(PROGRAM_SPECS),
                               "collectives": payload["spmd"]["collectives"], "findings": 0}
    assert payload["spmd"]["collectives"] > 0
    ex = payload["spmd_exec"]
    assert {k: ex[k] for k in ("exit", "program", "n_devices", "recompiles_after_warmup")} == {
        "exit": 0, "program": "series_superstep", "n_devices": 6,
        "recompiles_after_warmup": 0}
    assert 0.0 <= ex["parity_drift"] <= gate.PARITY_RTOL
    prec = payload["precision"]
    assert prec["exit"] == 0 and prec["programs"] > 0 and prec["bf16_programs"] > 0
    assert prec["sites"] > 0 and prec["findings"] == 0
