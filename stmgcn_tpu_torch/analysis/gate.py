"""The port's CI lint gate (``scripts/lint_gate_torch.sh``): the counterpart
of the JAX package's ``scripts/lint_gate.sh``, with its stdout contract.

    python -m stmgcn_tpu_torch.analysis.gate [--device {cuda,cpu}] [--report PATH]

runs each section in a process of its own (one section's crash is that
section's ``exit`` and never loses the line; the sections that run no
model side by side, then the others one at a time), echoes every
section's output to stderr once it ends, and prints to stdout exactly one JSON line with the JAX gate's
keys (:func:`gate_payload`); the exit code is 0 iff ``"gate"`` is
``"PASS"``. ``--device`` (``cuda`` by default, as every entry point of the
port) is where the sections that run the port train and serve (``obs``,
``continual``, ``federation``, ``spmd_exec``): ``cuda`` with no card fails
them, and so the gate; nothing falls back to the CPU. ``--report PATH``
writes each section's seconds and the kernel launches its process counted
(``{"seconds": {...}, "launches": {...}}``).

The sections and what fails each (:func:`gate_failures`):

- ``lint``: ``python -m stmgcn_tpu_torch.cli lint --format json``: exit,
  errors, warnings, report version; fails on exit != 0 or errors != 0;
- ``concurrency``: the program database of the port's package
  (``type_informed``) and :func:`check_concurrency`: classes, typed edges,
  findings; fails on findings != 0 or classes == 0 (an empty database);
- ``ruff``: run only when the image has ``ruff``, over the port's files;
  fails on ruff's exit != 0;
- ``obs`` (and ``health``, the same process): the JAX gate's smoke
  training (``preset("smoke")``, 5 rows, ``24*7*2+60`` steps, two epochs,
  batch 8, resident, blocks of 2, health every step) under the span tracer
  on ``--device``: the captures after the first epoch's warmup mark
  (:func:`~stmgcn_tpu_torch.obs.graphmon.snapshot`, JAX's recompiles) and
  the spans; fails on recaptures > 0 or spans == 0; then the run's health
  records, its non-finite counters and ``check_health_overhead``; fails
  on non-finite != 0, records == 0 or findings != 0;
- ``continual``: ``closed_loop_smoke`` on ``--device``; fails unless one
  promotion, one rejection and no non-finite value;
- ``federation``: ``train_throwaway(rows=3, epochs=1)`` then
  ``run_federation_soak`` (two replicas, 0.4 s, buckets 1, 2, 4) on
  ``--device`` and ``check_federation_config``; fails on a hung caller, a
  cross-generation response, kills != 1, recovered != cities or findings;
- ``spmd``: :func:`~stmgcn_tpu_torch.analysis.spmd_check.spmd_summary`;
  fails on programs == 0, collectives == 0 or findings != 0;
- ``spmd_exec``: ``composed_trainer("branchpar")`` on SPMD_WORLD gloo
  ranks (``launch_local``) on ``--device`` against its one-device twin from
  the same initial state; fails on a rank's failure (a rank's manifest or
  wire finding on one more step fails it), a program other than
  SPMD_PROGRAM, a world other than SPMD_WORLD, a per-epoch loss gap above
  PARITY_RTOL (relative) or a recapture on a rank;
- ``precision``: :func:`~stmgcn_tpu_torch.analysis.precision_check.
  precision_summary`; fails on programs == 0, bf16_programs == 0 or
  findings != 0.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

__all__ = ["CONFIG_SECTIONS", "PARITY_RTOL", "SECTIONS", "SPMD_PROGRAM", "SPMD_WORLD", "gate_failures",
           "gate_payload", "main", "run_gate"]

_REPO = Path(__file__).resolve().parents[2]

#: the sections run in their own processes, in this order (``ruff`` runs
#: in the gate's process when the image has it)
SECTIONS = ("lint", "concurrency", "obs", "continual", "federation", "spmd", "spmd_exec",
            "precision")
#: the composed program the ``branchpar`` mesh trainer takes, its world, and
#: the port's loss rule against the one-device twin (rtol; the JAX gate
#: asks bit-equality, the port allclose: tests/test_torch_branch_parallel.py)
SPMD_PROGRAM, SPMD_WORLD, PARITY_RTOL = "series_superstep", 6, 2e-5
#: the sections that run no model (source and config passes), run side by
#: side before the others
CONFIG_SECTIONS = ("lint", "concurrency", "spmd", "precision")
#: a section process's limit, seconds (its exit is then 124)
SECTION_TIMEOUT = 900.0


# -- the verdict ----------------------------------------------------------------

def _fields(sections: dict) -> dict:
    """``name -> (exit, out)`` for every section, ``out`` {} where the
    section printed no JSON object."""
    return {name: (sections.get(name, {}).get("exit", 1), sections.get(name, {}).get("out") or {})
            for name in SECTIONS}


def gate_failures(sections: dict) -> list:
    """Each reason the gate fails. ``sections[name]`` is ``{"exit": code,
    "out": dict}`` for each of :data:`SECTIONS` (``out`` the section's JSON
    object, ``{}`` when it printed none) and ``sections["ruff"]`` is
    ``{"available": bool, "exit": code or None}``. Empty: PASS."""
    f = _fields(sections)
    why = []

    def need(ok: bool, reason: str) -> None:
        if not ok:
            why.append(reason)

    (lx, lint), (cx, conc), (ox, obs) = f["lint"], f["concurrency"], f["obs"]
    need(lx == 0 and lint.get("errors") == 0, f"lint: exit {lx}, errors {lint.get('errors')}")
    need(cx == 0 and conc.get("findings") == 0,
         f"concurrency: exit {cx}, findings {conc.get('findings')}")
    need((conc.get("classes") or 0) > 0, f"concurrency: {conc.get('classes')} classes "
         "(an empty program database)")
    ruff = sections.get("ruff", {})
    if ruff.get("available"):
        need(ruff.get("exit") == 0, f"ruff: exit {ruff.get('exit')}")
    need(ox == 0 and obs.get("recaptures_after_warmup") == 0,
         f"obs: exit {ox}, recaptures after warmup {obs.get('recaptures_after_warmup')}")
    need((obs.get("trace_spans") or 0) > 0, f"obs: {obs.get('trace_spans')} trace spans")
    need(obs.get("health_nonfinite") == 0, f"health: non-finite {obs.get('health_nonfinite')}")
    need((obs.get("health_records") or 0) > 0, f"health: {obs.get('health_records')} records")
    need(obs.get("health_findings") == 0, f"health: findings {obs.get('health_findings')}")
    cx, cont = f["continual"]
    need(cx == 0 and (cont.get("promotions"), cont.get("rejections"), cont.get("nonfinite"))
         == (1, 1, 0), f"continual: exit {cx}, promotions {cont.get('promotions')}, rejections "
         f"{cont.get('rejections')}, non-finite {cont.get('nonfinite')}")
    fx, fed = f["federation"]
    need(fx == 0 and fed.get("hung") == 0 and fed.get("cross_generation") == 0
         and fed.get("kills") == 1 and fed.get("findings") == 0,
         f"federation: exit {fx}, hung {fed.get('hung')}, cross-generation "
         f"{fed.get('cross_generation')}, kills {fed.get('kills')}, findings "
         f"{fed.get('findings')}")
    need(fed.get("recovered") is not None and fed.get("recovered") == fed.get("cities"),
         f"federation: {fed.get('recovered')} of {fed.get('cities')} cities recovered")
    sx, spmd = f["spmd"]
    need(sx == 0 and (spmd.get("programs") or 0) > 0 and (spmd.get("collectives") or 0) > 0
         and spmd.get("findings") == 0, f"spmd: exit {sx}, programs {spmd.get('programs')}, "
         f"collectives {spmd.get('collectives')}, findings {spmd.get('findings')}")
    ex, ex_out = f["spmd_exec"]
    drift = ex_out.get("parity_drift")
    need(ex == 0 and ex_out.get("program") == SPMD_PROGRAM
         and ex_out.get("n_devices") == SPMD_WORLD
         and drift is not None and drift <= PARITY_RTOL
         and ex_out.get("recompiles_after_warmup") == 0,
         f"spmd_exec: exit {ex}, program {ex_out.get('program')}, n_devices "
         f"{ex_out.get('n_devices')}, parity drift {drift} (rule {PARITY_RTOL}), recaptures "
         f"{ex_out.get('recompiles_after_warmup')}")
    px, prec = f["precision"]
    need(px == 0 and (prec.get("programs") or 0) > 0 and (prec.get("bf16_programs") or 0) > 0
         and prec.get("findings") == 0, f"precision: exit {px}, programs "
         f"{prec.get('programs')}, bf16 programs {prec.get('bf16_programs')}, findings "
         f"{prec.get('findings')}")
    return why


def gate_payload(sections: dict) -> dict:
    """The gate's one stdout line (``sections`` as :func:`gate_failures`
    reads them): ``"gate"`` PASS iff no failure, then each section under
    the JAX gate's keys."""
    f = _fields(sections)
    (lx, lint), (cx, conc), (ox, obs) = f["lint"], f["concurrency"], f["obs"]
    ruff = sections.get("ruff", {})

    def pick(name, *keys):
        code, out = f[name]
        return {"exit": code, **{k: out.get(k) for k in keys}}

    return {
        "gate": "FAIL" if gate_failures(sections) else "PASS",
        "lint": {"exit": lx, **{k: lint.get(k) for k in ("errors", "warnings", "version")}},
        "concurrency": {"exit": cx, **{k: conc.get(k)
                                       for k in ("classes", "typed_edges", "findings")}},
        "ruff": {"available": bool(ruff.get("available")), "exit": ruff.get("exit")},
        "obs": {"exit": ox, "recompiles_after_warmup": obs.get("recaptures_after_warmup"),
                "trace_spans": obs.get("trace_spans")},
        "health": {"exit": ox, "nonfinite": obs.get("health_nonfinite"),
                   "records": obs.get("health_records"),
                   "findings": obs.get("health_findings")},
        "continual": pick("continual", "promotions", "rejections", "nonfinite"),
        "federation": pick("federation", "hung", "cross_generation", "kills", "recovered",
                           "cities", "findings"),
        "spmd": pick("spmd", "programs", "collectives", "findings"),
        "spmd_exec": pick("spmd_exec", "program", "n_devices", "parity_drift",
                          "recompiles_after_warmup"),
        "precision": pick("precision", "programs", "bf16_programs", "sites", "findings"),
    }


# -- the sections (each in a process of its own) ---------------------------------

def _launches() -> dict:
    """The kernel wrappers' launch counts in this process (0 on the CPU,
    where the plain versions run)."""
    import importlib

    from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm, fused_lstm_bwd

    spmm = importlib.import_module("stmgcn_tpu_torch.ops.spmm")  # the module, not the function

    return {"B1": fused_lstm.launches, "B2": fused_lstm_bwd.launches,
            "B1 xla": fused_lstm.launches_xla, "B2 xla": fused_lstm_bwd.launches_xla,
            "B3": spmm.spmm_stack.launches, "B4": spmm.spmm_stack_bwd.launches,
            "B5": spmm.spmm.launches}


def _concurrency(device: str) -> dict:
    from stmgcn_tpu_torch.analysis.concurrency_check import check_concurrency
    from stmgcn_tpu_torch.analysis.lint import package_root
    from stmgcn_tpu_torch.analysis.program_db import ProgramDB

    db = ProgramDB.from_root(package_root(), package="stmgcn_tpu_torch", type_informed=True)
    findings = check_concurrency(db)
    for finding in findings:
        print(finding, file=sys.stderr)
    return {"classes": len(db.classes), "typed_edges": len(db.typed_edges),
            "findings": len(findings)}


def _obs(device: str) -> dict:
    """The traced smoke training with health at every step."""
    from stmgcn_tpu_torch.obs import graphmon
    from stmgcn_tpu_torch.obs import trace as obs_trace

    obs_trace.configure()
    from stmgcn_tpu_torch.analysis.section_check import check_health_overhead
    from stmgcn_tpu_torch.config import preset
    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.obs.health import load_health
    from stmgcn_tpu_torch.obs.registry import REGISTRY

    with tempfile.TemporaryDirectory(prefix="stmgcn_gate_") as tmp:
        cfg = preset("smoke")
        cfg.data.rows = 5
        cfg.data.n_timesteps = 24 * 7 * 2 + 60
        cfg.train.epochs = 2
        cfg.train.batch_size = 8
        cfg.train.data_placement = "resident"
        cfg.train.steps_per_superstep = 2
        cfg.train.out_dir = tmp
        cfg.health.enabled, cfg.health.every_k = True, 1
        cfg.health.out = os.path.join(tmp, "health.jsonl")
        trainer = build_trainer(cfg, device=device, verbose=False)
        trainer.train()
        trainer.flush_checkpoints()
        n_spans = obs_trace.active_tracer().export_jsonl(os.path.join(tmp, "trace.jsonl"))
        _, records = load_health(cfg.health.out)
    snap = graphmon.snapshot()
    return {"recaptures_after_warmup": snap["recaptures_after_warmup"],
            "captures": snap["captures"], "trace_spans": n_spans,
            "health_nonfinite": int(REGISTRY.counter("train.health.nonfinite_grads").value
                                    + REGISTRY.counter("train.health.nonfinite_loss").value),
            "health_records": len(records), "health_findings": len(check_health_overhead()),
            "train_path": trainer.train_path, "graphs": trainer.graphs,
            "launches": _launches()}


def _continual(device: str) -> dict:
    from stmgcn_tpu_torch.train.continual import closed_loop_smoke

    with tempfile.TemporaryDirectory(prefix="stmgcn_continual_") as tmp:
        out = closed_loop_smoke(tmp, device=device)
    return {**{k: out[k] for k in ("promotions", "rejections", "nonfinite", "generation")},
            "launches": _launches()}


def _federation(device: str) -> dict:
    from stmgcn_tpu_torch.analysis.section_check import check_federation_config
    from stmgcn_tpu_torch.serving.bench import run_federation_soak, train_throwaway

    with tempfile.TemporaryDirectory(prefix="stmgcn_federation_") as tmp:
        fc, supports = train_throwaway(rows=3, epochs=1, out_dir=tmp, device=device)
        rec = run_federation_soak(fc, supports, replicas=2, soak_seconds=0.4,
                                  buckets=(1, 2, 4))
    return {"hung": rec["soak"]["hung_clients"],
            "cross_generation": rec["soak"]["cross_generation"],
            "kills": rec["router"]["kills"], "recovered": rec["recovery"]["cities_serveable"],
            "cities": rec["recovery"]["cities_total"],
            "findings": len(check_federation_config()), "launches": _launches()}


def _spmd(device: str) -> dict:
    from stmgcn_tpu_torch.analysis.spmd_check import spmd_summary

    return spmd_summary()


def _precision(device: str) -> dict:
    from stmgcn_tpu_torch.analysis.precision_check import precision_summary

    return precision_summary()


def _spmd_exec(device: str) -> dict:
    """The composed ``branchpar`` twin here, then SPMD_WORLD ranks of
    :func:`_spmd_rank` from its initial state; raises on a failed rank."""
    import torch

    from stmgcn_tpu_torch.ops._build import PREBUILT_ENV
    from stmgcn_tpu_torch.parallel import composed_trainer
    from stmgcn_tpu_torch.parallel.mesh import launch_local

    with tempfile.TemporaryDirectory(prefix="stmgcn_spmd_exec_") as tmp:
        twin = composed_trainer("branchpar", twin="single", out_dir=os.path.join(tmp, "twin"),
                                device=device)
        init = {k: v.detach().cpu().clone() for k, v in twin.model.state_dict().items()}
        torch.save(init, os.path.join(tmp, "init.pt"))
        h_twin = twin.train()
        # the ranks load the kernels the twin built, and never run nvcc
        _, problem = launch_local(
            [sys.executable, "-m", "stmgcn_tpu_torch.analysis.gate", "--rank-job", tmp,
             "--device", device], SPMD_WORLD,
            env={PREBUILT_ENV: "1", "OMP_NUM_THREADS": "1", "PYTHONPATH": str(_REPO)},
            log_dir=tmp, timeout=SECTION_TIMEOUT, cwd=str(_REPO))
        logs = [open(os.path.join(tmp, f"rank{r}.log")).read() for r in range(SPMD_WORLD)]
        if problem is not None:
            raise RuntimeError(f"spmd_exec: {problem}" + "".join(
                f"\n--- rank {r} ---\n{log[-3000:]}" for r, log in enumerate(logs)))
        ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(SPMD_WORLD)]
    for r, got in enumerate(ranks):
        print(f"spmd_exec rank {r} at {got['coords']}: {got['path']}, history "
              f"{got['history']}, findings {got['findings']}", file=sys.stderr)
    findings = [f for got in ranks for f in got["findings"]]
    if findings:
        raise RuntimeError("spmd_exec: the ranks' manifest and wire findings: "
                           + "; ".join(findings))
    paths, worlds = {got["path"] for got in ranks}, {got["world"] for got in ranks}
    drift = max(abs(a - b) / abs(b) for got in ranks for mode in ("train", "validate")
                for a, b in zip(got["history"][mode], h_twin[mode], strict=True))
    launches = {k: sum(got["launches"][k] for got in ranks) for k in ranks[0]["launches"]}
    return {"program": paths.pop() if len(paths) == 1 else sorted(paths),
            "n_devices": worlds.pop() if len(worlds) == 1 else sorted(worlds),
            "parity_drift": drift,
            "recompiles_after_warmup": sum(got["recaptures"] for got in ranks),
            "twin_history": h_twin, "launches": launches}


def _spmd_rank(job: str, device: str) -> int:
    """One rank of the ``spmd_exec`` job: the composed ``branchpar``
    trainer from the twin's initial state, trained; then one more step
    under ``step_comm_report`` held to its manifest and wire models; its
    results to ``job/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from stmgcn_tpu_torch.analysis.spmd_check import manifest_findings, param_bytes
    from stmgcn_tpu_torch.analysis.spmd_check import wire_findings
    from stmgcn_tpu_torch.obs import graphmon
    from stmgcn_tpu_torch.parallel import (
        banded_meta,
        composed_config,
        composed_trainer,
        init_distributed,
        manifest_for_config,
    )
    from stmgcn_tpu_torch.utils import step_comm_report

    torch.set_num_threads(1)
    dev = init_distributed(device=device, timeout=SECTION_TIMEOUT)
    init = torch.load(os.path.join(job, "init.pt"), weights_only=False)
    t = composed_trainer("branchpar", out_dir=os.path.join(job, "mesh"), device=dev,
                         initial_state=init)
    history = t.train()
    recaptures = graphmon.snapshot()["recaptures_after_warmup"]
    cfg = composed_config("branchpar")
    report = step_comm_report(t.train_batch, next(iter(t.batches("train"))))
    manifest = manifest_for_config(cfg, transport=t.mesh.backend)
    meta = dict(banded_meta(t, cfg), param_bytes=param_bytes(t.model))
    findings = (manifest_findings("branchpar/train", manifest, report)
                + wire_findings("branchpar/train", report, meta))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out = {"path": t.train_path, "world": t.mesh.world, "coords": t.mesh.coords,
           "history": history, "recaptures": recaptures,
           "findings": [str(f) for f in findings], "launches": _launches()}
    with open(os.path.join(job, f"rank{t.mesh.rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


_SECTION_FNS = {"concurrency": _concurrency, "obs": _obs, "continual": _continual,
                "federation": _federation, "spmd": _spmd, "spmd_exec": _spmd_exec,
                "precision": _precision}


def _run_section(name: str, device: str) -> int:
    """One section in this process: its JSON object on stdout, anything
    else it prints on stderr."""
    with contextlib.redirect_stdout(sys.stderr):
        out = _SECTION_FNS[name](device)
    print(json.dumps(out))
    return 0


# -- the gate --------------------------------------------------------------------

def _parse(stdout: str) -> dict:
    """A section's JSON object: the whole of its stdout, or its last line;
    ``{}`` when neither is one."""
    lines = stdout.strip().splitlines()
    for text in (stdout, lines[-1] if lines else ""):
        try:
            out = json.loads(text)
        except ValueError:
            continue
        if isinstance(out, dict):
            return out
    return {}


def _ruff() -> dict:
    if shutil.which("ruff") is None:
        return {"available": False, "exit": None}
    paths = ["stmgcn_tpu_torch", "chip_smoke.py", *sorted(
        str(p.relative_to(_REPO)) for p in (_REPO / "tests").glob("test_torch_*.py"))]
    proc = subprocess.run(["ruff", "check", *paths], cwd=str(_REPO), stdout=sys.stderr,
                          stderr=sys.stderr)
    return {"available": True, "exit": proc.returncode}


def _text(out) -> str:
    return out.decode() if isinstance(out, bytes) else out or ""


def _section(name: str, device: str, env: dict) -> tuple:
    """One section's process: (exit, stdout, stderr, seconds); exit 124
    when it outlives SECTION_TIMEOUT."""
    cmd = ([sys.executable, "-m", "stmgcn_tpu_torch.cli", "lint", "--format", "json"]
           if name == "lint" else
           [sys.executable, "-m", "stmgcn_tpu_torch.analysis.gate", "--section", name,
            "--device", device])
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=str(_REPO), env=env, capture_output=True, text=True,
                              timeout=SECTION_TIMEOUT)
        code, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        code, stdout, stderr = 124, e.stdout, e.stderr
    return code, _text(stdout), _text(stderr), round(time.perf_counter() - t0, 2)


def run_gate(device: str = "cuda", report: Optional[str] = None) -> int:
    """Every section in a process of its own (the CONFIG_SECTIONS side by
    side, then the others one at a time), then the one stdout line;
    returns the exit code (0 iff PASS)."""
    sections, seconds = {}, {}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(_REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t_all = time.perf_counter()
    with ThreadPoolExecutor(len(CONFIG_SECTIONS)) as pool:
        done = dict(zip(CONFIG_SECTIONS, pool.map(lambda n: _section(n, device, env),
                                                  CONFIG_SECTIONS)))
    for name in SECTIONS:
        code, stdout, stderr, seconds[name] = done.get(name) or _section(name, device, env)
        print(f"{stderr}--- gate section {name}: exit {code}, {seconds[name]} s ---\n{stdout}",
              file=sys.stderr, flush=True)
        sections[name] = {"exit": code, "out": _parse(stdout)}
    t0 = time.perf_counter()
    sections["ruff"] = _ruff()
    seconds["ruff"] = round(time.perf_counter() - t0, 2)
    seconds["gate"] = round(time.perf_counter() - t_all, 2)
    for reason in gate_failures(sections):
        print(f"gate: FAIL: {reason}", file=sys.stderr)
    print("gate seconds: " + ", ".join(f"{k} {v}" for k, v in seconds.items()), file=sys.stderr)
    payload = gate_payload(sections)
    if report is not None:
        os.makedirs(os.path.dirname(os.path.abspath(report)), exist_ok=True)
        with open(report, "w") as f:
            json.dump({"seconds": seconds, "device": device,
                       "launches": {n: sections[n]["out"].get("launches") for n in SECTIONS}},
                      f)
    print(json.dumps(payload), flush=True)
    return 0 if payload["gate"] == "PASS" else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="lint_gate_torch.sh",
        description="The port's CI lint gate: one JSON line on stdout, exit 0 iff PASS.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the training and serving sections run (default: cuda)")
    parser.add_argument("--report", help="write each section's seconds and kernel launches "
                        "to this JSON file")
    parser.add_argument("--section", choices=sorted(_SECTION_FNS), help=argparse.SUPPRESS)
    parser.add_argument("--rank-job", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_job is not None:
        return _spmd_rank(args.rank_job, args.device)
    if args.section is not None:
        return _run_section(args.section, args.device)
    return run_gate(args.device, args.report)


if __name__ == "__main__":
    sys.exit(main())
