"""Several ranks and one set of files: the lead reads and writes, every
rank agrees (mirrors ``tests/test_multihost.py``), on CPU ranks over gloo.

- restore: the lead trains at dp=2 and writes its checkpoints; fresh
  trainers on both ranks, the other rank pointed at an empty directory,
  resume from the lead's file (read by the lead, its bytes broadcast):
  every rank ends with the lead's parameter digest and cursor, and trains
  on from there identically;
- a corrupt lead file raises on every rank: the lead its own
  ``CorruptCheckpointError``, the others the lead's error by name;
- SIGTERM to one non-lead rank of a dp=2 x branch=3 job stops every rank
  at the same safe point within seconds, each raising ``Preempted``, and
  the lead's emergency ``latest.ckpt`` reads back on one device as the
  single-device twin's, preempted at the same step (parameters rtol 5e-4,
  atol 2e-5, ``tests/test_parallel.py:96-104``: gloo sums in another
  order);
- the CLI: ``--virtual-devices 2`` prints one JSON line for the job; a
  failed export on the lead fails every rank (exit 1), a good one writes
  the artifact and exits 0;
- ``launch_local``: a rank that fails, or a job past its timeout, stops
  the others.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_rank_worker as ranks  # noqa: E402

from stmgcn_tpu_torch.cli import build_parser, config_from_args  # noqa: E402
from stmgcn_tpu_torch.parallel.mesh import launch_local  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = ["--preset", "branchpar", "--branch-parallel", "1", "--rows", "3", "--timesteps",
       str(24 * 7 + 42), "--epochs", "1", "--virtual-devices", "2"]


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    return [r["restore"] for r in ranks.launch(2, ["restore"],
                                               tmp_path_factory.mktemp("restore"))]


def test_restore_reads_on_the_lead_and_broadcasts(restored):
    lead, other = restored
    assert lead["restored"] == lead["trained"] == other["restored"]
    assert lead["epoch"] == other["epoch"] == 1
    assert lead["global_step"] == other["global_step"] > 0
    assert lead["history"] == other["history"]


def test_a_corrupt_lead_file_raises_on_every_rank(restored):
    lead, other = restored
    assert lead["corrupt"].startswith("CorruptCheckpointError: ")
    assert other["corrupt"].startswith(
        "ValueError: the lead rank failed to read the checkpoint: CorruptCheckpointError")
    assert "CRC32 mismatch" in other["corrupt"]


@pytest.fixture(scope="module")
def preempted(tmp_path_factory):
    return [r["preempt"] for r in ranks.launch(6, ["preempt"],
                                               tmp_path_factory.mktemp("preempt"))]


def test_sigterm_to_one_rank_stops_every_rank_at_one_safe_point(preempted):
    sent = preempted[ranks.PREEMPT_RANK]["sent"]
    assert sent is not None
    assert [r["sent"] is None for r in preempted].count(False) == 1  # only the signalled rank
    for rank, r in enumerate(preempted):
        assert r["raised"] is not None and r["raised"].startswith("Preempted: "), rank
        assert (r["global_step"], r["epoch"]) == (ranks.PREEMPT_STEP, 1), rank
        assert r["at"] - sent < 10.0, rank  # no rank waited out a collective timeout


def test_the_emergency_checkpoint_is_the_twins_state(preempted):
    lead = preempted[0]
    twin, mesh, mine = lead["twin"], lead["mesh_ckpt"], lead["twin_ckpt"]
    assert twin["raised"].startswith("Preempted: ")
    assert twin["global_step"] == mesh["global_step"] == mine["global_step"] == (
        ranks.PREEMPT_STEP)
    assert mesh["epoch"] == mine["epoch"]
    assert mesh["mesh"]["dp"] == 2 and mesh["mesh"]["branch"] == 3 and mine["mesh"] is None
    assert mesh["state"].keys() == mine["state"].keys()
    for name, value in mesh["state"].items():
        np.testing.assert_allclose(value.numpy(), mine["state"][name].numpy(), rtol=5e-4,
                                   atol=2e-5, err_msg=name)


def _cli(argv, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=_REPO)
    return subprocess.run([sys.executable, "-m", "stmgcn_tpu_torch.cli", *argv], cwd=_REPO,
                          env=env, capture_output=True, text=True, timeout=ranks.TIMEOUT)


def test_cli_mesh_flags_read_into_the_config():
    cfg = config_from_args(build_parser().parse_args(
        ["--preset", "branchpar", "--branch-parallel", "1", "--region-strategy", "auto",
         "--halo", "4"]))
    assert (cfg.mesh.dp, cfg.mesh.branch, cfg.mesh.region_strategy, cfg.mesh.halo) == (
        2, 1, "auto", 4)


def test_cli_virtual_devices_one_json_line_and_export_status(tmp_path):
    out = str(tmp_path / "run")
    bad = _cli(CLI + ["--out-dir", out, "--export", str(tmp_path / "no" / "such" / "m.stmgx")],
               tmp_path)
    assert bad.returncode == 1, bad.stderr[-3000:]
    lines = [json.loads(line) for line in bad.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1 and lines[0]["preset"] == "branchpar"
    assert "export failed" in bad.stderr and "transport gloo" in bad.stderr
    good = _cli(CLI + ["--out-dir", out, "--test-only", "--export", str(tmp_path / "m.stmgx")],
                tmp_path)
    assert good.returncode == 0, good.stderr[-3000:]
    assert sum(line.startswith("{") for line in good.stdout.splitlines()) == 1
    assert os.path.getsize(tmp_path / "m.stmgx") > 0


def test_cli_virtual_devices_must_match_the_mesh(tmp_path):
    res = _cli(["--preset", "smoke", "--virtual-devices", "2", "--out-dir", str(tmp_path)],
               tmp_path)
    assert res.returncode == 1 and "needs a config mesh of 2 devices" in res.stderr
    res = _cli(["--preset", "multicity", "--device", "cpu", "--out-dir", str(tmp_path)],
               tmp_path)
    assert res.returncode == 1 and "needs 8 ranks, but this job has 1" in res.stderr


def test_launch_local_stops_the_job_when_a_rank_fails(tmp_path):
    code = ("import os, sys, time; rank = int(os.environ['RANK']); "
            "sys.exit(3) if rank == 1 else time.sleep(60)")
    t0 = time.monotonic()
    codes, problem = launch_local([sys.executable, "-c", code], 3, log_dir=str(tmp_path))
    assert time.monotonic() - t0 < 30
    assert problem == "rank(s) [1] exited with [3]"
    assert codes[1] == 3 and codes[0] < 0 and codes[2] < 0  # the others killed
    t0 = time.monotonic()
    codes, problem = launch_local([sys.executable, "-c", "import time; time.sleep(60)"], 2,
                                  log_dir=str(tmp_path), timeout=1.0)
    assert time.monotonic() - t0 < 30
    assert problem == "the job outlived its 1 s" and all(c < 0 for c in codes)
    assert launch_local([sys.executable, "-c", "pass"], 2, log_dir=str(tmp_path)) == ([0, 0],
                                                                                       None)
