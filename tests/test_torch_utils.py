"""The port's measurement utilities (``stmgcn_tpu_torch/utils``) on the CPU.

``stmgcn_step_flops`` is the JAX package's arithmetic: it must equal
``stmgcn_tpu.utils.flops.stmgcn_step_flops`` exactly over a grid of
arguments. ``device_peak_flops`` knows the H100's dense peaks by device
name (no card needed) and gives None on the CPU. The timers fence CUDA work
and refuse to time nothing; ``trace`` writes a Chrome trace. The host-load
cases mirror ``tests/test_hostload.py``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from stmgcn_tpu.utils.flops import stmgcn_step_flops as jax_step_flops
from stmgcn_tpu.utils.profiling import region_timesteps_per_sec as jax_region_rate
from stmgcn_tpu_torch.utils import (
    BenchLock,
    StepTimer,
    device_peak_flops,
    fence,
    host_load_snapshot,
    mfu,
    region_timesteps_per_sec,
    stmgcn_step_flops,
    time_chained,
    trace,
)
from stmgcn_tpu_torch.utils.hostload import (
    PROBE_MARKER,
    PROBE_SRC,
    _competing_python,
    is_contended,
    persist_measurement,
    probe_backend_child,
    wait_for_probe_children,
)

torch.set_num_threads(1)

BASE = dict(batch=64, seq_len=12, n_nodes=256, n_feats=1, m_graphs=3, n_supports=3,
            lstm_hidden_dim=64, lstm_num_layers=3, gcn_hidden_dim=64)


@pytest.mark.parametrize("change", [
    {},
    {"batch": 1},
    {"n_nodes": 8192, "batch": 2, "seq_len": 5},
    {"n_supports": 1, "m_graphs": 1},
    {"lstm_num_layers": 1, "lstm_hidden_dim": 8, "gcn_hidden_dim": 8},
    {"lstm_num_layers": 5, "lstm_hidden_dim": 48},
    {"horizon": 3, "n_feats": 2},
    {"backward": False},
    {"backward": False, "horizon": 4, "batch": 7},
])
def test_step_flops_equal_the_jax_model(change):
    kw = {**BASE, **change}
    assert stmgcn_step_flops(**kw) == jax_step_flops(**kw)


def test_backward_is_three_forwards():
    assert stmgcn_step_flops(**BASE) == pytest.approx(3 * stmgcn_step_flops(**BASE,
                                                                            backward=False))


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM5 80GB"])
def test_peaks_of_the_h100_by_name(name):
    assert device_peak_flops(name) == 989.4e12
    assert device_peak_flops(name, precision="bf16") == 989.4e12
    assert device_peak_flops(name, precision="tf32") == 494.7e12
    assert device_peak_flops(name, precision="fp32") == 66.9e12


def test_peaks_unknown_cards_and_the_cpu():
    assert device_peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert device_peak_flops("NVIDIA H100 PCIe") is None
    assert device_peak_flops("cpu") is None
    assert device_peak_flops(torch.device("cpu"), precision="tf32") is None
    if not torch.cuda.is_available():
        assert device_peak_flops() is None
    with pytest.raises(ValueError, match="precision"):
        device_peak_flops("NVIDIA H100 80GB HBM3", precision="fp8")


def test_mfu():
    flops = stmgcn_step_flops(**BASE)
    peak = device_peak_flops("NVIDIA H100 80GB HBM3")
    assert mfu(flops, 0.01, peak) == pytest.approx(flops / 0.01 / 989.4e12)
    assert mfu(flops, 0.01, None) is None
    assert mfu(flops, 0.0, peak) is None


def test_region_rate_equals_the_jax_function():
    assert region_timesteps_per_sec(64, 12, 256, 0.0123) == jax_region_rate(64, 12, 256, 0.0123)


def test_step_timer_skips_warmup_and_summarizes():
    timer = StepTimer(warmup=2)
    x = torch.ones(4, 4)
    for _ in range(5):
        out = timer.measure(lambda: x @ x)
    assert torch.equal(out, x @ x)
    summary = timer.summary()
    assert summary["steps"] == 3 and len(timer.times) == 3
    assert 0 < summary["min_s"] <= summary["p50_s"] <= summary["mean_s"] * 3
    timer.record(0.5)
    assert timer.summary()["steps"] == 4 and timer.times.max() == 0.5
    assert StepTimer().summary() == {"steps": 0} and np.isnan(StepTimer().mean)


def test_fence_needs_a_computed_tensor():
    fence({"loss": torch.ones(()), "parts": [torch.zeros(3)]})
    for empty in (None, {}, [1.0, 2.0], (torch.empty(0),)):
        with pytest.raises(ValueError, match="no non-empty tensor"):
            fence(empty)


def test_time_chained():
    state = {"x": torch.ones(8, 8)}

    def step():
        state["x"] = state["x"] @ torch.eye(8)
        return state["x"]

    seconds = time_chained(step, iters=5, warmup=1)
    assert 0 < seconds < 1.0 and torch.equal(state["x"], torch.ones(8, 8))


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "prof"
    with trace(str(log_dir)):
        torch.ones(16, 16) @ torch.ones(16, 16)
    files = list(log_dir.glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


# -- host load (the cases of tests/test_hostload.py) ----------------------------

def test_snapshot_shape():
    snap = host_load_snapshot()
    assert snap["nproc"] >= 1
    assert snap["loadavg_1m"] is None or snap["loadavg_1m"] >= 0.0
    for proc in snap["competing_python"]:
        assert proc["pid"] != os.getpid()
        assert "python" in proc["cmd"]


def test_snapshot_excludes_self_and_ancestors():
    pids = {p["pid"] for p in host_load_snapshot()["competing_python"]}
    assert os.getpid() not in pids
    assert os.getppid() not in pids


def test_is_contended():
    quiet = {"competing_python": []}
    busy = {"competing_python": [{"pid": 1, "cmd": "python x.py"}]}
    assert is_contended({"before": quiet, "after": quiet}) is False
    assert is_contended({"before": busy, "after": quiet}) is True
    assert is_contended({"before": quiet, "after": busy}) is True
    assert is_contended({}) is False
    assert is_contended({"before": None, "after": None}) is False


def test_lock_excludes_second_holder(tmp_path):
    path = str(tmp_path / "bench.lock")
    first, second = BenchLock(path), BenchLock(path)
    assert first.acquire(wait_s=1) is True
    assert second.acquire(wait_s=0.2, poll_s=0.05) is False
    rec = second.record()
    assert rec["acquired"] is False and rec["holder_pid"] == os.getpid()
    first.release()
    assert second.acquire(wait_s=1, poll_s=0.05) is True
    assert second.record() == {"acquired": True, "waited_s": second.waited_s}
    second.release()
    with BenchLock(path) as held:
        assert held.acquired
    again = BenchLock(path)
    assert again.acquire(wait_s=0.5, poll_s=0.05) is True
    again.release()


def _hold_lock(path):
    lock = BenchLock(path)
    assert lock.acquire(wait_s=5)
    with open(path + ".held", "w") as f:
        f.write("1")
    time.sleep(30)  # the parent kills this process long before


def test_lock_excludes_across_processes(tmp_path):
    """Two processes; a killed holder's lock is released by the kernel."""
    import multiprocessing as mp

    ctx = mp.get_context("fork")
    path = str(tmp_path / "bench.lock")
    child = ctx.Process(target=_hold_lock, args=(path,), daemon=True)
    child.start()
    try:
        deadline = time.monotonic() + 20
        while not os.path.exists(path + ".held"):
            assert child.is_alive(), f"child died early, exitcode {child.exitcode}"
            assert time.monotonic() < deadline, "child never acquired"
            time.sleep(0.05)
        mine = BenchLock(path)
        assert mine.acquire(wait_s=0.3, poll_s=0.05) is False
        assert mine.record()["holder_pid"] == child.pid
        child.kill()
        child.join(10)
        assert mine.acquire(wait_s=5, poll_s=0.1) is True
        mine.release()
    finally:
        if child.is_alive():
            child.kill()
        child.join(5)


def test_probe_and_drain(tmp_path):
    """The probe child answers the device type; the drain recognizes probe
    children by a marker derived from the probe's source and waits for a
    short-lived one."""
    assert PROBE_MARKER in PROBE_SRC
    assert probe_backend_child(timeout_s=120) == ("cuda" if torch.cuda.is_available() else "cpu")
    child = subprocess.Popen([sys.executable, "-c",
                              f"import time\n# {PROBE_MARKER}\ntime.sleep(2)"])
    try:
        deadline = time.monotonic() + 10
        while child.pid not in {p["pid"] for p in _competing_python(max_procs=256)
                                if PROBE_MARKER in p["cmd"]}:
            assert time.monotonic() < deadline, "the fake probe never showed"
            time.sleep(0.1)
        assert wait_for_probe_children(max_wait_s=30, poll_s=0.2) is True
        assert child.poll() is not None
    finally:
        child.kill()
        child.wait()


def test_persist_measurement_policy(tmp_path):
    path = str(tmp_path / "record.json")
    quiet = {"before": {"competing_python": []}, "after": {"competing_python": []}}
    busy = {"before": {"competing_python": [{"pid": 1}]}, "after": {}}
    assert persist_measurement(path, {"platform": "gpu", "host_load": quiet}, True, "t")
    cpu = {"platform": "cpu", "host_load": quiet}
    assert persist_measurement(path, cpu, False, "t") is False and cpu["persisted"] is False
    contended = {"platform": "gpu", "host_load": busy}
    assert persist_measurement(path, contended, True, "t") is False
    assert contended["contended"] is True
    assert json.load(open(path))["contended"] is False
    assert persist_measurement(path, {"platform": "gpu", "host_load": quiet}, True, "t")
