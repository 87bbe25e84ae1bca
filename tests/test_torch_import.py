"""Import hygiene and device defaults of the PyTorch port.

``stmgcn_tpu_torch``, ``chip_smoke.py`` and the port's scripts
(``scripts/*.py``) import torch and numpy only: no JAX, flax, optax or
msgpack (the card's machine has no msgpack; the checkpoint codec is the
port's own), and nothing of the JAX package (whose package ``__init__``s
pull JAX in) or its benchmark (``bench.py``, which imports JAX).
Docstrings may name them. The entry
points default to the GPU and raise without one instead of quietly running
on the CPU.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import stmgcn_tpu_torch
from stmgcn_tpu_torch import Forecaster, ServingEngine, STMGCN, Trainer, build_trainer, preset
from stmgcn_tpu_torch.ops import _build

torch.set_num_threads(1)

PACKAGE = Path(stmgcn_tpu_torch.__file__).parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "stmgcn_tpu", "bench"}
CHIP_SMOKE = PACKAGE.parent / "chip_smoke.py"
SCRIPTS = sorted((PACKAGE.parent / "scripts").glob("*.py"))


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(PACKAGE.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_no_file_of_the_package_imports_jax():
    found = []
    for path in [path for path, _ in _modules()] + [CHIP_SMOKE] + SCRIPTS:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            found += [(path.name, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not found


def test_importing_every_module_loads_no_jax():
    """A fresh interpreter, so this test process's own JAX does not count."""
    names = [name for _, name in _modules()]
    code = (
        "import importlib, json, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        f"print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(PACKAGE.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=str(PACKAGE.parent))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_entry_points_need_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the GPU default is valid here")
    cfg = preset("smoke")
    kw = dict(m_graphs=1, n_supports=3, seq_len=5, input_dim=1, lstm_hidden_dim=8,
              lstm_num_layers=1, gcn_hidden_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        STMGCN(**kw)
    model = STMGCN(**kw, device="cpu")
    derived = {"input_dim": 1, "n_nodes": 4}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Forecaster(model, model.state_dict(), None, cfg, derived)
    fc = Forecaster(model, model.state_dict(), None, cfg, derived, device="cpu")
    supports = np.zeros((1, 3, 4, 4), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine.from_forecaster(fc, supports)
    with ServingEngine.from_forecaster(fc, supports, device="cpu") as eng:
        assert eng.predict(np.ones((2, 5, 4, 1), np.float32)).shape == (2, 4, 1)
    cfg.data.rows, cfg.data.n_timesteps = 3, 24 * 7 + 60
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_trainer(cfg)
    trainer = build_trainer(cfg, device="cpu", verbose=False)
    assert trainer.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(trainer.model, trainer.dataset, trainer.supports.numpy())


def test_kernel_build_has_no_fallback(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing quietly takes its place."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    src = tmp_path / "k.cu"
    src.write_text("// empty\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library([src], "missing_nvcc_probe")
    assert not (tmp_path / "kernels").exists()


#: the top-level names of ``stmgcn_tpu_torch`` before its ``__init__`` became
#: lazy, and those of ``stmgcn_tpu_torch.serving``
TOP_LEVEL = (
    "CitySupports", "CityOutcome", "ContinualDaemon", "ContinualTrainer", "ExperimentConfig",
    "FederationRouter", "FleetServingEngine", "Forecaster", "GateDecision", "GlobalBudget",
    "HashRing", "PromotionGate", "ReplicaHandle", "ReplicaUnavailable", "STMGCN", "SeriesRing",
    "ServingConfig", "ServingEngine", "StaleObservationError", "TierPromotionGate",
    "TrainConfig", "Trainer", "build_trainer", "closed_loop_smoke", "from_jax_params",
    "ingest_stream", "make_holdout_eval", "preset", "run", "to_jax_params",
)
SERVING = (
    "AdmissionController", "BatcherWedged", "CheckpointWatcher", "CityOutcome",
    "DeadlineExceeded", "DispatchError", "EngineStats", "FederationRouter",
    "FleetServingEngine", "GateDecision", "GlobalBudget", "HashRing", "MicroBatcher",
    "Overloaded", "PromotionGate", "ReplicaHandle", "ReplicaUnavailable", "ServingEngine",
    "ShedError", "TierPromotionGate", "pad_to_bucket", "ring_hash", "serve_predict",
    "smallest_covering_bucket",
)


def test_lazy_init_resolves_every_name_it_exported():
    import importlib

    import stmgcn_tpu_torch.serving as serving

    for package, names, extra in ((stmgcn_tpu_torch, TOP_LEVEL, ("ExportedForecaster",
                                                                  "export_forecaster")),
                                  (serving, SERVING, ())):
        assert set(names) | set(extra) == set(package.__all__)
        for name in (*names, *extra):
            value = getattr(package, name)
            home = importlib.import_module(value.__module__)
            assert getattr(home, name) is value, name
            assert name in dir(package)
        with pytest.raises(AttributeError, match="no attribute"):
            getattr(package, "NotAName")


def test_importing_the_package_loads_no_submodule():
    """``import stmgcn_tpu_torch`` and ``stmgcn_tpu_torch.serving`` load
    nothing until a name is asked for."""
    code = ("import sys, stmgcn_tpu_torch, stmgcn_tpu_torch.serving; print(sorted(m for m in "
            "sys.modules if m.startswith('stmgcn_tpu_torch')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(PACKAGE.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=str(PACKAGE.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(["stmgcn_tpu_torch", "stmgcn_tpu_torch.serving"])
