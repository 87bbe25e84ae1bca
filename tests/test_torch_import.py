"""Import hygiene and device defaults of the PyTorch port.

``stmgcn_tpu_torch`` imports torch and numpy only: no JAX, no flax, and
nothing of the JAX package (whose package ``__init__``s pull JAX in). Its
entry points default to the GPU and raise without one instead of quietly
running on the CPU.
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
from stmgcn_tpu_torch import Forecaster, ServingEngine, STMGCN, preset
from stmgcn_tpu_torch.ops import _build

torch.set_num_threads(1)

PACKAGE = Path(stmgcn_tpu_torch.__file__).parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "stmgcn_tpu"}


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(PACKAGE.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_no_file_of_the_package_imports_jax():
    found = []
    for path, _ in _modules():
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
