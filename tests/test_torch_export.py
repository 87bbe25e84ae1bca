"""The port's export artifact (``stmgcn_tpu_torch/export.py``) on the CPU.

Mirrors ``tests/test_export.py`` and the ``from_artifact`` tests of
``tests/test_serving.py``: an artifact written by ``export_forecaster`` and
read back by ``ExportedForecaster.load`` gives the forecaster's predictions
(rtol 1e-5, atol 1e-4 in raw demand units, the JAX tests' tolerance) at any
batch from one program, in fp32 and in the bf16 xla form; a block-sparse
checkpoint exports dense; a heterogeneous one exports one city; bad files
fail cleanly, a JAX artifact by name; and a ``ServingEngine`` built
``from_artifact`` serves what one built ``from_forecaster`` serves. Against
the JAX package: the JAX forecaster's parameters, converted with
``from_jax_params``, exported by both packages, give the same predictions
on the same seeded inputs. On the CPU the artifact's B1 operator runs its
plain version; the card's kernel is held against it by ``chip_smoke.py``.
"""

import copy
import json
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.experiment import build_model as jax_build_model
from stmgcn_tpu.export import ExportedForecaster as JaxExportedForecaster
from stmgcn_tpu.export import export_forecaster as jax_export_forecaster
from stmgcn_tpu.inference import Forecaster as JaxForecaster
from stmgcn_tpu_torch import Forecaster, ServingConfig, ServingEngine
from stmgcn_tpu_torch.config import ExperimentConfig
from stmgcn_tpu_torch.data import DemandDataset, WindowSpec, synthetic_dataset
from stmgcn_tpu_torch.experiment import build_model
from stmgcn_tpu_torch.export import _MAGIC, ExportedForecaster, export_forecaster
from stmgcn_tpu_torch.models import from_jax_params
from stmgcn_tpu_torch.ops import SupportConfig, stack_from_dense

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
LADDER = ServingConfig(buckets=(1, 4), max_batch=4, max_delay_ms=5.0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(**model):
    cfg = jax_preset("default")
    cfg.data.rows = 3
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 8
    cfg.model.lstm_num_layers = 2
    for key, value in model.items():
        setattr(cfg.model, key, value)
    return cfg


@pytest.fixture(scope="module")
def setup():
    """The JAX forecaster of a seeded 3x3 flagship, the port's on its
    converted weights, the supports and raw-unit history."""
    jcfg = _config()
    cfg = ExperimentConfig.from_dict(jcfg.to_dict())
    data = synthetic_dataset(rows=3, n_timesteps=24 * 7 * 2 + 60, seed=0)
    ds = DemandDataset(data, WindowSpec(3, 1, 1, 24))
    supports = SupportConfig(cfg.model.kernel_type, cfg.model.K).build_all(ds.adjs.values())
    derived = {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}
    jmodel = jax_build_model(jcfg, ds.n_feats)
    x0 = jnp.zeros((1, cfg.data.seq_len, ds.n_nodes, ds.n_feats), jnp.float32)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), jnp.asarray(supports), x0))
    jfc = JaxForecaster(jmodel, params, ds.normalizer, jcfg, derived)
    state = from_jax_params(params, cfg.model.m_graphs)
    fc = Forecaster(build_model(cfg, ds.n_feats, device="cpu"), state, ds.normalizer, cfg,
                    derived, device="cpu")
    history = ds.denormalize(ds.arrays("train")[0])
    return fc, jfc, supports, history, ds


@pytest.fixture(scope="module")
def artifact(setup, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "model.stmgx")
    export_forecaster(setup[0], path)
    return path


def _hist(ds, batch, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 50, (batch, 5, ds.n_nodes, ds.n_feats)).astype(np.float32)


def _close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_roundtrip_matches_forecaster(setup, artifact):
    fc, _, supports, history, _ = setup
    ex = ExportedForecaster.load(artifact, device="cpu")
    assert (ex.seq_len, ex.horizon) == (fc.seq_len, fc.horizon)
    assert ex.meta["format"] == "torch.export" and ex.meta["dtype"] == "float32"
    _close(ex.predict(supports, history[:4]), fc.predict(supports, history[:4]))


@pytest.mark.parametrize("batch", [1, 3, 7])
def test_symbolic_batch(setup, artifact, batch):
    """One program serves every batch size."""
    fc, _, supports, history, _ = setup
    ex = ExportedForecaster.load(artifact, device="cpu")
    rows = history[batch:2 * batch]
    _close(ex.predict(supports, rows), fc.predict(supports, rows))


def test_program_holds_the_b1_operator(artifact, monkeypatch):
    """The recurrence is one operator node, not a decomposition of the
    Python route; on the CPU its implementation is the plain version."""
    fl = sys.modules["stmgcn_tpu_torch.ops.fused_lstm"]
    ex = ExportedForecaster.load(artifact, device="cpu")
    targets = [str(n.target) for n in ex.exported.graph.nodes if n.op == "call_function"]
    assert sum("stmgcn.fused_lstm_fwd" in t for t in targets) == 1
    assert not any("lstm" in t and "stmgcn" not in t for t in targets)
    calls = []
    plain = fl.fused_lstm_reference
    monkeypatch.setattr(fl, "fused_lstm_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    ex.predict(np.zeros(ex.support_shape, np.float32),
               np.ones((2, ex.seq_len, ex.meta["n_nodes"], 1), np.float32))
    assert calls == [1]


def test_validates_shapes(setup, artifact):
    _, _, supports, history, _ = setup
    ex = ExportedForecaster.load(artifact, device="cpu")
    with pytest.raises(ValueError, match="supports must be"):
        ex.predict(supports[:, :2], history[:2])
    with pytest.raises(ValueError, match="history must be"):
        ex.predict(supports, history[:2, :3])
    with pytest.raises(ValueError, match="history must be"):
        ex.predict(supports, history[0])


def test_load_defaults_to_the_gpu(artifact):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the GPU default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExportedForecaster.load(artifact)


def test_converts_block_sparse_checkpoint(setup, tmp_path):
    """A block-sparse-built forecaster exports the dense program on the
    same parameters."""
    fc, _, supports, history, _ = setup
    cfg = copy.deepcopy(fc.config)
    cfg.model.sparse = True
    sparse_fc = Forecaster(build_model(cfg, fc.derived["input_dim"], device="cpu"),
                           fc.state_dict, fc.normalizer, cfg, fc.derived, device="cpu")
    sparse = tuple(stack_from_dense(supports[m]) for m in range(supports.shape[0]))
    rows = history[:3]
    _close(sparse_fc.predict(sparse, rows), fc.predict(supports, rows))
    path = str(tmp_path / "sparse.stmgx")
    export_forecaster(sparse_fc, path)
    _close(ExportedForecaster.load(path, device="cpu").predict(supports, rows),
           fc.predict(supports, rows))


def test_pallas_bf16_exports_the_xla_form(setup, tmp_path):
    """A bf16 forecaster whose checkpoint names the pallas form exports the
    xla form, as the JAX export's clone does: it matches the xla bf16
    forecaster of the same weights."""
    fc, _, supports, history, _ = setup
    fcs = {}
    for backend in ("pallas", "xla"):
        cfg = copy.deepcopy(fc.config)
        cfg.model.dtype, cfg.model.lstm_backend = "bfloat16", backend
        fcs[backend] = Forecaster(build_model(cfg, fc.derived["input_dim"], device="cpu"),
                                  fc.state_dict, fc.normalizer, cfg, fc.derived, device="cpu")
    path = str(tmp_path / "bf16.stmgx")
    export_forecaster(fcs["pallas"], path)
    ex = ExportedForecaster.load(path, device="cpu")
    assert ex.meta["dtype"] == "bfloat16"
    rows = history[:3]
    got = ex.predict(supports, rows)
    _close(got, fcs["xla"].predict(supports, rows))
    # the bf16 program is not the fp32 one
    assert not np.allclose(got, fc.predict(supports, rows), rtol=1e-6, atol=1e-6)


def test_heterogeneous_exports_one_city(setup, tmp_path):
    from stmgcn_tpu_torch.serving.bench import fleet_forecaster

    fc, _, supports, _, _ = setup
    hetero, sups, n_nodes = fleet_forecaster(fc, supports)
    with pytest.raises(ValueError, match="pass city="):
        export_forecaster(hetero, str(tmp_path / "x.stmgx"))
    with pytest.raises(ValueError, match="only applies"):
        export_forecaster(fc, str(tmp_path / "x.stmgx"), city=0)
    with pytest.raises(ValueError, match="city must be in"):
        export_forecaster(hetero, str(tmp_path / "x.stmgx"), city=2)
    path = str(tmp_path / "city1.stmgx")
    export_forecaster(hetero, path, city=1)
    ex = ExportedForecaster.load(path, device="cpu")
    assert ex.meta["city"] == 1 and ex.meta["n_nodes"] == n_nodes[1]
    rows = np.random.default_rng(3).uniform(0, 50, (3, fc.seq_len, n_nodes[1], 1))
    rows = rows.astype(np.float32)
    _close(ex.predict(sups[1], rows), hetero.predict(sups[1], rows, city=1))


def test_import_is_lean():
    """Loading an artifact needs the operator's registration, not the model,
    training or experiment stack, nor JAX."""
    code = ("import sys; import stmgcn_tpu_torch.export; "
            "heavy = [m for m in sys.modules if m.startswith(('stmgcn_tpu_torch.models', "
            "'stmgcn_tpu_torch.train', 'stmgcn_tpu_torch.experiment', 'jax', 'flax', "
            "'stmgcn_tpu.'))]; print(','.join(heavy) or 'LEAN')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env=env)
    assert out.stdout.strip().splitlines()[-1] == "LEAN", out.stdout + out.stderr


def test_rejects_bad_file(tmp_path):
    p = tmp_path / "junk.stmgx"
    p.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not an stmgcn-tpu export artifact"):
        ExportedForecaster.load(str(p), device="cpu")


def test_rejects_corrupt_length_field(tmp_path):
    """A lying length field fails before any allocation."""
    p = tmp_path / "corrupt.stmgx"
    p.write_bytes(_MAGIC + struct.pack("<Q", 1 << 62) + b"abcd")
    with pytest.raises(ValueError, match="truncated export artifact"):
        ExportedForecaster.load(str(p), device="cpu")


def test_rejects_trailing_garbage(artifact, tmp_path):
    path = tmp_path / "model.stmgx"
    path.write_bytes(open(artifact, "rb").read() + b"\x00garbage after the final blob")
    with pytest.raises(ValueError, match="trailing garbage"):
        ExportedForecaster.load(str(path), device="cpu")


def test_rejects_unknown_version_and_format(artifact, tmp_path):
    from stmgcn_tpu_torch.export import _read_blobs, _write_blobs

    meta_blob, program = _read_blobs(artifact, 2)
    for key, value, match in (("version", 2, "unsupported export version"),
                              ("format", "onnx", "unsupported artifact format")):
        meta = json.loads(meta_blob)
        meta[key] = value
        path = str(tmp_path / f"{key}.stmgx")
        _write_blobs(path, [json.dumps(meta).encode(), program])
        with pytest.raises(ValueError, match=match):
            ExportedForecaster.load(path, device="cpu")


@pytest.fixture(scope="module")
def jax_artifact(setup, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_export") / "jax.stmgx")
    jax_export_forecaster(setup[1], path, platforms=("cpu",))
    return path


def test_rejects_a_jax_artifact_by_name(jax_artifact):
    with pytest.raises(ValueError, match="JAX artifact"):
        ExportedForecaster.load(jax_artifact, device="cpu")


@pytest.mark.parametrize("batch", [1, 3, 7])
def test_matches_the_jax_artifact(setup, artifact, jax_artifact, batch):
    """The JAX forecaster's parameters, exported by each package: the two
    artifacts agree on the same seeded inputs."""
    _, _, supports, _, ds = setup
    rows = _hist(ds, batch, seed=batch)
    want = np.asarray(JaxExportedForecaster.load(jax_artifact).predict(supports, rows))
    _close(ExportedForecaster.load(artifact, device="cpu").predict(supports, rows), want)


def test_engine_from_artifact_matches_from_forecaster(setup, artifact):
    fc, _, supports, history, _ = setup
    with ServingEngine.from_artifact(artifact, supports, config=LADDER, device="cpu") as art, \
            fc.serving_engine(supports, config=LADDER, device="cpu") as ref:
        assert not art.graphs and art.exported is not None
        for b in (1, 3, 4, 6):
            rows = history[b:2 * b]
            _close(art.predict(rows), ref.predict(rows))
            _close(art.predict_direct(rows), fc.predict(supports, rows))


def test_exported_predict_routes_through_engine(setup, artifact):
    """Once wrapped, the artifact's own predict serves from the bucket
    ladder; different supports raise; after close it serves on its own."""
    _, _, supports, history, _ = setup
    ex = ExportedForecaster.load(artifact, device="cpu")
    rows = history[:2]
    before = ex.predict(supports, rows)
    with ServingEngine.from_artifact(ex, supports, config=LADDER) as eng:
        eng.stats.reset()
        np.testing.assert_array_equal(ex.predict(supports, rows), before)
        assert eng.stats.snapshot()["totals"]["requests"] == 1
        with pytest.raises(ValueError, match="pinned"):
            ex.predict(supports * 2.0, rows)
    assert ex._engine is None
    np.testing.assert_array_equal(ex.predict(supports, rows), before)


def test_from_artifact_cannot_swap(setup, artifact, tmp_path):
    fc, _, supports, _, _ = setup
    with ServingEngine.from_artifact(artifact, supports, config=LADDER, device="cpu") as eng:
        with pytest.raises(RuntimeError, match="from_artifact"):
            eng.swap_params(fc.state_dict)
        with pytest.raises(RuntimeError, match="cannot hot-swap"):
            eng.watch_checkpoints(str(tmp_path))
        assert eng.generation == 0


def test_from_artifact_checks_supports_and_device(setup, artifact):
    _, _, supports, _, _ = setup
    with pytest.raises(ValueError, match="supports must be"):
        ServingEngine.from_artifact(artifact, supports[:1], config=LADDER, device="cpu")
    ex = ExportedForecaster.load(artifact, device="cpu")
    with pytest.raises(ValueError, match="loaded on cpu"):
        ServingEngine.from_artifact(ex, supports, config=LADDER, device="cuda")
