"""The port's command line (``python -m stmgcn_tpu_torch.cli``) on the CPU.

``main([...])`` trains a smoke-sized city into a temporary ``--out-dir``;
``--test-only`` then scores ``best.ckpt`` exactly as the training run's own
test did (the same file, the same arithmetic), ``--resume`` and ``--resume
auto`` continue from it, and the exit codes follow ``stmgcn_tpu/cli.py``.
The flags the two CLIs share reach the same config in both, and the JAX
flags whose features are ported (the data and model flags, the LSTM
forms, the matmul precision, the sanitizers, tracing, profiling and
export) have the JAX names, defaults and choices. ``--export`` writes an
artifact that serves what ``best.ckpt`` serves, ``--profile`` a Chrome
trace, and ``serve-bench`` prints one JSON record line.
"""

import json

import pytest
import torch

from stmgcn_tpu.cli import build_parser as jax_build_parser
from stmgcn_tpu.cli import config_from_args as jax_config_from_args
from stmgcn_tpu_torch import ExperimentConfig
from stmgcn_tpu_torch.cli import build_parser, config_from_args, main

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--rows", "3", "--timesteps", "240", "--batch-size", "16"]


def _results(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1]), out


def test_train_then_test_only_then_resume(tmp_path, capsys):
    out_dir = str(tmp_path / "run")
    base = ["--preset", "smoke", "--out-dir", out_dir] + SMALL
    assert main(base + ["--epochs", "1"]) == 0
    trained, _ = _results(capsys)
    assert trained["preset"] == "smoke" and set(trained["results"]) == {"train", "test"}
    assert (tmp_path / "run" / "best.ckpt").exists()
    assert (tmp_path / "run" / "latest.ckpt").exists()

    assert main(base + ["--test-only"]) == 0
    tested, _ = _results(capsys)
    assert tested == trained  # best.ckpt, scored again

    assert main(base + ["--epochs", "2", "--resume"]) == 0
    resumed, lines = _results(capsys)
    assert any(line.startswith("Resumed from epoch 1") for line in lines)
    assert "Epoch 2," in "\n".join(lines) and "Epoch 1," not in "\n".join(lines)

    assert main(base + ["--epochs", "2", "--resume", "auto"]) == 0
    again, lines = _results(capsys)
    assert any(line.startswith("Resumed from epoch 2") for line in lines)
    assert again == resumed  # nothing left to train: best.ckpt scored again


def test_exit_codes_follow_the_reference(tmp_path, capsys):
    empty = ["--preset", "smoke", "--out-dir", str(tmp_path / "empty")] + SMALL
    assert main(empty + ["--resume"]) == 1
    assert "not found — train first or check --out-dir" in capsys.readouterr().err
    assert main(empty + ["--test-only"]) == 1
    assert "best.ckpt not found" in capsys.readouterr().err
    assert main(empty + ["--epochs", "1", "--resume", "auto"]) == 0
    result, lines = _results(capsys)
    assert "No resumable checkpoint found — starting fresh" in lines
    assert main(["--preset", "nope", "--device", "cpu"]) == 1  # preset() refuses it
    assert "preset must be one of" in capsys.readouterr().err
    assert main(["--preset", "bandedbranch", "--print-config"]) == 0  # ported
    assert json.loads(capsys.readouterr().out)["mesh"]["branch"] == 2
    for flag in (["--platform", "cpu"], ["--resume", "always"]):
        with pytest.raises(SystemExit) as info:
            main(["--preset", "smoke"] + flag)
        assert info.value.code == 2
    # --distributed joins a job from the launcher's environment; none here
    assert main(["--preset", "smoke", "--distributed"] + SMALL) == 1
    assert "init_distributed needs world_size and rank" in capsys.readouterr().err
    assert main(["--preset", "smoke", "--print-config", "--top-k", "3"]) == 0
    assert json.loads(capsys.readouterr().out)["train"]["top_k"] == 3


@pytest.mark.parametrize("flags", [
    [],
    ["--preset", "smoke", "--epochs", "3", "--batch-size", "8", "--lr", "0.01",
     "--lr-schedule", "cosine", "--warmup-epochs", "0.5", "--min-lr-fraction", "0.1"],
    ["--weight-decay", "0", "--grad-clip-norm", "2.5", "--loss", "huber", "--patience", "4",
     "--top-k", "2", "--shuffle", "--seed", "7", "--out-dir", "runs/a"],
    ["--steps-per-superstep", "4", "--normalize", "std", "--horizon", "3", "--rows", "6",
     "--timesteps", "500", "--sparse", "--checkpoint-every-steps", "5"],
    ["--data", "city.npz", "-date", "0101", "0630", "0701", "0731", "-cpt", "4", "2", "1",
     "--val-ratio", "0.3", "--m-graphs", "2", "--kernel", "localpool", "--cheb-k", "3",
     "--lstm-backend", "pallas", "--checkify", "nan"],
    ["--lstm-fused", "--lstm-unroll", "4", "--dtype", "bfloat16", "--checkify", "all",
     "--val-ratio", "0.25"],
    ["--preset", "branchpar", "--branch-parallel", "1", "--region-strategy", "auto",
     "--halo", "4"],
    ["--preset", "multicity", "--region-strategy", "banded"],
])
def test_shared_flags_reach_the_same_config(flags):
    port = config_from_args(build_parser().parse_args(flags))
    jax_cfg = jax_config_from_args(jax_build_parser().parse_args(flags))
    assert port == ExperimentConfig.from_dict(jax_cfg.to_dict())
    assert build_parser().parse_args(flags).device == "cuda"  # the card by default


#: the JAX CLI's flags whose features the port has (their ``dest``)
PORTED_FLAGS = ("data", "dates", "obs_len", "val_ratio", "m_graphs", "kernel", "cheb_k",
                "lstm_backend", "lstm_fused", "lstm_unroll", "matmul_precision", "checks",
                "debug_nans", "trace_out", "profile", "export", "virtual_devices",
                "distributed", "region_strategy", "halo")


@pytest.mark.parametrize("dest", PORTED_FLAGS)
def test_ported_flag_has_the_jax_names_default_and_choices(dest):
    def action(parser):
        return next(a for a in parser._actions if a.dest == dest)

    port, ref = action(build_parser()), action(jax_build_parser())
    fields = ("option_strings", "default", "choices", "nargs", "type", "const", "metavar")
    assert {f: getattr(port, f) for f in fields} == {f: getattr(ref, f) for f in fields}


@pytest.mark.parametrize("name", ["scaled", "bandedbranch", "branchpar", "multicity"])
def test_jax_mesh_section_round_trips_unchanged(name):
    """``MeshConfig`` reads, checks and writes every JAX mesh field, so a
    ``scaled`` config (``region_strategy="auto"``) or a ``bandedbranch`` one
    (``halo=16``) read by the port and written back keeps them."""
    from stmgcn_tpu.config import preset as jax_preset
    from stmgcn_tpu_torch.config import MeshConfig

    want = jax_preset(name).to_dict()
    cfg = ExperimentConfig.from_dict(want)
    assert json.loads(json.dumps(cfg.to_dict()["mesh"])) == json.loads(
        json.dumps(want["mesh"]))
    assert ExperimentConfig.from_dict(cfg.to_dict()) == cfg
    for bad, match in (({"region_strategy": "ring"}, "gspmd|banded|auto"),
                       ({"halo": -1}, "halo"), ({"dp": 0}, "mesh extents")):
        with pytest.raises(ValueError, match=match):
            MeshConfig(**bad)


def test_export_writes_an_artifact_that_loads_and_matches(tmp_path, capsys):
    import numpy as np

    from stmgcn_tpu_torch import Forecaster
    from stmgcn_tpu_torch.data import synthetic_dataset
    from stmgcn_tpu_torch.export import ExportedForecaster

    out_dir, path = tmp_path / "run", str(tmp_path / "model.stmgx")
    base = ["--preset", "smoke", "--out-dir", str(out_dir)] + SMALL
    assert main(base + ["--epochs", "1", "--export", path]) == 0
    trained, _ = _results(capsys)  # the results line comes before the export
    assert set(trained["results"]) == {"train", "test"}
    fc = Forecaster.from_checkpoint(str(out_dir / "best.ckpt"), device="cpu")
    ex = ExportedForecaster.load(path, device="cpu")
    city = synthetic_dataset(rows=3, n_timesteps=240, seed=fc.config.data.seed)
    supports = fc.config.model.support_config.build_all(
        list(city.adjs.values())[:fc.config.model.m_graphs])
    rows = np.random.default_rng(0).uniform(0, 50, (3, fc.seq_len, 9, 1)).astype(np.float32)
    np.testing.assert_allclose(ex.predict(supports, rows), fc.predict(supports, rows),
                               rtol=1e-5, atol=1e-4)
    missing = str(tmp_path / "no_such_dir" / "model.stmgx")
    assert main(base + ["--test-only", "--export", missing]) == 1
    assert "export failed" in capsys.readouterr().err


def test_profile_writes_a_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    base = ["--preset", "smoke", "--out-dir", str(tmp_path / "run")] + SMALL
    assert main(base + ["--epochs", "1", "--profile", str(prof)]) == 0
    assert set(_results(capsys)[0]["results"]) == {"train", "test"}
    traces = list(prof.glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_serve_bench_prints_one_json_line(capsys):
    assert main(["serve-bench", "--device", "cpu", "--rows", "2", "--batch", "4",
                 "--buckets", "1,4", "--clients", "2", "--per-client", "2", "--iters", "2",
                 "--warmup", "1", "--no-fleet"]) == 0
    lines = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert set(record) == {"shapes", "legs", "engine_stats", "speedup", "captured_at"}
    assert record["shapes"]["n_nodes"] == 4
