"""Span tracing in the port (``stmgcn_tpu_torch/obs/trace.py``), mirroring
``tests/test_obs.py``'s ``TestTracer``, ``TestTracedParity`` and
``TestTraceCliContract``.

- The tracer: nesting, the bounded ring, idempotent and unbalanced
  closes, the JSONL schema, the disabled path's shared no-op, the module
  switch, and a fence on tensors.
- Tracing is invisible to training: a traced run's parameters and losses
  are bitwise an untraced run's, a program runs the same aten ops with
  tracing on, and the trainer's spans are all there.
- The CLI's ``--trace-out``: the JSONL schema, nesting, span coverage of
  the wall window (>= 90%), the port's ``obs`` report's one-line JSON
  over the file, and the JAX package's report reading the same file.
- Serving: micro-batched requests record the batcher's four spans.
"""

import collections
import json
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stmgcn_tpu.obs.report import load_trace as jax_load_trace
from stmgcn_tpu.obs.report import summarize as jax_summarize
from stmgcn_tpu_torch import Forecaster, ServingConfig, build_trainer, preset
from stmgcn_tpu_torch.cli import main
from stmgcn_tpu_torch.config import ExperimentConfig, ObsConfig
from stmgcn_tpu_torch.experiment import build_dataset, build_model, build_supports
from stmgcn_tpu_torch.obs import trace as obs_trace
from stmgcn_tpu_torch.obs.cli import main as obs_main
from stmgcn_tpu_torch.obs.report import summarize
from stmgcn_tpu_torch.obs.trace import SCHEMA_VERSION, Tracer

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _tracing_off_after():
    yield
    obs_trace.configure(enable=False)


class TestTracer:
    def test_nesting_parent_depth(self):
        trc = Tracer()
        with trc.span("outer"):
            with trc.span("inner", step=3):
                pass
        outer = next(s for s in trc.spans() if s["name"] == "outer")
        inner = next(s for s in trc.spans() if s["name"] == "inner")
        assert inner["parent"] == outer["id"] and inner["depth"] == 1
        assert outer["parent"] == 0 and outer["depth"] == 0
        assert inner["attrs"] == {"step": 3}

    def test_record_span_inherits_open_nesting(self):
        trc = Tracer()
        with trc.span("outer") as sp:
            t0 = time.perf_counter()
            trc.record_span("retro", t0, t0 + 0.001)
            sp.end()
        retro = next(s for s in trc.spans() if s["name"] == "retro")
        outer = next(s for s in trc.spans() if s["name"] == "outer")
        assert retro["parent"] == outer["id"]

    def test_ring_is_bounded_and_counts_drops(self):
        trc = Tracer(capacity=8)
        for i in range(20):
            trc.record_span(f"s{i}", 0.0, 0.001)
        assert len(trc.spans()) == 8 and trc.dropped == 12
        assert trc.spans()[0]["name"] == "s12"
        trc.reset()
        assert trc.spans() == [] and trc.dropped == 0

    def test_end_is_idempotent(self):
        trc = Tracer()
        sp = trc.span("once")
        sp.end()
        sp.end()
        assert len(trc.spans()) == 1

    def test_unbalanced_close_unwinds_stack(self):
        trc = Tracer()
        outer = trc.span("outer")
        trc.span("abandoned")  # never closed (an exception path)
        outer.end()
        nxt = trc.span("after")
        assert nxt.parent == 0 and nxt.depth == 0
        nxt.end()

    def test_capacity_must_be_positive(self):
        with pytest.raises(ValueError):
            Tracer(capacity=0)

    def test_export_jsonl_schema(self, tmp_path):
        trc = Tracer(capacity=16)
        with trc.span("a"):
            with trc.span("b"):
                pass
        path = str(tmp_path / "t.jsonl")
        assert trc.export_jsonl(path) == 2
        objs = [json.loads(line) for line in open(path).read().splitlines()]
        meta, spans = objs[0], objs[1:]
        assert meta == {"schema_version": SCHEMA_VERSION, "kind": "meta", "capacity": 16,
                        "dropped": 0, "spans": 2}
        for s in spans:
            assert s["schema_version"] == SCHEMA_VERSION
            assert {"id", "parent", "depth", "name", "ts", "dur_ms"} <= set(s)

    def test_disabled_path_allocates_nothing(self):
        obs_trace.configure(enable=False)
        assert obs_trace.active_tracer() is None and obs_trace.enabled() is False
        assert obs_trace.span("x") is obs_trace.span("y")  # one shared no-op
        with obs_trace.span("z") as sp:
            sp.fence(torch.ones(2))

    def test_module_switch_roundtrip(self):
        trc = obs_trace.configure(capacity=32)
        assert obs_trace.active_tracer() is trc and obs_trace.enabled()
        with obs_trace.span("on"):
            pass
        assert trc.spans()[0]["name"] == "on"
        obs_trace.configure(enable=False)
        assert obs_trace.active_tracer() is None

    def test_fence_closes_after_the_tensors(self):
        trc = Tracer()
        sp = trc.span("device")
        sp.fence([torch.ones(3) * 2, "not a tensor"])
        assert [s["name"] for s in trc.spans()] == ["device"]

    def test_obs_section_reads_with_its_contract(self):
        d = preset("smoke").to_dict()
        d["obs"].update(trace=True, trace_path="t.jsonl", ring_capacity=128)
        assert ExperimentConfig.from_dict(d).obs == ObsConfig(True, "t.jsonl", 128, 1024)
        assert ObsConfig(trace=True, ring_capacity=0).violations()
        assert ObsConfig(reservoir=0).violations() and not ObsConfig().violations()
        d["obs"]["ring_capacity"] = 10**6
        with pytest.raises(ValueError, match="ring_capacity"):
            ExperimentConfig.from_dict(d)


# -- tracing is invisible to training ----------------------------------------------

def _smoke(tmp_path, name):
    cfg = preset("smoke")
    cfg.data.rows, cfg.data.n_timesteps = 3, 24 * 7 * 2 + 40
    cfg.train.epochs, cfg.train.batch_size, cfg.train.steps_per_superstep = 2, 8, 2
    cfg.train.out_dir = str(tmp_path / name)
    return cfg


def _train(tmp_path, traced):
    trc = obs_trace.configure(capacity=4096) if traced else obs_trace.configure(False)
    try:
        trainer = build_trainer(_smoke(tmp_path, str(traced)), device="cpu", verbose=False)
        history = trainer.train()
        return trainer, history, trc
    finally:
        obs_trace.configure(enable=False)


class TestTracedParity:
    def test_tracing_is_bit_invisible_to_training(self, tmp_path):
        plain, hist_plain, _ = _train(tmp_path, False)
        traced, hist_traced, trc = _train(tmp_path, True)
        assert hist_plain == hist_traced
        for (name, a), b in zip(plain.model.state_dict().items(),
                                traced.model.state_dict().values()):
            assert torch.equal(a, b), name
        names = {s["name"] for s in trc.spans()}
        assert {"train.host_pack", "train.upload", "train.superstep", "train.epoch",
                "train.train_epoch", "train.eval_epoch", "train.checkpoint",
                "event.train_start", "event.train_end"} <= names
        superstep = [s for s in trc.spans() if s["name"] == "train.superstep"]
        assert {s["attrs"]["s"] for s in superstep} == {1, 2}

    def test_a_program_runs_the_same_ops_traced(self, tmp_path):
        class Count(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.ops = collections.Counter()

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                self.ops[str(func)] += 1
                return func(*args, **(kwargs or {}))

        counted = []
        for traced in (False, True):
            obs_trace.configure(enable=traced)
            trainer = build_trainer(_smoke(tmp_path, f"ops{traced}"), device="cpu",
                                    verbose=False)
            block = list(trainer.batches("train"))[:2]
            with Count() as c:
                trainer._run_block(block)
            counted.append(c.ops)
        assert counted[0] == counted[1]


# -- the CLI's --trace-out -----------------------------------------------------------

class TestTraceCliContract:
    def test_traced_run_schema_and_obs_cli_stdout(self, tmp_path, capsys):
        trace_path = str(tmp_path / "trace.jsonl")
        assert main(["--preset", "smoke", "--device", "cpu", "--rows", "3",
                     "--timesteps", str(24 * 7 * 2 + 40), "--epochs", "2", "--batch-size",
                     "8", "--steps-per-superstep", "2", "--out-dir", str(tmp_path / "out"),
                     "--trace-out", trace_path]) == 0
        assert f"trace written to {trace_path}" in capsys.readouterr().err
        objs = [json.loads(line) for line in open(trace_path).read().splitlines()]
        meta, spans = objs[0], objs[1:]
        assert meta["kind"] == "meta" and meta["schema_version"] == SCHEMA_VERSION
        assert meta["spans"] == len(spans) and meta["dropped"] == 0
        ids = {s["id"] for s in spans}
        for s in spans:
            assert s["schema_version"] == SCHEMA_VERSION and s["dur_ms"] >= 0.0
            assert s["parent"] == 0 or s["parent"] in ids
        assert "train.test" in {s["name"] for s in spans}
        summary = summarize(spans)
        assert summary["coverage"] >= 0.90, summary

        assert obs_main([trace_path, "--format", "json"]) == 0
        out = capsys.readouterr().out
        assert out.count("\n") == 1  # exactly one JSON line
        doc = json.loads(out)
        assert doc["meta"]["spans"] == len(spans) and doc["summary"]["coverage"] >= 0.90

        # the JAX package's report reads the port's file the same way
        jmeta, jspans = jax_load_trace(trace_path)
        assert jmeta == meta and jax_summarize(jspans) == summary


# -- serving -------------------------------------------------------------------------

def test_micro_batched_requests_record_the_batcher_spans():
    cfg = preset("smoke")
    cfg.data.rows, cfg.data.n_timesteps = 3, 24 * 7 + 40
    ds = build_dataset(cfg)
    model = build_model(cfg, ds.n_feats, device="cpu", generator=torch.Generator().manual_seed(0))
    fc = Forecaster(model, model.state_dict(), ds.normalizer, cfg,
                    {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}, device="cpu")
    history = ds.denormalize(ds.arrays("test")[0][:3])
    engine = fc.serving_engine(build_supports(cfg, ds), config=ServingConfig(
        buckets=(1, 4), max_batch=4), device="cpu")
    untraced = engine.predict(history)
    trc = obs_trace.configure()
    traced = engine.predict(history)
    engine.close()
    np.testing.assert_array_equal(traced, untraced)
    names = [s["name"] for s in trc.spans()]
    assert names.count("serve.admit") == 1 and names.count("serve.queue") == 1
    device = next(s for s in trc.spans() if s["name"] == "serve.device")
    assert device["attrs"] == {"bucket": 4, "rows": 3, "requests": 1, "gen": 0}
    assert "serve.scatter" in names
