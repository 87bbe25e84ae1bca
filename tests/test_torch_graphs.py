"""Captured programs (``stmgcn_tpu_torch/graphs.py``), the device-tensor
optimizer, the training programs and the capture telemetry, on the CPU.

Nothing here captures a CUDA graph: the CPU has none, and ``python3
chip_smoke.py`` on the card is what holds the graphs against the eager
route. These tests drive everything around the capture:

- :class:`Optimizer.apply` from a buffer of per-step scalars equals
  ``Optimizer.step`` bit for bit, and the gradients and moments it reads
  stay the same tensors across steps, ``zero_grad`` and a state load;
- the training programs, driven from their static index, mask and scalar
  buffers, equal the one-step programs bit for bit over two epochs (a tail
  short of S and a fleet class included), and one block and a tail step
  equal the JAX ``make_series_superstep_fns`` / ``make_fleet_superstep_fns``
  losses and parameters at ``tests/test_torch_train.py``'s trainer
  tolerances (losses rtol 2e-5, parameters atol 2e-5);
- :class:`CapturedProgram`'s bookkeeping under a stand-in pool whose
  "capture" runs the body (as a capture runs its Python) and whose replay
  runs it on the static buffers: padding, launch-count deltas (and counts
  from other threads during a capture, which are not the capture's),
  concurrent callers of one program and of two programs whose outputs
  share the pool's memory, a swap between copy-in and replay, and a
  trainer whose programs all go through it, bitwise equal to the eager one,
  with no capture after warmup; the same with the health twins, the
  divergence guard's rollback and a poisoned step, where the one-step twin
  a replay first captures in epoch 2 is the one recapture;
- with health and the guard off, a block of 3 and a one-step program run
  exactly the aten ops they ran before the health twins existed (the
  counterpart of ``tests/test_health.py::TestFreeWhenOff``'s primitive-count
  pin, counted with a ``TorchDispatchMode``);
- ``restore`` writes into the live parameter and moment tensors;
- ``obs/graphmon.py``'s warmup, freeze and upload semantics, as
  ``tests/test_obs.py::TestJaxMonitoring`` holds jaxmon's;
- ``graphs=True`` on the CPU raising by name.
"""

import copy
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.experiment import build_trainer as jax_build_trainer
from stmgcn_tpu.train.step import make_fleet_superstep_fns, make_series_superstep_fns
from stmgcn_tpu_torch import ExperimentConfig, Forecaster, ServingConfig, build_trainer, preset
from stmgcn_tpu_torch.experiment import build_dataset, build_model, build_supports
from stmgcn_tpu_torch.graphs import (
    CapturedProgram,
    DeviceOps,
    GraphPool,
    Program,
    resolve_graphs,
)
from stmgcn_tpu_torch.models import from_jax_params
from stmgcn_tpu_torch.obs import graphmon
from stmgcn_tpu_torch.obs.registry import REGISTRY
from stmgcn_tpu_torch.ops import counters
from stmgcn_tpu_torch.serving import engine as engine_module
from stmgcn_tpu_torch.serving.engine import ServingEngine, _bucket_program
from stmgcn_tpu_torch.train.step import make_optimizer

torch.set_num_threads(1)

S = 3
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5


class StandInPool(DeviceOps):
    """A CPU stand-in for :class:`GraphPool`: the warm-up runs the body;
    "capture" runs it once more (a capture runs the body's Python, so its
    launches are recorded), restoring ``preserve`` (tensors whose values a
    real capture would not change) afterwards; a replay runs the body on
    the static buffers and writes the captured outputs, with the counts of
    ``counted`` (``(wrapper, attr)`` pairs) put back, since a replay calls
    no wrapper. ``on_replay`` runs before each replay. The thread that
    runs the "capture" is the one capturing."""

    def __init__(self, preserve=(), counted=(), on_replay=None):
        super().__init__(torch.device("cpu"))
        self.lock = threading.Lock()
        self.reserved_bytes = 0
        self.preserve = list(preserve)
        self.counted = list(counted)
        self.on_replay = on_replay
        self.captures = self.replays = 0
        self._capturing = None

    def capturing(self):
        return threading.get_ident() == self._capturing

    def warmup(self, fn):
        return fn()

    def capture(self, fn, generator=None):
        saved = [t.detach().clone() for t in self.preserve]
        self._capturing = threading.get_ident()
        try:
            static = self.static_output(fn())
        finally:
            self._capturing = None
        with torch.no_grad():
            for t, v in zip(self.preserve, saved):
                t.copy_(v)
        self.captures += 1

        def graph():
            with torch.inference_mode(static.is_inference()):
                static.copy_(fn())

        return graph, static

    def static_output(self, out):
        """Where a captured output lives: its own tensor."""
        return out

    def replay(self, graph):
        if self.on_replay is not None:
            self.on_replay()
        before = [getattr(fn, attr) for fn, attr in self.counted]
        graph()
        for (fn, attr), value in zip(self.counted, before):
            setattr(fn, attr, value)
        self.replays += 1


class SharedScratchPool(StandInPool):
    """A stand-in pool in which every program's output lives in one shared
    buffer, as a later capture's output may live in an earlier graph's
    scratch; a replay holds the buffer a while before its readback is
    enqueued, so a replay of another program in between would overwrite
    it."""

    def __init__(self, size):
        super().__init__()
        self.shared = torch.zeros(size)

    def static_output(self, out):
        view = self.shared[:out.numel()].view(out.shape)
        view.copy_(out)
        return view

    def replay(self, graph):
        super().replay(graph)
        time.sleep(0.0005)  # another program's replay would land here


def _fake_kernel():
    def kernel():
        pass

    kernel.launches = 0
    return kernel


# -- the optimizer ---------------------------------------------------------

CASES = {
    "adam_l2": dict(lr=2e-3, weight_decay=1e-4),
    "cosine_clip_l2": dict(lr=5e-3, weight_decay=1e-4, schedule="cosine", warmup_steps=2,
                           decay_steps=9, min_lr_fraction=0.1, grad_clip_norm=0.5),
}


def _params_and_grads(steps):
    rng = np.random.default_rng(0)
    shapes = [(6, 5), (5,), (2, 3, 4)]
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * (3.0 if k % 2 else 0.2)).astype(np.float32) for s in shapes]
             for k in range(steps)]
    return init, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_apply_from_scalar_buffer_equals_step_bitwise(name):
    """The captured update reads its per-step scalars from a device buffer
    the host filled: the same floats as the eager step."""
    steps = 8
    init, grads = _params_and_grads(steps)
    pa = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in init]
    pb = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in init]
    oa, ob = make_optimizer(pa, **CASES[name]), make_optimizer(pb, **CASES[name])
    buffer = torch.tensor([ob.scalars(k) for k in range(steps)], dtype=torch.float32)
    for k, g in enumerate(grads):
        for opt, params in ((oa, pa), (ob, pb)):
            opt.zero_grad()
            for p, gk in zip(params, g):
                p.grad.copy_(torch.from_numpy(gk))
        oa.step()
        ob.apply(buffer[k])
        assert all(torch.equal(a, b) for a, b in zip(pa, pb)), k
    assert oa.count == steps and ob.count == 0  # apply leaves the count to the caller


def test_optimizer_tensors_stay_put():
    """Gradients and moments are allocated once: zero_grad, steps and a
    state load write into them."""
    cfg = preset("smoke")
    model = build_model(cfg, 1, device="cpu", generator=torch.Generator().manual_seed(0))
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    opt = make_optimizer(params, **CASES["cosine_clip_l2"])
    ptrs = [t.data_ptr() for t in [p.grad for p in params] + opt.exp_avg + opt.exp_avg_sq]
    rng = np.random.default_rng(1)
    for _ in range(3):
        opt.zero_grad()
        for p in params:
            p.grad.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)))
        opt.step()
    tree = opt.state_tree(names, model.m_graphs)
    opt.zero_grad()
    assert all(float(p.grad.abs().sum()) == 0 for p in params)
    assert [t.data_ptr() for t in [p.grad for p in params] + opt.exp_avg
            + opt.exp_avg_sq] == ptrs
    fresh = make_optimizer([torch.nn.Parameter(p.detach().clone()) for p in params],
                           **CASES["cosine_clip_l2"])
    fresh_ptrs = [t.data_ptr() for t in fresh.exp_avg + fresh.exp_avg_sq]
    fresh.load_state_tree(tree, names, model.m_graphs)
    assert [t.data_ptr() for t in fresh.exp_avg + fresh.exp_avg_sq] == fresh_ptrs
    assert fresh.count == 3
    assert all(torch.equal(a, b) for a, b in zip(fresh.exp_avg_sq, opt.exp_avg_sq))


# -- the training programs -------------------------------------------------

def _smoke(out_dir, steps):
    cfg = preset("smoke")
    cfg.data.rows, cfg.data.n_timesteps = 4, 24 * 7 + 80
    cfg.train.epochs, cfg.train.batch_size = 2, 16
    cfg.train.shuffle, cfg.train.steps_per_superstep = True, steps
    cfg.train.out_dir = str(out_dir)
    return cfg


def _multicity(out_dir, steps, **train):
    from stmgcn_tpu_torch.config import MeshConfig

    cfg = preset("multicity")
    cfg.mesh = MeshConfig()
    cfg.data.city_rows, cfg.data.city_timesteps = (5, 4), (24 * 7 * 2, 24 * 7 * 2 + 24)
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 8
    cfg.model.lstm_num_layers = 1
    cfg.train.epochs, cfg.train.batch_size = 2, 8
    cfg.train.fleet, cfg.train.steps_per_superstep = True, steps
    cfg.train.out_dir = str(out_dir)
    for key, value in train.items():
        setattr(cfg.train, key, value)
    return cfg


def _state_equal(a, b) -> bool:
    sb = b.model.state_dict()
    return all(torch.equal(v, sb[k]) for k, v in a.model.state_dict().items())


def test_series_blocks_and_tail_equal_one_step_programs_bitwise(tmp_path):
    runs = []
    for steps in (1, S):
        trainer = build_trainer(_smoke(tmp_path / f"s{steps}", steps), device="cpu",
                                verbose=False)
        runs.append((trainer, trainer.train()))
    (one, h1), (blocks, hs) = runs
    assert blocks.train_steps_per_epoch % S  # a tail short of S
    assert h1 == hs and _state_equal(one, blocks)
    assert all(torch.equal(a, b) for a, b in zip(one.optimizer.exp_avg_sq,
                                                 blocks.optimizer.exp_avg_sq))
    assert sorted(k[1] for k in blocks._programs) == [1, S]
    assert all(not p.captured for p in blocks._programs.values())


def test_fleet_blocks_equal_one_step_programs_bitwise(tmp_path):
    runs = []
    for steps in (1, 4):
        trainer = build_trainer(_multicity(tmp_path / f"s{steps}", steps), device="cpu",
                                verbose=False)
        runs.append((trainer, trainer.train()))
    (one, h1), (blocks, h4) = runs
    assert blocks.train_path == "fleet_superstep" and one.fleet_plan is not None
    assert [k[0][0] for k in blocks._programs] == ["class"] * len(blocks._programs)
    assert h1 == h4 and _state_equal(one, blocks)


def _jax_series(tmp_path):
    cfg = jax_preset("default")
    cfg.data.rows = 4
    cfg.data.n_timesteps = 24 * 7 + 80
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 8
    cfg.model.lstm_num_layers = 2
    cfg.train.batch_size = 8
    cfg.train.lr_schedule, cfg.train.warmup_epochs = "cosine", 0.5
    cfg.train.grad_clip_norm = 1.0
    cfg.train.steps_per_superstep = S
    cfg.train.out_dir = str(tmp_path / "jax")
    port = cfg.to_dict()
    port["train"]["out_dir"] = str(tmp_path / "port")
    return cfg, ExperimentConfig.from_dict(port)


def _assert_agree(port, losses, jt, jax_losses):
    np.testing.assert_allclose(losses, np.asarray(jax_losses), rtol=LOSS_RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    for name, value in port.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=PARAM_ATOL,
                                   err_msg=name)


def test_series_block_and_tail_match_jax_superstep(tmp_path):
    jax_cfg, cfg = _jax_series(tmp_path)
    jt = jax_build_trainer(jax_cfg, verbose=False)
    pt = build_trainer(cfg, device="cpu", verbose=False,
                       initial_state=from_jax_params(jax.tree.map(np.asarray, jt.params), 3))
    batches = list(pt.batches("train"))
    blocks = [batches[:S], batches[S:S + 1]]  # a block, then a tail step
    fns = make_series_superstep_fns(jt.model, jt._optimizer, "mse", horizon=1)
    series, targets = jt._resident_series(0), jt._resident_targets("train", 0)
    jax_losses, port_losses = [], []
    for block in blocks:
        idx = jnp.asarray(np.stack([b.indices for b in block]).astype(np.int32))
        mask = jnp.asarray(np.stack([np.arange(len(b)) < b.n_real for b in block]),
                           jnp.float32)
        jt.params, jt.opt_state, losses = fns.train_superstep(
            jt.params, jt.opt_state, jt.supports, series, targets, jt._offsets_device(), idx,
            mask)
        jax_losses += list(np.asarray(losses))
        port_losses += pt._run_block(block)
    assert pt.optimizer.count == pt.global_step == S + 1
    _assert_agree(pt, port_losses, jt, jax_losses)


def test_fleet_class_block_matches_jax_fleet_superstep(tmp_path):
    cfg = _multicity(tmp_path / "port", 4)
    jax_cfg = jax_preset("multicity")
    jax_cfg = type(jax_cfg).from_dict(cfg.to_dict())
    jax_cfg.train.out_dir = str(tmp_path / "jax")
    jt = jax_build_trainer(jax_cfg, verbose=False)
    pt = build_trainer(cfg, device="cpu", verbose=False,
                       initial_state=from_jax_params(jax.tree.map(np.asarray, jt.params), 3))
    padded = [c for c, info in pt._fleet_cities.items() if info.pad]
    assert padded, "the multicity cities should share one padded class"
    city = padded[0]
    run = [b for b in pt.batches("train") if b.city == city]
    block, tail = run[:4], run[4:5]
    info = jt._fleet_cities[city]
    targets, bases = jt._fleet_targets("train", info.cls)
    fns = make_fleet_superstep_fns(jt.model, jt._optimizer, "mse", horizon=1)
    n = pt._sites[pt._city_site[city][0]].series.shape[1]
    jax_losses, port_losses = [], []
    for steps in (block, tail):
        idx = np.stack([np.asarray(b.indices) + bases[city] for b in steps]).astype(np.int32)
        mask = np.stack([(np.arange(len(b)) < b.n_real)[:, None]
                         * (np.arange(n) < info.n_real)[None, :] for b in steps])
        k = len(steps)
        jt.params, jt.opt_state, losses = fns.train_superstep(
            jt.params, jt.opt_state, jt._fleet_supports(info.cls), jt._fleet_series(info.cls),
            targets, jt._offsets_device(), jnp.asarray(idx), jnp.asarray(mask, jnp.float32),
            jnp.full((k,), info.slot, jnp.int32), jnp.full((k,), info.n_real, jnp.int32))
        jax_losses += list(np.asarray(losses))
        port_losses += pt._run_block(steps)
    _assert_agree(pt, port_losses, jt, jax_losses)


def test_restore_writes_into_the_live_tensors(tmp_path):
    trainer = build_trainer(_smoke(tmp_path, S), device="cpu", verbose=False)
    trainer.n_epochs = 1
    live = ([p for p in trainer.model.parameters()] + [p.grad for p in trainer.model.parameters()]
            + trainer.optimizer.exp_avg + trainer.optimizer.exp_avg_sq)
    ptrs = [t.data_ptr() for t in live]
    trainer.train()
    saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    moments = [t.clone() for t in trainer.optimizer.exp_avg]
    trainer.n_epochs = 2
    trainer.train()  # moves everything on
    trainer.restore(trainer.latest_prev_path)
    assert [t.data_ptr() for t in live] == ptrs
    assert all(torch.equal(v, saved[k]) for k, v in trainer.model.state_dict().items())
    assert all(torch.equal(a, b) for a, b in zip(trainer.optimizer.exp_avg, moments))


# -- CapturedProgram's bookkeeping -----------------------------------------

def test_program_pads_the_static_inputs_and_returns_the_output():
    seen = []

    def body(v):
        seen.append(v["x"].clone())
        return v["x"] * 2 + v["k"].to(torch.float32)[:, None]

    spec = {"x": ((4, 3), torch.float32), "k": ((4,), torch.int32)}
    for program in (Program(body, spec, DeviceOps("cpu")),
                    CapturedProgram(body, spec, StandInPool())):
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        out = program({"x": x, "k": np.array([1, 2, 3])})
        want = np.zeros((4, 3), np.float32)
        want[:2] = x * 2
        want += np.array([1, 2, 3, 0], np.float32)[:, None]
        np.testing.assert_array_equal(out.numpy(), want)
        out = program({"x": x[:1]})  # a shorter request: the rest is zeros
        np.testing.assert_array_equal(out.numpy()[1:], 0)
        np.testing.assert_array_equal(out.numpy()[0], x[0] * 2)
        with pytest.raises(ValueError, match="static input 'x'"):
            program({"x": np.zeros((5, 3), np.float32)})
        with pytest.raises(KeyError):
            program({"y": x})


def test_replays_add_the_captured_launches():
    kernel = _fake_kernel()

    def body(v):
        counters.bump(kernel)
        counters.bump(kernel)
        return v["x"] + 1

    pool = StandInPool(counted=[(kernel, "launches")])
    program = CapturedProgram(body, {"x": ((2,), torch.float32)}, pool)
    before = REGISTRY.counter("graphs.captures").value
    program({"x": np.ones(2, np.float32)})  # warm-up (counted) + capture (not)
    assert kernel.launches == 2 and pool.captures == 1
    assert program.deltas == {(kernel, "launches"): 2}
    assert REGISTRY.counter("graphs.captures").value == before + 1
    for k in range(3):
        out = program({"x": np.full(2, k, np.float32)})
        np.testing.assert_array_equal(out.numpy(), np.full(2, k + 1, np.float32))
    assert kernel.launches == 2 + 3 * 2 and pool.replays == 3
    eager = Program(body, {"x": ((2,), torch.float32)}, DeviceOps("cpu"))
    kernel.launches = 0
    for _ in range(4):
        eager({})
    assert kernel.launches == 4 * 2  # the same per call


def test_counts_from_other_threads_during_a_capture_are_not_recorded():
    kernel = _fake_kernel()
    calls = []

    def body(v):
        counters.bump(kernel)
        calls.append(None)
        if len(calls) == 2:  # the capture: an eager forward on another thread
            other = threading.Thread(target=counters.bump, args=(kernel, "launches", 5))
            other.start()
            other.join()
        return v["x"] + 1

    program = CapturedProgram(body, {"x": ((2,), torch.float32)},
                              StandInPool(counted=[(kernel, "launches")]))
    program({})
    assert program.deltas == {(kernel, "launches"): 1}
    assert kernel.launches == 1 + 5  # the warm-up and the other thread's
    program({})
    assert kernel.launches == 1 + 5 + 1


def _run_callers(callers, n_threads, rounds):
    """Run ``callers(k, r)`` from ``n_threads`` threads, ``rounds`` each,
    switching threads often; returns what they raised or reported."""
    errors = []

    def caller(k):
        try:
            for r in range(rounds):
                callers(k, r, errors)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    return errors


def test_concurrent_callers_of_two_programs_sharing_pool_memory():
    pool = SharedScratchPool(8)
    programs = [CapturedProgram(lambda v, a=a: v["x"] * a, {"x": ((8,), torch.float32)}, pool,
                                name=f"rung {a}") for a in (2, 3)]
    for program in programs:
        program({})

    def call(k, r, errors):
        a, program = (2, 3)[k % 2], programs[k % 2]
        value = float(100 * k + r)
        out = program({"x": np.full(8, value, np.float32)}).numpy()
        if not np.all(out == a * value):
            errors.append((k, r, out))

    assert not _run_callers(call, 6, 20)


def test_concurrent_callers_of_one_program_keep_their_inputs():
    def body(v):
        first = v["x"].clone()
        time.sleep(0.001)  # another caller's copy-in would land here
        return first + v["x"]

    program = CapturedProgram(body, {"x": ((8,), torch.float32)}, StandInPool())
    program({})

    def call(k, r, errors):
        value = float(100 * k + r)
        out = program({"x": np.full(8, value, np.float32)}).numpy()
        if not np.all(out == 2 * value):
            errors.append((k, r, out))

    assert not _run_callers(call, 6, 20)


def _small_forecaster():
    cfg = preset("smoke")
    cfg.data.rows, cfg.data.n_timesteps = 3, 24 * 7 + 40
    ds = build_dataset(cfg)
    model = build_model(cfg, ds.n_feats, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    derived = {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}
    fc = Forecaster(model, model.state_dict(), ds.normalizer, cfg, derived, device="cpu")
    return fc, build_supports(cfg, ds), ds


def test_a_swap_between_copy_in_and_replay_never_mixes_generations(monkeypatch):
    fc, supports, ds = _small_forecaster()
    sup = torch.as_tensor(supports)
    pools = []
    state = {"armed": False}

    def on_replay():
        if state["armed"]:  # this dispatch has read its generation already
            state["armed"] = False
            engine.swap_params(new_state)

    def stand_in(device):
        pools.append(StandInPool(on_replay=on_replay))
        return pools[-1]

    monkeypatch.setattr(engine_module, "GraphPool", stand_in)
    cfg = ServingConfig(buckets=(1, 2))
    engine = ServingEngine({b: _bucket_program(sup, torch.device("cpu")) for b in (1, 2)},
                           copy.deepcopy(fc.model).eval(), fc.normalizer, fc.expected, cfg,
                           torch.device("cpu"), graphs=True)
    new_state = {k: v + 0.05 for k, v in fc.model.state_dict().items()}
    rows = ds.denormalize(ds.arrays("test")[0])[:2]
    swaps = REGISTRY.counter("graphs.swap_captures").value
    try:
        old = fc.predict(supports, rows)
        state["armed"] = True
        got, gen = engine.predict_direct(rows, with_generation=True)
        assert gen == 0 and engine.generation == 1
        np.testing.assert_allclose(got, old, rtol=1e-5, atol=1e-4)
        fresh = Forecaster(build_model(fc.config, fc.derived["input_dim"], device="cpu"),
                           new_state, fc.normalizer, fc.config, fc.derived, device="cpu")
        got, gen = engine.predict_direct(rows, with_generation=True)
        assert gen == 1
        np.testing.assert_allclose(got, fresh.predict(supports, rows), rtol=1e-5, atol=1e-4)
        assert not np.allclose(got, old, rtol=1e-5, atol=1e-4)
        assert len(pools) == 2 and REGISTRY.counter("graphs.swap_captures").value == swaps + 2
    finally:
        engine.close()


def test_trainer_through_stand_in_captures_equals_eager_bitwise(tmp_path):
    runs = []
    for graphed in (False, True):
        trainer = build_trainer(_smoke(tmp_path / str(graphed), S), device="cpu",
                                verbose=False)
        if graphed:
            opt = trainer.optimizer
            trainer.graphs = True
            trainer.graph_pool = StandInPool(
                preserve=list(opt.params) + [p.grad for p in opt.params] + opt.exp_avg
                + opt.exp_avg_sq)
        runs.append((trainer, trainer.train(), graphmon.snapshot()))
        trainer.test(checkpoint=None)
    (eager, he, _), (graphed, hg, snap) = runs
    assert he == hg and _state_equal(eager, graphed)
    programs = graphed._programs.values()
    assert all(p.captured and p.graph is not None for p in programs)
    assert graphed.graph_pool.captures == len(graphed._programs) == 2  # S and the tail
    assert snap["recaptures_after_warmup"] == 0


def test_health_twins_and_guard_through_stand_in_captures_equal_eager(tmp_path):
    from stmgcn_tpu_torch.resilience import FaultPlan, FaultSpec

    runs = []
    for graphed in (False, True):
        cfg = _smoke(tmp_path / str(graphed), 7)  # one block of 7 an epoch, no tail
        cfg.train.batch_size, cfg.train.divergence_guard = 8, True
        cfg.health.enabled = True
        trainer = build_trainer(cfg, device="cpu", verbose=False,
                                fault_plan=FaultPlan(FaultSpec("poison", epoch=2, step=2)))
        assert trainer.train_steps_per_epoch == 7
        if graphed:
            opt = trainer.optimizer
            trainer.graphs = True
            trainer.graph_pool = StandInPool(
                preserve=list(opt.params) + [p.grad for p in opt.params] + opt.exp_avg
                + opt.exp_avg_sq)
        runs.append((trainer, trainer.train(), graphmon.snapshot()))
    (eager, he, _), (graphed, hg, snap) = runs
    assert he == hg and _state_equal(eager, graphed) and graphed._guard.total == 1
    # the 7-step twin in epoch 1; its block rolled back in epoch 2 and replayed
    # through the one-step twin, first captured then: the one recapture
    assert sorted(graphed._programs) == [(("city", 0), 1, "train", True),
                                         (("city", 0), 7, "train", True)]
    assert graphed.graph_pool.captures == 2 and snap["recaptures_after_warmup"] == 1
    assert (tmp_path / "True" / "health.jsonl").read_text() == (
        tmp_path / "False" / "health.jsonl").read_text()


#: aten ops of a plain block of 3 steps and of a one-step program of the
#: smoke trainer below, including the static inputs' fill and the readback,
#: as counted before the health twins and the guard existed (3 more a step
#: since the gate's node mean sums in float64: its float64 cast, and the
#: cast back of its forward and its backward; 3 more since the dense conv
#: takes one product per branch at M=1 too: the supports' unbind, the stack
#: and its backward)
PLAIN_BLOCK_OPS, PLAIN_STEP_OPS = 1643, 559


def test_plain_programs_unchanged_with_health_and_guard_off(tmp_path):
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    cfg = _smoke(tmp_path, S)
    cfg.train.epochs, cfg.train.batch_size, cfg.train.shuffle = 1, 8, False
    trainer = build_trainer(cfg, device="cpu", verbose=False)
    batches = list(trainer.batches("train"))
    counted = []
    for block in (batches[:S], batches[S:S + 1]):
        with Count() as c:
            trainer._run_block(block)
        counted.append(sum(c.ops.values()))
    assert counted == [PLAIN_BLOCK_OPS, PLAIN_STEP_OPS]
    assert all(not key[3] for key in trainer._programs) and trainer._snapshot is None


# -- telemetry -------------------------------------------------------------

class TestGraphMonitoring:
    def test_warmup_mark_and_recapture_gauge(self):
        graphmon.record_capture(1.0)
        graphmon.mark_warmup_complete()
        assert graphmon.snapshot()["recaptures_after_warmup"] == 0
        graphmon.record_capture(2.0, swap=True)  # a swap is no recapture
        assert graphmon.snapshot()["recaptures_after_warmup"] == 0
        graphmon.record_capture(3.0)
        assert graphmon.snapshot()["recaptures_after_warmup"] >= 1
        frozen = graphmon.freeze_recaptures()
        graphmon.record_capture(4.0)
        assert graphmon.snapshot()["recaptures_after_warmup"] == int(frozen)
        graphmon.mark_warmup_complete()  # re-marking unfreezes and re-baselines
        assert graphmon.snapshot()["recaptures_after_warmup"] == 0

    def test_record_upload_and_per_step_rate(self):
        before = REGISTRY.counter("graphs.upload_bytes").value
        graphmon.record_upload(1000)
        graphmon.record_upload(1000)
        snap = graphmon.snapshot(steps=2)
        assert snap["upload_bytes"] - int(before) == 2000
        assert "upload_bytes_per_step" in snap

    def test_programs_count_their_uploads(self):
        program = Program(lambda v: v["x"] + 0, {"x": ((3, 2), torch.float32)},
                          DeviceOps("cpu"))
        before = REGISTRY.counter("graphs.upload_bytes").value
        program({})
        assert REGISTRY.counter("graphs.upload_bytes").value - before == 3 * 2 * 4


# -- graphs on the CPU -----------------------------------------------------

def test_graphs_true_on_the_cpu_raises_by_name(tmp_path):
    assert resolve_graphs(None, torch.device("cpu")) is False
    assert resolve_graphs(False, torch.device("cpu")) is False
    with pytest.raises(ValueError, match="graphs=True"):
        build_trainer(_smoke(tmp_path, 1), device="cpu", graphs=True, verbose=False)
    fc, supports, _ = _small_forecaster()
    with pytest.raises(ValueError, match="graphs=True"):
        fc.serving_engine(supports, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        GraphPool(torch.device("cpu"))


def test_sr_seed_under_graphs_needs_register_generator_state(tmp_path, monkeypatch):
    from stmgcn_tpu_torch.train import trainer as trainer_module

    cfg = _smoke(tmp_path, 1)
    cfg.train.precision, cfg.train.sr_seed = "bf16", 7
    monkeypatch.setattr(trainer_module, "resolve_graphs", lambda graphs, device: True)
    monkeypatch.delattr(torch.cuda.CUDAGraph, "register_generator_state", raising=False)
    with pytest.raises(RuntimeError, match="register_generator_state"):
        build_trainer(cfg, device="cpu", verbose=False)
