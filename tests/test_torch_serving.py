"""The port's ``Forecaster`` and ``ServingEngine`` on the CPU.

``Forecaster.predict`` matches the JAX ``Forecaster`` built from the same
weights (converted) and the same fitted normalizer: rtol 1e-5, atol 1e-4
in raw demand units — the normalizer's range is ~1e2, and the two
frameworks sum in other orders. The engine matches the port's own
``Forecaster.predict`` at every request size, padded buckets and oversized
splits included (rtol 1e-6, atol 1e-5: the forward is row-independent, but
a padded batch may take another matmul blocking), gives concurrent callers
their own rows, sheds or degrades at a full queue, serves inline when its
batcher dies, and stamps a swap's new generation.
"""

import itertools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.experiment import build_model as jax_build_model
from stmgcn_tpu.inference import Forecaster as JaxForecaster
from stmgcn_tpu_torch import Forecaster, ServingConfig, ServingEngine
from stmgcn_tpu_torch.config import ExperimentConfig
from stmgcn_tpu_torch.data import DemandDataset, WindowSpec, synthetic_dataset
from stmgcn_tpu_torch.experiment import build_model
from stmgcn_tpu_torch.models import from_jax_params
from stmgcn_tpu_torch.ops import SupportConfig
from stmgcn_tpu_torch.serving import Overloaded
from stmgcn_tpu_torch.serving.engine import _bucket_program

torch.set_num_threads(1)

LADDER = ServingConfig(buckets=(1, 4, 16), max_batch=16, max_delay_ms=5.0)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_preset("default")
    jcfg.data.rows = 3
    jcfg.model.lstm_hidden_dim = jcfg.model.gcn_hidden_dim = 8
    jcfg.model.lstm_num_layers = 2
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
    fc = Forecaster(build_model(cfg, ds.n_feats, device="cpu"), state, ds.normalizer,
                    cfg, derived, device="cpu")
    history = ds.denormalize(ds.arrays("train")[0])  # raw units
    return fc, jfc, supports, history, cfg


@pytest.fixture(scope="module")
def engine(setup):
    fc, _, supports, _, _ = setup
    eng = fc.serving_engine(supports, config=LADDER, device="cpu")
    yield eng
    eng.close()


def _close(got, want, rtol=1e-6, atol=1e-5):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_forecaster_matches_jax_forecaster(setup):
    fc, jfc, supports, history, _ = setup
    rows = history[:6]
    _close(fc.predict(supports, rows), jfc.predict(supports, rows), rtol=1e-5, atol=1e-4)
    norm = fc.normalizer.transform(rows)
    _close(fc.predict(supports, norm, normalized=True),
           jfc.predict(supports, norm, normalized=True), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [1, 3, 16, 100])
def test_engine_matches_forecaster_at_every_size(setup, engine, n):
    fc, _, supports, history, _ = setup
    rows = history[:n]
    want = fc.predict(supports, rows)
    _close(engine.predict(rows), want)
    _close(engine.predict_direct(rows), want)


def test_engine_rejects_bad_input(setup, engine):
    fc, _, supports, history, _ = setup
    with pytest.raises(ValueError, match="history must be"):
        engine.predict(history[:2, :, :4])
    with pytest.raises(ValueError, match="supports must be"):
        ServingEngine.from_forecaster(fc, supports[:, :2], config=LADDER, device="cpu")
    with pytest.raises(ValueError, match="invalid serving config"):
        ServingEngine.from_forecaster(fc, supports, device="cpu",
                                      config=ServingConfig(buckets=(4, 1)))


def test_concurrent_callers_get_their_own_rows(setup, engine):
    fc, _, supports, history, _ = setup
    results, errors = {}, []

    def caller(k):
        try:
            rows = history[5 * k: 5 * k + 2 + k]
            results[k] = (rows, [engine.predict(rows) for _ in range(3)])
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    for rows, outs in results.values():
        want = fc.predict(supports, rows)
        for out in outs:
            _close(out, want)
    snap = engine.stats.snapshot()
    assert snap["totals"]["requests"] >= 12


def _engine_with_first_dispatch(fc, supports, cfg, before_first):
    """An engine whose first dispatch calls ``before_first()`` before it
    runs the model; every later dispatch runs at once."""
    run = _bucket_program(torch.as_tensor(supports), torch.device("cpu"))
    calls = itertools.count()

    def program(model, history):
        if next(calls) == 0:
            before_first()
        return run(model, history)

    return ServingEngine({b: program for b in cfg.buckets}, fc.model, fc.normalizer,
                         fc.expected, cfg, torch.device("cpu"))


def _held_engine(fc, supports, **slo):
    """An engine under an SLO config whose first dispatch blocks until the
    returned ``release`` event is set, so a test can hold the worker
    mid-dispatch and fill the queue behind it."""
    cfg = ServingConfig(buckets=(1, 2, 4), max_batch=4, max_delay_ms=1.0,
                        deadline_ms=5000.0, queue_bound_rows=4, **slo)
    entered, release = threading.Event(), threading.Event()

    def hold():
        entered.set()
        assert release.wait(timeout=60)

    return _engine_with_first_dispatch(fc, supports, cfg, hold), entered, release


class _WorkerKilled(BaseException):
    """Kills the micro-batch worker (an ``Exception`` would only fail the
    one dispatch)."""


def test_dead_batcher_falls_back_to_inline_dispatch(setup):
    """A worker that dies mid-dispatch wedges the batcher: the caller whose
    dispatch died and every later caller are served inline."""
    fc, _, supports, history, _ = setup

    def die():
        raise _WorkerKilled

    eng = _engine_with_first_dispatch(fc, supports, LADDER, die)
    try:
        rows = history[:2]
        want = fc.predict(supports, rows)
        _close(eng.predict(rows), want)
        assert eng._batcher.wedged
        _close(eng.predict(rows), want)
    finally:
        eng.close()


@pytest.mark.parametrize("policy", ["reject", "degrade"])
def test_full_queue_sheds_or_degrades(setup, policy):
    """With the worker held and the queue at its row bound, the next
    arrival is shed with the typed ``Overloaded`` (``reject``) or served
    inline at ``degrade_rung`` (``degrade``); every admitted caller is
    still served its own rows."""
    fc, _, supports, history, _ = setup
    slo = {"shed_policy": "degrade", "degrade_rung": 1} if policy == "degrade" else {}
    eng, entered, release = _held_engine(fc, supports, **slo)
    results, threads = {}, []

    def client(key, rows):
        results[key] = eng.predict(rows)

    try:
        threads.append(threading.Thread(target=client, args=("head", history[:4])))
        threads[0].start()  # fills the top rung: dispatched at once, then held
        assert entered.wait(timeout=60)
        for i in range(4):  # fill the queue to exactly its 4-row bound
            threads.append(threading.Thread(target=client, args=(i, history[i:i + 1])))
            threads[-1].start()
        deadline = time.monotonic() + 60
        while eng._batcher._pending_rows < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        extra = history[7:8]
        if policy == "reject":
            with pytest.raises(Overloaded):
                eng.predict(extra)
        else:
            _close(eng.predict(extra), fc.predict(supports, extra))
    finally:
        release.set()
        for t in threads:
            t.join(timeout=60)
        eng.close()
    assert not any(t.is_alive() for t in threads)
    _close(results["head"], fc.predict(supports, history[:4]))
    for i in range(4):
        _close(results[i], fc.predict(supports, history[i:i + 1]))
    shed = eng.stats.snapshot()["totals"]["shed"]
    assert shed == ({"overloaded": 1} if policy == "reject"
                    else {"overloaded": 1, "degraded": 1})


def test_swap_params_stamps_new_generation(setup):
    fc, _, supports, history, cfg = setup
    eng = fc.serving_engine(supports, config=LADDER, device="cpu")
    try:
        rows = history[:20]  # oversized: two chunks, one generation
        before, gen0 = eng.predict(rows, with_generation=True)
        assert gen0 == eng.generation == 0
        new_state = {k: v * 1.5 for k, v in fc.state_dict.items()}
        assert eng.swap_params(new_state) == 1
        after, gen1 = eng.predict(rows, with_generation=True)
        direct, gen_d = eng.predict_direct(rows[:3], with_generation=True)
        assert gen1 == gen_d == 1
        swapped = Forecaster(build_model(cfg, 1, device="cpu"), new_state,
                             fc.normalizer, cfg, fc.derived, device="cpu")
        _close(after, swapped.predict(supports, rows))
        _close(direct, swapped.predict(supports, rows[:3]))
        assert not np.allclose(before, after)
        bad = dict(new_state)
        bad["head.bias"] = torch.zeros(2)
        with pytest.raises(ValueError, match="head.bias"):
            eng.swap_params(bad)
        assert eng.generation == 1
    finally:
        eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.predict(history[:1])
