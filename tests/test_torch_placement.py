"""The port's data placement routes against each other and the JAX trainer.

``tests/test_resident.py`` and ``tests/test_window_free.py`` for the port:

- the window-free resident route (the default), the materialized resident
  route (``window_free=False``, per step and in blocks of 3) and the
  streaming route (``data_placement="stream"`` at ``prefetch`` 0, 1 and 2,
  per step whatever S asks) train the smoke model two epochs, shuffle on,
  to bitwise the same losses, parameters and test metrics: the gathers
  and uploads are pure copies;
- the materialized and streaming routes against the JAX trainer on the
  same config and initial weights: epoch losses rtol 2e-5, parameters
  atol 2e-5, as ``test_torch_train.py::test_trainer_matches_jax_trainer``;
- "auto" streams under a small class-level ``RESIDENT_CAP_BYTES``, sized
  against the series (window-free) or the windows (materialized);
- ``prefetch`` places ahead with the JAX queue semantics, and a
  mid-epoch resume on the streaming route skips the consumed batches
  without placing them and ends bitwise where the uninterrupted run ended;
- heterogeneous cities under ``window_free=False`` take the per-city loop
  with the JAX ``fallback_reason``, bitwise the window-free one-step
  programs, and allclose to the JAX trainer;
- bad combinations raise the JAX trainer's messages; the CLI flags reach
  the trainer.
"""

import jax
import numpy as np
import pytest
import torch

from stmgcn_tpu.cli import build_parser as jax_build_parser
from stmgcn_tpu.cli import config_from_args as jax_config_from_args
from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.data import DemandDataset as JaxDemandDataset
from stmgcn_tpu.data import HeteroCityDataset as JaxHetero
from stmgcn_tpu.data import WindowSpec as JaxWindowSpec
from stmgcn_tpu.data import synthetic_dataset as jax_synthetic
from stmgcn_tpu.experiment import build_trainer as jax_build_trainer
from stmgcn_tpu.models import STMGCN as JaxSTMGCN
from stmgcn_tpu.ops import SupportConfig as JaxSupportConfig
from stmgcn_tpu.train import CitySupports as JaxCitySupports
from stmgcn_tpu.train import Trainer as JaxTrainer
from stmgcn_tpu_torch import CitySupports, ExperimentConfig, Trainer, build_trainer, preset
from stmgcn_tpu_torch import from_jax_params
from stmgcn_tpu_torch.cli import build_parser, config_from_args
from stmgcn_tpu_torch.data import DemandDataset, HeteroCityDataset, WindowSpec, synthetic_dataset
from stmgcn_tpu_torch.graphs import DeviceOps, Placed, Prefetcher, Program
from stmgcn_tpu_torch.models import STMGCN
from stmgcn_tpu_torch.ops import SupportConfig

torch.set_num_threads(1)

LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5


def _smoke(out_dir, **train):
    cfg = preset("smoke")
    cfg.data.rows, cfg.data.n_timesteps = 4, 24 * 7 + 80
    cfg.train.epochs, cfg.train.batch_size, cfg.train.shuffle = 2, 16, True
    cfg.train.out_dir = str(out_dir)
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _run(out_dir, **train):
    trainer = build_trainer(_smoke(out_dir, **train), device="cpu", verbose=False)
    history = trainer.train()
    results = trainer.test(modes=("validate", "test"), checkpoint=None)
    return trainer, history, results


def _same_state(a, b) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return all(torch.equal(v, sb[k]) for k, v in sa.items())


@pytest.fixture(scope="module")
def window_free_run(tmp_path_factory):
    """The default route, one step at a time: the reference of every
    bitwise comparison."""
    return _run(tmp_path_factory.mktemp("wf"))


ROUTES = {
    "materialized-S1": dict(window_free=False),
    "materialized-S3": dict(window_free=False, steps_per_superstep=3),
    "window-free-S3": dict(steps_per_superstep=3),
    "stream-prefetch0": dict(data_placement="stream", prefetch=0),
    "stream-prefetch1": dict(data_placement="stream"),
    "stream-prefetch2": dict(data_placement="stream", prefetch=2),
    "stream-prefetch2-S3": dict(data_placement="stream", prefetch=2, steps_per_superstep=3),
}
PATHS = {"materialized-S1": ("per_step", True, False),
         "materialized-S3": ("superstep", True, False),
         "window-free-S3": ("series_superstep", True, True),
         "stream-prefetch0": ("per_step", False, False),
         "stream-prefetch1": ("per_step", False, False),
         "stream-prefetch2": ("per_step", False, False),
         "stream-prefetch2-S3": ("per_step", False, False)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routes_bitwise_equal_to_window_free(window_free_run, tmp_path, route):
    ref, ref_hist, ref_results = window_free_run
    trainer, history, results = _run(tmp_path, **ROUTES[route])
    path, resident, window_free = PATHS[route]
    assert (trainer.train_path, trainer._resident, trainer._window_free) == (
        path, resident, window_free)
    assert trainer.dataset.materialized != window_free
    assert not ref.dataset.materialized  # the default never builds a window
    assert history == ref_hist and results == ref_results
    assert _same_state(trainer, ref)
    assert trainer.optimizer.count == ref.optimizer.count


def test_program_keys_name_the_route(window_free_run, tmp_path):
    ref = window_free_run[0]
    assert sorted(ref._programs) == [(("city", 0), 1, "train", False)]
    mat = build_trainer(_smoke(tmp_path / "m", window_free=False, steps_per_superstep=3),
                        device="cpu", verbose=False)
    mat.train()
    assert sorted(k[1] for k in mat._programs) == [1, 3]
    assert {k[4] for k in mat._programs} == {"windows"}
    assert set(mat._sites["city", 0].arrays) == {"train", "validate"}  # uploaded once each
    stream = build_trainer(_smoke(tmp_path / "s", data_placement="stream"),
                           device="cpu", verbose=False)
    stream.train()
    assert list(stream._programs) == [(("city", 0), 1, "train", False, "stream")]
    program = stream._programs[("city", 0), 1, "train", False, "stream"]
    assert set(program.device_inputs) == {"x", "y"} and "idx" not in program.inputs.views


# -- against the JAX trainer ----------------------------------------------------

def _jax_configs(out_dir, **train):
    cfg = jax_preset("default")
    cfg.data.rows = 5
    cfg.data.n_timesteps = 24 * 7 * 2 + 60
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 16
    cfg.model.lstm_num_layers = 2
    cfg.train.epochs, cfg.train.batch_size, cfg.train.shuffle = 2, 8, True
    for k, v in train.items():
        setattr(cfg.train, k, v)
    cfg.train.out_dir = str(out_dir)
    port = cfg.to_dict()
    port["train"]["out_dir"] = str(out_dir / "port")
    return cfg, ExperimentConfig.from_dict(port)


@pytest.mark.parametrize("train", [
    dict(window_free=False, steps_per_superstep=3),
    dict(data_placement="stream", prefetch=2),
], ids=["materialized-S3", "stream-prefetch2"])
def test_routes_match_jax_trainer(tmp_path, train):
    jax_cfg, cfg = _jax_configs(tmp_path, **train)
    jt = jax_build_trainer(jax_cfg, verbose=False)
    init = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    jax_history = jt.train()
    pt = build_trainer(cfg, device="cpu", initial_state=init, verbose=False)
    assert (pt._resident, pt._window_free) == (jt._resident, jt._window_free)
    assert (pt.train_path, pt.fallback_reason) == (jt.train_path, jt.fallback_reason)
    history = pt.train()
    for mode in ("train", "validate"):
        np.testing.assert_allclose(history[mode], jax_history[mode], rtol=LOSS_RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    for name, value in pt.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=PARAM_ATOL,
                                   err_msg=name)
    jax_test = jt.test(modes=("test",), checkpoint=None)["test"]
    test = pt.test(modes=("test",), checkpoint=None)["test"]
    for metric, value in jax_test.items():
        np.testing.assert_allclose(test[metric], value, rtol=5e-5, err_msg=metric)


# -- the auto decision --------------------------------------------------------

def test_auto_streams_under_a_small_class_cap(tmp_path, monkeypatch):
    ds = build_trainer(_smoke(tmp_path), device="cpu", verbose=False).dataset
    assert Trainer.RESIDENT_CAP_BYTES == 1 << 30
    assert ds.resident_nbytes < ds.nbytes < Trainer.RESIDENT_CAP_BYTES
    # a cap between the series and the windows: auto keeps the series,
    # and streams the materialized windows
    monkeypatch.setattr(Trainer, "RESIDENT_CAP_BYTES", ds.resident_nbytes)
    wf = build_trainer(_smoke(tmp_path), device="cpu", verbose=False)
    assert wf._resident_cap_bytes() == ds.resident_nbytes  # the CPU's budget is the floor
    assert wf._resident and wf._window_free
    mat = build_trainer(_smoke(tmp_path, window_free=False), device="cpu", verbose=False)
    assert not mat._resident and not mat._window_free and mat._prefetcher is not None
    resident = build_trainer(_smoke(tmp_path, window_free=False, data_placement="resident"),
                             device="cpu", verbose=False)
    assert resident._resident  # an explicit placement ignores the cap
    monkeypatch.setattr(Trainer, "RESIDENT_CAP_BYTES", ds.resident_nbytes - 1)
    streamed = build_trainer(_smoke(tmp_path, steps_per_superstep=3), device="cpu",
                             verbose=False)
    assert not streamed._resident and streamed.train_path == "per_step"
    assert streamed.fallback_reason.startswith("stream:")


def test_auto_matches_jax_under_a_small_cap(tmp_path, monkeypatch):
    """The JAX trainer's decision at the same class caps (its CPU reports
    no memory, so its budget is the floor too)."""
    data = jax_synthetic(rows=4, n_timesteps=24 * 7 + 80, seed=0)
    nbytes = JaxDemandDataset(data, JaxWindowSpec(3, 1, 1, 24)).resident_nbytes
    for cap in (nbytes, nbytes - 1):
        monkeypatch.setattr(JaxTrainer, "RESIDENT_CAP_BYTES", cap)
        monkeypatch.setattr(Trainer, "RESIDENT_CAP_BYTES", cap)
        jcfg, cfg = _jax_configs(tmp_path)
        for c in (jcfg, cfg):
            c.data.rows, c.data.n_timesteps = 4, 24 * 7 + 80
            c.data.serial_len, c.data.daily_len, c.data.weekly_len = 3, 1, 1
        jt = jax_build_trainer(jcfg, verbose=False)
        pt = build_trainer(cfg, device="cpu", verbose=False)
        assert pt.dataset.resident_nbytes == jt.dataset.resident_nbytes
        assert (pt._resident, pt._window_free) == (jt._resident, jt._window_free)


# -- prefetch and resume -------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_prefetch_places_ahead(tmp_path, prefetch):
    """The JAX ``_placed_batches`` queue: batch i is consumed after
    ``min(i + prefetch + 1, n)`` batches were placed."""
    trainer = build_trainer(_smoke(tmp_path, data_placement="stream", prefetch=prefetch),
                            device="cpu", verbose=False)
    trainer.epoch = 1
    events = []
    place = trainer._place_stream

    def counted(batch, mode):
        events.append("place")
        return place(batch, mode)

    trainer._place_stream = counted
    n = len(list(trainer.batches("train")))
    for i, (batch, placed) in enumerate(trainer._placed_batches("train")):
        assert events.count("place") == min(i + prefetch + 1, n)
        assert isinstance(placed, Placed) and set(placed.tensors) == {"x", "y"}
        np.testing.assert_array_equal(placed.tensors["x"].numpy(), batch.x)
    assert events.count("place") == n


@pytest.mark.parametrize("prefetch", [0, 2])
def test_training_places_the_next_batch_while_the_step_runs(tmp_path, monkeypatch, prefetch):
    """A training step's program is enqueued first; the next placement
    runs before the wait for its readback (``before_wait``), so on the
    card the upload overlaps the step; batch i still starts with batches
    0 .. i + prefetch placed."""
    trainer = build_trainer(_smoke(tmp_path, data_placement="stream", prefetch=prefetch),
                            device="cpu", verbose=False)
    events = []
    place = trainer._place_stream

    def counted(batch, mode):
        events.append("place")
        return place(batch, mode)

    call = Program.__call__

    def traced(self, values, placed=None, before_wait=None):
        def ahead():
            events.append("ahead")
            before_wait()

        events.append("step")
        return call(self, values, placed, ahead if before_wait is not None else None)

    trainer._place_stream = counted
    monkeypatch.setattr(Program, "__call__", traced)
    trainer.epoch = 1
    trainer._run_train_epoch()
    n = trainer.train_steps_per_epoch
    starts = [i for i, e in enumerate(events) if e == "step"]
    assert len(starts) == n and events.count("place") == n
    for i, at in enumerate(starts):
        assert events[:at].count("place") == min(i + prefetch + 1, n)
    # every later placement runs inside a step, right after its enqueue
    later = [i for i, e in enumerate(events) if e == "place"][prefetch + 1:]
    assert all(events[i - 1] == "ahead" for i in later)


def test_stream_resume_mid_epoch_equals_the_uninterrupted_run(tmp_path):
    """A streamed run writing latest every 3 steps keeps its first
    mid-epoch file; a fresh trainer restores it, places only the
    batches it has yet to consume and ends bitwise where the first run
    ended."""
    kw = dict(data_placement="stream", prefetch=2, checkpoint_every_steps=3,
              async_checkpoint=False)
    a = build_trainer(_smoke(tmp_path / "a", **kw), device="cpu", verbose=False)
    kept = []
    save = a._save

    def save_and_keep(path):
        data = save(path)
        if path == a.latest_path and a._batch_in_epoch and not kept:
            kept.append((a.epoch, a._batch_in_epoch))
            (tmp_path / "mid.ckpt").write_bytes(data)
        return data

    a._save = save_and_keep
    history = a.train()
    per_epoch = a.train_steps_per_epoch
    assert kept and kept[0][0] == 1 and 0 < kept[0][1] < per_epoch
    b = build_trainer(_smoke(tmp_path / "b", **kw), device="cpu", verbose=False)
    b.restore(str(tmp_path / "mid.ckpt"))
    placed = []
    place = b._place_stream

    def counted(batch, mode):
        placed.append(mode)
        return place(batch, mode)

    b._place_stream = counted
    resumed = b.train()
    # epoch 1 past its cursor, then epoch 2; each epoch's validation
    assert placed.count("train") == 2 * per_epoch - kept[0][1]
    assert placed.count("validate") == 2 * len(list(b.batches("validate")))
    assert resumed == history
    assert _same_state(a, b)


# -- heterogeneous cities ---------------------------------------------------------

CITY_DIMS = ((3, 3), (2, 4), (2, 2))
MODEL = dict(m_graphs=3, n_supports=3, seq_len=5, input_dim=1, lstm_hidden_dim=8,
             lstm_num_layers=1, gcn_hidden_dim=8)


def _datas(synthetic):
    return [synthetic(rows=r, cols=c, n_timesteps=24 * 7 * 2 + 12 * i, seed=i + 1)
            for i, (r, c) in enumerate(CITY_DIMS)]


def _jax_hetero(out_dir, **kw):
    datas = _datas(jax_synthetic)
    return JaxTrainer(
        JaxSTMGCN(horizon=1, **MODEL), JaxHetero(datas, JaxWindowSpec(3, 1, 1, 24)),
        JaxCitySupports(JaxSupportConfig("chebyshev", 2).build_all(d.adjs.values())
                        for d in datas),
        n_epochs=2, batch_size=8, out_dir=str(out_dir), verbose=False, **kw)


def _port_hetero(out_dir, initial_state=None, **kw):
    datas = _datas(synthetic_dataset)
    supports = CitySupports(SupportConfig("chebyshev", 2).build_all(d.adjs.values())
                            for d in datas)
    return Trainer(STMGCN(**MODEL, device="cpu"), HeteroCityDataset(datas, WindowSpec(3, 1, 1, 24)),
                   supports, n_epochs=2, batch_size=8, out_dir=str(out_dir),
                   initial_state=initial_state, device="cpu", verbose=False, **kw)


@pytest.mark.parametrize("train", [
    dict(window_free=False, steps_per_superstep=4),
    dict(window_free=False, steps_per_superstep=4, fleet=False),
    dict(data_placement="stream", steps_per_superstep=4),
], ids=["materialized-fleet", "materialized-fleet-off", "stream"])
def test_hetero_routes_match_jax(tmp_path, train):
    jt = _jax_hetero(tmp_path / "jax", shuffle=True, **train)
    init = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    pt = _port_hetero(tmp_path / "port", init, shuffle=True, **train)
    assert (pt.train_path, pt.fallback_reason) == (jt.train_path, jt.fallback_reason)
    assert pt.train_path == "per_step" and pt.fallback_reason
    assert bool(pt.fleet_plan) == bool(jt._fleet_plan)
    jax_hist, history = jt.train(), pt.train()
    for mode in ("train", "validate"):
        np.testing.assert_allclose(history[mode], jax_hist[mode], rtol=LOSS_RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    for name, value in pt.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=PARAM_ATOL,
                                   err_msg=name)
    report = pt.test(modes=("test",), checkpoint=None)["test"]
    assert set(report["per_city"]) == {"city0", "city1", "city2"}


def test_hetero_materialized_fleet_is_bitwise_the_window_free_steps(tmp_path):
    """Engaged fleet, one step at a time: the class site's padded windows
    against its padded series, through the same one-step programs."""
    wf = _port_hetero(tmp_path / "wf", fleet=True, shuffle=True)
    init = {k: v.clone() for k, v in wf.model.state_dict().items()}
    mat = _port_hetero(tmp_path / "mat", init, fleet=True, shuffle=True, window_free=False)
    assert mat.fleet_plan and [k[0][0] for k in mat._sites] == [k[0][0] for k in wf._sites]
    assert mat._cities[0].series is None and mat._cities[1].pad == wf._cities[1].pad
    assert wf.train() == mat.train()
    assert _same_state(wf, mat)
    assert wf.test(modes=("test",), checkpoint=None) == mat.test(modes=("test",),
                                                                 checkpoint=None)


# -- errors and the CLI -----------------------------------------------------------

BAD = {
    "prefetch": dict(prefetch=-1),
    "placement": dict(data_placement="disk"),
    "window-free-stream": dict(window_free=True, data_placement="stream"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_combinations_raise_the_jax_messages(tmp_path, case):
    data = jax_synthetic(rows=3, n_timesteps=24 * 7 * 2, seed=1)
    jds = JaxDemandDataset(data, JaxWindowSpec(3, 1, 1, 24))
    with pytest.raises(ValueError) as jax_err:
        JaxTrainer(JaxSTMGCN(horizon=1, **MODEL),
                   jds, JaxSupportConfig("chebyshev", 2).build_all(jds.adjs.values()),
                   batch_size=8, out_dir=str(tmp_path), verbose=False, **BAD[case])
    ds = DemandDataset(synthetic_dataset(rows=3, n_timesteps=24 * 7 * 2, seed=1),
                       WindowSpec(3, 1, 1, 24))
    with pytest.raises(ValueError) as err:
        Trainer(STMGCN(**MODEL, device="cpu"), ds,
                SupportConfig("chebyshev", 2).build_all(ds.adjs.values()), batch_size=8,
                out_dir=str(tmp_path), device="cpu", verbose=False, **BAD[case])
    assert str(err.value) == str(jax_err.value)


def test_window_free_needs_the_series_protocol(tmp_path):
    class WindowsOnly(DemandDataset):
        def __getattribute__(self, name):
            if name == "series":
                raise AttributeError(name)
            return super().__getattribute__(name)

    ds = WindowsOnly(synthetic_dataset(rows=3, n_timesteps=24 * 7 * 2, seed=1),
                     WindowSpec(3, 1, 1, 24))
    assert not hasattr(ds, "series")
    sup = SupportConfig("chebyshev", 2).build_all(ds.adjs.values())
    with pytest.raises(ValueError, match="series/mode_targets protocol"):
        Trainer(STMGCN(**MODEL, device="cpu"), ds, sup, batch_size=8, window_free=True,
                out_dir=str(tmp_path), device="cpu", verbose=False)


@pytest.mark.parametrize("flags", [
    ["--data-placement", "stream"],
    ["--data-placement", "resident", "--no-window-free"],
    ["--window-free"],
    [],
], ids=["stream", "resident-materialized", "window-free", "defaults"])
def test_cli_flags_reach_the_trainer(tmp_path, flags):
    argv = flags + ["--preset", "smoke", "--rows", "4", "--timesteps", str(24 * 7 + 80),
                    "--out-dir", str(tmp_path)]
    cfg = config_from_args(build_parser().parse_args(argv))
    want = jax_config_from_args(jax_build_parser().parse_args(argv))
    for field in ("data_placement", "window_free", "prefetch"):
        assert getattr(cfg.train, field) == getattr(want.train, field), field
    trainer = build_trainer(cfg, device="cpu", verbose=False)
    assert trainer._resident == (cfg.train.data_placement != "stream")
    assert trainer._window_free == (trainer._resident and cfg.train.window_free is not False)


def test_prefetcher_and_device_inputs_on_the_cpu():
    with pytest.raises(ValueError, match="staging buffer"):
        Prefetcher(torch.device("cpu"), 0)
    pf = Prefetcher(torch.device("cpu"), 2)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    placed = pf.place({"x": x})
    x[0, 0] = 99.0  # the placed copy does not alias the host array
    assert placed.event is None and placed.nbytes == 24
    assert placed.ready()["x"][0, 0].item() == 0.0
    ops = DeviceOps(torch.device("cpu"))
    program = Program(lambda v: v["x"].sum(dim=1) + v["a"][0], {"a": ((1,), torch.float32)},
                      ops, device_spec={"x": ((2, 3), torch.float32)})
    with pytest.raises(ValueError, match="placed batch"):
        program({"a": np.ones(1, np.float32)})
    with pytest.raises(KeyError, match="device inputs"):
        program({"a": np.ones(1, np.float32)}, pf.place({"y": x}))
    out = program({"a": np.ones(1, np.float32)}, placed)
    assert out.tolist() == [4.0, 13.0]
