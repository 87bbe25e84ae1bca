"""Checkpoints that the port and the JAX package both read and write.

- The port's msgpack codec against ``msgpack`` and ``flax.serialization``,
  both ways, over parameter trees (both branch layouts) and the optax
  chain states of every optimizer the trainers build: equal trees, and the
  very bytes ``flax.serialization.to_bytes`` writes.
- Files across packages: a port file loads through the JAX
  ``load_checkpoint`` with the JAX trainer's templates, and a JAX file
  restores the port's ``Trainer``. Resumed from either, the next epoch of
  both packages agrees (losses rtol 2e-5, parameters atol 2e-5, the
  bounds of ``tests/test_torch_train.py``'s two-epoch parity). The JAX
  ``Forecaster.from_checkpoint`` on a port file predicts what the port's
  does (rtol 1e-5, atol 1e-5 in raw units: float32 sums in other orders).
- Corrupt files (truncated at any cut, a flipped bit, trailing bytes)
  raise ``CorruptCheckpointError`` naming the blob, and the recovery chain
  takes the reference's order and quarantines what fails.
- A mid-epoch resume ends with the uninterrupted run's history and
  parameters (rtol 1e-6: the same arithmetic, restored bit for bit).
- The engine's checkpoint watcher swaps newer files in, and rejects a
  corrupt one while keeping its generation.
"""

import json
import os
import struct

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from stmgcn_tpu.config import preset as jax_preset
from stmgcn_tpu.experiment import build_trainer as jax_build_trainer
from stmgcn_tpu.inference import Forecaster as JaxForecaster
from stmgcn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from stmgcn_tpu.train.step import make_optimizer as jax_make_optimizer
from stmgcn_tpu_torch import ExperimentConfig, Forecaster, build_trainer, from_jax_params
from stmgcn_tpu_torch.experiment import build_dataset, build_supports
from stmgcn_tpu_torch.models.params import from_optax_state, to_jax_params
from stmgcn_tpu_torch.train import checkpoint as ckpt
from stmgcn_tpu_torch.train import make_optimizer, msgpack_codec
from stmgcn_tpu_torch.train.checkpoint import (
    CorruptCheckpointError,
    load_checkpoint,
    load_latest_verified,
    save_checkpoint,
    verify_checkpoint,
)

torch.set_num_threads(1)

EPOCH_RTOL, PARAM_ATOL = 2e-5, 2e-5


def _jax_cfg(out_dir, **train):
    cfg = jax_preset("default")
    cfg.data.rows, cfg.data.n_timesteps = 3, 24 * 7 * 2 + 40
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 8
    cfg.model.lstm_num_layers = 2
    cfg.train.batch_size, cfg.train.out_dir = 16, str(out_dir)
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _port_cfg(jax_cfg, out_dir, **train):
    d = jax_cfg.to_dict()
    d["train"].update(out_dir=str(out_dir), **train)
    return ExperimentConfig.from_dict(d)


def _tree_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), \
        (type(a), type(b))
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _numpy(tree):
    return jax.tree.map(np.asarray, serialization.to_state_dict(tree))


# -- the codec ---------------------------------------------------------------

OPTIMIZERS = {
    "adam": dict(lr=2e-3),
    "l2": dict(lr=2e-3, weight_decay=1e-4),
    "clip_l2_cosine": dict(lr=1e-3, weight_decay=1e-4, grad_clip_norm=1.0, schedule="cosine",
                           warmup_steps=2, decay_steps=10),
    "cosine": dict(lr=1e-3, schedule="cosine", decay_steps=10),
}


@pytest.fixture(scope="module")
def jax_params(tmp_path_factory):
    """A shrunk flagship's initialized flax params, from the JAX trainer."""
    cfg = _jax_cfg(tmp_path_factory.mktemp("init"))
    return jax_build_trainer(cfg, verbose=False).params


@pytest.mark.parametrize("layout", ["vmapped", "looped"])
def test_codec_writes_flax_bytes_and_reads_them_back(jax_params, layout):
    state = from_jax_params(jax.tree.map(np.asarray, jax_params), 3)
    tree = to_jax_params(state, 3, layout=layout)
    blob = msgpack_codec.packb(tree)
    assert blob == serialization.to_bytes(jax.tree.map(jax.numpy.asarray, tree))
    _tree_equal(serialization.msgpack_restore(blob), tree)
    raw = msgpack.unpackb(blob, raw=False)
    assert set(raw["params"]) == set(tree["params"])
    _tree_equal(msgpack_codec.unpackb(serialization.to_bytes(tree)), tree)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_state_tree_is_the_optax_chain_state(jax_params, name):
    """The port's optimizer state, after steps, serializes to the same tree
    structure, dtypes and values the optax chain holds after the same
    steps (values within rtol 1e-5 of each other), and reads back."""
    kw = OPTIMIZERS[name]
    tx = jax_make_optimizer(**kw)
    jp, jstate = jax_params, tx.init(jax_params)
    state = from_jax_params(jax.tree.map(np.asarray, jp), 3)
    names = list(state)
    params = [torch.nn.Parameter(state[n].clone()) for n in names]
    opt = make_optimizer(params, **kw)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jp)
        updates, jstate = tx.update(grads, jstate, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, updates)
        gstate = from_jax_params(grads, 3)
        for n, p in zip(names, params):
            p.grad = gstate[n].clone()
        opt.step()
    want = _numpy(jstate)
    got = opt.state_tree(names, 3)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
                 or (g.dtype, g.shape) == (w.dtype, w.shape) or pytest.fail("dtype"), got, want)
    blob = msgpack_codec.packb(got)
    _tree_equal(msgpack_codec.unpackb(blob), got)
    restored = serialization.from_bytes(jstate, blob)  # the JAX template takes it
    assert jax.tree.structure(restored) == jax.tree.structure(jstate)
    # and the state goes back into a fresh optimizer
    fresh = make_optimizer([torch.nn.Parameter(state[n].clone()) for n in names], **kw)
    fresh.load_state_tree(msgpack_codec.unpackb(serialization.to_bytes(jstate)), names, 3)
    assert fresh.count == 3
    _tree_equal(fresh.state_tree(names, 3), msgpack_codec.unpackb(
        msgpack_codec.packb(jax.tree.map(np.asarray, want))))


def test_codec_refuses_what_it_does_not_take():
    with pytest.raises(ValueError, match="__msgpack_chunked_array__"):
        msgpack_codec.packb({"__msgpack_chunked_array__": True})
    chunked = msgpack.packb({"w": {"__msgpack_chunked_array__": True, "shape": {}}})
    with pytest.raises(ValueError, match="__msgpack_chunked_array__"):
        msgpack_codec.unpackb(chunked)
    with pytest.raises(ValueError, match="ExtType 2"):
        msgpack_codec.unpackb(msgpack.packb(msgpack.ExtType(2, b"xx")))
    with pytest.raises(ValueError, match="trailing"):
        msgpack_codec.unpackb(msgpack.packb({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        msgpack_codec.unpackb(msgpack.packb({"a": "abc"})[:-1])
    with pytest.raises(TypeError):
        msgpack_codec.packb({1: 2})


def test_optax_state_with_another_chain_is_refused(jax_params):
    tree = _numpy(jax_make_optimizer(lr=1e-3).init(jax_params))
    with pytest.raises(ValueError, match="entries"):
        from_optax_state(tree, ("clip", "l2", "adam", "scale"), 3)


# -- the file format ----------------------------------------------------------

def _toy_state():
    params = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    opt_state = {"0": {"count": np.asarray(2, np.int32),
                       "mu": {"w": np.linspace(0.0, 1.0, 4, dtype=np.float32)}}}
    return params, opt_state


def test_v2_roundtrip_and_v1_files(tmp_path):
    params, opt_state = _toy_state()
    path = str(tmp_path / "c.ckpt")
    save_checkpoint(path, params, opt_state, {"epoch": 3})
    assert verify_checkpoint(path) == {"epoch": 3}
    meta, p, o = load_checkpoint(path)
    assert meta == {"epoch": 3}
    _tree_equal(p, params)
    _tree_equal(o, opt_state)
    assert load_checkpoint(path, load_opt_state=False)[2] is None
    # the JAX reader takes the port's file, and the port reads a JAX v1 file
    _, jp, jo = jax_load_checkpoint(path)
    _tree_equal(jax.tree.map(np.asarray, jp), params)
    blobs = [json.dumps({"epoch": 7}).encode(), serialization.to_bytes(params),
             serialization.to_bytes(opt_state)]
    old = tmp_path / "old.ckpt"
    old.write_bytes(b"STMG1\n" + b"".join(struct.pack("<Q", len(b)) + b for b in blobs))
    meta, p, o = load_checkpoint(str(old))
    assert meta == {"epoch": 7}
    _tree_equal(p, params)
    _tree_equal(o, opt_state)


def _extents(data: bytes) -> dict:
    """Each blob's ``(header start, payload start, end)`` in a v2 file."""
    pos, out = 6, {}
    for name in ("meta", "params", "opt_state"):
        length = struct.unpack("<QI", data[pos:pos + 12])[0]
        out[name] = (pos, pos + 12, pos + 12 + length)
        pos += 12 + length
    return out


def _blob_at(data: bytes, cut: int) -> str:
    """The blob whose header or payload a cut at byte ``cut`` falls in."""
    return next(name for name, (_, _, end) in _extents(data).items() if cut < end)


def test_truncation_at_any_cut_names_the_blob(tmp_path):
    params, opt_state = _toy_state()
    good = tmp_path / "good.ckpt"
    save_checkpoint(str(good), params, opt_state, {"epoch": 1})
    data = good.read_bytes()
    cut_path = tmp_path / "cut.ckpt"
    for cut in range(len(data)):
        cut_path.write_bytes(data[:cut])
        for read in (load_checkpoint, verify_checkpoint):
            with pytest.raises(CorruptCheckpointError) as info:
                read(str(cut_path))
            if cut >= 6:
                assert _blob_at(data, cut) in str(info.value), (cut, str(info.value))


@pytest.mark.parametrize("blob", ["meta", "params", "opt_state"])
def test_bitflip_and_trailing_bytes_name_the_blob(tmp_path, blob):
    params, opt_state = _toy_state()
    path = tmp_path / "c.ckpt"
    save_checkpoint(str(path), params, opt_state, {"epoch": 1})
    data = bytearray(path.read_bytes())
    _, start, end = _extents(bytes(data))[blob]
    data[(start + end) // 2] ^= 0x01
    path.write_bytes(bytes(data))
    with pytest.raises(CorruptCheckpointError, match=f"CRC32 mismatch in {blob} blob"):
        verify_checkpoint(str(path))
    save_checkpoint(str(path), params, opt_state, {"epoch": 1})
    with open(path, "ab") as f:
        f.write(b"extra")
    with pytest.raises(CorruptCheckpointError, match="trailing bytes after the opt_state"):
        load_checkpoint(str(path))
    path.write_bytes(b"NOTCKPT" + bytes(20))
    with pytest.raises(CorruptCheckpointError, match="not a stmgcn-tpu checkpoint"):
        verify_checkpoint(str(path))


def test_recovery_chain_order_and_quarantine(tmp_path):
    params, opt_state = _toy_state()
    assert load_latest_verified(str(tmp_path)) is None
    for name, epoch in (("best.ckpt", 1), ("best_e2.ckpt", 2), ("best_e10.ckpt", 10),
                        ("latest.prev.ckpt", 11), ("latest.ckpt", 12)):
        save_checkpoint(str(tmp_path / name), params, opt_state, {"epoch": epoch})
    assert [os.path.basename(p) for p in ckpt._resume_candidates(str(tmp_path))] == [
        "latest.ckpt", "latest.prev.ckpt", "best_e10.ckpt", "best_e2.ckpt", "best.ckpt"]
    logs = []
    for name, want in (("latest.ckpt", 11), ("latest.prev.ckpt", 10), ("best_e10.ckpt", 2),
                       ("best_e2.ckpt", 1)):
        path = tmp_path / name
        path.write_bytes(path.read_bytes()[:-3])  # truncate the newest
        got_path, meta, p, _ = load_latest_verified(str(tmp_path), log=logs.append)
        assert meta["epoch"] == want
        _tree_equal(p, params)
        assert not path.exists() and (tmp_path / (name + ".corrupt")).exists()
        assert name in logs[-1] and "quarantined" in logs[-1]
    (tmp_path / "best.ckpt").write_bytes(b"garbage")
    assert load_latest_verified(str(tmp_path), quarantine=False) is None
    assert (tmp_path / "best.ckpt").exists()


# -- the trainer, across packages ----------------------------------------------

CROSS = dict(epochs=2, lr_schedule="cosine", warmup_epochs=0.5, grad_clip_norm=1.0)


def _next_epoch_agrees(path, jax_cfg, port_cfg):
    """Both packages restore ``path`` (an epoch-1 checkpoint) and train
    epoch 2; their histories and final parameters agree."""
    jt = jax_build_trainer(jax_cfg, verbose=False)
    jt.restore(path)
    jh = jt.train()
    pt = build_trainer(port_cfg, device="cpu", verbose=False)
    pt.restore(path)
    spe = pt.train_steps_per_epoch
    assert (pt.epoch, pt.global_step, pt.optimizer.count) == (1, spe, spe)
    ph = pt.train()
    assert len(jh["train"]) == len(ph["train"]) == 1
    for mode in ("train", "validate"):
        np.testing.assert_allclose(ph[mode], jh[mode], rtol=EPOCH_RTOL)
    want = from_jax_params(jax.tree.map(np.asarray, jt.params), 3)
    for name, value in pt.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=PARAM_ATOL,
                                   err_msg=name)


def test_jax_checkpoint_resumes_the_port_trainer(tmp_path):
    jt = jax_build_trainer(_jax_cfg(tmp_path / "jax1", **CROSS), verbose=False)
    jt.n_epochs = 1  # stop after epoch 1; the schedule spans two in every run
    jt.train()
    path = str(tmp_path / "jax1" / "latest.ckpt")
    meta, _, _ = load_checkpoint(path)
    assert meta["epoch"] == 1 and "config" in meta and "derived" in meta
    jax_cfg = _jax_cfg(tmp_path / "jax2", **CROSS)
    _next_epoch_agrees(path, jax_cfg, _port_cfg(jax_cfg, tmp_path / "port2"))


def test_port_checkpoint_loads_in_jax_and_resumes_it(tmp_path):
    jax_cfg = _jax_cfg(tmp_path / "jax", **CROSS)
    port_cfg = _port_cfg(jax_cfg, tmp_path / "port1")
    pt = build_trainer(port_cfg, device="cpu", verbose=False)
    pt.n_epochs = 1  # as above
    pt.train()
    path = str(tmp_path / "port1" / "latest.ckpt")
    jt = jax_build_trainer(jax_cfg, verbose=False)
    meta, params, opt_state = jax_load_checkpoint(path, jt.params, jt.opt_state)
    assert meta["epoch"] == 1 and meta["precision"] == "fp32"
    assert jax.tree.structure(params) == jax.tree.structure(jt.params)
    assert jax.tree.structure(opt_state) == jax.tree.structure(jt.opt_state)
    _next_epoch_agrees(path, jax_cfg, _port_cfg(jax_cfg, tmp_path / "port2"))


def test_jax_forecaster_reads_a_port_checkpoint(tmp_path):
    jax_cfg = _jax_cfg(tmp_path, epochs=1)
    cfg = _port_cfg(jax_cfg, tmp_path)
    build_trainer(cfg, device="cpu", verbose=False).train()
    best = str(tmp_path / "best.ckpt")
    fc = Forecaster.from_checkpoint(best, device="cpu")
    jfc = JaxForecaster.from_checkpoint(best)
    ds = build_dataset(cfg)
    supports = build_supports(cfg, ds)
    history = ds.denormalize(ds.arrays("test")[0][:6])
    got = fc.predict(supports, history)
    np.testing.assert_allclose(got, np.asarray(jfc.predict(supports, history)),
                               rtol=1e-5, atol=1e-5)
    assert fc.derived == {"input_dim": 1, "n_nodes": 9}
    save_checkpoint(str(tmp_path / "bare.ckpt"), *_toy_state(), {"epoch": 1})
    with pytest.raises(ValueError, match="config/derived"):
        Forecaster.from_checkpoint(str(tmp_path / "bare.ckpt"), device="cpu")


# -- the trainer on its own --------------------------------------------------------

def _port(out_dir, **train):
    cfg = ExperimentConfig.from_dict(_jax_cfg(out_dir, **train).to_dict())
    return build_trainer(cfg, device="cpu", verbose=False)


def test_mid_epoch_resume_ends_with_the_uninterrupted_history(tmp_path):
    """Run A trains two epochs in blocks of 2 steps and writes latest every
    3 steps; the first mid-epoch latest it wrote is kept aside. Run B
    restores that file, re-enters the epoch past its consumed batches, and
    ends where A ended."""
    kw = dict(epochs=2, shuffle=True, steps_per_superstep=2, checkpoint_every_steps=3,
              top_k=2, async_checkpoint=True)
    a = _port(tmp_path / "a", **kw)
    kept = []
    save = a._save

    def save_and_keep(path):
        data = save(path)
        if path == a.latest_path and a._batch_in_epoch and not kept:
            kept.append(a._batch_in_epoch)
            ckpt.write_checkpoint_bytes(str(tmp_path / "mid.ckpt"), data)
        return data

    a._save = save_and_keep
    history = a.train()
    assert kept and 0 < kept[0] < a.train_steps_per_epoch
    names = sorted(os.listdir(tmp_path / "a"))
    assert {"best.ckpt", "latest.ckpt", "latest.prev.ckpt"} <= set(names)
    assert len([n for n in names if n.startswith("best_e")]) == len(a._kept) <= 2

    b = _port(tmp_path / "b", **kw)
    meta = b.restore(str(tmp_path / "mid.ckpt"))
    assert meta["batch_in_epoch"] == kept[0] and len(meta["partial"]["losses"]) == kept[0]
    resumed = b.train()
    for mode in ("train", "validate"):
        np.testing.assert_allclose(resumed[mode], history[mode], rtol=1e-6)
    for name, value in b.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), a.model.state_dict()[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert b.global_step == a.global_step == b.optimizer.count

    for field, value in (("seed", 1), ("shuffle", False), ("steps_per_superstep", 3)):
        other = _port(tmp_path / "c", **dict(kw, **{field: value}))
        with pytest.raises(ValueError, match=field):
            other.restore(str(tmp_path / "mid.ckpt"))
    # test() reads best.ckpt; a missing file raises
    results = b.test(modes=("test",))
    assert np.isfinite(results["test"]["mse"])
    fresh = _port(tmp_path / "empty", **kw)
    assert fresh.restore_auto() is None
    with pytest.raises(FileNotFoundError):
        fresh.restore()


def _deferred_file(t, path: str, deferred: list) -> None:
    meta = {**t._meta(), "epoch": 1, "batch_in_epoch": 1, "deferred": deferred,
            "partial": {"losses": [0.5], "counts": [4]}}
    save_checkpoint(path, *t.state_trees(), meta)


def test_state_the_port_lacks_is_refused(tmp_path):
    """Divergence-guard state the resuming epoch cannot honour, deferred
    ordinals it has no batch for, is refused by name, not dropped."""
    t = _port(tmp_path, epochs=1)
    path = str(tmp_path / "x.ckpt")
    _deferred_file(t, path, [999])
    t.restore(path)
    with pytest.raises(ValueError, match="defers batch ordinals"):
        t.train()


def test_guard_meta_is_installed(tmp_path):
    """Divergence-guard state in a file is installed, never dropped: the
    ``lr_scale`` cut and a mid-epoch file's deferred ordinals."""
    t = _port(tmp_path, epochs=1)
    path = str(tmp_path / "x.ckpt")
    save_checkpoint(path, *t.state_trees(), {**t._meta(), "lr_scale": 0.5})
    t.restore(path)
    assert t.optimizer.lr_scale == 0.5
    _deferred_file(t, path, [2])
    t.restore(path)
    assert t._resume_deferred == [2]


def test_a_trainer_that_wrote_in_the_background_is_freed(tmp_path):
    """The background writer holds its queue, not the trainer: once the
    trainer is unreferenced it is collected (with its device memory) and
    the writer thread ends."""
    import gc
    import threading
    import weakref

    t = _port(tmp_path, epochs=1, async_checkpoint=True)
    t.train()
    writers = [th for th in threading.enumerate() if th.name == "stmgcn-ckpt-writer"]
    assert writers
    ref = weakref.ref(t)
    del t
    gc.collect()
    assert ref() is None
    for th in writers:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in writers)


@pytest.mark.parametrize("async_checkpoint", [True, False])
def test_write_failure_surfaces(tmp_path, async_checkpoint):
    """A write that fails in the background writer is re-raised by the
    flush that ends ``train()``; written inline, it raises at once."""
    t = _port(tmp_path, epochs=1, async_checkpoint=async_checkpoint)
    (tmp_path / f"best.ckpt.tmp.{os.getpid()}").mkdir()  # the temp file cannot open
    if async_checkpoint:
        with pytest.raises(RuntimeError, match="background checkpoint write failed"):
            t.train()
    else:
        with pytest.raises(IsADirectoryError):
            t.train()
    assert not (tmp_path / "best.ckpt").exists()


# -- serving ---------------------------------------------------------------------

def test_watcher_swaps_newer_checkpoints_and_rejects_corrupt_ones(tmp_path):
    t = _port(tmp_path, epochs=1)
    t.train()
    fc = Forecaster.from_checkpoint(str(tmp_path / "best.ckpt"), device="cpu")
    supports = build_supports(fc.config, t.dataset)
    rows = t.dataset.denormalize(t.dataset.arrays("test")[0][:3])
    with fc.serving_engine(supports, device="cpu") as engine:
        watcher = engine.watch_checkpoints(str(tmp_path))
        assert not watcher.poll()  # nothing newer than the engine's start
        before = engine.predict(rows)
        # a newer best lands
        meta, params, opt_state = load_checkpoint(str(tmp_path / "best.ckpt"))
        params = jax.tree.map(lambda a: a * 1.5, params)
        later = os.path.getmtime(tmp_path / "best.ckpt") + 10
        save_checkpoint(str(tmp_path / "best.ckpt"), params, opt_state, meta)
        os.utime(tmp_path / "best.ckpt", (later, later))
        for name in os.listdir(tmp_path):  # best is the newest verified file
            if name != "best.ckpt":
                os.remove(tmp_path / name)
        assert watcher.poll() and engine.generation == 1 and watcher.swaps == 1
        after, gen = engine.predict(rows, with_generation=True)
        assert gen == 1 and not np.allclose(before, after)
        swapped = Forecaster(fc.model, from_jax_params(params, 3), fc.normalizer, fc.config,
                             fc.derived, device="cpu")
        np.testing.assert_allclose(after, swapped.predict(supports, rows), rtol=1e-6,
                                   atol=1e-5)
        # a truncated latest, newer still: quarantined, counted, not swapped
        save_checkpoint(str(tmp_path / "latest.ckpt"), params, opt_state, meta)
        data = (tmp_path / "latest.ckpt").read_bytes()
        (tmp_path / "latest.ckpt").write_bytes(data[:len(data) // 2])
        os.utime(tmp_path / "latest.ckpt", (later + 10, later + 10))
        assert not watcher.poll()
        assert watcher.rejected == 1 and engine.generation == 1
        assert (tmp_path / "latest.ckpt.corrupt").exists()
        assert engine.predict(rows, with_generation=True)[1] == 1
        threaded = engine.watch_checkpoints(str(tmp_path), poll_s=0.01)
        assert not watcher.poll()
    assert threaded._thread is None  # close() stopped the polling thread
