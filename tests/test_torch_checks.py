"""The ``checks`` sanitizers in the port (``train.checks``, the CLI's
``--checkify``), mirroring ``tests/test_checkify.py``, and ``--debug-nans``.

- A checked step equals an unchecked one bit for bit (the flags write
  nothing the step reads).
- A NaN is trapped after its block, naming the check, the step and the
  site; an eval is trapped the same way, and a clean eval passes.
- The index drill: a window index out of range is clamped (as a JAX
  gather clamps), flagged and named, and the trainer's next dispatch
  works.
- A bad check name is rejected.
- With checks off the programs run the aten ops they ran before the
  sanitizers existed (the pin of ``tests/test_torch_graphs.py``).
- ``--debug-nans`` trains eagerly and names the module that made a NaN.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stmgcn_tpu_torch import build_trainer, preset
from stmgcn_tpu_torch.cli import main
from stmgcn_tpu_torch.config import TrainConfig
from stmgcn_tpu_torch.resilience import FaultPlan, FaultSpec
from stmgcn_tpu_torch.train.step import (
    CHECK_SETS,
    CHECK_SITES,
    CheckError,
    Sanitizer,
    gather_window_batch,
    masked_loss,
)

torch.set_num_threads(1)

S = 3
#: aten ops of a plain block of 3 steps and of a one-step program of the
#: smoke trainer (tests/test_torch_graphs.py's pin)
PLAIN_BLOCK_OPS, PLAIN_STEP_OPS = 1643, 559


def _bit(site):
    return 1 << [name for name, _ in CHECK_SITES].index(site)


def _cfg(tmp_path, checks, name="run"):
    cfg = preset("smoke")
    cfg.data.rows, cfg.data.n_timesteps = 3, 24 * 7 * 2 + 40
    cfg.train.epochs, cfg.train.batch_size, cfg.train.shuffle = 1, 8, False
    cfg.train.steps_per_superstep, cfg.train.checks = S, checks
    cfg.train.out_dir = str(tmp_path / name)
    return cfg


def _trainer(tmp_path, checks, name="run", **kw):
    return build_trainer(_cfg(tmp_path, checks, name), device="cpu", verbose=False, **kw)


@pytest.mark.parametrize("checks", CHECK_SETS)
def test_checked_step_matches_unchecked(tmp_path, checks):
    plain, checked = _trainer(tmp_path, None, "a"), _trainer(tmp_path, checks, "b")
    block = list(plain.batches("train"))[:S]
    assert plain._run_block(block) == checked._run_block(block)
    assert plain._run_block(block[:1]) == checked._run_block(block[:1])
    for (name, a), b in zip(plain.model.state_dict().items(),
                            checked.model.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("checks", ["nan", "float", "all"])
def test_checked_step_traps_nan_naming_the_step(tmp_path, checks):
    """A NaN poison in the mask of epoch 1's step 4 (the block of steps
    3..5): the loss is the first site it reaches."""
    trainer = _trainer(tmp_path, checks, fault_plan=FaultPlan(FaultSpec("poison", epoch=1,
                                                                        step=4)))
    with pytest.raises(CheckError, match="nan check failed at epoch 1, step 4") as info:
        trainer.train()
    assert (info.value.check, info.value.site) == ("nan", "loss")
    assert "NaN in the loss" in str(info.value)


def test_nan_in_the_input_is_named_at_the_lstm(tmp_path):
    trainer = _trainer(tmp_path, "nan")
    trainer._cities[0].series[5, 0, 0] = float("nan")
    with pytest.raises(CheckError, match="NaN in the LSTM output"):
        trainer.train()


def test_index_check_clamps_flags_and_the_next_dispatch_works(tmp_path):
    trainer, plain = _trainer(tmp_path, "index"), _trainer(tmp_path, None, "plain")
    block = list(trainer.batches("train"))[:S]
    bad = dataclasses.replace(block[1], indices=np.asarray(block[1].indices) + 10**6)
    with pytest.raises(CheckError, match="index check failed .* step 1") as info:
        trainer._run_block([block[0], bad, block[2]])
    assert info.value.site == "window index"
    assert np.isfinite(trainer._run_block(block)).all()
    # a negative index would wrap silently; here it is clamped to 0 and flagged
    series, targets = plain._cities[0].series, plain._cities[0].targets["train"]
    idx = torch.tensor([-3, 0, 2], dtype=torch.int32)
    san = Sanitizer("index")
    san.begin("cpu")
    x, y = gather_window_batch(series, targets, plain.offsets, idx, 1, san)
    assert san.end().item() == _bit("window index")
    want = gather_window_batch(series, targets, plain.offsets, idx.clamp(min=0))
    assert torch.equal(x, want[0]) and torch.equal(y, want[1])


def test_float_check_flags_a_zero_denominator():
    san = Sanitizer("float")
    san.begin("cpu")
    masked_loss("mse", torch.ones(2, 3, 1), torch.zeros(2, 3, 1), torch.zeros(2), san)
    err = CheckError.from_word(int(san.end()), "here")
    assert (err.check, err.site) == ("div", "loss denominator")
    san = Sanitizer("nan")  # nan alone does not check the denominator
    san.begin("cpu")
    masked_loss("mse", torch.ones(2, 3, 1), torch.zeros(2, 3, 1), torch.zeros(2), san)
    assert san.end().item() == _bit("loss")  # the loss's NaN (0 / 0)


def test_checked_eval_traps_and_clean_passes(tmp_path):
    trainer = _trainer(tmp_path, "float")
    assert np.isfinite(trainer._run_eval_epoch("validate"))
    trainer._cities[0].series[:] = float("nan")
    with pytest.raises(CheckError, match="nan check failed at epoch 0, validate batch 0"):
        trainer._run_eval_epoch("validate")


def test_invalid_checks_name_rejected():
    with pytest.raises(ValueError, match="checks must be one of"):
        Sanitizer("everything")
    with pytest.raises(ValueError, match="train.checks"):
        TrainConfig(checks="everything")


def test_programs_unchanged_with_checks_off(tmp_path):
    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    trainer = _trainer(tmp_path, None)
    batches = list(trainer.batches("train"))
    counted = []
    for block in (batches[:S], batches[S:S + 1]):
        with Count() as c:
            trainer._run_block(block)
        counted.append(sum(c.ops.values()))
    assert counted == [PLAIN_BLOCK_OPS, PLAIN_STEP_OPS]
    assert trainer.sanitizer is None


def test_cli_checkify_and_debug_nans(tmp_path, capsys):
    base = ["--preset", "smoke", "--device", "cpu", "--rows", "3", "--timesteps", "240",
            "--batch-size", "16", "--epochs", "1"]
    assert main(base + ["--checkify", "all", "--out-dir", str(tmp_path / "a")]) == 0
    checked = capsys.readouterr().out.strip().splitlines()[-1]
    assert main(base + ["--out-dir", str(tmp_path / "b")]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == checked
    assert main(base + ["--debug-nans", "--out-dir", str(tmp_path / "c")]) == 0
    out = capsys.readouterr().out
    assert "[debug-nans] CUDA graphs off" in out and out.strip().splitlines()[-1] == checked


def test_debug_nans_names_the_module(tmp_path):
    trainer = _trainer(tmp_path, None, debug_nans=True)
    assert trainer.graphs is False
    trainer._cities[0].series[5, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite output of module branches"):
        trainer.train()
    with pytest.raises(ValueError, match="debug_nans"):
        _trainer(tmp_path, None, "d", debug_nans=True, graphs=True)
