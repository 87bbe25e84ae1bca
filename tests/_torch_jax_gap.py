#!/usr/bin/env python3
"""How far the port's one-device trainer lands from the JAX package's, on
the CPU, from one initial state.

    python3 tests/_torch_jax_gap.py            # from the repo root
    python3 tests/_torch_jax_gap.py --rows 31 --cols 2

The config is ``tests/test_torch_region.py``'s padded region test with the
mesh removed: ``scaled`` at a small grid (5x5 by default), K=2, float32,
batch 16, two epochs. JAX's trainer is built first; the port's takes its
initial parameters (``from_jax_params``). Both train; the script prints,
per tensor, the largest parameter difference and how many entries sit past
the rule of ``tests/test_parallel.py:96-104`` (rtol 5e-4, atol 2e-5), and
the largest relative difference of the per-epoch losses. The last line is
one JSON object of the numbers. Reported, not gated; a helper beside the
tests (it imports both packages), not one of them.
"""

import argparse
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from stmgcn_tpu.config import ExperimentConfig as JaxConfig  # noqa: E402
from stmgcn_tpu.config import MeshConfig as JaxMeshConfig  # noqa: E402
from stmgcn_tpu.config import preset as jax_preset  # noqa: E402
from stmgcn_tpu.experiment import build_trainer as jax_build_trainer  # noqa: E402
from stmgcn_tpu_torch.config import ExperimentConfig  # noqa: E402
from stmgcn_tpu_torch.experiment import build_trainer  # noqa: E402
from stmgcn_tpu_torch.models.params import from_jax_params  # noqa: E402

RTOL, ATOL = 5e-4, 2e-5


def config(rows: int, cols=None) -> JaxConfig:
    """The JAX package's ``scaled`` preset at the padded region test's
    sizes, on one device."""
    cfg = jax_preset("scaled")
    cfg.data.rows, cfg.data.cols = rows, cols
    cfg.data.n_timesteps = 24 * 7 * 2 + 48
    cfg.model.dtype = "float32"
    cfg.model.K = 2
    cfg.train.epochs = 2
    cfg.train.batch_size = 16
    cfg.mesh = JaxMeshConfig()
    return cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=5)
    ap.add_argument("--cols", type=int, default=None, help="default: as --rows")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    jcfg = config(args.rows, args.cols)
    cfg = ExperimentConfig.from_dict(jcfg.to_dict())
    root = tempfile.mkdtemp(prefix="jax_gap_")
    jcfg.train.out_dir = os.path.join(root, "jax")
    jt = jax_build_trainer(jcfg, verbose=False)
    m = 3  # scaled's graphs
    init = from_jax_params(jax.tree.map(np.asarray, jt.params), m)
    cfg.train.out_dir = os.path.join(root, "port")
    pt = build_trainer(cfg, device="cpu", verbose=False, initial_state=init)
    port_hist, jax_hist = pt.train(), jt.train()
    theirs = from_jax_params(jax.tree.map(np.asarray, jt.params), m)
    mine = from_jax_params(pt.state_trees()[0], m)
    tensors = {}
    for name, want in theirs.items():
        got, want = mine[name].double().numpy(), want.double().numpy()
        diff = np.abs(got - want)
        past = int((diff > ATOL + RTOL * np.abs(want)).sum())
        tensors[name] = {"max_abs": float(diff.max()), "past_rule": past}
        print(f"{name}: largest |port - jax| {diff.max():.4g}, {past} of {diff.size} "
              f"entries past rtol {RTOL} / atol {ATOL}")
    losses = {mode: float(np.max(np.abs(np.asarray(port_hist[mode]) - np.asarray(jax_hist[mode]))
                                 / np.abs(np.asarray(jax_hist[mode]))))
              for mode in ("train", "validate")}
    out = {"rows": cfg.data.rows, "cols": cfg.data.cols,
           "max_abs": max(t["max_abs"] for t in tensors.values()),
           "past_rule": sum(t["past_rule"] for t in tensors.values()),
           "loss_max_rel": losses, "tensors": tensors}
    print(f"losses, largest relative difference: {losses}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
