#!/usr/bin/env python3
"""Locate the bf16 fleet's card-vs-CPU serving gap on trained weights.

    python3 scripts/bf16_fleet_gap.py [--seeds 0 1] [--windows 4] [--out FILE]

Run from the repo root on a machine with a CUDA card. For each seed it
trains the ``multicity`` fleet at ``precision="bf16"`` as
``chip_smoke.py`` phase 55 does (two epochs, blocks of 4, from the
``train.seed`` weights), loads the run's ``best.ckpt`` into four
forecasters (bf16 and fp32, each on the card and on the CPU) and, for each
city over its first ``--windows`` test windows, reports:

- ``served``: the gaps phase 55 reads (max |err| / max |want|, ||err|| /
  ||want||, raw units) of card bf16, card fp32 and CPU fp32 against CPU
  bf16, with the place and values of each largest error, and the same gaps
  over every test window of the city;
- ``layers``: for each module on the path, its output on the card against
  the CPU's (``chained``: each side fed by its own upstream), and the
  card's module run on the CPU module's own inputs against the CPU's output
  (``local``: one layer's implementations side by side), in bf16 ulps of
  the CPU value;
- ``swapped``: the served gap when the card takes the CPU's output at one
  module and computes the rest itself.

One JSON object per seed and city goes to standard output and to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the modules of one forward, upstream first (``STMGCN`` attribute paths)
MODULES = ("branches.cg_lstm.gate.temporal_gconv", "branches.cg_lstm.gate",
           "branches.cg_lstm.lstm", "branches.gcn", "head")


def first_tensor(value):
    """The module output compared: a tensor, or a tuple's first tensor
    (``StackedLSTM`` returns ``(outputs, states)``)."""
    import torch

    while not isinstance(value, torch.Tensor):
        value = value[0]
    return value


def moved(value, device):
    """``value`` with every tensor in it on ``device``."""
    import torch

    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, (list, tuple)):
        return type(value)(moved(v, device) for v in value)
    return value


def ulp_gap(got, want) -> dict:
    """``got`` against ``want``: max |diff|, max relative, normwise, the
    largest difference in bf16 ulps of ``want`` and how many elements
    differ."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want)
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return {"max_abs": float(diff.max()), "max_rel": float(diff.max() / np.abs(want).max()),
            "norm_rel": float(np.linalg.norm(got - want) / np.linalg.norm(want)),
            "max_ulps": float((diff / ulp).max()),
            "differ": int((diff > 0).sum()), "size": int(diff.size)}


def served_gap(got, want, fp32=None) -> dict:
    """Phase 55's two readings and the place of the largest error."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    at = np.unravel_index(int(diff.argmax()), diff.shape)
    out = {"max": float(diff.max() / np.abs(want).max()),
           "norm": float(np.linalg.norm(got - want) / np.linalg.norm(want)),
           "at": [int(i) for i in at], "got": float(got[at]), "want": float(want[at])}
    if fp32 is not None:
        out["fp32_at"] = float(np.asarray(fp32)[at])
    return out


class Recorder:
    """Forward hooks on :data:`MODULES` of one model: each call's inputs
    and output, or one module's output replaced."""

    def __init__(self, model):
        self.model, self.calls, self.handles = model, {}, []

    def module(self, name):
        return self.model.get_submodule(name)

    def record(self):
        self.calls = {name: [] for name in MODULES}
        for name in MODULES:
            def hook(mod, args, out, name=name):
                self.calls[name].append((moved(args, "cpu"), moved(out, "cpu")))
            self.handles.append(self.module(name).register_forward_hook(hook))
        return self

    def replace(self, name, outputs):
        it = iter(outputs)
        device = next(self.model.parameters()).device
        self.handles.append(self.module(name).register_forward_hook(
            lambda mod, args, out: moved(next(it), device)))
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []


def train(seed: int, device, out: str):
    """The bf16 multicity fleet of phase 55 trained from ``seed``; returns
    ``(best.ckpt path, dataset)``."""
    from chip_smoke import EPOCHS, FLEET_S, state_of

    from stmgcn_tpu_torch import build_trainer, preset
    from stmgcn_tpu_torch.config import MeshConfig

    def config(name):
        cfg = preset("multicity")
        cfg.mesh = MeshConfig()
        cfg.train.fleet, cfg.train.steps_per_superstep = True, FLEET_S
        cfg.train.epochs, cfg.train.precision = EPOCHS, "bf16"
        cfg.train.seed, cfg.train.out_dir = seed, os.path.join(out, name)
        return cfg

    state = state_of(build_trainer(config("init"), device=device, verbose=False))
    trainer = build_trainer(config("run"), device=device, initial_state=state, verbose=False)
    history = trainer.train()
    print(f"seed {seed}: trained, epoch losses {history['train']}", file=sys.stderr)
    return trainer.best_path, trainer.dataset


def examine(seed: int, city: int, path: str, ds, windows: int, device) -> dict:
    import copy

    import torch

    from stmgcn_tpu_torch import Forecaster
    from stmgcn_tpu_torch.experiment import build_model, build_supports

    base = Forecaster.from_checkpoint(path, device="cpu")
    fcs = {}
    for precision, dtype in (("bf16", "bfloat16"), ("fp32", "float32")):
        cfg = copy.deepcopy(base.config)
        cfg.model.dtype = dtype
        for side, where in (("card", device), ("cpu", "cpu")):
            model = build_model(cfg, base.derived["input_dim"], device=where)
            fcs[precision, side] = Forecaster(
                model, base.state_dict, None, cfg, base.derived, base.normalizers,
                device=where)
    sups = build_supports(base.config, ds).for_city(city)
    x_all = ds.denormalize(ds.city_arrays("test", city)[0], city=city)
    rows = x_all[:windows]
    card16, cpu16, card32, cpu32 = (fcs[k] for k in (("bf16", "card"), ("bf16", "cpu"),
                                                      ("fp32", "card"), ("fp32", "cpu")))

    def predict(fc, h=rows):
        return fc.predict(sups, h, city=city)

    with Recorder(card16.model).record() as rc, Recorder(cpu16.model).record() as rp:
        got, want = predict(card16), predict(cpu16)
        card_calls, cpu_calls = rc.calls, rp.calls
    f32_card, f32_cpu = predict(card32), predict(cpu32)
    report = {"seed": seed, "city": city, "windows": windows, "served": {
        "card bf16": served_gap(got, want, f32_cpu),
        "card fp32": served_gap(f32_card, want),
        "cpu fp32": served_gap(f32_cpu, want),
        "card fp32 vs cpu fp32": served_gap(f32_card, f32_cpu)}}
    every = {k: predict(fc, x_all) for k, fc in (("card bf16", card16), ("cpu bf16", cpu16),
                                                  ("cpu fp32", cpu32))}
    report["served_all_windows"] = {
        "windows": int(len(x_all)),
        "card bf16": served_gap(every["card bf16"], every["cpu bf16"]),
        "cpu fp32": served_gap(every["cpu fp32"], every["cpu bf16"])}
    layers = {}
    with torch.inference_mode():
        for name in MODULES:
            chained = [ulp_gap(first_tensor(c[1]).float(), first_tensor(p[1]).float())
                       for c, p in zip(card_calls[name], cpu_calls[name])]
            mod = card16.model.get_submodule(name)
            local = [ulp_gap(first_tensor(mod(*moved(p[0], device))).float().cpu(),
                             first_tensor(p[1]).float()) for p in cpu_calls[name]]
            layers[name] = {"chained": chained, "local": local}
    report["layers"] = layers
    swapped = {}
    for name in MODULES:
        with Recorder(card16.model).replace(name, [p[1] for p in cpu_calls[name]]):
            swapped[name] = served_gap(predict(card16), want)
    report["swapped"] = swapped
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    parser.add_argument("--windows", type=int, default=4)
    parser.add_argument("--out", default=os.path.join("chiprun_out", "bf16_fleet_gap.jsonl"))
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("bf16_fleet_gap: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.card_line())
    chip_smoke.build_kernels()
    device = torch.device("cuda")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp, open(args.out, "w") as f:
        for seed in args.seeds:
            path, ds = train(seed, device, os.path.join(tmp, f"seed{seed}"))
            for city in range(ds.n_cities):
                line = json.dumps(examine(seed, city, path, ds, args.windows, device))
                print(line)
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
