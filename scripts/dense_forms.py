#!/usr/bin/env python3
"""What the dense conv's per-branch products and the gate's float64 node
mean cost on the main path, on one card, in one call.

    python3 scripts/dense_forms.py      # from the repo root, on a host with a CUDA card

Two forms of the same model, timed in turns (A, B, B, A; host clock around
a call that ends in a synchronize, ``chip_smoke.ab_p50``):

- ``per-branch``: the port's forms: one product per branch for every dense
  support stack (``ops/layers.py`` ``branchwise_einsum``), and at float32
  compute the gate's node mean summed in float64;
- ``stacked``: one einsum over the stacked branches (a batched GEMM; per-row
  stacks batched over branch and row) and the node mean summed in float32.

Paths, each graphed as ``chip_smoke.py``'s phases 30-32 run them: the dense
flagship's training step inside a block of 4 (batch 64), fp32 and bf16;
its serving dispatch at rungs 1 and 64, fp32 and bf16; the multicity fleet
(one card) serving both cities at rungs 1 and 64 (per-row support stacks)
and its training step. Every reading stands beside the card's
``nvidia-smi`` name and power limit; the last line of the output is one
JSON object of the numbers. Reported, not gated. Exits 1 without a card.
"""

import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

FORMS = ("per-branch", "stacked")
RUNGS = (1, 64)


def _stacked_einsum(spec, a, b):
    """The product before the per-branch form: a ``...`` over the branch
    (and, per row, the row) axes, one einsum."""
    from stmgcn_tpu_torch.ops import layers

    lhs, out = spec.split("->")
    ta, tb = lhs.split(",")
    return layers.accum_einsum(f"...{ta},...{tb}->...{out}", a, b)


@contextlib.contextmanager
def form(name: str):
    """The model's forms while the block runs: the port's, or ``stacked``."""
    import torch

    from stmgcn_tpu_torch.models.cg_lstm import ContextualGate
    from stmgcn_tpu_torch.ops import chebconv

    saved = chebconv.branchwise_einsum, ContextualGate._pool_dtype
    if name == "stacked":
        chebconv.branchwise_einsum = _stacked_einsum
        ContextualGate._pool_dtype = lambda self: torch.float32
    try:
        yield
    finally:
        chebconv.branchwise_einsum, ContextualGate._pool_dtype = saved


def under(name, fn):
    def call():
        with form(name):
            return fn()
    return call


def timed(what: str, fns: dict, card: str, calls: int, per: int = 1) -> dict:
    """Each form's p50 of ``fns[form]()`` in turns (ms, over ``per``)."""
    p50 = {k: v / per for k, v in cs.ab_p50(fns, calls).items()}
    print(f"{what}: per-branch {p50['per-branch']:.4f} ms, stacked {p50['stacked']:.4f} ms "
          f"(per-branch / stacked {p50['per-branch'] / p50['stacked']:.4f}) ({card})")
    return p50


def training(make, what: str, card: str) -> dict:
    """A graphed trainer per form from one state; each warmed over its
    epoch's first blocks (capture), then one full block timed."""
    trainers = {}
    state = None
    for name in FORMS:
        with form(name):
            trainers[name] = make(state)
        if state is None:
            state = {k: v.detach().cpu().clone()
                     for k, v in trainers[name].model.state_dict().items()}
    g = trainers[FORMS[0]]
    block = [b for b in g._blocks(list(g.batches("train")), 0)
             if len(b) == g.steps_per_superstep][0]
    for name, t in trainers.items():
        for _ in range(3):
            under(name, lambda t=t: t._run_block(block))()
    S = g.steps_per_superstep
    return timed(f"{what}, p50 of a step inside a block of {S} (graphed, batch {g.batch_size})",
                 {n: under(n, lambda t=t: t._run_block(block)) for n, t in trainers.items()},
                 card, 8, S)


def serving(make_engine, requests: dict, what: str, card: str) -> dict:
    """A graphed engine per form over the same weights; each request's
    dispatch p50 in turns."""
    engines = {}
    for name in FORMS:
        with form(name):
            engines[name] = make_engine()
    try:
        return {req: timed(f"{what}, {req}, p50 dispatch (graphed)",
                           {n: under(n, lambda e=e, kw=kw: e.predict_direct(**kw))
                            for n, e in engines.items()}, card, cs.AB_CALLS)
                for req, kw in requests.items()}
    finally:
        for engine in engines.values():
            engine.close()


def dense(device, card: str) -> dict:
    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig, build_trainer
    from stmgcn_tpu_torch.experiment import build_dataset, build_model, build_supports

    out = {}
    for precision in ("fp32", "bf16"):
        def make(initial, precision=precision):
            c = cs.flagship_config(cs.BATCH)
            c.train.precision = precision
            c.train.out_dir = cs.scratch(f"forms_dense_{precision}_{initial is None}")
            return build_trainer(c, device=device, graphs=True, initial_state=initial,
                                 verbose=False)

        out[f"train {precision}"] = training(make, f"dense training, {precision}", card)
        torch.cuda.empty_cache()
    cfg = cs.pallas_preset("default")
    cfg.data.rows, cfg.data.serial_len = cs.GRID, cs.SERIAL
    ds = build_dataset(cfg)
    supports = build_supports(cfg, ds)
    derived = {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}
    model = build_model(cfg, ds.n_feats, device=device, generator=torch.Generator().manual_seed(0))
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    windows = ds.denormalize(ds.arrays("test")[0])
    requests = {f"rung {b}": {"history": windows[:b]} for b in RUNGS}
    for dtype in ("float32", "bfloat16"):
        c = cs.pallas_preset("default")
        c.data.rows, c.data.serial_len, c.model.dtype = cs.GRID, cs.SERIAL, dtype
        fc = Forecaster(build_model(c, ds.n_feats, device=device), state, ds.normalizer, c,
                        derived, device=device)
        out[f"serve {dtype}"] = serving(lambda fc=fc: fc.serving_engine(
            supports, config=ServingConfig(buckets=cs.BUCKETS), device=device, graphs=True),
            requests, f"dense serving, {dtype}", card)
        torch.cuda.empty_cache()
    return out


def fleet(device, card: str) -> dict:
    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig, build_trainer
    from stmgcn_tpu_torch.experiment import build_supports

    def make(initial, epochs=None):
        cfg = cs.fleet_config(cs.scratch(f"forms_fleet_{initial is None}_{epochs}"))
        cfg.train.epochs = epochs or cfg.train.epochs
        return build_trainer(cfg, device=device, graphs=True, initial_state=initial,
                             verbose=False)

    out = {"train": training(make, "multicity fleet training", card)}
    torch.cuda.empty_cache()
    trainer = make(None, epochs=1)
    trainer.train()
    fc = Forecaster.from_checkpoint(trainer.best_path, device=device)
    ds = trainer.dataset
    sups = build_supports(fc.config, ds)
    windows = {c: ds.denormalize(ds.city_arrays("test", c)[0], city=c) for c in (0, 1)}
    requests = {f"city {c}, rung {b}": {"history": windows[c][:b], "city": c}
                for c in (0, 1) for b in RUNGS}
    out["serve"] = serving(lambda: fc.fleet_engine(
        sups, config=ServingConfig(buckets=cs.BUCKETS), device=device, graphs=True),
        requests, "multicity fleet serving", card)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dense_forms: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card)
    try:
        cs.build_kernels()
        device = torch.device("cuda", 0)
        out = {"card": card, "dense": dense(device, card)}
        cs.release()
        out["fleet"] = fleet(device, card)
        print(json.dumps(out))
    finally:
        import shutil

        for root in cs._SCRATCH:
            shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
