#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s phase 62 parameter rule stands, step by step,
on one card.

    python3 scripts/region_gaps.py      # from the repo root, on a host with a CUDA card
    python3 scripts/region_gaps.py --first-step     # the first step's gradients alone

First the dense conv's product at ``scaled``'s shapes, one einsum over
the stacked branches against one per branch, forward and input gradient,
each against float64 (``einsum_errors``).

Then ``scaled`` at float32 and full width (one epoch, 22 steps) on its
region=8 mesh (eight ranks sharing the card over gloo, N = 2,500 padded to
2,504) and on a region=4 one (four ranks, no padding), each against the
unpadded single-device twin of the same seed, and the two meshes against
each other. After every optimizer step each run keeps its parameters; per
step the script prints how many entries sit past phase 62's elementwise
rule (rtol 5e-4, atol 2e-5) and the largest difference, and at the end,
per tensor past it, the twin's Adam rms gradient at those entries beside
the tensor's median.

Then the first step's gradients, before Adam, on the first training
batch: the one-device twin (fp32, the LSTM kernels), the region=4 mesh's
(summed over the ranks), and on one device the same weights and batch in
float64 (the layered LSTM, every product in float64: the reference), in
fp32 with the layered LSTM instead of the kernels, with B1 or B2 alone
replaced by its plain version, and in fp32 with the grid branch on a
one-shard banded strip (the mesh's branch modes). At the entries where
the twin's and the mesh's first Adam updates differ by more than phase
62's atol (with L2 weight decay nearly cancelling a gradient, Adam's first
step turns a gradient's last bits into a step of O(lr)), each gradient is
printed beside the reference.

Every reading stands beside the card's ``nvidia-smi`` name and power
limit; JSON lines go to ``chiprun_out/region_gaps.jsonl`` and the last line
of the output is one JSON object of the numbers. Exits 1 without a card.
Reported, not gated.

``python3 scripts/region_gaps.py --rank JOB DIR`` is one rank of a mesh
run (the script starts them).
"""

import json
import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke as cs  # noqa: E402

REGIONS = (8, 4)


def _snapshots(trainer) -> list:
    """Each optimizer step's parameters (one step a dispatch), on the host."""
    snaps = []
    dispatch = trainer._dispatch

    def recorded(*a, **k):  # every dispatch is one training step (S = 1)
        out = dispatch(*a, **k)
        snaps.append({n: p.detach().float().cpu().clone()
                      for n, p in trainer.model.named_parameters()})
        return out

    trainer._dispatch = recorded
    return snaps


def run(cfg, device) -> dict:
    """``cfg`` trained with a snapshot after each step; the twin's Adam rms
    gradients too."""
    from stmgcn_tpu_torch.experiment import build_trainer

    trainer = build_trainer(cfg, device=device, verbose=False)
    snaps = _snapshots(trainer)
    trainer.train()
    opt = trainer.optimizer
    rms = {n: np.sqrt(v.detach().float().cpu().numpy())
           for n, v in zip(trainer._param_names, opt.exp_avg_sq)}
    return {"snaps": snaps, "rms": rms, "path": trainer.train_path}


def mesh_job(args, out: str, device) -> dict:
    cfg = cs.scaled_config(os.path.join(out, "run"), "float32")
    cfg.mesh.region = args["region"]
    return run(cfg, device)


def grads_job(args, out: str, device) -> dict:
    """The mesh's first-batch gradients, summed over the ranks."""
    cfg = cs.scaled_config(os.path.join(out, "run"), "float32")
    cfg.mesh.region = args["region"]
    return first_grads(cfg, device)


JOBS = {"mesh": mesh_job, "grads": grads_job}


def first_grads(cfg, device, *, layered: bool = False, float64: bool = False,
                banded: bool = False, plain: str = "") -> dict:
    """The gradients of the first training batch's loss (no optimizer step),
    whole and summed over the ranks on a mesh; ``layered`` takes the LSTM's
    layer-by-layer plain route, ``float64`` runs every product in float64,
    ``banded`` routes the grid branch to a one-shard banded strip;
    ``plain`` ``"fwd"`` or ``"bwd"`` replaces that LSTM kernel (B1 or B2)
    by its plain version on the card."""
    import importlib

    import torch

    fl = importlib.import_module("stmgcn_tpu_torch.ops.fused_lstm")

    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.models.cg_lstm import ContextualGate
    from stmgcn_tpu_torch.ops import chebconv, layers
    from stmgcn_tpu_torch.ops.lstm import StackedLSTM
    from stmgcn_tpu_torch.parallel import banded_decompose, bandwidth
    from stmgcn_tpu_torch.train.step import masked_loss

    trainer = build_trainer(cfg, device=device, verbose=False, graphs=False)
    model, supports = trainer.model, trainer.supports
    batch = next(iter(trainer.batches("train")))
    x, y, mask = trainer.place(batch, "train")
    if banded:
        from stmgcn_tpu_torch.models import STMGCN

        dense = supports.cpu().numpy()
        routed = (banded_decompose(dense[0], 1, max(bandwidth(s) for s in dense[0])).to(device),
                  supports[1], supports[2])
        twin = STMGCN(model.m_graphs, model.n_supports, model.seq_len, model.input_dim,
                      lstm_hidden_dim=cfg.model.lstm_hidden_dim,
                      lstm_num_layers=cfg.model.lstm_num_layers,
                      gcn_hidden_dim=cfg.model.gcn_hidden_dim,
                      support_modes=("banded", "dense", "dense"), device=device)
        twin.load_state_dict(model.state_dict())
        model, supports = twin, routed
    saved = (StackedLSTM.forward, chebconv.accum_matmul, layers.accum_einsum,
             layers.accum_matmul, fl.fused_lstm, fl.fused_lstm_bwd)
    try:
        if plain == "fwd":
            fl.fused_lstm = fl.fused_lstm_reference
        elif plain == "bwd":
            fl.fused_lstm_bwd = fl.fused_lstm_bwd_reference
        if layered or float64:
            StackedLSTM.forward = StackedLSTM.layered
        forward = model
        if float64:  # every product, sum and cast in float64
            def einsum64(spec, a, b):
                return torch.einsum(spec, a.double(), b.double())

            def matmul64(a, b):
                return a.double() @ b.double()

            layers.accum_einsum = einsum64  # branchwise_einsum's product
            chebconv.accum_matmul = layers.accum_matmul = matmul64
            model = model.double()
            for module in model.modules():
                if hasattr(module, "compute_dtype"):  # the gate pools in the signal's dtype
                    module.compute_dtype = None if isinstance(
                        module, ContextualGate) else torch.float64
            supports, x, y = supports.double(), x.double(), y.double()

            def forward(sup, obs):  # the fusion sum in float64 (one device, horizon 1)
                return model.head(model.branches(sup, obs, None).sum(dim=0))
        model.zero_grad()
        pred = forward(supports, x)
        masked_loss(cfg.train.loss, pred, y, mask, rows=trainer._rows,
                    nodes=trainer._nodes(batch.city)).backward()
    finally:
        (StackedLSTM.forward, chebconv.accum_matmul, layers.accum_einsum,
         layers.accum_matmul, fl.fused_lstm, fl.fused_lstm_bwd) = saved
    grads = [p.grad.double() for p in model.parameters()]
    if trainer.mesh is not None:
        from stmgcn_tpu_torch.parallel.collectives import replica_sum

        grads = [replica_sum(g, trainer.mesh) for g in grads]
    return {"grads": dict(zip(trainer._param_names, (g.cpu() for g in grads))),
            "params": {n: p.detach().double().cpu() for n, p in model.named_parameters()}}


def rank_main(job: str, out: str) -> int:
    import torch
    import torch.distributed as dist

    from stmgcn_tpu_torch.parallel import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_distributed(device="cuda", timeout=cs.MESH_TIMEOUT)
    args = torch.load(os.path.join(out, "args.pt"), weights_only=False)
    result = JOBS[job](args, out, device)
    if dist.get_rank() == 0:  # the parameters are replicated: the lead's suffice
        torch.save(result, os.path.join(out, "rank0.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mesh_run(region: int) -> dict:
    import torch

    from stmgcn_tpu_torch.ops._build import PREBUILT_ENV
    from stmgcn_tpu_torch.parallel.mesh import launch_local

    out = cs.scratch(f"region-gaps-{region}")
    os.makedirs(out, exist_ok=True)
    torch.save({"region": region}, os.path.join(out, "args.pt"))
    _, problem = launch_local([sys.executable, os.path.abspath(__file__), "--rank", "mesh", out],
                              region, env={PREBUILT_ENV: "1"}, log_dir=out,
                              timeout=cs.MESH_TIMEOUT, cwd=_REPO)
    if problem is not None:
        cs.fail(f"region={region}: {problem}\n"
                + open(os.path.join(out, "rank0.log")).read()[-3000:])
    return torch.load(os.path.join(out, "rank0.pt"), weights_only=False)


def gaps(snap: dict, want: dict) -> tuple:
    """Entries past phase 62's elementwise rule, and the largest
    difference, over every tensor."""
    past, worst = 0, 0.0
    for name, value in snap.items():
        a, b = value.numpy(), want[name].numpy()
        past += int((~np.isclose(a, b, rtol=cs.MESH_PARAM_RTOL, atol=cs.MESH_PARAM_ATOL)).sum())
        worst = max(worst, float(np.max(np.abs(a - b))))
    return past, worst


def adam_first(g: np.ndarray, p: np.ndarray, cfg) -> np.ndarray:
    """The first Adam update of gradient ``g`` at ``p`` (L2 added first;
    bias-corrected moments g and g squared)."""
    g = g + cfg.train.weight_decay * p
    return cfg.train.lr * g / (np.abs(g) + 1e-8)


def first_step_grads(device, card: str) -> dict:
    """The first batch's gradients five ways (module docstring) at the
    entries where the twin's and the mesh's first updates differ most."""
    import torch

    from stmgcn_tpu_torch.config import MeshConfig
    from stmgcn_tpu_torch.parallel.mesh import launch_local
    from stmgcn_tpu_torch.ops._build import PREBUILT_ENV

    cfg = cs.scaled_config(cs.scratch("region-gaps-grads"), "float32")
    cfg.mesh = MeshConfig()
    runs = {"twin": first_grads(cfg, device), "float64": first_grads(cfg, device, float64=True),
            "layered": first_grads(cfg, device, layered=True),
            "banded": first_grads(cfg, device, banded=True),
            "plain_fwd": first_grads(cfg, device, plain="fwd"),
            "plain_bwd": first_grads(cfg, device, plain="bwd")}
    cs.release()
    out = cs.scratch("region-gaps-mesh-grads")
    os.makedirs(out, exist_ok=True)
    torch.save({"region": 4}, os.path.join(out, "args.pt"))
    _, problem = launch_local([sys.executable, os.path.abspath(__file__), "--rank", "grads", out],
                              4, env={PREBUILT_ENV: "1"}, log_dir=out, timeout=cs.MESH_TIMEOUT,
                              cwd=_REPO)
    if problem is not None:
        cs.fail(f"grads: {problem}\n" + open(os.path.join(out, "rank0.log")).read()[-3000:])
    runs["mesh"] = torch.load(os.path.join(out, "rank0.pt"), weights_only=False)
    ref = runs["float64"]["grads"]
    report = {}
    for name, g in runs["twin"]["grads"].items():
        p = runs["twin"]["params"][name].numpy()
        u_twin = adam_first(g.numpy(), p, cfg)
        u_mesh = adam_first(runs["mesh"]["grads"][name].numpy(), p, cfg)
        gap = np.abs(u_twin - u_mesh).ravel()
        worst = np.argsort(gap)[::-1][:3]
        rows = []
        for e in worst:
            if gap[e] <= cs.MESH_PARAM_ATOL:
                continue
            rows.append({"entry": int(e), "update_gap": float(gap[e]),
                         **{k: float(runs[k]["grads"][name].numpy().ravel()[e])
                            for k in ("float64", "twin", "mesh", "layered", "banded",
                                      "plain_fwd", "plain_bwd")}})
        errs = {k: float(np.max(np.abs(runs[k]["grads"][name].numpy() - ref[name].numpy())))
                for k in ("twin", "mesh", "layered", "banded", "plain_fwd", "plain_bwd")}
        if rows:
            report[name] = {"entries": rows, "max_err_vs_float64": errs}
            print(f"first-batch gradient of {name}: at the entries where the twin's and the "
                  f"region=4 mesh's first Adam updates differ most: {rows}; largest |g - "
                  f"g_float64| over the tensor: {errs} ({card})")
    return report


def einsum_errors(device, card: str) -> dict:
    """The dense conv's product at ``scaled``'s shapes (M=3, K=4, N = 2,500,
    B 16; the branch conv's F = 64 per branch, the gate's F = 5 shared),
    as the twin computes it (one einsum over the stacked branches) and
    branch by branch (the region mesh's per-branch form), forward and the
    signal's gradient of ``sum(out * cot)``, each against float64: the
    largest error over the largest |value|."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(0)
    m, k, n, b = 3, 4, 2500, 16
    sup = (torch.randn(m, k, n, n, generator=gen) * (torch.rand(m, k, n, n, generator=gen)
                                                      < 0.05)).to(device)
    out = {}
    for name, x in (("branch conv", torch.randn(m, b, n, 64, generator=gen)),
                    ("gate conv", torch.randn(b, n, 5, generator=gen))):
        x = x.to(device)
        cot = torch.randn((m, b, n, k, x.shape[-1]), generator=gen).to(device)

        def product(xx, per_branch=False, s=sup):
            if not per_branch:
                return torch.einsum("...kij,...bjf->...bikf", s, xx)
            return torch.stack([torch.einsum("kij,bjf->bikf", s[i], xx[i] if xx.dim() == 4 else xx)
                                for i in range(m)])

        results = {}
        for label, per, dtype in (("float64", False, torch.float64), ("stacked", False, None),
                                  ("per_branch", True, None)):
            xx = (x.double() if dtype else x).clone().requires_grad_()
            got = product(xx, per, sup.double() if dtype else sup)
            (got * (cot.double() if dtype else cot)).sum().backward()
            results[label] = (got.detach().double(), xx.grad.double())
        want, want_dx = results["float64"]
        out[name] = {f"{label} {part}": float((results[label][i] - ref).abs().max())
                     / float(ref.abs().max())
                     for label in ("stacked", "per_branch")
                     for i, (part, ref) in enumerate((("forward", want), ("dx", want_dx)))}
    out["allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
    out["precision"] = torch.get_float32_matmul_precision()
    print(f"dense conv product, largest error over the largest value against float64: {out} "
          f"({card})")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("region_gaps: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card)
    os.makedirs(os.path.join(_REPO, "chiprun_out"), exist_ok=True)
    sink = open(os.path.join(_REPO, "chiprun_out", "region_gaps.jsonl"), "w")
    summary = {"card": card}
    try:
        cs.build_kernels()
        device = torch.device("cuda")
        from stmgcn_tpu_torch.config import MeshConfig

        summary["einsum"] = einsum_errors(device, card)
        regions = () if "--first-step" in sys.argv else REGIONS
        cfg = cs.scaled_config(cs.scratch("region-gaps-twin"), "float32")
        cfg.mesh = MeshConfig()
        twin = run(cfg, device) if regions else None
        cs.release()
        meshes = {}
        for region in regions:
            got = meshes[region] = mesh_run(region)
            steps = []
            for s, (snap, want) in enumerate(zip(got["snaps"], twin["snaps"])):
                past, worst = gaps(snap, want)
                steps.append({"step": s + 1, "past": past, "max_diff": worst})
                sink.write(json.dumps({"region": region, **steps[-1]}) + "\n")
            final, want = got["snaps"][-1], twin["snaps"][-1]
            tensors = {}
            for name, value in final.items():
                a, b = value.numpy(), want[name].numpy()
                close = np.isclose(a, b, rtol=cs.MESH_PARAM_RTOL, atol=cs.MESH_PARAM_ATOL)
                if not close.all():
                    rms = twin["rms"][name]
                    tensors[name] = {"past": int((~close).sum()),
                                     "max_diff": float(np.max(np.abs(a - b))),
                                     "rms_grad_at_past": float(np.median(rms[~close])),
                                     "rms_grad_median": float(np.median(rms))}
            first = next((st["step"] for st in steps if st["past"]), None)
            summary[f"region{region}"] = {"steps": steps, "first_step_past": first,
                                         "final_past": tensors}
            print(f"scaled fp32 region={region} (gloo ranks on one card) against the one-device "
                  f"twin: entries past phase 62's rule by step "
                  f"{[st['past'] for st in steps]}; largest |diff| by step "
                  f"{[float('%.3e' % st['max_diff']) for st in steps]}; first step past: "
                  f"{first}; at the end: {tensors or 'none'} ({card})")
        summary["first_step"] = first_step_grads(device, card)
        if len(meshes) == 2:  # two region meshes against each other
            a, b = (meshes[r]["snaps"] for r in REGIONS)
            both = [gaps(x, y) for x, y in zip(a, b)]
            summary["mesh_vs_mesh"] = [{"step": i + 1, "past": p, "max_diff": w}
                                       for i, (p, w) in enumerate(both)]
            print(f"region={REGIONS[0]} against region={REGIONS[1]}: entries past phase 62's "
                  f"rule by step {[p for p, _ in both]}; largest |diff| by step "
                  f"{[float('%.3e' % w) for _, w in both]} ({card})")
        print(json.dumps(summary))
    finally:
        import shutil

        sink.close()
        for root in cs._SCRATCH:
            shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--rank":
        sys.exit(rank_main(sys.argv[2], sys.argv[3]))
    sys.exit(main())
