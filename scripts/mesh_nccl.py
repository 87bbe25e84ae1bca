#!/usr/bin/env python3
"""``chip_smoke.py``'s mesh phases over NCCL, one rank per card.

    python3 scripts/mesh_nccl.py      # from the repo root, on a host with 4 cards

Five legs, each read in full before the verdict; every number beside the
cards' ``nvidia-smi`` name and power limit; the last line one JSON object
of the numbers. Needs four CUDA cards; exits 1 without them.

1. **The record of the float32 sum** (``c4-record``): phase 57
   (``multicity``: cities 12x12 and 10x10, batch 64, full width, two
   epochs) at dp=4 over NCCL, the gradients summed as the port summed them
   before the float64 bucket: one float32 all-reduce over NCCL. At every
   step each rank also sums the same float32 partials over gloo (a group
   of the same ranks through the host) and in float64; the partial and the
   three sums of ``branches.gcn.W`` are kept. After the run, the entries
   past phase 57's elementwise rule against the single-device twin (rtol
   5e-4, atol 2e-5) are printed with, at each step where the transports'
   float32 sums differ there, the four partials, their exact sum, each
   transport's float32 sum and its distance from the exact sum in float32
   ulps. Over the whole bucket, per step: the entries where NCCL's and
   gloo's float32 sums differ.
2. **The order-free sum over NCCL** (``multicity``): phase 57 at dp=4 with
   the port's ``GradSync`` (float64 bucket), held to the twin by phase 57's
   own rules: the transport NCCL; per-step losses (rtol 1e-5); final
   parameters elementwise (rtol 5e-4, atol 2e-5); one B1 launch per
   forward of 6,912 or 4,800 rows and one B2 per step; one 2,290,264-byte
   gradient all-reduce a step; the manifest.
3. **The same over gloo** (four ranks sharing card 0): the final
   parameters must equal leg 2's bit for bit.
4. **``scaled`` at region=4 over NCCL point-to-point**: the preset at full
   width and float32 (N = 2,500 = 4 x 625, no padding; the grid branch
   banded at its halo of 150, the others dense), one epoch: the routes,
   one B1 per forward of 30,000 rows (M=3 x B 16 x N_local 625) and one B2
   per step, the step's bytes (``region_bytes``: the dense convs' input
   cotangents reduce-scattered, ``comm.reduce_scatter``) and manifest, and
   phase 62's rule against the fp32 twin.
5. **``scaled`` with block-CSR strips at region=4 over NCCL** (phase 64 at
   region=4, 625-row strips): routes, B1 rows, B3 two per forward and B4
   one per step, the step's bytes (``stacked_bytes``: the strips' input
   cotangent reduce-scattered) and manifest, and phase 62's rule against
   the one-device block-CSR twin.

``--record-only`` runs leg 1 alone: the script copied into another
checkout (the code before the float64 bucket, say) records that code's
sums. ``python3 scripts/mesh_nccl.py --rank JOB DIR`` is one rank of leg 1
(the script starts them).
"""

import json
import math
import os
import subprocess
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke as cs  # noqa: E402

DP, REGION = 4, 4
#: the tensor whose entries phase 57's rule caught over NCCL's float32 sum
WATCH = "branches.gcn.W"


def c4_record(args, out: str, device) -> dict:
    """Leg 1 in one rank: the preset trained on NCCL's float32 sum, with
    the watched tensor's partials and its float32 NCCL, float32 gloo and
    float64 sums at every step, and per step the count of bucket entries
    where the two float32 sums differ."""
    import torch
    import torch.distributed as dist

    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.models import from_jax_params

    cfg = cs.mesh_config("multicity", os.path.join(out, "run"))
    cfg.mesh.dp = DP
    trainer = build_trainer(cfg, device=device, verbose=False)
    sync, mesh = trainer.optimizer.sync, trainer.mesh
    gloo = dist.new_group(list(mesh.lines["dp"]), backend="gloo")
    sizes = [p.numel() for p in trainer.optimizer.params]
    i = trainer._param_names.index(WATCH)
    lo = sum(sizes[:i])
    hi = lo + sizes[i]
    rec = {"partial": [], "nccl": [], "gloo": [], "f64": [], "differ": []}

    @torch.no_grad()
    def float32_sum(grads):
        bucket = torch.cat([g.reshape(-1).float() for g in grads])
        nccl = bucket.clone()
        dist.all_reduce(nccl, group=mesh.groups["dp"])
        host = bucket.cpu()
        dist.all_reduce(host, group=gloo)
        wide = bucket.double()
        dist.all_reduce(wide, group=mesh.groups["dp"])
        for key, value in (("partial", bucket), ("nccl", nccl), ("gloo", host), ("f64", wide)):
            rec[key].append(value[lo:hi].cpu().numpy().copy())
        rec["differ"].append(int((nccl.cpu() != host).sum()))
        start = 0
        for g in grads:  # training goes on from NCCL's float32 sum
            g.copy_(nccl[start:start + g.numel()].view_as(g))
            start += g.numel()

    sync.reduce = float32_sum
    trainer.train()
    params, _ = trainer.state_trees()
    rec = {k: np.stack(v) if k != "differ" else v for k, v in rec.items()}
    return {"state": from_jax_params(params, trainer.model.m_graphs), "record": rec,
            "backend": mesh.backend, "shape": tuple(trainer.optimizer.params[i].shape)}


JOBS = {"c4-record": c4_record}
#: the jobs run so far (each gets a directory of its own)
_RUNS: list = []


def rank_main(job: str, out: str) -> int:
    import torch
    import torch.distributed as dist

    from stmgcn_tpu_torch.parallel import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_distributed(device="cuda", timeout=cs.MESH_TIMEOUT)
    args = torch.load(os.path.join(out, "args.pt"), weights_only=False)
    result = JOBS[job](args, out, device)
    torch.save(result, os.path.join(out, f"rank{dist.get_rank()}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_job(cmd, job: str, world: int, env=None, **args) -> list:
    """``cmd + [job, out]`` in ``world`` local ranks (the kernels prebuilt,
    ``env`` on top); each rank's saved result."""
    import torch

    from stmgcn_tpu_torch.ops._build import PREBUILT_ENV
    from stmgcn_tpu_torch.parallel.mesh import launch_local

    _RUNS.append(job)
    out = cs.scratch(f"nccl-{job}-{len(_RUNS)}")
    os.makedirs(out, exist_ok=True)
    torch.save(args, os.path.join(out, "args.pt"))
    _, problem = launch_local(cmd + [job, out], world, env={PREBUILT_ENV: "1", **(env or {})},
                              log_dir=out, timeout=cs.MESH_TIMEOUT, cwd=_REPO)
    if problem is not None:
        tails = "".join(f"\n--- rank {r} ---\n" + open(os.path.join(out, f"rank{r}.log")).read()
                        [-3000:] for r in range(world))
        cs.fail(f"{job}: {problem}{tails}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def ulps(value: float, exact: float) -> float:
    """``value - exact`` in float32 ulps at ``exact``."""
    return (float(value) - exact) / float(np.spacing(np.float32(abs(exact))))


def record_leg(twin: dict) -> dict:
    """Leg 1 and its readings."""
    results = run_job([sys.executable, os.path.abspath(__file__), "--rank"], "c4-record", DP,
                      dp=DP)
    got = results[0]
    gaps = cs.param_gaps({"state": got["state"]}, twin)
    recs = [r["record"] for r in results]
    past = np.flatnonzero(~np.isclose(got["state"][WATCH].cpu().numpy(),
                                      twin["state"][WATCH].cpu().numpy(),
                                      rtol=cs.MESH_PARAM_RTOL, atol=cs.MESH_PARAM_ATOL).ravel())
    print(f"leg 1 (multicity dp={DP}, NCCL's float32 sum, as before the repair): backend "
          f"{got['backend']}; past phase 57's elementwise rule: {cs.gaps_text(gaps)}; bucket "
          f"entries where NCCL's and gloo's float32 sums differ, per step: {got['record']['differ']}")
    entries = []
    for e in past[:8]:
        steps = []
        for s in range(len(recs[0]["f64"])):
            parts = [float(r["partial"][s][e]) for r in recs]
            exact = math.fsum(parts)
            nccl, gloo = float(recs[0]["nccl"][s][e]), float(recs[0]["gloo"][s][e])
            if nccl != gloo:
                steps.append({"step": s, "partials": parts, "exact": exact,
                              "f64_rounded": float(np.float32(exact)), "nccl": nccl,
                              "gloo": gloo, "nccl_ulps": ulps(nccl, exact),
                              "gloo_ulps": ulps(gloo, exact),
                              "f64_sum": float(recs[0]["f64"][s][e])})
        entries.append({"entry": np.unravel_index(e, got["shape"]), "flat": int(e),
                        "steps_differing": len(steps), "first": steps[:2]})
        for st in steps[:2]:
            print(f"  {WATCH}{tuple(int(i) for i in entries[-1]['entry'])} step {st['step']}: "
                  f"partials {st['partials']}; exact sum {st['exact']:.10e} (float64 all-reduce "
                  f"{st['f64_sum']:.10e}); NCCL float32 {st['nccl']:.10e} ({st['nccl_ulps']:+.2f}"
                  f" ulp), gloo float32 {st['gloo']:.10e} ({st['gloo_ulps']:+.2f} ulp)")
        print(f"  {WATCH} flat {int(e)}: NCCL's and gloo's float32 sums differ at "
              f"{len(steps)} of {len(recs[0]['f64'])} steps")
    return {"past": {k: v for k, v in gaps.items() if not v["elementwise_ok"]},
            "differ_per_step": got["record"]["differ"], "entries": entries}


def repaired_legs(twin: dict, cards: list, problems: list) -> dict:
    """Legs 2 and 3: the port's float64 sum over NCCL, then over gloo."""
    ranks = [r["57"] for r in cs.run_ranks("multicity", DP, dp=DP)]
    rows = {64 // DP * 144 * 3, 64 // DP * 100 * 3}
    records = []
    for r, got in enumerate(ranks):
        what = f"leg 2 (multicity dp={DP} over NCCL, float64 sum) rank {r}"
        if got["mesh"]["backend"] != "nccl":
            problems.append(f"{what}: the transport was {got['mesh']['backend']}")
        cs.check_comm(got, what, grads=8 * cs.MESH_PARAMS, steps=got["steps"])
        cs.check_mesh_launches(got, what, rows)
        cs.check_mesh_run(got, twin, what, params=False)
        params = cs.param_gaps(got, twin)
        worst = max(params, key=lambda k: params[k]["update_gap"])
        past = sorted(k for k, v in params.items() if not v["elementwise_ok"])
        if past:
            problems.append(f"{what}: parameters past phase 57's elementwise tolerance: "
                            f"{cs.gaps_text(params)}")
        loss_diff = float(np.max(np.abs(np.asarray(got["losses"]) - twin["losses"])))
        records.append({"rank": r, "p50_ms": got["p50_ms"], "loss_max_diff": loss_diff,
                        "param_max_diff": max(v["max_diff"] for v in params.values()),
                        "worst_update_gap": params[worst]["update_gap"],
                        "past_elementwise": past})
        print(f"{what}: {got['steps']} steps, losses max |diff| {loss_diff:.3e}; parameters "
              f"max |diff| {records[-1]['param_max_diff']:.3e}, past phase 57's elementwise "
              f"tolerance: {cs.gaps_text(params)}; B1 {got['counts']['B1']} launches of "
              f"{got['rows']} rows, B2 {got['counts']['B2']}; dp all-reduce "
              f"{got['comm']['what']['all-reduce/dp/grads']}; step p50 {got['p50_ms']:.2f} ms "
              f"({cards[r]})")
    gloo = [r["57"] for r in run_job([sys.executable, os.path.join(_REPO, "chip_smoke.py"),
                                      "--mesh-rank"], "multicity", DP,
                                     env={"CUDA_VISIBLE_DEVICES": "0"}, dp=DP)]
    bitwise = {}
    for r, (a, b) in enumerate(zip(ranks, gloo)):
        if b["mesh"]["backend"] != "gloo":
            problems.append(f"leg 3 rank {r}: the transport was {b['mesh']['backend']}")
        differ = sorted(k for k in a["state"] if not np.array_equal(
            a["state"][k].cpu().numpy(), b["state"][k].cpu().numpy()))
        bitwise[r] = differ
        if differ:
            problems.append(f"leg 3 rank {r}: NCCL's and gloo's final parameters differ in "
                            f"{differ}")
    print(f"leg 3 (multicity dp={DP} over gloo, four ranks on card 0, float64 sum): final "
          f"parameters bitwise equal to NCCL's on every rank: "
          f"{all(not d for d in bitwise.values())} (tensors differing per rank: {bitwise}); "
          f"step p50s {[round(g['p50_ms'], 2) for g in gloo]} ms ({cards[0]})")
    return {"nccl": records, "gloo_bitwise_equal": all(not d for d in bitwise.values()),
            "gloo_p50_ms": [g["p50_ms"] for g in gloo]}


def region_leg(device, cards: list, problems: list) -> dict:
    """Leg 4: ``scaled`` at region=4 over NCCL against its fp32 twin."""
    twin = cs.mesh_twin("scaled", device, epochs=cs.REGION_EPOCHS)
    twin.pop("trainer")
    cs.release()
    results = cs.run_ranks("scaled", REGION, root=cs.scratch("nccl-region"), region=REGION,
                           phases=("62",), files=False)
    cfg = cs.scaled_config("", "float32")
    cfg.mesh.region = REGION
    rows = {3 * 16 * 2500 // REGION}
    out = []
    for r, res in enumerate(results):
        got, what = res["62"], f"leg 4 (scaled region={REGION} over NCCL, fp32) rank {r}"
        if got["mesh"]["backend"] != "nccl":
            problems.append(f"{what}: the transport was {got['mesh']['backend']}")
        try:
            cs.check_routes(got, what, rows, pad=0)
            cs.check_mesh_launches(got, what, rows)
            step = cs.check_region_comm(got, cfg, what)
            text = cs.check_mesh_run(got, twin, what)
        except SystemExit as e:
            problems.append(str(e))
            text, step = str(e), {}
        out.append({"rank": r, "p50_ms": got["p50_ms"], "check": text})
        print(f"{what}: {text}; routes {got['route']['modes']}, halos {got['route']['halos']}; "
              f"B1 rows {got['rows']}; one step moved {step}; step p50 {got['p50_ms']:.2f} ms "
              f"(twin {twin['p50_ms']:.2f} ms; {cards[r]})")
    return {"ranks": out, "twin_p50_ms": twin["p50_ms"]}


def sparse_leg(device, cards: list, problems: list) -> dict:
    """Leg 5: ``scaled`` with block-CSR strips at region=4 over NCCL
    against the one-device block-CSR twin."""
    twin = cs.strip_twin(device)
    cs.release()
    results = cs.run_ranks("scaled", REGION, root=cs.scratch("nccl-sparse"), region=REGION,
                           phases=("64",))
    cfg = cs.strip_config("")
    cfg.mesh.region = REGION
    rows = {3 * 16 * 2500 // REGION}
    out = []
    for r, res in enumerate(results):
        got, what = res["64"], f"leg 5 (scaled sparse region={REGION} over NCCL, fp32) rank {r}"
        if got["mesh"]["backend"] != "nccl":
            problems.append(f"{what}: the transport was {got['mesh']['backend']}")
        try:
            if got["route"]["modes"] != ("sparse",) * 3 or got["route"]["node_pad"] != 0:
                cs.fail(f"{what}: routed {got['route']}")
            cs.check_block_counts(got, what, rows, sparse=True)
            want = cs.stacked_bytes(cfg, got["numel"], got["route"]["n_nodes"], "sparse",
                                    transport="nccl")
            cs.check_step_bytes(got, want, what)
            text = cs.check_mesh_run(got, twin, what)
        except SystemExit as e:
            problems.append(str(e))
            text = str(e)
        out.append({"rank": r, "p50_ms": got["p50_ms"], "check": text})
        print(f"{what}: {text}; launches {cs.counts_text(got['counts'])}; one step moved "
              f"{got['step_comm']['what']}; step p50 {got['p50_ms']:.2f} ms (twin "
              f"{twin['p50_ms']:.2f} ms; {cards[r]})")
    return {"ranks": out, "twin_p50_ms": twin["p50_ms"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < DP:
        print(f"mesh_nccl: needs {DP} CUDA cards, found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip().splitlines()
    print("\n".join(cards))
    problems, legs = [], {}
    try:
        cs.build_kernels()
        device = torch.device("cuda", 0)
        twin = cs.mesh_twin("multicity", device)
        twin.pop("trainer")
        cs.release()
        print(f"multicity twin (one device, graphed, card 0): step p50 {twin['p50_ms']:.2f} ms "
              f"({cards[0]})")
        legs["record"] = record_leg(twin)
        if "--record-only" not in sys.argv:
            legs["repaired"] = repaired_legs(twin, cards, problems)
            del twin
            cs.release()
            legs["region"] = region_leg(device, cards, problems)
            cs.release()
            legs["sparse"] = sparse_leg(device, cards, problems)
        print(json.dumps({"dp": DP, "region": REGION, "legs": legs, "cards": cards,
                          "problems": problems}, default=str))
    finally:
        import shutil

        for root in cs._SCRATCH:
            shutil.rmtree(root, ignore_errors=True)
    return 1 if problems else 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--rank":
        sys.exit(rank_main(sys.argv[2], sys.argv[3]))
    sys.exit(main())
