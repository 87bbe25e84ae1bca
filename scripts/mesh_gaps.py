#!/usr/bin/env python3
"""Second witnesses for the mesh phases' parameter rules, on one card.

    python3 scripts/mesh_gaps.py      # from the repo root, on a host with a CUDA card

1. ``chip_smoke.py``'s phase 57 at dp=4 over gloo (four ranks sharing the
   card): the split of ``scripts/mesh_nccl.py``'s NCCL run (16 of the 64
   rows a rank) with the other transport. Per rank and tensor, the final
   parameters against the single-device twin (``param_gaps``: phase 57's
   elementwise tolerance and the normwise update gap; at entries past the
   tolerance, the twin's Adam rms gradient there). Reported, not gated.
2. Phase 59 (``branchpar`` in bf16 at dp=2 x branch=3, one epoch) at seeds
   0 and 1 (data, weights and batch order), each rank held by
   ``check_bf16_run`` against the bf16 and fp32 twins of the same seed.

Prints every reading beside the card's ``nvidia-smi`` name and power limit;
the last line is one JSON object of the numbers. Exits 1 if a rank of 2
breaks phase 59's rule (after reading every rank), or without a card.
"""

import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

DP, SEEDS = 4, (0, 1)


def dp4_gloo(device, card: str) -> list:
    twin = cs.mesh_twin("multicity", device)
    twin.pop("trainer")
    cs.release()
    ranks = [r["57"] for r in cs.run_ranks("multicity", DP, dp=DP)]
    records = []
    for r, got in enumerate(ranks):
        gaps = cs.param_gaps(got, twin)
        worst = max(gaps, key=lambda k: gaps[k]["update_gap"])
        loss = float(np.max(np.abs(np.asarray(got["losses"]) - twin["losses"])))
        records.append({"rank": r, "backend": got["mesh"]["backend"], "loss_max_diff": loss,
                        "param_max_diff": max(v["max_diff"] for v in gaps.values()),
                        "worst_update_gap": gaps[worst]["update_gap"], "worst": worst,
                        "past_elementwise": {k: v for k, v in gaps.items()
                                             if not v["elementwise_ok"]},
                        "p50_ms": got["p50_ms"]})
        print(f"multicity dp={DP} over {got['mesh']['backend']}, rank {r}: {got['steps']} steps, "
              f"losses max |diff| {loss:.3e}; parameters max |diff| "
              f"{records[-1]['param_max_diff']:.3e}; past phase 57's elementwise tolerance: "
              f"{cs.gaps_text(gaps)}; each tensor's update within {gaps[worst]['update_gap']:.3e} of its norm "
              f"({worst}); step p50 {got['p50_ms']:.2f} ms ({card})")
    print(f"twin (one device, graphed): step p50 {twin['p50_ms']:.2f} ms ({card})")
    return records


def bf16_seed(device, seed: int, card: str) -> dict:
    twin16 = cs.mesh_twin("branchpar", device, dtype="bfloat16", epochs=cs.MESH_BF16_EPOCHS,
                          seed=seed)
    twin32 = cs.mesh_twin("branchpar", device, epochs=cs.MESH_BF16_EPOCHS, seed=seed)
    twin16.pop("trainer")
    twin32.pop("trainer")
    cs.release()
    ranks = [r["59"] for r in cs.run_ranks("branchpar-bf16", 6, seed=seed)]
    texts, problems = [], []
    for r, got in enumerate(ranks):
        try:
            text = cs.check_bf16_run(got, twin16, twin32, f"phase 59 at seed {seed}, rank {r}")
        except SystemExit as e:  # the rule's verdict: read every rank, then exit 1
            text = str(e)
            problems.append(text)
        texts.append(text)
        print(f"phase 59 at seed {seed}, rank {r}: {text} ({card})")
    f = np.asarray(twin32["losses"])
    return {"seed": seed, "steps": len(f),
            "twin16_gap": float(np.max(np.abs(np.asarray(twin16["losses"]) - f))),
            "mesh_gaps": [float(np.max(np.abs(np.asarray(g["losses"]) - f))) for g in ranks],
            "mesh_vs_twin16": [float(np.max(np.abs(np.asarray(g["losses"])
                                                   - np.asarray(twin16["losses"]))))
                               for g in ranks],
            "texts": texts, "problems": problems}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mesh_gaps: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    try:
        cs.build_kernels()
        device = torch.device("cuda", 0)
        out = {"card": card, "dp4_gloo": dp4_gloo(device, card)}
        out["bf16"] = [bf16_seed(device, seed, card) for seed in SEEDS]
        print(json.dumps(out))
        failed = any(b["problems"] for b in out["bf16"])
    finally:
        import shutil

        for root in cs._SCRATCH:
            shutil.rmtree(root, ignore_errors=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
