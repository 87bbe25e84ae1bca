#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 57 at dp=4 over NCCL, one rank per card.

    python3 scripts/mesh_nccl.py      # from the repo root, on a host with 4 cards

The ``multicity`` preset (cities 12x12 and 10x10, batch 64, full width,
the epochs cut to two) on a dp=4 mesh of four rank processes, one per
card: with a card each, the transport rule (``parallel/mesh.py``
``transport``) picks NCCL. Each rank is held against the single-device
twin on card 0 by phase 57's own rules, and the script exits 1 unless,
on every rank: the transport is NCCL; the per-step losses agree (rtol
1e-5); the final parameters agree elementwise (rtol 5e-4, atol 2e-5,
``tests/test_parallel.py:96-104``); one B1 launch per forward of 6,912 or
4,800 rows and one B2 per step; one 1,145,132-byte gradient all-reduce a
step; the manifest check. Every rank is read before the verdict: the
tensors past the elementwise tolerance are printed with the twin's Adam
rms gradient at their entries, and each tensor's normwise update gap
``|p_rank - p_twin| / |p_twin - p_init|`` beside them. Each rank's step
p50 stands beside the twin's with every card's ``nvidia-smi`` name and
power limit. Needs four CUDA cards; exits 1 without them. The last line
is one JSON object of the numbers.
"""

import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

DP = 4


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
    try:
        cs.build_kernels()
        device = torch.device("cuda", 0)
        twin = cs.mesh_twin("multicity", device)
        twin.pop("trainer")
        cs.release()
        ranks = [r["57"] for r in cs.run_ranks("multicity", DP, dp=DP)]
        rows = {64 // DP * 144 * 3, 64 // DP * 100 * 3}
        problems, records = [], []
        for r, got in enumerate(ranks):
            what = f"multicity dp={DP} over NCCL, rank {r}"
            if got["mesh"]["backend"] != "nccl":
                problems.append(f"{what}: the transport was {got['mesh']['backend']}")
            cs.check_comm(got, what, grads=4 * cs.MESH_PARAMS, steps=got["steps"])
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
            print(f"{what}: {got['steps']} steps, losses max |diff| {loss_diff:.3e}; "
                  f"parameters max |diff| {records[-1]['param_max_diff']:.3e}, past phase 57's "
                  f"elementwise tolerance: {cs.gaps_text(params)}; "
                  f"each tensor's update within {params[worst]['update_gap']:.3e} of its norm "
                  f"({worst}); B1 {got['counts']['B1']} launches "
                  f"of {got['rows']} rows, B2 {got['counts']['B2']}; dp all-reduce "
                  f"{got['comm']['what']['all-reduce/dp/grads']}; step p50 "
                  f"{got['p50_ms']:.2f} ms ({cards[r]})")
        print(f"twin (one device, graphed, card 0): step p50 {twin['p50_ms']:.2f} ms ({cards[0]})")
        print(json.dumps({"dp": DP, "transport": "nccl", "twin_p50_ms": twin["p50_ms"],
                          "steps": ranks[0]["steps"], "ranks": records, "cards": cards,
                          "problems": problems}))
    finally:
        import shutil

        for root in cs._SCRATCH:
            shutil.rmtree(root, ignore_errors=True)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
