#!/usr/bin/env bash
# CI lint gate of the PyTorch port (stmgcn_tpu_torch): the counterpart of
# scripts/lint_gate.sh, which stays the JAX package's gate. It imports no
# JAX. Usage:
#
#   bash scripts/lint_gate_torch.sh [--device cuda|cpu] [--report PATH]
#
# --device (cuda by default) is where the training and serving sections run;
# cuda with no card fails the gate. Stdout is exactly one JSON line with the
# JAX gate's keys, exit 0 iff "gate" is "PASS"; the rest goes to stderr.
# Each section's torch meaning (its fail conditions: the docstring and
# gate_failures of stmgcn_tpu_torch/analysis/gate.py, the one description):
#
#   lint         python -m stmgcn_tpu_torch.cli lint --format json
#   concurrency  the port's program database and check_concurrency
#   ruff         ruff over the port's files, when the image has it
#   obs/health   the JAX gate's traced smoke training with health records;
#                on the CPU nothing is CUDA-graph captured, so the recapture
#                count guards nothing there
#   continual    closed_loop_smoke
#   federation   train_throwaway, then run_federation_soak
#   spmd         the declared collective manifests of the presets
#   spmd_exec    composed_trainer("branchpar") on six gloo ranks against its
#                one-device twin; the program must be "series_superstep"
#   precision    the presets' PrecisionPolicy
#
# JAX keys with no counterpart of their own: both recompiles_after_warmup
# (they count CUDA-graph recaptures), spmd.programs/collectives and the
# precision counts (no lowered programs: declarations and policies).
set -u -o pipefail

cd "$(dirname "$0")/.."

PY=${PYTHON:-python}

exec "$PY" -m stmgcn_tpu_torch.analysis.gate "$@"
