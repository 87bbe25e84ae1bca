"""Command line entry point of the port: train, resume, test, export and
benchmark serving.

The main-path subset of ``stmgcn_tpu/cli.py``, with the same flags and the
same exit behaviour; ``--device`` takes the place of ``--platform``::

    python -m stmgcn_tpu_torch.cli --preset default --out-dir output
    python -m stmgcn_tpu_torch.cli --preset default --out-dir output --resume
    python -m stmgcn_tpu_torch.cli --preset default --out-dir output --test-only
    python -m stmgcn_tpu_torch.cli --preset smoke --device cpu --timesteps 400 --epochs 1
    python -m stmgcn_tpu_torch.cli --preset default --out-dir output --export m.stmgx
    python -m stmgcn_tpu_torch.cli --preset default --out-dir output --profile prof/
    python -m stmgcn_tpu_torch.cli serve-bench --full-model --rows 16 --soak --federation 2
    python -m stmgcn_tpu_torch.cli health output/health.jsonl
    python -m stmgcn_tpu_torch.cli obs trace.jsonl
    python -m stmgcn_tpu_torch.cli lint --format json

Training writes ``best.ckpt`` and ``latest.ckpt`` (the JAX package's format)
into ``--out-dir``; ``--resume`` continues from the newest verified
checkpoint there, and exits 1 when there is none (``--resume auto`` starts
fresh instead); ``--test-only`` evaluates ``best.ckpt``. The run ends with
one JSON line, ``{"preset": ..., "results": ...}``. SIGTERM during training
writes an emergency ``latest.ckpt`` at the next block boundary and exits
143; ``--resume`` continues from it. The ``health`` and ``obs`` subcommands
report a ``health.jsonl`` stream and a span trace
(:mod:`stmgcn_tpu_torch.obs.cli`); ``--trace-out PATH`` writes such a
trace of the run. ``--checkify`` runs the in-program sanitizers
(``train.checks``) and ``--debug-nans`` the eager debug mode
(``train/trainer.py``). ``--profile DIR`` captures a ``torch.profiler``
trace of the run (the kernels named) into ``DIR``; ``--export PATH``
writes ``best.ckpt`` as a serving artifact after the results line
(``stmgcn_tpu_torch/export.py``; one file per city of a heterogeneous
checkpoint, ``PATH`` with ``.cityN`` before its suffix), and exits 1 if
that fails. ``serve-bench`` is the serving benchmark
(``stmgcn_tpu_torch/serving/bench.py``): one JSON record line on stdout.
``lint`` checks the presets' configs and the CUDA kernels' launch budgets
without a GPU (``stmgcn_tpu_torch/analysis/cli.py``); it exits 1 on an
error finding. ``--data-placement``, ``--window-free`` and
``--no-window-free`` choose where batches come from
(``train/trainer.py``). A preset it lacks fails with ``preset()``'s error.

**Meshes** (``stmgcn_tpu_torch/parallel``): a preset with a mesh
(``multicity``: dp=8; ``branchpar``: dp=2 x branch=3; ``scaled``:
region=8, its node rows split over eight ranks; ``bandedbranch``: dp=2 x
region=2 x branch=2) trains on that many ranks; ``--sparse`` gives each
rank block-CSR row strips of the supports. ``--virtual-devices N`` launches N local CPU ranks over gloo (it
implies ``--device cpu``: the JAX CLI's N emulated CPU devices), each this
command with ``--distributed``; ``--distributed`` joins a ``torchrun``-style
job (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), one rank
per process, NCCL when each local rank has a card of its own and gloo
otherwise (printed). ``--branch-parallel B`` sets ``mesh.branch``;
``--region-strategy`` picks a region mesh's plan per branch (``gspmd``:
every branch on the dense node-row plan; ``banded``: every branch on the
halo plan, or an error; ``auto``: the banded ones) and ``--halo`` the halo
budget. The lead rank prints the one JSON line
and exports; the export's status reaches every rank, so a failed export
fails each one::

    python -m stmgcn_tpu_torch.cli --preset branchpar --virtual-devices 6 --epochs 1
    torchrun --nproc-per-node 8 -m stmgcn_tpu_torch.cli --preset multicity --distributed
    torchrun --nproc-per-node 8 -m stmgcn_tpu_torch.cli --preset scaled --distributed \
        --region-strategy auto
    torchrun --nproc-per-node 8 -m stmgcn_tpu_torch.cli --preset scaled --distributed --sparse
    torchrun --nproc-per-node 8 -m stmgcn_tpu_torch.cli --preset bandedbranch --distributed
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from stmgcn_tpu_torch.config import PRESETS, preset

__all__ = ["build_parser", "config_from_args", "main"]


def _positive_int(value: str) -> int:
    n = int(value)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {n}")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="stmgcn_tpu_torch",
        description="ST-MGCN on PyTorch/CUDA: spatiotemporal multi-graph demand forecasting",
    )
    p.add_argument("--preset", default="default",
                   help=f"baseline config to start from (ported: {', '.join(sorted(PRESETS))})")
    p.add_argument("--data", type=str, default=None,
                   help="path to a data_dict.npz archive (default: synthetic)")
    p.add_argument("-date", "--dates", type=str, nargs=4, default=None,
                   metavar=("TRAIN_S", "TRAIN_E", "TEST_S", "TEST_E"),
                   help="MMDD split dates, e.g. -date 0101 0630 0701 0731")
    p.add_argument("-cpt", "--obs-len", type=int, nargs=3, default=None,
                   metavar=("SERIAL", "DAILY", "WEEKLY"),
                   help="observation window lengths, e.g. -cpt 3 1 1")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr-schedule", choices=("none", "cosine"), default=None,
                   help="constant lr or warmup + cosine decay sized to the full run")
    p.add_argument("--warmup-epochs", type=float, default=None,
                   help="linear warmup extent for --lr-schedule cosine")
    p.add_argument("--min-lr-fraction", type=float, default=None,
                   help="cosine floor as a fraction of --lr")
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--grad-clip-norm", type=float, default=None,
                   help="global-norm gradient clipping (off by default)")
    p.add_argument("--loss", choices=("mse", "mae", "huber"), default=None)
    p.add_argument("--patience", type=int, default=None)
    p.add_argument("--top-k", type=int, default=None,
                   help="keep the k best improvement snapshots (best_eN.ckpt) "
                        "alongside best/latest")
    p.add_argument("--shuffle", action="store_true", default=None,
                   help="shuffle training batches (reference default is off)")
    p.add_argument("--m-graphs", type=int, default=None)
    p.add_argument("--kernel", choices=("chebyshev", "localpool", "random_walk_diffusion"),
                   default=None)
    p.add_argument("--cheb-k", type=int, default=None, help="max polynomial order K")
    p.add_argument("--sparse", action="store_true", default=None,
                   help="block-CSR supports for the graph convolutions")
    p.add_argument("--lstm-backend", choices=("xla", "pallas"), default=None,
                   help="the LSTM kernels' bf16 form: xla (default: float32 storage, "
                        "bf16 products, the JAX scan's roundings) or pallas (bf16 "
                        "storage, the JAX Pallas kernel's); one form at float32")
    p.add_argument("--lstm-unroll", type=int, default=None,
                   help="the JAX scan's unroll factor (a schedule: no effect on the "
                        "numbers, none here)")
    p.add_argument("--lstm-fused", action="store_true", default=None,
                   help="the JAX single-scan schedule: at bf16 under --lstm-backend xla "
                        "the float32 biases are added unrounded and each step's "
                        "input-weight gradient is rounded (the layered default rounds "
                        "the biases and each input weight's gradient once)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                   help="model compute dtype (bf16 products, fp32 accumulation and "
                        "fp32 parameters); serving and training run in it")
    p.add_argument("--precision", choices=("fp32", "bf16"), default=None,
                   help="training step precision: fp32 (default) or bf16 (the model "
                        "computes in bf16 over fp32 master parameters, which the "
                        "optimizer and checkpoints keep)")
    p.add_argument("--sr-seed", type=int, default=None, metavar="SEED",
                   help="stochastically round the master->bf16 parameter casts with "
                        "this seed (bf16 only; default: round to nearest even)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--out-dir", type=str, default=None)
    p.add_argument("--data-placement", choices=("auto", "resident", "stream"),
                   default=None,
                   help="batch data residency: upload splits once and gather "
                        "on device (resident), upload per batch with "
                        "prefetch (stream), or pick by device/size (auto)")
    p.add_argument("--steps-per-superstep", type=_positive_int, default=None, metavar="S",
                   help="optimizer steps per block, with one loss readback per block")
    p.add_argument("--window-free", dest="window_free", action="store_true",
                   default=None,
                   help="require the window-free resident path: keep the raw "
                        "(T, N, C) series on device and gather each batch's "
                        "windows inside the step program (~seq_len x less "
                        "resident device memory; default: on wherever it can hold)")
    p.add_argument("--no-window-free", dest="window_free",
                   action="store_false",
                   help="force materialized window arrays (the bit-parity "
                        "oracle / streaming-hetero fallback path)")
    p.add_argument("--fleet", dest="fleet", action="store_true", default=None,
                   help="require fleet shape-class training: heterogeneous cities "
                        "grouped into node-count rungs, each class's cities padded to "
                        "one shape (default: auto when --steps-per-superstep > 1 and "
                        "the dataset is viable)")
    p.add_argument("--no-fleet", dest="fleet", action="store_false",
                   help="never group cities into shape classes (each city steps at "
                        "its own shape)")
    p.add_argument("--fleet-max-classes", type=_positive_int, default=None, metavar="C",
                   help="most shape classes the fleet planner may open (default 8); "
                        "cities fitting none run per-step")
    p.add_argument("--fleet-max-pad-waste", type=float, default=None, metavar="F",
                   help="max padded-node fraction of a rung a city may waste before "
                        "it is excluded from the class (default 0.5)")
    p.add_argument("--normalize", choices=("minmax", "std", "none"), default=None,
                   help="demand normalization (stats travel inside checkpoints)")
    p.add_argument("--val-ratio", type=float, default=None,
                   help="validation fraction carved off the end of train "
                        "(reference default 0.2)")
    p.add_argument("--horizon", type=int, default=None,
                   help="forecast steps per sample (default 1, next-step)")
    p.add_argument("--rows", type=int, default=None,
                   help="synthetic city grid rows (N = rows^2)")
    p.add_argument("--timesteps", type=int, default=None,
                   help="synthetic demand length in timesteps")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to train and test (default: the GPU; there is no "
                        "fallback to the CPU)")
    p.add_argument("--virtual-devices", type=int, default=None, metavar="N",
                   help="launch N local CPU ranks over gloo for a mesh config of N "
                        "devices (implies --device cpu)")
    p.add_argument("--distributed", action="store_true",
                   help="join a multi-process job from the environment torchrun sets "
                        "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): one rank per "
                        "process, NCCL when each local rank has its own card, else gloo")
    p.add_argument("--branch-parallel", type=_positive_int, default=None, metavar="B",
                   help="shard the M graph branches over a 'branch' mesh axis of "
                        "extent B (B must divide m_graphs)")
    p.add_argument("--region-strategy", choices=("gspmd", "banded", "auto"), default=None,
                   help="region-sharded conv plan per branch: gspmd (all-gather the "
                        "signal's node rows), banded (halo exchange, every branch) or "
                        "auto (halo exchange for the banded branches)")
    p.add_argument("--halo", type=int, default=None,
                   help="halo budget (rows) for the banded region strategy; default "
                        "half a rank's node rows")
    p.add_argument("--matmul-precision", choices=("default", "high", "highest"),
                   default=None,
                   help="torch.set_float32_matmul_precision for the float32 cuBLAS "
                        "products (default -> medium, high -> high, highest -> highest; "
                        "left out, nothing changes: highest). The hand-written kernels "
                        "keep their own products")
    p.add_argument("--debug-nans", action="store_true",
                   help="debug mode: train eagerly (CUDA graphs off), check every "
                        "module's output for NaN/Inf and run the backward under autograd "
                        "anomaly detection; fails naming the module or the backward op")
    p.add_argument("--checkify", choices=("nan", "index", "float", "all"), default=None,
                   dest="checks",
                   help="in-program sanitizers on the train and eval steps (nan: "
                        "non-finite values; index: out-of-range window indices, clamped; "
                        "float: nan + a zero loss denominator; all: everything); fails "
                        "after the block naming the check, the step and the site")
    p.add_argument("--trace-out", type=str, default=None, metavar="PATH",
                   help="record wall-clock spans (host pack, upload, device block, "
                        "epochs, checkpoints, serving) and write the JSONL timeline to "
                        "PATH; inspect with the obs subcommand")
    p.add_argument("--resume", nargs="?", const="strict", default=None,
                   choices=("strict", "auto"),
                   help="resume before training from the newest verified checkpoint in "
                        "<out-dir> (latest -> rotated previous -> best snapshots; corrupt "
                        "files are quarantined). Bare --resume errors when nothing "
                        "resumable exists; --resume auto starts fresh instead")
    p.add_argument("--checkpoint-every-steps", type=int, default=None, metavar="K",
                   help="also rewrite latest.ckpt every K optimizer steps with the "
                        "mid-epoch resume cursor (default 0: epoch boundaries only)")
    p.add_argument("--divergence-guard", action="store_true", default=None,
                   help="check each block's losses for NaN/Inf; on a trip, roll the "
                        "parameters and optimizer back to the pre-block snapshot and skip "
                        "(or defer) the batch. Costs a sync per block")
    p.add_argument("--divergence-action", choices=("skip", "defer"), default=None,
                   help="what the guard does with an offending batch: drop it (skip) or "
                        "retry it once at epoch end (defer)")
    p.add_argument("--divergence-patience", type=_positive_int, default=None,
                   help="abort after this many consecutive guard trips (default 3)")
    p.add_argument("--divergence-lr-cut", type=float, default=None, metavar="F",
                   help="multiply the learning rate by F in (0,1) on each guard trip")
    p.add_argument("--health-out", type=str, default=None, metavar="PATH",
                   help="enable numeric-health telemetry and write health.jsonl (loss, "
                        "grad norm, update ratio, nonfinite counts, per-group and per-city "
                        "attribution) to PATH; inspect with the health subcommand")
    p.add_argument("--health-every-k", type=_positive_int, default=None, metavar="K",
                   help="health sampling cadence: every K-th block or step; implies "
                        "health telemetry on (default 1)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the run (host and CUDA "
                        "activity, the kernels named) into DIR as a Chrome trace")
    p.add_argument("--export", type=str, default=None, metavar="PATH",
                   help="after training/testing, write the best checkpoint as a "
                        "self-contained serving artifact (a torch.export program with "
                        "the normalizer; see stmgcn_tpu_torch.export)")
    p.add_argument("--test-only", action="store_true",
                   help="skip training; evaluate <out-dir>/best.ckpt")
    p.add_argument("--print-config", action="store_true",
                   help="print the resolved config as JSON and exit")
    return p


#: flag attribute -> ``cfg.train`` field, as the JAX CLI maps them
_TRAIN_FLAGS = (
    "epochs", "batch_size", "lr", "lr_schedule", "warmup_epochs", "min_lr_fraction",
    "weight_decay", "grad_clip_norm", "loss", "patience", "top_k", "seed", "out_dir",
    "data_placement", "window_free", "steps_per_superstep", "fleet", "fleet_max_classes",
    "fleet_max_pad_waste",
    "checkpoint_every_steps", "precision", "sr_seed", "divergence_action",
    "divergence_patience", "divergence_lr_cut", "checks",
)

#: ``--matmul-precision`` -> ``torch.set_float32_matmul_precision``: JAX's
#: "default" (bf16 passes on a TPU) is torch's "medium" (bf16 products)
MATMUL_PRECISIONS = {"default": "medium", "high": "high", "highest": "highest"}


def config_from_args(args):
    """The preset with the flags applied, as ``stmgcn_tpu/cli.py`` applies
    them; raises ``ValueError`` for a preset the port lacks."""
    cfg = preset(args.preset)
    if args.data is not None:
        cfg.data.path = args.data
    if args.dates is not None:
        cfg.data.dates = tuple(args.dates)
    if args.obs_len is not None:
        cfg.data.serial_len, cfg.data.daily_len, cfg.data.weekly_len = args.obs_len
    if args.val_ratio is not None:
        # the fraction carved off train, on the fraction path too (the JAX CLI's)
        cfg.data.val_ratio = args.val_ratio
        cfg.data.val_frac = cfg.data.train_frac * args.val_ratio
        cfg.data.train_frac = cfg.data.train_frac * (1.0 - args.val_ratio)
    if args.horizon is not None:
        cfg.data.horizon = args.horizon
    if args.normalize is not None:
        cfg.data.normalize = args.normalize
    if args.rows is not None:
        cfg.data.rows = args.rows
    if args.timesteps is not None:
        cfg.data.n_timesteps = args.timesteps
    for field in _TRAIN_FLAGS:
        val = getattr(args, field)
        if val is not None:
            setattr(cfg.train, field, val)
    if args.shuffle:
        cfg.train.shuffle = True
    if args.divergence_guard:
        cfg.train.divergence_guard = True
    if args.health_out is not None or args.health_every_k is not None:
        cfg.health.enabled = True
        if args.health_out is not None:
            cfg.health.out = args.health_out
        if args.health_every_k is not None:
            cfg.health.every_k = args.health_every_k
    if args.m_graphs is not None:
        cfg.model.m_graphs = args.m_graphs
    if args.kernel is not None:
        cfg.model.kernel_type = args.kernel
    if args.cheb_k is not None:
        cfg.model.K = args.cheb_k
    if args.dtype is not None:
        cfg.model.dtype = args.dtype
    if args.sparse:
        cfg.model.sparse = True
    if args.lstm_unroll is not None:
        cfg.model.lstm_unroll = args.lstm_unroll
    if args.lstm_fused:
        cfg.model.lstm_fused_scan = True
    if args.lstm_backend is not None:
        cfg.model.lstm_backend = args.lstm_backend
    if args.branch_parallel is not None:
        cfg.mesh.branch = args.branch_parallel
    if args.region_strategy is not None:
        cfg.mesh.region_strategy = args.region_strategy
    if args.halo is not None:
        cfg.mesh.halo = args.halo
    return cfg


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "lint":
        # the config and kernel-budget checks: no torch model stack, no GPU
        from stmgcn_tpu_torch.analysis.cli import main as lint_main

        return lint_main(argv[1:])
    if argv and argv[0] == "serve-bench":
        # the serving benchmark: one JSON record line on stdout
        from stmgcn_tpu_torch.serving.bench import main as serve_bench_main

        return serve_bench_main(argv[1:])
    if argv and argv[0] in ("obs", "health"):
        # the file reports (obs/cli.py)
        from stmgcn_tpu_torch.obs.cli import health_main
        from stmgcn_tpu_torch.obs.cli import main as obs_main

        return (obs_main if argv[0] == "obs" else health_main)(argv[1:])
    args = build_parser().parse_args(argv)
    try:
        cfg = config_from_args(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.trace_out is not None:  # the JAX CLI sets the obs section here too
        cfg.obs.trace, cfg.obs.trace_path = True, args.trace_out
    if args.print_config:
        print(json.dumps(cfg.to_dict(), indent=2))
        return 0
    if args.virtual_devices:
        return launch_ranks(argv, args.virtual_devices, cfg.mesh.n_devices)

    import torch  # defer the torch stack

    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.obs import trace as obs_trace
    from stmgcn_tpu_torch.resilience import Preempted

    if args.matmul_precision is not None:
        torch.set_float32_matmul_precision(MATMUL_PRECISIONS[args.matmul_precision])
    if cfg.obs.trace:
        obs_trace.configure(capacity=cfg.obs.ring_capacity)
    device = args.device
    try:
        if args.distributed:
            from stmgcn_tpu_torch.parallel import init_distributed

            device = init_distributed(device=args.device)
        trainer = build_trainer(cfg, device=device, debug_nans=args.debug_nans)
    except ValueError as e:  # configuration errors, without a traceback
        print(f"error: {e}", file=sys.stderr)
        return 1
    except FileNotFoundError as e:
        print(f"error: {e.filename or e} not found", file=sys.stderr)
        return 1
    try:
        if args.resume == "auto":
            meta = trainer.restore_auto()
            if meta is None:
                print("No resumable checkpoint found — starting fresh")
            else:
                print(f"Resumed from epoch {meta['epoch']} (best val {meta['best_val']:.5})")
        elif args.resume:
            meta = trainer.restore()
            print(f"Resumed from epoch {meta['epoch']} (best val {meta['best_val']:.5})")
        with contextlib.ExitStack() as stack:
            if args.profile:
                from stmgcn_tpu_torch.utils import trace

                stack.enter_context(trace(args.profile))
            if not args.test_only:
                trainer.train()
            results = trainer.test(modes=("train", "test"))
        if args.profile:
            print(f"profiler trace written to {args.profile}", file=sys.stderr)
    except Preempted as e:
        # the emergency checkpoint has landed: SIGTERM's conventional code
        print(f"preempted: {e}", file=sys.stderr)
        return 143
    except FileNotFoundError as e:
        print(f"error: {e.filename or e} not found"
              + (" — train first or check --out-dir" if args.test_only or args.resume else ""),
              file=sys.stderr)
        return 1
    lead = trainer.is_lead
    if lead:  # one JSON line per job
        print(json.dumps({"preset": cfg.name, "results": results}))
    trc = obs_trace.active_tracer()
    if trc is not None and cfg.obs.trace_path and lead:
        n = trc.export_jsonl(cfg.obs.trace_path)
        print(f"trace written to {cfg.obs.trace_path} ({n} spans) — inspect with "
              f"`python -m stmgcn_tpu_torch.cli obs {cfg.obs.trace_path}`", file=sys.stderr)
    # export last: a failed export must not cost the run its results line
    if args.export:
        ok = export_best(cfg, args.export, device) if lead else True
        if trainer.mesh is not None:  # every rank exits with the lead's status
            from stmgcn_tpu_torch.utils import comm

            status = (b"1" if ok else b"0") if lead else None
            ok = comm.broadcast_bytes(status, trainer.mesh, what="export-status") == b"1"
    if args.distributed:  # every rank leaves the job together, its transport torn down
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    return 0 if not args.export or ok else 1


def launch_ranks(argv, n: int, mesh_devices: int) -> int:
    """``--virtual-devices N``: this command with ``--distributed --device
    cpu`` in N local processes (ranks 0..N-1 of a gloo job; one OpenMP
    thread each unless ``OMP_NUM_THREADS`` says otherwise, as torchrun
    sets it); returns the first failing rank's exit code, or 0. A rank
    that fails stops the others."""
    import os

    from stmgcn_tpu_torch.parallel.mesh import launch_local

    if n != mesh_devices:
        print(f"error: --virtual-devices {n} needs a config mesh of {n} devices, "
              f"this one has {mesh_devices} (dp x region x branch)", file=sys.stderr)
        return 1
    rest, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--virtual-devices":
            skip = True
        elif not a.startswith("--virtual-devices="):
            rest.append(a)
    codes, problem = launch_local(
        [sys.executable, "-m", "stmgcn_tpu_torch.cli", *rest, "--distributed", "--device",
         "cpu"], n, env={"OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS", "1")})
    if problem is None:
        return 0
    return next((c for c in codes if c not in (None, 0) and c > 0), 1)


def export_best(cfg, path: str, device) -> bool:
    """Write ``<out-dir>/best.ckpt`` as a serving artifact at ``path`` (one
    file per city of a heterogeneous checkpoint); False, with the error on
    stderr, when that fails."""
    import os

    from stmgcn_tpu_torch.export import export_forecaster
    from stmgcn_tpu_torch.inference import Forecaster

    try:
        fc = Forecaster.from_checkpoint(os.path.join(cfg.train.out_dir, "best.ckpt"),
                                        device=device)
        if fc.normalizers is not None:
            root, ext = os.path.splitext(path)
            for c in range(len(fc.normalizers)):
                city_path = f"{root}.city{c}{ext}"
                export_forecaster(fc, city_path, city=c)
                print(f"serving artifact written to {city_path}", file=sys.stderr)
        else:
            export_forecaster(fc, path)
            print(f"serving artifact written to {path}", file=sys.stderr)
    except Exception as e:  # noqa: BLE001 — reported, and the exit code says so
        print(f"error: export failed: {type(e).__name__}: {e}", file=sys.stderr)
        return False
    return True


if __name__ == "__main__":
    sys.exit(main())
