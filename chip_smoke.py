#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``stmgcn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code on failure:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build every CUDA kernel from ``stmgcn_tpu_torch/csrc`` with ``nvcc``
   (into ``build/kernels/``), one ``nvcc`` per source, all at once, and
   time the ``mma.sync`` TF32 probe built beside them: the rate the
   kernels' tensor-core products can reach; ptxas's registers, spills and
   shared memory of every kernel, and each kernel plan's dynamic shared
   memory;
3. hold the LSTM forward kernel against its plain PyTorch version on the
   card at the main paths' shape (the flagship at a 16x16 grid, batch 64:
   M=3 branches x 64 x 256 nodes = 49,152 rows, a 12-step window, L=3,
   H=64), with residuals on and off, on a ragged row count, and at every
   hidden width and layer count the wrapper accepts; then time kernel,
   plain version and the cuDNN ``nn.LSTM`` yardstick with CUDA events,
   beside the fp32 bound and the tensor-core (3xTF32) bound;
4. the same for the LSTM backward kernel (nonzero cotangents at every step
   and on the final states), plus two runs that must agree bitwise; its
   yardstick is cuDNN's forward + backward against forward (with
   residuals) + backward kernels;
   then (3b, ``lstm_shapes``) the kernel route at shapes the kernels do not
   take directly, H=48 (padded to 64) with L=3 and H=64 with L=5 (two
   groups of layers), and at the main path's H=64, L=3 as the baseline, at
   M=3 x 16,384 rows and T=12, forward and backward against the plain
   layered route, ceil(L/4) launches each way, timed and traced;
5. serve the ``default``-width ST-MGCN (seeded random weights, synthetic
   16x16 city) through ``Forecaster`` and ``ServingEngine``: requests of
   1, 3, 16, 64 and 100 rows and four concurrent callers, every response
   finite and equal to ``Forecaster.predict`` on the same rows, one
   bucket-4 batch equal to the same model on the CPU, and the forward
   kernel's launch counter showing one launch per forward (and no
   backward launch);
6. trace the smallest and largest rung with ``torch.profiler``: device
   busy time, idle share and the LSTM kernel's share per dispatch;
7. train the flagship at the bench point through ``build_trainer`` ->
   ``train()`` (two epochs, batch 64, blocks of 4 steps) -> ``test()``:
   finite losses and metrics, a finite gradient on every parameter after
   the first step, one backward launch per optimizer step and one forward
   launch per model forward;
8. the p50 time of an optimizer step (host clock, synchronized);
9. the same model from one initial state, three steps at batch 4 on the
   card and on the CPU's plain path: losses and parameters agree;
10. trace two training steps: device busy time, idle share, and the
    forward and backward kernels' shares;
11. the metro city of ``bench.py``'s largeN point on the host: a 64x128 grid
    (N = 8,192) with structured transit and district-similarity graphs
    (this file's own copy of the builder), its dense Chebyshev supports
    (``lambda_max`` over the sparse Laplacian, the one N^3 product,
    ``T_2``, in float64 on the card) and their tiled plan at tile 128, with
    the seconds of each;
12. the block-CSR kernels against their plain versions on the card: the
    stacked forward (B3) and backward (B4, two runs bitwise equal) at the
    plan's gate-conv and graph-conv shapes for batch 2 and the top serving
    rung, shared and per-branch signals, a ragged sub-city at tiles 128 and
    64; the single-support kernel (B5) and its transpose on one unpermuted
    support; B3 and B4 with every stored slot counted as real (padding
    multiplied) bitwise equal to the counted run; the blocks each launch
    reads against those stored; each timed against its bound (3xTF32 on
    the tensor cores, or bytes; the fp32-FMA bound beside it), its plain
    version and the dense cuBLAS product over the same supports;
13. serve the ``default``-width flagship on the plan (ladder 1, 2, 4;
    requests of 1, 2, 4 and 5 rows), every response equal to
    ``Forecaster.predict``, the same weights through the dense model on the
    dense stack agreeing, and two B3 launches, one B1 launch and no backward
    launch per forward;
14. train it on the plan (batch 2, two epochs, blocks of 4 steps), with one
    B1, one B2, two B3 and one B4 launch per optimizer step, the step p50,
    the tiled model against the dense one over three steps from one state,
    and a trace of two steps with each kernel's share;
15. the block-sparse mode at the metro city: per-branch ``BlockSparseStack``
    supports (B3/B4) and the K-tuple of ``BlockSparse`` (B5), one forward
    and backward each, equal to the dense model's output and input gradient.

Phases 16-18 run after phase 10, before the metro city; they are the main
path of the checkpoint slice, and the B1/B2 launch counts of the last line
are theirs (16 and 17):

16. ``checkpoints``: the flagship at the bench point trains two epochs
    writing best, best-k, latest and latest.prev, and a mid-epoch latest
    every 5 steps; ``test()`` reads ``best.ckpt``; a second trainer
    restores the first mid-epoch file, re-enters the epoch and must end
    with the first run's losses and parameters; each file's bytes, the
    serialize, write and read seconds and the resume's time to its first
    step are printed;
17. ``serve_checkpoint``: ``Forecaster.from_checkpoint(best.ckpt)`` on the
    card → ``ServingEngine``, equal to the trainer's evaluation of the same
    parameters; ``watch_checkpoints`` swaps in the checkpoint a further
    epoch writes while four callers keep requesting (one generation per
    response, the new one after the poll), and quarantines a truncated
    ``latest.ckpt`` without moving the generation;
18. ``cli``: ``python -m stmgcn_tpu_torch.cli`` in subprocesses on the card:
    train the smoke preset, ``--test-only``, ``--resume``, and a bare
    ``--resume`` with nothing to resume, which exits 1.

Phases 19-25 are the bf16 slice (the kernels' bf16 forms, mixed-precision
training, bf16 serving); 19 runs after phase 3b, 20-22 after phase 18, 23-25
after phase 15. The bf16 kernel records' launch counts are 20's (B1, B2),
24's (B3, B4) and 25's (B5):

19. B1 and B2 in bf16 against their plain bf16 versions on the card at the
    main path's shape (residuals on and off, a ragged row count, every H and
    L the kernels take; B2 twice bitwise equal), timed beside the bf16 bound
    (989 TFLOP/s or bytes), the plain version and cuDNN's ``nn.LSTM`` in
    bf16; the bf16 kernel route at H=48 (padded) and L=5 (two groups)
    against the CPU's plain versions;
20. mixed-precision training of the dense flagship (``precision="bf16"``):
    a twin drill against fp32 from one initial state (per-step losses within
    1e-3, no non-finite loss or gradient, float32 parameters), both step
    p50s, ``train()`` two epochs and ``test()``, and an ``sr_seed`` run;
21. bf16 serving of the dense city (``model.dtype="bfloat16"``): an fp32 and
    a bf16 engine over one set of weights, bf16 responses equal to the bf16
    Forecaster, each rung's p50 beside fp32's, the card against the CPU port,
    and the fp32 model on the same weights as the control that the bf16
    limits must reject;
22. bf16 checkpoints: meta ``precision`` bf16 over float32 masters, an exact
    mid-epoch resume, an fp32 trainer restoring the file, and
    ``Forecaster.from_checkpoint`` serving it in bf16;
23. B3, B4 and B5 in bf16 against their plain versions at the metro plan,
    timed beside the bf16 bound, the plain version and cuBLAS's bf16 product
    with an fp32 result; a float32 cotangent that bf16 cannot hold, through
    autograd, rounded to bf16 before B4 as on the CPU;
24. the metro plan in bf16: serving (fp32 and bf16 engines, per-rung p50s,
    card vs CPU, the fp32 control) and a few steps of bf16 tiled training
    with B3 and B4's launches checked;
25. the bf16 K-tuple route (B5) at the metro city against the bf16 dense
    model.

Phases 26-29 are the fleet slice (heterogeneous cities in shape classes),
run after phase 22, in fp32; every fp32 kernel record carries their
launches as ``fleet_launches``:

26. the ``multicity`` preset's cities (12x12 and 10x10: one class at rung
    144, the second padded by 44 nodes) on one card, ``fleet=True``,
    blocks of 4, batch 64, two epochs: ``train_path`` must be
    ``"fleet_superstep"``, with one B1 launch per forward, one B2 per step
    and no block-CSR launch, then ``test()`` per city, the step p50, and
    three steps (one of each city, two of the padded one) on the card
    against the CPU port from one state;
27. its ``best.ckpt`` through ``FleetServingEngine``: concurrent callers
    for both cities, every answer equal to ``Forecaster.predict(city=)``,
    dispatches that coalesce the two cities, each rung's p50, and a
    ``swap_params`` both cities then serve from;
28. ``bench.py``'s 8-city fleet point (two classes, serial 3, batch 2) at
    the default model's full width: one epoch of fleet blocks of 8 and one
    of the per-city loop, each timed on the host clock (graphed and eager:
    phase 33);
29. a tiled fleet of three cities (N = 1,024, 960 and 896; tile 128; one
    class at rung 1,024, which grows the 896-node plan by a block row): B3
    and B4 on each grown plan against their plain versions at the training
    shapes, two epochs with the tiled launches per forward and step, the
    step p50, and each city served in a private exact-fit class.

Every engine and trainer above runs captured (CUDA graphs, the default on
the card; ``stmgcn_tpu_torch/graphs.py``): each serving rung and fleet
(class, rung) is one graph, each training block of S steps and each
one-step tail one graph, so the checks above hold the graphed route, and
the launch counts count replays through each capture's record. Phases
30-34 hold it against the eager route (``graphs=False``) in the same call,
on the same weights; each prints the largest difference, whether the two
were bitwise equal, each route's p50s (host clock, synchronized, taken in
turns graphed, eager, eager, graphed), the graph pool's bytes and a trace
of each route (busy time and idle share):

30. dense serving, fp32 and bf16, every rung: the serving tolerances
    (fp32 SERVE_RTOL/SERVE_ATOL; bf16 2^-9 and 2^-13), the launches equal;
31. dense training, fp32, bf16 and bf16 with ``sr_seed`` (captured one step
    at a time, its generator registered with the graph and reseeded per
    step; it must equal the eager route bitwise): AB_BLOCKS blocks of S and
    a tail step from one state, agree_over_steps' tolerances, the launches
    per step equal, the p50 of a step inside a block and of a one-step
    program; phase 7's and the other trainings' ``recaptures_after_warmup``
    must read 0 over their epochs;
32. the multicity fleet (after phase 27): fleet serving, both cities,
    every rung, and fleet training blocks of its class;
33. phase 28 runs bench.py's 8-city epoch four ways: fleet blocks and the
    per-city loop, each graphed and eager;
34. the metro plan (after phase 25): tiled serving, fp32 and bf16, and
    tiled training, fp32 and bf16;
35. concurrent callers on one graph pool (in phases 30 and 32): four
    threads, two inline and two through the batchers, start together and
    call every rung of the dense fp32 engine, and every rung of both
    cities of the multicity fleet split into two classes (no padding
    allowed), each answer held to ``Forecaster.predict`` at the serving
    tolerance.

Phases 36-39 are the resilience slice (health twins, the divergence guard,
fault plans, SIGTERM, serving drift), run after phase 29 at the dense
flagship (fp32; 36 in bf16 too) and the multicity fleet; phase 40 runs
after phase 34 on the metro plan. Every fp32 record carries their launches
as ``resilience_launches`` (B1/B2 from 36-39, B1-B4 from 40), the bf16 B1/B2
records those of 36's bf16 run:

36. health: one step's in-graph health row against a recomputation from
    the card's tensors after it, and (fp32) against the CPU port's plain
    versions from one state, clean and NaN- and Inf-poisoned (norms at
    HEALTH_RTOL, non-finite counts exact); two epochs in blocks of 4 with
    the health twin on every dispatch, the parameters after each dispatch
    bitwise those of a plain trainer from the same state; health.jsonl one
    record per dispatch (every_k 1) and per second one (every_k 2); the
    twin's step p50 beside the plain step's; the graph pools' bytes with
    and without the twins; in each multicity fleet block's ``city_loss`` the
    block city's slot holding each step's loss exactly and the others 0;
37. the guard and faults: a poison at POISON_AT, skipped by the guard,
    ends bitwise equal to a drop run; ``defer`` retries at the epoch's end
    and ``lr_cut`` lands in meta; three poisons in a row abort with the
    hint; the guard-on block p50 beside guard-off; truncate-, corrupt- and
    torn-write on latest.ckpt fall back through ``load_latest_verified``;
38. SIGTERM: a ``sigterm`` fault at SIGTERM_AT raises ``Preempted`` and a
    fresh trainer resumes to bitwise the uninterrupted run's end (the time
    to its first step printed); ``python -m stmgcn_tpu_torch.cli --preset
    default`` at the flagship's grid and batch gets a real SIGTERM after
    its first epoch, exits 143 (the seconds from the signal to the
    emergency file printed) and ``--resume`` finishes;
39. serving: the health run's best.ckpt (baseline, ``health.drift``) in a
    dense engine: held-out windows silent on the input gauge's PSI, traffic
    x DRIFT_SHIFT firing, the reset on ``swap_params``; the prediction
    gauge equal to a host monitor's over the served predictions and silent
    for the held-out targets (the served predictions' reading printed);
    the rung-1 p50 with drift on and off;
    ``batcher-die`` degrading to the inline path (answers equal
    ``Forecaster.predict``), ``dispatch-slow`` shedding under a deadline,
    the watcher's ``corrupt-checkpoint`` hook rejecting the file; the
    fleet engine's drift over both cities;
40. the metro plan: one epoch of tiled health training (B3/B4 per forward
    and step counted), then a poison skipped by the guard against a drop
    run, held to agree_over_steps' tolerances (the bitwise verdict printed;
    phase 43 holds one tiled block bitwise per route).

Phases 41-45 are the slice of the xla form, a repeatable tiled step, the
sanitizers and tracing. Every model of the phases before 41 pins
``lstm_backend="pallas"`` (``pallas_preset``): at float32 both forms run
the same kernels, at bf16 those phases hold the bf16-storage form as they
did. 41 runs after phase 19, 42 after phase 39, 43-44 after phase 40 and
45 last:

41. B1 and B2 in the xla form (float32 storage, bf16 products: the JAX
    package's default bf16 LSTM, ``lstm_backend="xla"``) against their
    plain versions on the card at the main path's shape (M=3 x 16,384
    rows, T=12, L=3, H=64), residuals on and off, the layered and fused
    schedules' roundings and the fused one over a bf16 shadow of the
    weights, a ragged row count and every (H, L) the kernels take; B2
    twice bitwise equal; CUDA-event times of kernel, plain version and
    cuDNN's bf16 ``nn.LSTM`` x3, beside the bound with float32 bytes;
42. the ``default`` preset at ``model.dtype="bfloat16"`` in the xla form:
    the serving ladder, graphed (engine vs Forecaster; card vs CPU within
    2^-9 and 2^-13, the fp32 model the control), a training block of 4 at
    ``precision="bf16"`` without and with ``sr_seed``, and the xla and
    pallas forms' rung-1 and block-step p50s in turns; the xla records'
    launch counts are this phase's ("B1 xla", "B2 xla");
43. the repeatability drill at the metro plan: one tiled block of 4 from one state,
    twice graphed and twice eager (fresh trainers), each pair bitwise;
    an eager forward and backward twice (forward against backward); the
    block under ``torch.use_deterministic_algorithms(True)`` with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` for this phase only, which raises
    at an op PyTorch knows to be nondeterministic; graphed against eager
    printed;
44. the sanitizers (``train.checks``) at the dense bench point: a clean
    checked block bitwise the unchecked one, a NaN poison and an
    out-of-range window index each raising ``CheckError`` naming its step
    (the next dispatch in the process running), the checked and unchecked
    block p50s in turns, one checked epoch of the metro plan;
45. tracing: a traced dense two-epoch run and 64 micro-batched requests,
    the JSONL read by the port's ``obs`` report, traced against untraced
    block and rung-1 p50s in turns.

Phases 46-48 are the slice of the closed continual loop and the serving
federation, run after phase 45. Every fp32 record carries the launches of 47 as
``continual_launches`` and of 48 as ``federation_launches``:

46. the ingest ring (``SeriesRing``) at the dense city (N = 256) and the
    JAX default capacity 1,024: RING_ROWS rows of the synthetic series
    through an ``IngestFaultPlan`` of late, duplicate, gap, nonfinite and
    stale rows, the card's ring against a CPU ring fed the same arrivals
    (outcomes, ``series()``, ``target_indices`` and ``window_at`` bitwise),
    the allocated bytes unchanged after warmup, the ingest p50;
47. the closed loop at the dense flagship, fp32: a graphed engine with
    drift on (the baseline of a one-epoch health run), the ring pre-filled
    past its capacity, a ``ContinualTrainer`` at the JAX defaults (8 steps
    at batch 8, one captured block) with ``holdout`` 4, a ``PromotionGate``
    with a real held-out eval and a ``ContinualDaemon``, while a serving
    thread answers held-out windows throughout (no error, the generation
    never going back): a clean promotion, a poisoned fine-tune rejected
    ``nonfinite``, a corrupt candidate write rejected ``corrupt``, a raise
    retried after the daemon's backoff and promoted, one run of the
    background thread and a bounded stop; the calm traffic's drift and
    whether it triggers a retrain, the fine-tune, gate and swap times, the
    time from the triggering row to the first answer of the new
    generation, no recapture after the first fine-tune, and the card's
    first candidate against a CPU port fine-tune from the same start
    (each tensor's update normwise within CPU_UPDATE_RTOL);
48. the federation: the ``multicity`` preset's model over three cities,
    FED_REPLICAS fleet engines and a warm spare sharing one
    ``GlobalBudget`` behind a ``FederationRouter`` with the serve-bench
    drills of one ``FederationFaultPlan`` (a poisoned candidate that a
    ``TierPromotionGate`` quarantines once, a replica killed at a scatter,
    a herd spike, hang-on-drain), a tier promotion cutting every live
    replica over, the spare joining, every scattered answer bitwise the
    answering engine's direct one, the ``predict_many`` p50 over the three
    cities, and the reserved memory back down after ``close()``.

Phases 49-51 are the slice of the deployment and measurement path, run
last. The B1 records carry the launches of 49 as ``export_launches`` (the
fp32 record the fp32 artifact's, the xla record the bf16 artifact's; the
bf16-storage record 0, as an artifact runs the xla form):

49. export: the ``default`` flagship (dense city, N = 256, seeded random
    weights) exported in fp32 and in bf16 with ``export_forecaster``, each
    file loaded into a fresh ``ExportedForecaster`` on the card and on the
    CPU; requests of 1, 3, 7 and 64 rows from one program (its batch
    symbolic, one B1 operator node in it) against ``Forecaster.predict``
    on the card (fp32 at SERVE_RTOL/SERVE_ATOL, bf16 within BF16_SERVE_MAX
    and BF16_SERVE_NORM, the fp32 model the control they must reject) and
    against the CPU load; B1's launches per predict (one; the bf16 file in
    the xla form); each file's bytes and its export and load seconds; a
    graphed ``ServingEngine.from_artifact`` beside ``from_forecaster``
    (every rung, launches equal, each rung's p50 in turns, no capture after
    warmup), ``ex.predict`` through the engine, ``swap_params`` refused;
    rung 1 through the B1 operator against the launch called directly
    (the route before the operator), graphed and eager, in turns;
50. ``python -m stmgcn_tpu_torch.cli serve-bench --full-model --rows 16
    --soak --federation 2`` in a subprocess: one JSON line, every leg's
    throughput, the soak's hung callers, hot swap and per-generation
    parity, the closed-loop drill's promotion and ``nonfinite`` rejection,
    the federation's drills; the legs' p50s and speedups printed;
51. the CLI at the smoke preset with ``--profile DIR``: the Chrome trace
    names B1 and B2; the MFU of phase 31's graphed dense block steps (fp32
    against the TF32 and fp32 peaks, bf16 against the bf16 peak), from
    ``stmgcn_step_flops``.

Phases 52-56 are the slice of data placement, bf16 fleets and the lint
(the fp32 records carry the placement paths' launches as
``placement_launches``, 52's fp32 runs and 53's; the xla records 52's bf16
runs' and 55's as ``placement_launches`` and ``fleet_bf16_launches``).
55 runs after phase 29, 53-54 after phase 44 (on the metro plan), 52 and
56 last:

52. the dense city at the bench point (the ``default`` preset, its own xla
    bf16 form), fp32 and bf16 (``precision="bf16"``): two epochs at batch
    64, shuffled, from one state, window-free resident in blocks of 4,
    materialized resident (``window_free=False``) in blocks of 4, which
    must equal the first bitwise (losses, parameters, Adam moments),
    window-free one step at a time, and streamed (``data_placement=
    "stream"``) at prefetch 0, 1 and 2, which must equal it bitwise,
    graphed and eager; one B1 launch per forward and one B2 per step in
    every run; each route's step p50 (two more epochs, in turns, twice)
    and host->device bytes a step;
53. the metro plan, fp32: one epoch at batch 2 from one state, resident
    (one step at a time) against streamed at prefetch METRO_PREFETCH:
    bitwise, B1-B4 launches per forward and step, both step p50s in turns
    and bytes a step, and a ``torch.profiler`` trace of one more epoch of
    each: the streams the batch uploads and the kernels ran on, how many
    uploads after the first prefetch + 1 batches' overlapped a kernel on
    another stream, and the device's idle share (it fails on a trace with
    no device events, on streamed uploads sharing the kernels' stream or
    overlapping none, and on any batch upload of the resident route);
54. the "auto" decision: ``_resident_cap_bytes()`` on the card and what
    "auto" picks at both cities; a class ``RESIDENT_CAP_BYTES`` above the
    free memory becomes the budget; under a budget below the metro city's
    windows "auto" streams them;
55. bf16 fleets: the ``multicity`` fleet at ``precision="bf16"`` (xla form)
    against the bf16 per-city loop and the fp32 fleet from one state
    (per-step losses within TWIN_ATOL over steps of both cities), two
    epochs of it with its launches counted, then a ``FleetServingEngine``
    at ``model.dtype="bfloat16"`` against the CPU port's bf16 forecaster
    per city within the bf16 serving limits, the fp32 model the control
    (seeded weights: the served outputs; the trained checkpoint's: the
    model's output before the final bf16 cast, and the served bf16 outputs
    at most one bf16 step apart);
56. ``python -m stmgcn_tpu_torch.cli lint --format json
    --include-suppressed`` in a subprocess, every pass (the whole-program
    AST and concurrency passes over the package, then every config and
    mesh pass over every preset): exit 0, no live finding, a program
    database of more than zero modules and classes, printed with the
    findings by rule, the suppressed count and the lint's seconds; each
    mesh preset's per-rank footprint (``estimate_shard_footprint``) beside
    ``Trainer._resident_cap_bytes()`` on the card; the lint's Python
    mirror of every kernel plan equal to what each built kernel form
    reports; each compiled instance's ``cudaFuncGetAttributes``
    (registers, spilled bytes, max threads) within the budgets the lint
    holds them to, beside ptxas's registers and spills.

Phases 57-60 are the mesh slice (data- and branch-parallel training on
``torch.distributed``), run last. Each mesh job is a set of rank processes
of this script (``chip_smoke.py --mesh-rank JOB DIR``) sharing the card
over gloo (NCCL refuses two ranks on one device), loading the kernels the
parent built (``STMGCN_KERNELS_PREBUILT``: a rank never runs ``nvcc``); a
rank that fails, or a job past MESH_TIMEOUT, fails the run and the other
ranks are killed. Each mesh run is held against its single-device twin on
the card (the same config without the mesh, the same seed; graphed, as a
user runs it). Every rank of every mesh job (57-59, 61-62, 64-65, 67,
68a) also holds its extra step to the lint's executed half
(``analysis/spmd_check.py``: ``manifest_findings``, and ``wire_findings``
with ``parallel.banded_meta`` and the float32 parameter bytes): a
finding fails the job, and each phase prints its largest dp all-reduce a
step beside ``2 x param_bytes + 4096`` and its largest halo permute call
beside ``halo x B_local x M_local x F_cap x 4``. The B1/B2 launches summed over the ranks of 57-58 and 67
(fp32) and 59 and 67 (xla) are the records' ``mesh_launches``:

57. ``multicity`` at its own dp=8 mesh, fp32, full width (cities 12x12 and
    10x10, batch 64, eight ranks; the epochs cut to MESH_EPOCHS): per-step
    losses (rtol 1e-5) and final parameters (rtol 5e-4, atol 2e-5) against
    the twin; one B1 launch per forward of 3,456 or 2,400 rows and one B2
    per step on every rank; one dp gradient all-reduce of 2,290,264 bytes a
    step (286,283 fp32 parameters summed as float64, so the sum does not
    depend on its order); one more step under
    ``step_comm_report`` keeps to ``manifest_for_config`` (``DP_GRAD_SYNC``
    seen, nothing undeclared); each rank's step p50 beside the twin's;
58. ``branchpar`` at dp=2 x branch=3, fp32, full width (N = 100, batch 16,
    six ranks), the same checks: B1 at 800 rows a launch (one branch a
    rank), the fusion all-reduce 204,800 bytes a forward per rank, the dp
    all-reduce 763,768 bytes a step (95,406 branch parameters and the
    head's 65, as float64), ``BRANCH_FUSION`` and ``DP_GRAD_SYNC`` seen; ``test()`` on
    every rank equal to the twin's;
59. ``branchpar`` at ``model.dtype="bfloat16"`` (the xla form), one epoch:
    the first TWIN_STEPS per-step losses within TWIN_ATOL of the bf16
    twin's; over the whole epoch every step's loss, each parameter tensor
    of at least BF16_NORM_MIN entries and the whole final state (normwise)
    no farther from the fp32 twin of one epoch than BF16_GAP_FACTOR times
    the bf16 twin's own gap to it; the xla B1/B2 counted per forward and
    step, the fusion still an fp32 all-reduce;
60. the files and the CLI: the lead wrote phase 58's checkpoints;
    ``Forecaster.from_checkpoint(best.ckpt)`` on one device serves what the
    mesh evaluated from that file (fp32 serving tolerance; the twin's own
    best beside it); a mesh resume gives every rank the lead file's
    parameter digest; a corrupt lead file raises on every rank;
    ``python -m stmgcn_tpu_torch.cli --preset branchpar --distributed`` in
    six processes launched as ``torchrun`` would prints one JSON line;
67. the trainer's opt-in features on the same six ranks: ``branchpar``
    for one epoch, window-free resident in blocks of FEATURE_S, with the
    divergence guard (skip), health at every dispatch, the index
    sanitizers and a fault plan that poisons step FEATURE_POISON and drops
    step FEATURE_DROP, at bf16 (the xla form) with stochastic rounding
    (SR_SEED) and at fp32 without, each against its one-device twin of the
    same plan (graphed): the poisoned block's non-finite steps and the
    guard's trips where the twin's are; at fp32 the losses and parameters
    by phase 57's rules and every health record's norms within
    HEALTH_RTOL (relative) of the twin's; at bf16 phase 59's rule for the
    losses, the parameters and (against the fp32 twin) the health norms;
    the health stats' branch all-reduce one a step; the lead alone writes
    ``health.jsonl``; B1/B2 and the manifests as in 58-59.

The region phases, run last: ``scaled`` (BASELINE config 3: a 50x50 grid,
N = 2,500 padded to 2,504 = 8 x 313, K=3, M=3, a 3-layer 64-wide LSTM,
batch 16, ``region=8``, ``region_strategy="auto"``) at full width through
``build_trainer`` -> ``train`` in eight rank processes sharing the card
over gloo, one epoch (22 steps; the one cut: the preset's 100 epochs),
each against the unpadded single-device twin of the same seed (graphed):

61. at ``model.dtype="bfloat16"`` (the preset's; the xla LSTM form): the
    routes (grid branch banded at its halo of 150, the other two dense),
    one xla B1 per forward of 15,024 rows (M=3 x B 16 x N_local 313) and
    one xla B2 per step on every rank; one more step under
    ``step_comm_report`` moves exactly the analytic bytes (``region_bytes``:
    the signal's node-row all-gathers and halo permutes, their cotangents,
    the pooled gate sums, the float64 gradient bucket and the loss) and
    keeps to ``manifest_for_config(banded=True)``; the losses and the final
    state by phase 59's whole-run rule (BF16_GAP_FACTOR against the bf16
    twin's own gap to the fp32 twin of one epoch);
62. the same at float32: B1/B2 counted alike, the bytes, and every step's
    loss (rtol 1e-5) and the final parameters elementwise (rtol 5e-4, atol
    2e-5) against the fp32 twin;
63. the files: the lead's ``best.ckpt`` of 62 (the JAX loop layout)
    served by ``Forecaster.from_checkpoint`` on one device equals what the
    mesh evaluated from it (fp32 serving tolerance); then ``python -m
    stmgcn_tpu_torch.cli --preset scaled --distributed --region-strategy
    auto`` in eight processes (its series cut to REGION_CLI_TIMESTEPS)
    prints one JSON line.

The sparse mesh phases, in the same eight-rank job as 61-62 (a world of
eight holds the region=8 and 2x2x2 meshes; each builds its process groups
once); each holds the kernels B3/B4 on a rank's strips and B1/B2 on its
rows:

64. ``scaled`` at fp32 with ``model.sparse`` (block-CSR row strips of 313
    rows over region=8): per rank, every step's
    loss (rtol 1e-5) and the final parameters elementwise (phase 62's
    rules) against the one-device block-CSR twin at N = 2,500 (one epoch);
    B3 two per
    forward (the gate's shared-signal launch and the graph conv's, all
    branches in one), B4 one per step, B1/B2 one per forward and step;
    each branch's strip C, C_t and stored-block density; one step's bytes
    against ``stacked_bytes`` and the manifest; and one conv's strip
    output against the twin's rows on a seeded signal (bit for bit, and
    the largest difference);
65. ``bandedbranch`` (dp=2 x region=2 x branch=2, M=2, its width) on each
    route, one epoch: the preset's synthetic graphs
    (``auto`` falls back to the dense plan), banded city adjacencies
    (branch-stacked strips, each branch group its own halo ring) and
    block-CSR supports (branch-stacked strips): ``branch_modes()`` and
    the routed form; every step's loss within BRANCH_LOSS_RTOL and the
    parameters (phase 57's rule) against the one-device twin on the same
    data and weights; the bytes; B1/B2 on every route, B3/B4 on the
    block-CSR one;
66. the metro plan's branch 0 split over the largest region its block
    bandwidth fits (``shard_tiled_plan``; the parent shards it while the
    metro city is on hand, with the one-device B3/B4 reference), each
    rank's sharded apply (halo-local stacks, B3 forward, B4 for the input
    gradient) within TILED_ATOL of the largest value;
68. in the same eight-rank job: (a) ``multicity`` (its 12x12 and 10x10
    cities, batch 64, full width) on a ``region=8`` mesh, window-free
    resident in blocks of FLEET_REGION_S, one epoch: ``fleet_superstep``
    (the shape classes planned over the padded node counts, every rung a
    multiple of 8), every step's loss and the final parameters against the
    one-device fleet twin (phase 57's rules), one B1 a forward of ``64 x
    rung / 8 x 3`` rows and one B2 a step, one gradient all-reduce over
    ``region`` a step, the manifest clean; (b) the NaN drill: the scaled
    city (window-free resident) with a NaN in node DRILL_NODE's series,
    whose rows one rank alone holds, trained under ``checks="nan"`` and
    then under ``debug_nans``: every rank raises the same error at the
    same step, within DRILL_SPREAD_S of one another.

Checkpoints go to a temporary directory that the run removes.

The last three lines are the card, one JSON object describing each kernel
form (B1's and B2's fp32 records carry phase 3b's shapes as
``route_shapes``, the B1 records their ``export_launches``; the bf16 forms' records carry ``"dtype": "bfloat16"``,
the xla forms' ``"form": "xla"`` too; every record its ``mesh_launches``
``region_launches`` and ``sparse_mesh_launches``, summed over the ranks of
57-59 and 67, of 61-62 and 68, and of 64-66),
and ``{"ok": true, "device":
{...}}``. There is no CPU mode: without a CUDA
device the script exits non-zero before printing any result.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# the serving rung at the canonical bench point (bench.py: 16x16 grid,
# 10+1+1-step window, batch 64) over the flagship default model
GRID, SERIAL, BATCH = 16, 10, 64
BUCKETS = (1, 4, 16, 64)
#: requests per round: these sizes, then one past the top rung (split over
#: two rungs); then CALLERS threads of 8 rows each; ROUNDS times over
SIZES, OVERSIZED, CALLERS, ROUNDS = (1, 3, 16, 64), 100, 4, 5
#: kernel vs plain version, fp32: the two sum each gate's K=64/128 products
#: in different orders, and 36 dependent cell steps carry the difference
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
#: backward kernel vs plain version, fp32. dxp: each entry runs the same
#: 36-step reverse chain in another summation order, as the forward does.
#: Weight gradients: each entry sums R*T = 196,608 products at the training
#: shape, the kernel in 4,096-row chunks then chunk by chunk, the plain
#: version per step through cuBLAS; the rounding of such sums scales with the sum of
#: |terms|, so they are held normwise, to 1e-5 of their largest entry.
BWD_RTOL, BWD_ATOL = 1e-4, 1e-5
WGRAD_RTOL = 1e-5
#: engine vs forecaster vs CPU, raw demand units (normalizer range ~1e2):
#: float32 GEMMs at different batch shapes and devices sum in other orders
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-3
#: training phase: epochs of the flagship at the bench point, optimizer
#: steps per block (one loss readback each), steps timed for the p50
EPOCHS, SUPERSTEP, TIMED_STEPS = 2, 4, 10
#: card vs CPU over CPU_STEPS optimizer steps at batch CPU_BATCH from one
#: initial state. Losses: the same model on float32 kernels vs the CPU's
#: plain path differ in summation order only. Parameters: Adam scales each
#: entry's step by that entry's own gradient size, so an entry whose
#: gradient is near zero carries a relative error of its gradient, up to
#: O(1), into its step (elementwise differences of several 1e-6 at lr
#: 2e-3 were seen), while each tensor's update as a whole agrees to float32
#: rounding. So each tensor's total update is held normwise:
#: |p_card - p_cpu| / |p_cpu - p_initial| <= CPU_UPDATE_RTOL.
CPU_STEPS, CPU_BATCH = 3, 4
CPU_LOSS_RTOL, CPU_UPDATE_RTOL = 1e-5, 1e-3
#: H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside the
#: tensor cores, TF32 on them, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
#: every kernel takes its products as three TF32 passes (3xTF32) on the
#: tensor cores: its bound is that route's, TF32_PASSES x FLOPs over the
#: TF32 peak (or its bytes, if longer); the fp32-FMA bound stands beside it
TF32_PASSES = 3
#: the mma.sync probe: rounds of 16 products per warp, 8 warps per CTA
MMA_PROBE_ITERS = 4000
#: checkpoints phase: latest.ckpt every CKPT_EVERY optimizer steps (13 a
#: dense epoch, in blocks of 4: mid-epoch writes after steps 8 and 13), and
#: the CKPT_TOP_K best snapshots kept; the CLI phase's smoke city length
CKPT_EVERY, CKPT_TOP_K, CLI_TIMESTEPS = 5, 2, 400
#: the metro city of bench.py's largeN point (bench.py:1155-1235): a
#: METRO_ROWS x 2*METRO_ROWS grid, N = 8,192, planned at tile 128; batch 2
#: and a 3+1+1-step window as bench.py runs it. 200 timesteps give 22
#: training windows: 11 optimizer steps per epoch at batch 2.
METRO_ROWS, METRO_TILE, METRO_BATCH, METRO_SERIAL = 64, 128, 2, 3
METRO_TIMESTEPS, METRO_EPOCHS = 200, 2
METRO_BUCKETS, METRO_SIZES, METRO_ROUNDS = (1, 2, 4), (1, 2, 4, 5), 3
#: the ragged kernel checks: a sub-city of the first RAGGED_N nodes and a
#: RAGGED_F-column signal, neither a multiple of a tile
RAGGED_N, RAGGED_F = 1000, 37
#: block-CSR kernels vs plain versions, fp32: each output entry sums at
#: most C*t products (1,920 at the metro plan's C = 15, t = 128; B4 K times
#: more) in another order, the kernels each product as 3xTF32 and each
#: block's t-deep sum in the tensor cores' truncating accumulator
#: (tests/test_torch_spmm_tf32.py), so it is held at rtol 1e-5 plus 1e-5 of
#: the output's largest entry
SPMM_RTOL, SPMM_ATOL = 1e-5, 1e-5
#: the tiled/sparse model vs the dense one on the card, fp32: the two sum
#: each support row's products in other orders. Outputs (normalized
#: units) rtol 1e-4, atol 1e-5. Input gradients are held normwise,
#: |g - g_dense| <= GRAD_RTOL |g_dense|: a ReLU pre-activation within
#: rounding of zero can take the other sign under the other order (one of
#: the graph conv's 3.1M at the metro city, |v| ~ 1e-9, seen on the card),
#: and the gradient through it jumps, moving a few dozen entries of the
#: input gradient by up to 4% of its largest entry; a wrong product moves
#: the whole gradient by O(1).
MODEL_RTOL, MODEL_ATOL, GRAD_RTOL = 1e-4, 1e-5, 1e-2
#: bf16 forms vs their plain bf16 versions (phases 19, 23). B1/B2: the
#: rounding sites coincide, and the kernel's fp32 sums in another order flip
#: a bf16 rounding of a stored state now and then (one ulp, 2^-8 relative),
#: which the recurrence carries on: elementwise rtol 2^-6 (four ulps) plus
#: 2^-7 of the largest entry; the weight gradients, fp32 sums of exact
#: products over every row and step, normwise 2^-8. B3-B5 take SPMM_RTOL and
#: SPMM_ATOL: exact bf16 products, fp32 sums.
BF16_RTOL, BF16_ATOL_REL, BF16_WGRAD_NORM = 2.0**-6, 2.0**-7, 2.0**-8
#: bf16 serving (phases 21, 22, 24, 25): engine vs Forecaster, card vs CPU
#: port, a served file vs the trainer, K-tuples vs dense. One bf16 model
#: whose fp32 sums run in other orders (batch shapes, devices) and now and
#: then flip a bf16 rounding, which the LSTM's row and the graph conv's
#: neighbours carry on: max |err| within BF16_SERVE_MAX of the largest
#: prediction, and ||err|| within BF16_SERVE_NORM of ||want||. On an H100
#: the card-vs-CPU gaps read 5.2e-4 / 5.0e-4 of the largest (dense / metro)
#: and 8.4e-5 / 3.0e-5 normwise. The control, the fp32 model on the same
#: weights with every bf16 rounding left out, read 1.1e-3 / 6.2e-4 of the
#: largest, so the largest error alone cannot tell it apart, and 4.3e-4 /
#: 1.7e-4 normwise, which the normwise limit rejects; phases 21 and 24
#: fail unless it does. Input gradients (phase 25, read 2.2e-3) normwise
#: BF16_GRAD_RTOL.
BF16_SERVE_MAX, BF16_SERVE_NORM, BF16_GRAD_RTOL = 2.0**-9, 2.0**-13, 2.0**-7
#: the fleet phases (26-29). The multicity preset's two cities (12x12 over
#: four weeks, 10x10 over three: one class at rung 144, the second city
#: padded by 44 nodes) train in blocks of FLEET_S at the preset's batch 64;
#: bench.py's 8-city fleet point (bench.py:745-760: FLEET_CITY_DIMS, two
#: classes at rungs 16 and 6, serial 3, batch 2, its series lengths) at the
#: default model's full width, one epoch in blocks of FLEET_BENCH_S against
#: one of the per-city loop; a tiled fleet of TILED_FLEET_ROWS x
#: TILED_FLEET_COLS cities (N = 1,024, 960, 896: one class at rung 1,024,
#: which grows the 896-node plan by a block row and keeps the 960-node one
#: inside its last tile) at tile 128
FLEET_S, FLEET_BENCH_S = 4, 8
BENCH_FLEET_DIMS = ((4, 4), (4, 4), (5, 3), (3, 5), (7, 2), (2, 7), (3, 2), (2, 3))
BENCH_FLEET_SERIAL, BENCH_FLEET_BATCH = 3, 2
TILED_FLEET_ROWS, TILED_FLEET_COLS, TILED_FLEET_TILE = (32, 30, 28), 32, 128
TILED_FLEET_TIMESTEPS, TILED_FLEET_BATCH = 24 * 7 + 60, 8
#: the twin drill (tests/test_mixed_precision.py:84-116): bf16 per-step losses
#: within 1e-3 of fp32's from one initial state, over the JAX drill's six
#: steps; the sr_seed run's seed and steps; the bf16 tiled training's steps
TWIN_STEPS, TWIN_ATOL, SR_SEED, SR_STEPS, METRO_BF16_STEPS = 6, 1e-3, 7, 4, 4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


_SCRATCH: list = []


def scratch(name: str) -> str:
    """A directory path for one phase's files (checkpoints), under one
    temporary root that ``main`` removes at the end; nothing is written
    into the checkout."""
    if not _SCRATCH:
        _SCRATCH.append(tempfile.mkdtemp(prefix="chip_smoke-"))
    return os.path.join(_SCRATCH[0], name)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    """Phase 2: every kernel library of the port's paths and the two
    ``mma.sync`` probes (TF32, bf16), one ``nvcc`` per library (each LSTM
    source builds one per form: fp32, bf16, xla), all started together;
    ptxas's register and spill lines. Returns the probes' libraries (TF32,
    bf16)."""
    from concurrent.futures import ThreadPoolExecutor

    from stmgcn_tpu_torch.ops import _build
    from stmgcn_tpu_torch.ops.fused_lstm import (
        FORMS,
        SOURCE,
        bwd_kernel_library,
        kernel_library,
    )

    spmm_library = importlib.import_module("stmgcn_tpu_torch.ops.spmm").kernel_library
    t0 = time.perf_counter()
    lstm = [functools.partial(fn, form) for form in range(len(FORMS))
            for fn in (kernel_library, bwd_kernel_library)]
    with ThreadPoolExecutor(max_workers=len(lstm) + 3) as pool:
        builds = [f.result() for f in [
            *map(pool.submit, lstm),
            pool.submit(spmm_library),
            pool.submit(_build.load_library, [SOURCE.with_name("mma_tf32_rate.cu")],
                        "mma_tf32_rate"),
            pool.submit(_build.load_library, [SOURCE.with_name("mma_bf16_rate.cu")],
                        "mma_bf16_rate")]]
    infos = [b[-1] for b in builds]
    print(f"built {', '.join(i.path.name for i in infos)} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc in parallel: "
          f"{', '.join(f'{i.seconds:.1f} s' for i in infos)})")
    for info in infos:
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")
    from stmgcn_tpu_torch.ops.fused_lstm import KERNEL_HIDDEN, kernel_resources
    from stmgcn_tpu_torch.ops.spmm import KERNEL_TILES, kernel_plan

    import torch

    for dtype in (torch.float32, torch.bfloat16, "xla"):
        for tile in KERNEL_TILES if dtype != "xla" else ():
            print(f"  block-CSR kernels, {dtype}, at tile {tile}, by signal width F: " + "; ".join(
                "F={} column tile {column_tile}, 8 warps of {warp_rows}x{warp_cols}, {stages} "
                "ring stages, {smem_bytes} bytes of dynamic shared memory".format(
                    f, **kernel_plan(tile, f, dtype))
                for f in (10, 20, 37, 128)))
        for h in KERNEL_HIDDEN:
            res = [kernel_resources(layers, h, dtype) for layers in (1, 2, 3, 4)]
            print(f"  LSTM kernels, {dtype}, at H={h}: {res[0]['block_rows']} rows per CTA; "
                  "dynamic shared memory per CTA at L=1..4 (bytes): " + "; ".join(
                      f"{k} {[r[k] for r in res]}" for k in
                      ("lstm_fwd_kernel", "lstm_bwd_sweep", "lstm_bwd_wgrad")))
    return builds[-2][0], builds[-1][0]


def tensor_core_rate(probes) -> None:
    """Phase 2, end: the ``mma.sync`` m16n8k8 TF32 rate, one pass and the
    LSTM kernels' three, and the m16n8k16 bf16 rate of the bf16 forms, at
    one and two 8-warp CTAs per SM (CUDA events in the probes), against the
    TF32 and bf16 peaks."""
    import ctypes

    import torch

    tf32, bf16 = probes
    fn = tf32.stmgcn_mma_tf32_ms
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_float
    fn16 = bf16.stmgcn_mma_bf16_ms
    fn16.argtypes = [ctypes.c_int] * 2
    fn16.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for passes in (1, TF32_PASSES):
        for per_sm in (1, 2):
            ms = fn(sms * per_sm, MMA_PROBE_ITERS, passes)
            if ms <= 0:
                fail("the mma.sync probe did not launch")
            flops = sms * per_sm * 8 * 16 * MMA_PROBE_ITERS * passes * 2 * 16 * 8 * 8
            rate = flops / (ms * 1e-3)
            print(f"mma.sync TF32, {passes} pass(es), {per_sm} CTA(s) x 8 warps per SM: "
                  f"{ms:.4f} ms, {rate / 1e12:.1f} TFLOP/s = {rate / PEAK_TF32_FLOPS:.3f} "
                  "of the TF32 peak")
    for per_sm in (1, 2):
        ms = fn16(sms * per_sm, MMA_PROBE_ITERS)
        if ms <= 0:
            fail("the bf16 mma.sync probe did not launch")
        flops = sms * per_sm * 8 * 16 * MMA_PROBE_ITERS * 2 * 16 * 8 * 16
        rate = flops / (ms * 1e-3)
        print(f"mma.sync bf16 m16n8k16, {per_sm} CTA(s) x 8 warps per SM: {ms:.4f} ms, "
              f"{rate / 1e12:.1f} TFLOP/s = {rate / PEAK_BF16_FLOPS:.3f} of the bf16 peak")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def lstm_inputs(M, R, T, L, H, device, seed):
    """Raw layer-0 input ``x (M, R, T, 1)`` and U(+-1/sqrt(H)) weights, as
    the model draws them, plus the hoisted projection the kernel takes."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    scale = 1.0 / math.sqrt(H)

    def uni(*shape):
        return (torch.rand(*shape, generator=g, device=device) * 2 - 1) * scale

    x = torch.randn(M, R, T, 1, generator=g, device=device) * 2.0
    wx0, b0 = uni(M, 1, 4 * H), uni(M, 4 * H)
    wh, wx, b = uni(M, L, H, 4 * H), uni(M, max(L - 1, 1), H, 4 * H), uni(M, max(L - 1, 1), 4 * H)
    x_proj0 = (x @ wx0[:, None] + b0[:, None, None]).contiguous()
    return x, wx0, b0, x_proj0, wh, wx, b


def max_err(got, want, rtol, atol, what: str) -> float:
    import torch

    err = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            fail(f"{what}: shape {tuple(a.shape)} vs {tuple(b.shape)}")
        if not torch.isfinite(a).all():
            fail(f"{what}: non-finite values")
        err = max(err, (a - b).abs().max().item())
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
            fail(f"{what}: max |err| {err:.3e} over rtol={rtol}, atol={atol}")
    return err


def cudnn_lstms(wx0, b0, wh, wx, b):
    """cuDNN ``nn.LSTM``s on the same weights (TF32 off): one per branch,
    each computing that branch's projection and recurrence."""
    import torch

    M, L, H = wh.shape[0], wh.shape[1], wh.shape[2]
    cudnn = []
    for m in range(M):
        lstm = torch.nn.LSTM(1, H, L, batch_first=True).to(wh.device)
        with torch.no_grad():
            for layer in range(L):
                w_in = wx0[m] if layer == 0 else wx[m, layer - 1]
                getattr(lstm, f"weight_ih_l{layer}").copy_(w_in.T)
                getattr(lstm, f"weight_hh_l{layer}").copy_(wh[m, layer].T)
                getattr(lstm, f"bias_ih_l{layer}").copy_(b0[m] if layer == 0 else b[m, layer - 1])
                getattr(lstm, f"bias_hh_l{layer}").zero_()
        cudnn.append(lstm)
    return cudnn


def check_lstm_kernel(device) -> dict:
    """Phase 3: kernel vs plain version on the card, then timings."""
    import torch

    from stmgcn_tpu_torch.ops.fused_lstm import (
        KERNEL_HIDDEN,
        KERNEL_MAX_LAYERS,
        fused_lstm,
        fused_lstm_reference,
    )

    M, R, T, L, H = 3, BATCH * GRID * GRID, SERIAL + 2, 3, 64
    x, wx0, b0, xp, wh, wx, b = lstm_inputs(M, R, T, L, H, device, seed=0)
    worst = 0.0
    for res in (False, True):
        got = fused_lstm(xp, wh, wx, b, with_residuals=res)
        want = fused_lstm_reference(xp, wh, wx, b, with_residuals=res)
        torch.cuda.synchronize()
        worst = max(worst, max_err(got, want, KERNEL_RTOL, KERNEL_ATOL,
                                   f"fused_lstm M={M} R={R} residuals={res}"))
        del got, want
    # ragged: no block of rows divides 1000, one branch
    _, _, _, xr, whr, wxr, br = lstm_inputs(1, 1000, T, L, H, device, seed=1)
    for res in (False, True):
        got = fused_lstm(xr[0], whr[0], wxr[0], br[0], with_residuals=res)
        want = fused_lstm_reference(xr[0], whr[0], wxr[0], br[0], with_residuals=res)
        torch.cuda.synchronize()
        worst = max(worst, max_err(got, want, KERNEL_RTOL, KERNEL_ATOL,
                                   f"fused_lstm ragged R=1000 residuals={res}"))
    print(f"fused_lstm vs plain: max |err| {worst:.3e} (rtol {KERNEL_RTOL}, "
          f"atol {KERNEL_ATOL}) at M={M} R={R} T={T} L={L} H={H} and ragged "
          "R=1000, residuals on and off")
    # every (H, L) the wrapper accepts, two branches, a ragged row count
    sweep = 0.0
    for h in KERNEL_HIDDEN:
        for layers in range(1, KERNEL_MAX_LAYERS + 1):
            ops = lstm_inputs(2, 77, 5, layers, h, device, seed=h + layers)[3:]
            for res in (False, True):
                got = fused_lstm(*ops, with_residuals=res)
                want = fused_lstm_reference(*ops, with_residuals=res)
                torch.cuda.synchronize()
                sweep = max(sweep, max_err(got, want, KERNEL_RTOL, KERNEL_ATOL,
                                           f"fused_lstm H={h} L={layers} residuals={res}"))
    worst = max(worst, sweep)
    print(f"fused_lstm vs plain at H in {KERNEL_HIDDEN}, L in 1..{KERNEL_MAX_LAYERS} "
          f"(M=2, R=77, T=5): max |err| {sweep:.3e}")

    cudnn = cudnn_lstms(wx0, b0, wh, wx, b)
    with torch.no_grad():
        lib_out = torch.stack([cudnn[m](x[m])[0] for m in range(M)])
        ker_out = fused_lstm(xp, wh, wx, b)[0]
        torch.cuda.synchronize()
        lib_err = (lib_out - ker_out).abs().max().item()
        print(f"cuDNN nn.LSTM vs kernel (yardstick sanity): max |err| {lib_err:.3e}")
        del lib_out, ker_out

        ms = cuda_ms(lambda: fused_lstm(xp, wh, wx, b), iters=20)
        ms_res = cuda_ms(lambda: fused_lstm(xp, wh, wx, b, with_residuals=True), iters=10)
        plain_ms = cuda_ms(lambda: fused_lstm_reference(xp, wh, wx, b), iters=5)
        library_ms = cuda_ms(lambda: [cudnn[m](x[m]) for m in range(M)], iters=5)

    flops = M * R * T * (2 * H * 4 * H + (L - 1) * 2 * (2 * H) * (4 * H))
    n_bytes = 4 * (xp.numel() + wh.numel() + wx.numel() + b.numel()
                   + M * R * T * H + 2 * M * L * R * H)
    bound = route_bounds(flops, n_bytes)
    print(f"fused_lstm times (ms, CUDA events, mean): kernel {ms:.4f}, kernel with "
          f"residuals {ms_res:.4f}, plain {plain_ms:.4f}, cuDNN x{M} {library_ms:.4f}; "
          f"{bounds_text(bound, flops, n_bytes, ms)}")
    return {
        "name": "fused_lstm_fwd",
        "route": "cuda",
        "source": "stmgcn_tpu_torch/csrc/fused_lstm_fwd.cu",
        "replaces": "stmgcn_tpu/ops/pallas_lstm.py:172",
        "launches": None,  # filled from the main path's run
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        **bound,
        "library_ms": library_ms,
    }


def route_bounds(flops: float, n_bytes: float) -> dict:
    """A kernel's bounds (ms): ``bound_ms`` on the route every kernel takes,
    3xTF32 on the tensor cores, or its bytes if longer; ``bound_fp32_ms``
    the same work as fp32 FMAs (or its bytes)."""
    t_tc = TF32_PASSES * flops / PEAK_TF32_FLOPS * 1e3
    t_fp32 = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_tc, t_bytes),
            "bound_by": "operations" if t_tc >= t_bytes else "bytes",
            "bound_fp32_ms": max(t_fp32, t_bytes)}


def bounds_text(bound: dict, flops: float, n_bytes: float, ms: float) -> str:
    return (f"bound ({TF32_PASSES}xTF32 on the tensor cores, or bytes) {bound['bound_ms']:.4f} "
            f"({bound['bound_by']}; {flops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB) = "
            f"{bound['bound_ms'] / ms:.3f} of the kernel's time; fp32-FMA bound "
            f"{bound['bound_fp32_ms']:.4f} = {bound['bound_fp32_ms'] / ms:.3f}")


def lstm_bwd_case(M, R, T, L, H, device, seed):
    """Forward operands, the forward kernel's residuals and random
    cotangents, nonzero at every step and on both final states."""
    import torch

    from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm

    x, wx0, b0, xp, wh, wx, b = lstm_inputs(M, R, T, L, H, device, seed)
    hseq, cseq = fused_lstm(xp, wh, wx, b, with_residuals=True)[3:]
    g = torch.Generator(device=device).manual_seed(seed + 1000)
    g_out = torch.randn(M, R, T, H, generator=g, device=device)
    g_hfin = torch.randn(M, L, R, H, generator=g, device=device)
    g_cfin = torch.randn(M, L, R, H, generator=g, device=device)
    return (x, wx0, b0), (xp, wh, wx, b, hseq, cseq, g_out, g_hfin, g_cfin)


def bwd_err(got, want, what: str) -> float:
    """dxp elementwise (BWD_RTOL/BWD_ATOL); the weight gradients normwise
    (WGRAD_RTOL of their largest entry)."""
    import torch

    err = max_err(got[:1], want[:1], BWD_RTOL, BWD_ATOL, f"{what} dxp")
    for name, a, b in zip(("dwh0", "dwxh", "db"), got[1:], want[1:]):
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{what} {name}: shape {tuple(a.shape)} vs {tuple(b.shape)} or non-finite")
        e, scale = (a - b).abs().max().item(), b.abs().max().item()
        if e > WGRAD_RTOL * scale:
            fail(f"{what} {name}: max |err| {e:.3e} over {WGRAD_RTOL} x max |want| {scale:.3e}")
        err = max(err, e)
    return err


def check_lstm_bwd_kernel(device) -> dict:
    """Phase 4: the backward kernel against its plain version on the card,
    its determinism, then timings beside cuDNN's forward + backward."""
    import torch

    from stmgcn_tpu_torch.ops.fused_lstm import (
        KERNEL_HIDDEN,
        KERNEL_MAX_LAYERS,
        fused_lstm,
        fused_lstm_bwd,
        fused_lstm_bwd_reference,
    )

    M, R, T, L, H = 3, BATCH * GRID * GRID, SERIAL + 2, 3, 64
    (x, wx0, b0), ops = lstm_bwd_case(M, R, T, L, H, device, seed=2)
    got = fused_lstm_bwd(*ops)
    want = fused_lstm_bwd_reference(*ops)
    torch.cuda.synchronize()
    worst = bwd_err(got, want, f"fused_lstm_bwd M={M} R={R}")
    del want
    again = fused_lstm_bwd(*ops)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("fused_lstm_bwd: two runs on the same inputs differ")
    print(f"fused_lstm_bwd: two runs bitwise equal (dxp, dwh0, dwxh, db) at M={M} R={R}")
    del got, again
    _, ragged = lstm_bwd_case(1, 1000, T, L, H, device, seed=3)
    worst = max(worst, bwd_err(fused_lstm_bwd(*ragged), fused_lstm_bwd_reference(*ragged),
                               "fused_lstm_bwd ragged R=1000"))
    print(f"fused_lstm_bwd vs plain: max |err| {worst:.3e} (dxp rtol {BWD_RTOL}, atol "
          f"{BWD_ATOL}; weight grads {WGRAD_RTOL} x their max) at M={M} R={R} T={T} "
          f"L={L} H={H} and ragged R=1000")
    sweep = 0.0
    for h in KERNEL_HIDDEN:
        for layers in range(1, KERNEL_MAX_LAYERS + 1):
            _, case = lstm_bwd_case(2, 77, 5, layers, h, device, seed=h + layers)
            sweep = max(sweep, bwd_err(fused_lstm_bwd(*case), fused_lstm_bwd_reference(*case),
                                       f"fused_lstm_bwd H={h} L={layers}"))
    worst = max(worst, sweep)
    print(f"fused_lstm_bwd vs plain at H in {KERNEL_HIDDEN}, L in 1..{KERNEL_MAX_LAYERS} "
          f"(M=2, R=77, T=5): max |err| {sweep:.3e}")

    xp, wh, wx, b, hseq, cseq, g_out, g_hfin, g_cfin = ops
    ms = cuda_ms(lambda: fused_lstm_bwd(*ops), iters=10)
    plain_ms = cuda_ms(lambda: fused_lstm_bwd_reference(*ops), iters=3)

    def ours():
        res = fused_lstm(xp, wh, wx, b, with_residuals=True)
        fused_lstm_bwd(xp, wh, wx, b, res[3], res[4], g_out, g_hfin, g_cfin)

    cudnn = cudnn_lstms(wx0, b0, wh, wx, b)
    xs = [x[m].clone().requires_grad_(True) for m in range(M)]
    params = [p for lstm in cudnn for p in lstm.parameters()]

    def library():
        outs, grads = [], []
        for m in range(M):
            out, (h_n, c_n) = cudnn[m](xs[m])
            outs += [out, h_n, c_n]
            grads += [g_out[m], g_hfin[m], g_cfin[m]]
        torch.autograd.grad(outs, xs + params, grads)

    fwd_bwd_ms = cuda_ms(ours, iters=10)
    library_ms = cuda_ms(library, iters=5)

    flops = 3 * M * R * T * (2 * H * 4 * H + (L - 1) * 2 * (2 * H) * (4 * H))
    n_bytes = 4 * (sum(t.numel() for t in ops) + xp.numel()  # inputs + dxp
                   + wh.numel() + wx.numel() + b.numel())     # weight grads
    bound = route_bounds(flops, n_bytes)
    print(f"fused_lstm_bwd times (ms, CUDA events, mean): kernel {ms:.4f}, plain "
          f"{plain_ms:.4f}; forward with residuals + backward kernels {fwd_bwd_ms:.4f} vs "
          f"cuDNN forward + backward x{M} {library_ms:.4f}; "
          f"{bounds_text(bound, flops, n_bytes, ms)}")
    return {
        "name": "fused_lstm_bwd",
        "route": "cuda",
        "source": "stmgcn_tpu_torch/csrc/fused_lstm_bwd.cu",
        "replaces": "stmgcn_tpu/ops/pallas_lstm.py:212",
        "launches": None,  # filled from the main path's run
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        **bound,
        "library_ms": library_ms,
    }


#: the LSTM route at shapes the kernels do not take directly (C1): H padded
#: up to a kernel width, and more than four layers in groups of four; the
#: main path's own shape first, the route's baseline (no padding, one group)
ROUTE_SHAPES = ((64, 3), (48, 3), (64, 5))


def check_lstm_shapes(device):
    """Phase 3b: the kernel route (``StackedLSTM.fused``: H padded up to a
    kernel width, layers in groups of at most four) at H=48, L=3 and H=64,
    L=5, and at the main path's H=64, L=3 as the baseline, at M=3 x 16,384
    rows and T=12, forward and backward, against the plain layered route on
    the same weights and cotangents (phases 3 and 4's tolerances: outputs and the
    input gradient elementwise, the weight gradients normwise), with
    ceil(L/4) launches of each kernel per forward and backward, the times
    of both routes, and a trace of the route's forward and forward +
    backward: the kernels' device time against the rest (the hoisted
    projections, padding, slicing). Returns one entry for B1's record and
    one for B2's per shape."""
    import torch

    from stmgcn_tpu_torch.ops.fused_lstm import KERNEL_MAX_LAYERS, kernel_width
    from stmgcn_tpu_torch.ops.lstm import StackedLSTM

    M, R, T = 3, BATCH * GRID * GRID, SERIAL + 2
    fwd_entries, bwd_entries = [], []
    for H, L in ROUTE_SHAPES:
        groups = -(-L // KERNEL_MAX_LAYERS)
        lstm = StackedLSTM(1, H, L, branches=M, device=device,
                           generator=torch.Generator().manual_seed(H + L))
        g = torch.Generator(device=device).manual_seed(H * L)
        x = torch.randn(M, R, T, 1, generator=g, device=device) * 2.0
        g_out = torch.randn(M, R, T, H, generator=g, device=device)
        g_fin = [(torch.randn(M, R, H, generator=g, device=device),
                  torch.randn(M, R, H, generator=g, device=device)) for _ in range(L)]

        def run(route):
            lstm.zero_grad(set_to_none=True)
            xg = x.clone().requires_grad_(True)
            out, finals = getattr(lstm, route)(xg)
            loss = (out * g_out).sum() + sum((h * gh).sum() + (c * gc).sum()
                                             for (h, c), (gh, gc) in zip(finals, g_fin))
            loss.backward()
            outs = [out.detach()] + [t.detach() for hc in finals for t in hc]
            grads = {n: p.grad for n, p in lstm.named_parameters()}
            return outs, xg.grad, grads

        reset_counts()
        got_out, got_dx, got_grads = run("fused")
        counts = read_counts()
        if (counts["B1"], counts["B2"]) != (groups, groups):
            fail(f"LSTM route H={H} L={L}: {counts['B1']} forward and {counts['B2']} backward "
                 f"launches, expected {groups} each")
        want_out, want_dx, want_grads = run("layered")
        torch.cuda.synchronize()
        what = f"LSTM route H={H} L={L} (kernel width {kernel_width(H)}, {groups} group(s))"
        err_fwd = max_err(got_out, want_out, KERNEL_RTOL, KERNEL_ATOL, f"{what} forward")
        err_bwd = max_err([got_dx], [want_dx], BWD_RTOL, BWD_ATOL, f"{what} input gradient")
        for name, want in want_grads.items():
            got = got_grads[name]
            e, scale = (got - want).abs().max().item(), want.abs().max().item()
            if not torch.isfinite(got).all() or e > WGRAD_RTOL * scale:
                fail(f"{what} {name} gradient: max |err| {e:.3e} over {WGRAD_RTOL} x max "
                     f"|want| {scale:.3e}")
            err_bwd = max(err_bwd, e)
        del got_out, want_out, got_dx, want_dx, got_grads, want_grads

        with torch.no_grad():
            ms = cuda_ms(lambda: lstm.fused(x), iters=10)
            plain_ms = cuda_ms(lambda: lstm.layered(x), iters=3)
        fwd_bwd_ms = cuda_ms(lambda: run("fused"), iters=5)
        plain_fwd_bwd_ms = cuda_ms(lambda: run("layered"), iters=2)
        with torch.no_grad():
            wall, dev = profiled(lambda: lstm.fused(x), iters=5)
        shares(f"LSTM route H={H} L={L}, per forward", wall, dev,
               {"B1 forward": LSTM_PARTS["B1 forward"]})
        wall, dev = profiled(lambda: run("fused"), iters=3)
        shares(f"LSTM route H={H} L={L}, per forward + backward", wall, dev, LSTM_PARTS)
        flops = M * R * T * (2 * H * 4 * H + (L - 1) * 2 * (2 * H) * (4 * H))
        n_bytes = 4 * (M * R * T * 4 * H + sum(p.numel() for p in lstm.parameters())
                       + M * R * T * H + 2 * M * L * R * H)
        bound = route_bounds(flops, n_bytes)
        print(f"{what}: forward max |err| {err_fwd:.3e} (rtol {KERNEL_RTOL}, atol "
              f"{KERNEL_ATOL}), backward max |err| {err_bwd:.3e} (input gradient rtol "
              f"{BWD_RTOL}, atol {BWD_ATOL}; weight gradients {WGRAD_RTOL} x their max) "
              f"against the layered plain route at M={M} R={R} T={T}; launches B1 "
              f"{counts['B1']}, B2 {counts['B2']} per forward + backward; times (ms, CUDA "
              f"events, mean): route forward {ms:.4f} vs plain {plain_ms:.4f}, forward + "
              f"backward {fwd_bwd_ms:.4f} vs plain {plain_fwd_bwd_ms:.4f}; forward "
              f"{bounds_text(bound, flops, n_bytes, ms)}")
        fwd_entries.append({"H": H, "L": L, "launches": counts["B1"], "max_abs_err": err_fwd,
                            "ms": ms, "plain_ms": plain_ms, **bound})
        bwd_entries.append({"H": H, "L": L, "launches": counts["B2"], "max_abs_err": err_bwd,
                            "fwd_bwd_ms": fwd_bwd_ms, "plain_fwd_bwd_ms": plain_fwd_bwd_ms})
        del lstm
        torch.cuda.empty_cache()
    return fwd_entries, bwd_entries


#: kernel-name pieces in a profiler trace, by the kernel whose share they
#: are: B1 is one kernel, B2 its reverse sweep, its split-K weight-gradient
#: product (which also sums db) and the fixed-order reduce of the partials
LSTM_PARTS = {
    "B1 forward": ("lstm_fwd_kernel",),
    "B2 sweep": ("lstm_bwd_sweep",),
    "B2 weight gradients": ("lstm_bwd_wgrad",),
    "B2 reduce": ("reduce_partials",),
}
SPMM_PARTS = {"B3": ("spmm_stack_fwd_kernel",),
              "B4": ("spmm_stack_bwd_kernel", "reduce_parts")}


def profiled(run, iters: int):
    """Wall ms per call of ``run`` under ``torch.profiler`` (profiler on,
    so an upper bound) and each CUDA kernel's device ms per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    device = {
        e.key: e.self_device_time_total / 1e3 / iters
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    }
    return wall, device


def shares(what, wall, device, parts, top: int = 4) -> None:
    """One line: device busy ms, idle share, each part's ms and share of
    busy time, the rest; then the top kernels."""
    busy = sum(device.values())
    if busy == 0.0:
        print(f"trace, {what}: no device time recorded (not measured)")
        return
    ms = {name: sum(v for k, v in device.items() if any(key in k for key in keys))
          for name, keys in parts.items()}
    rest = busy - sum(ms.values())
    print(f"trace, {what}: wall {wall:.4f} ms (profiler on), device busy {busy:.4f} ms, "
          f"idle share {1 - busy / wall:.3f}; "
          + "; ".join(f"{n} {v:.4f} ms = {v / busy:.3f}" for n, v in ms.items())
          + f"; rest {rest:.4f} ms = {rest / busy:.3f}")
    print(f"trace, {what}, top device time (ms): " + "; ".join(
        f"{k[:48]} {v:.4f}" for k, v in sorted(device.items(), key=lambda kv: -kv[1])[:top]))


def trace_rungs(engine, windows, rungs, parts, what: str, iters: int = 10) -> None:
    """Phase 6: where one dispatch's time goes, per rung, from a
    ``torch.profiler`` trace of ``iters`` direct dispatches: wall time per
    dispatch (profiler on), device busy time (CUDA kernels and copies),
    the idle share, and each kernel's share of busy time."""
    import torch

    for b in rungs:
        for _ in range(3):
            engine.predict_direct(windows[:b])
        torch.cuda.synchronize()
        wall, device = profiled(lambda: engine.predict_direct(windows[:b]), iters)
        shares(f"{what}, rung {b}, per dispatch", wall, device, parts)


def serve(device, grid: int = GRID):
    """Phases 5 and 6: the serving path end to end, then its trace.
    Returns the engine's stats snapshot, the number of model forwards run
    on ``device`` and the LSTM kernel launches they made (read before the
    trace); raises SystemExit on any failed check."""
    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig
    from stmgcn_tpu_torch.experiment import build_dataset, build_model, build_supports
    from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm

    cfg = pallas_preset("default")
    cfg.data.rows, cfg.data.serial_len = grid, SERIAL
    ds = build_dataset(cfg)
    supports = build_supports(cfg, ds)
    model = build_model(cfg, ds.n_feats, device=device,
                        generator=torch.Generator().manual_seed(0))
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    derived = {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}
    fc = Forecaster(model, state, ds.normalizer, cfg, derived, device=device)
    windows = ds.denormalize(ds.arrays("test")[0])  # raw demand units
    if windows.shape[0] < OVERSIZED + CALLERS * 8:
        fail(f"test split holds only {windows.shape[0]} windows")

    engine = fc.serving_engine(supports, config=ServingConfig(buckets=BUCKETS),
                               device=device)
    try:
        for b in BUCKETS:  # warm every rung (allocator, cuBLAS handles)
            engine.predict_direct(windows[:b])
        engine.stats.reset()

        fc_calls = 0

        def check(got, rows, what):
            nonlocal fc_calls
            fc_calls += 1
            want = fc.predict(supports, rows)
            if got.shape != want.shape or not np.isfinite(got).all():
                fail(f"{what}: got {got.shape} (finite={np.isfinite(got).all()}), "
                     f"want {want.shape}")
            if not np.allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL):
                fail(f"{what}: max |engine - forecaster| "
                     f"{np.abs(got - want).max():.3e}")

        sizes = SIZES + (OVERSIZED,)
        for r in range(ROUNDS):
            for n in sizes:
                rows = windows[r:r + n]
                check(engine.predict(rows), rows, f"predict({n} rows)")
            check(engine.predict_direct(windows[r:r + 3]), windows[r:r + 3],
                  "predict_direct(3 rows)")

        results: dict = {}
        errors: list = []

        def caller(k):
            try:
                rows = windows[OVERSIZED + 8 * k: OVERSIZED + 8 * k + 8]
                results[k] = (rows, [engine.predict(rows) for _ in range(ROUNDS)])
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=caller, args=(k,)) for k in range(CALLERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if errors or any(t.is_alive() for t in threads):
            fail(f"concurrent callers: errors={errors!r}")
        for k, (rows, outs) in results.items():
            for out in outs:
                check(out, rows, f"concurrent caller {k}")

        # one bucket-4 batch against the same model on the CPU (plain path)
        cpu_model = build_model(cfg, ds.n_feats, device="cpu")
        fc_cpu = Forecaster(cpu_model, state, ds.normalizer, cfg, derived, device="cpu")
        rows = windows[:4]
        got, want = engine.predict(rows), fc_cpu.predict(supports, rows)
        err = np.abs(got - want).max()
        if not np.allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL):
            fail(f"bucket-4 batch, GPU engine vs CPU plain path: max |err| {err:.3e}")
        print(f"bucket-4 batch, GPU engine vs CPU plain path: max |err| {err:.3e} "
              f"(rtol {SERVE_RTOL}, atol {SERVE_ATOL}, raw units)")
        snapshot = engine.stats.snapshot()
        # model forwards on the card: rung warm-ups (and, graphed, each
        # rung's warm-up before its capture), engine dispatches, forecaster
        # calls
        forwards = len(BUCKETS) * (1 + engine.graphs) + snapshot["totals"]["dispatches"] + fc_calls
        launches = fused_lstm.launches
        if device.type == "cuda":
            trace_rungs(engine, windows, (BUCKETS[0], BUCKETS[-1]),
                        {"B1": LSTM_PARTS["B1 forward"]}, "dense serving")
        return snapshot, forwards, launches
    finally:
        engine.close()


def pallas_preset(name: str):
    """``preset(name)`` with its bf16 LSTM form pinned to ``"pallas"`` (bf16
    storage, the JAX Pallas kernel's): the phases before 41 hold that form,
    as they did before the xla form existed (at float32 both forms run the
    same kernels); phase 42 serves and trains the default ``"xla"``."""
    from stmgcn_tpu_torch import preset

    cfg = preset(name)
    cfg.model.lstm_backend = "pallas"
    return cfg


def flagship_config(batch: int):
    """The ``default`` flagship at the bench point (``bench.py:68-71``)."""
    cfg = pallas_preset("default")
    cfg.data.rows, cfg.data.serial_len = GRID, SERIAL
    cfg.train.batch_size, cfg.train.epochs = batch, EPOCHS
    cfg.train.steps_per_superstep = SUPERSTEP
    cfg.train.out_dir = scratch(f"dense_batch{batch}")
    return cfg


def kernels() -> dict:
    """Every kernel wrapper of the port by kernel number; each counts its
    launches in ``.launches``."""
    from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm, fused_lstm_bwd

    spmm = importlib.import_module("stmgcn_tpu_torch.ops.spmm")
    return {"B1": fused_lstm, "B2": fused_lstm_bwd, "B3": spmm.spmm_stack,
            "B4": spmm.spmm_stack_bwd, "B5": spmm.spmm}


def reset_counts() -> None:
    for fn in kernels().values():
        fn.launches = 0
    kernels()["B3"].launches_shared = 0
    kernels()["B1"].launches_xla = kernels()["B2"].launches_xla = 0


def read_counts() -> dict:
    """Every kernel's launches, as "B3 shared" those of B3's launches
    whose signal every branch shared (the tiled gate conv's), and as "B1
    xla" and "B2 xla" those of B1's and B2's in the xla form (phases 41-42;
    every earlier phase pins the pallas form, so they count 0 there)."""
    import torch

    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in kernels().items()}
    counts["B3 shared"] = kernels()["B3"].launches_shared
    counts["B1 xla"], counts["B2 xla"] = kernels()["B1"].launches_xla, kernels()["B2"].launches_xla
    return counts


def check_counts(counts, per_forward, per_step, forwards, steps, what) -> None:
    """Each kernel launched ``per_forward[k]`` times per model forward and
    ``per_step[k]`` times per optimizer step, and never otherwise."""
    for k, got in counts.items():
        want = per_forward.get(k, 0) * forwards + per_step.get(k, 0) * steps
        if got != want:
            fail(f"{what}: {got} {k} launches, expected {want} ({per_forward.get(k, 0)} per "
                 f"forward x {forwards} forwards + {per_step.get(k, 0)} per step x {steps} steps)")


def counts_text(counts) -> str:
    return ", ".join(f"{k} {v}" for k, v in counts.items())


def grads_ok(trainer) -> dict:
    """Per parameter: its gradient (the last step's: the gradients stay
    allocated, so a captured step leaves them readable) is finite and not
    all zero."""
    import torch

    return {n: bool(torch.isfinite(p.grad).all()) and bool(p.grad.abs().sum() > 0)
            for n, p in trainer.model.named_parameters()}


def train_and_test(trainer, per_forward, per_step, what):
    """``train()`` then ``test()`` with every kernel's launches counted
    around them (set to 0 just before, read just after): finite losses and
    metrics, a finite, nonzero gradient on every parameter after the first
    block, ``per_forward``/``per_step`` launches, and (graphed) no capture
    after the first epoch. Returns history and counts."""
    from stmgcn_tpu_torch.obs import graphmon

    first: dict = {}
    dispatch = trainer._dispatch

    def block_checking_grads(*args, **kw):
        out = dispatch(*args, **kw)
        if not first:  # every parameter's gradient, after the first block
            first.update(grads_ok(trainer))
        return out

    trainer._dispatch = block_checking_grads
    reset_counts()
    history = trainer.train()
    snap = graphmon.snapshot()
    results = trainer.test()
    counts = read_counts()
    del trainer._dispatch
    if snap["recaptures_after_warmup"]:
        fail(f"{what}: {snap['recaptures_after_warmup']} captures after the first epoch")
    if trainer.graphs:
        print(f"{what}: {len(trainer._programs)} captured training programs, "
              f"recaptures_after_warmup {snap['recaptures_after_warmup']} over "
              f"{len(history['train'])} epochs; graph pool {trainer.graph_pool.reserved_bytes} "
              "bytes")

    print(f"{what}, history: {json.dumps(history)}")
    if not all(np.isfinite(history[m]).all() for m in history):
        fail(f"{what}: non-finite epoch loss")
    for mode, report in results.items():
        # heterogeneous cities add a report per city
        for name, rep in [(mode, report)] + sorted(report.get("per_city", {}).items()):
            rep = {k: v for k, v in rep.items() if k != "per_city"}
            print(f"{what}, test(), {name}: " + ", ".join(f"{k} {v:.6g}" for k, v in rep.items()))
            if not all(np.isfinite(v) for v in rep.values()):
                fail(f"{what}: non-finite {name} metrics")
    bad = sorted(n for n, ok in first.items() if not ok)
    if not first or bad:
        fail(f"{what}: parameters without a finite, nonzero gradient after the first block: "
             f"{bad}")
    print(f"{what}: every parameter ({len(first)}) has a finite, nonzero gradient after the "
          "first block")
    ds, bs, epochs = trainer.dataset, trainer.batch_size, len(history["train"])
    steps = trainer.global_step
    forwards = steps + epochs * ds.num_batches("validate", bs) + sum(
        ds.num_batches(m, bs) for m in results)
    if steps != epochs * trainer.train_steps_per_epoch or steps != trainer.optimizer.count:
        fail(f"{what}: {steps} optimizer steps for {epochs} epochs")
    check_counts(counts, per_forward, per_step, forwards, steps, what)
    print(f"{what}: {steps} optimizer steps ({epochs} epochs x {trainer.train_steps_per_epoch}, "
          f"batch {bs}, blocks of {trainer.steps_per_superstep}) and {forwards - steps} "
          f"validation/test forwards; launches {counts_text(counts)} (per forward: "
          f"{counts_text(per_forward)}; per step: {counts_text(per_step)})")
    return history, counts


def train_on_card(device):
    """Phase 7: ``build_trainer`` -> ``train()`` -> ``test()`` on the card:
    one B1 launch per model forward, one B2 launch per optimizer step.
    Returns the trainer and the launch counts."""
    from stmgcn_tpu_torch import build_trainer

    trainer = build_trainer(flagship_config(BATCH), device=device)
    _, counts = train_and_test(trainer, {"B1": 1}, {"B2": 1}, "dense training")
    return trainer, counts


def step_times(trainer, what: str) -> None:
    """Phase 8 (and 14): host clock around single optimizer steps that end
    in a synchronize."""
    import torch

    batches = list(trainer.batches("train"))[:TIMED_STEPS + 2]
    times = []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        trainer.train_batch(batch)
        torch.cuda.synchronize()
        if i >= 2:  # two warm-up steps
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"{what} (batch {trainer.batch_size}, host clock to synchronize): p50 "
          f"{float(np.median(times)):.4f} ms, min {min(times):.4f} ms over {len(times)} steps")


def agree_over_steps(a, b, state, what: str, batches=None) -> None:
    """CPU_STEPS optimizer steps of trainers ``a`` and ``b`` from one
    initial ``state`` on the same batches (``batches``, or the epoch's
    first): losses within CPU_LOSS_RTOL, each tensor's total update within
    CPU_UPDATE_RTOL of its norm."""
    if batches is None:
        batches = list(a.batches("train"))[:CPU_STEPS]
    for i, batch in enumerate(batches):
        got, want = a.train_batch(batch).item(), b.train_batch(batch).item()
        print(f"{what}, step {i + 1}: loss {got:.8g} vs {want:.8g}")
        if not math.isclose(got, want, rel_tol=CPU_LOSS_RTOL):
            fail(f"{what}, step {i + 1}: loss {got} vs {want} (rtol {CPU_LOSS_RTOL})")
    want = {k: v.cpu() for k, v in b.model.state_dict().items()}
    rel, elem = {}, {}
    for k, v in a.model.state_dict().items():
        diff = v.cpu() - want[k]
        rel[k] = (diff.norm() / (want[k] - state[k]).norm()).item()
        elem[k] = diff.abs().max().item()
    worst = max(rel, key=rel.get)
    if not rel[worst] <= CPU_UPDATE_RTOL:
        fail(f"{what}: after {CPU_STEPS} steps, {worst}'s update differs by {rel[worst]:.3e} "
             f"of its norm (rtol {CPU_UPDATE_RTOL})")
    print(f"{what} over {CPU_STEPS} steps at batch {a.batch_size}: losses within rtol "
          f"{CPU_LOSS_RTOL}; each tensor's update within {rel[worst]:.3e} of its norm "
          f"({worst}; rtol {CPU_UPDATE_RTOL}); parameters max |diff| {max(elem.values()):.3e}")


def card_vs_cpu(device) -> None:
    """Phase 9: the same model from one initial state, CPU_STEPS optimizer
    steps on the card (kernels) and on the CPU (plain path)."""
    from stmgcn_tpu_torch import build_trainer

    cfg = flagship_config(CPU_BATCH)
    card = build_trainer(cfg, device=device, verbose=False)
    state = {k: v.detach().cpu().clone() for k, v in card.model.state_dict().items()}
    cpu = build_trainer(cfg, device="cpu", initial_state=state, verbose=False)
    agree_over_steps(card, cpu, state, "card vs CPU")


def trace_training(trainer, parts, what: str, steps: int = 2) -> None:
    """Phase 10 (and 14): ``torch.profiler`` over ``steps`` optimizer
    steps: device busy time, idle share, and each kernel's share."""
    import torch

    batches = iter(list(trainer.batches("train"))[:steps + 1])
    trainer.train_batch(next(batches))
    torch.cuda.synchronize()
    wall, device = profiled(lambda: trainer.train_batch(next(batches)), steps)
    shares(f"{what} (batch {trainer.batch_size}), per step", wall, device, parts, top=6)


# -- checkpoints: train, resume, test and serve from files, the CLI -------------

def checkpoint_config(out_dir: str):
    """The flagship at the bench point, writing ``latest`` every
    CKPT_EVERY optimizer steps and keeping CKPT_TOP_K best snapshots."""
    cfg = flagship_config(BATCH)
    cfg.train.out_dir = out_dir
    cfg.train.checkpoint_every_steps, cfg.train.top_k = CKPT_EVERY, CKPT_TOP_K
    return cfg


def checkpoints(device, root: str):
    """Phase 16: run A trains the flagship two epochs, writing best,
    best_e*, latest and latest.prev (the first mid-epoch ``latest`` kept
    aside), then ``test()`` reads ``best.ckpt``; a second trainer B in this
    process restores the mid-epoch file, re-enters its epoch and finishes:
    its losses agree with A's history and its parameters with A's
    (normwise, as card vs CPU). Prints each file's bytes, the serialize,
    write and read seconds, and the resume's time to its first block.
    Returns trainer A (its launch counts run on from here)."""
    from stmgcn_tpu_torch import build_trainer
    from stmgcn_tpu_torch.train.checkpoint import load_checkpoint, write_checkpoint_bytes

    a_dir, mid = os.path.join(root, "a"), os.path.join(root, "mid_epoch.ckpt")
    a = build_trainer(checkpoint_config(a_dir), device=device, verbose=False)
    initial = {k: v.detach().cpu().clone() for k, v in a.model.state_dict().items()}
    kept: list = []
    save = a._save

    def save_and_keep(path):
        data = save(path)
        if path == a.latest_path and a._batch_in_epoch and not kept:
            kept.append(a._batch_in_epoch)
            write_checkpoint_bytes(mid, data)
        return data

    a._save = save_and_keep
    history, _ = train_and_test(a, {"B1": 1}, {"B2": 1}, "checkpointed training")
    a._save = save
    if not kept:
        fail("checkpointed training wrote no mid-epoch latest.ckpt")
    files = {name: os.path.getsize(os.path.join(a_dir, name)) for name in sorted(os.listdir(a_dir))}
    want = {"best.ckpt", "latest.ckpt", "latest.prev.ckpt"}
    if not want <= set(files) or sum(n.startswith("best_e") for n in files) != len(a._kept):
        fail(f"checkpointed training wrote {sorted(files)}")
    print(f"checkpoint files after {EPOCHS} epochs (latest every {CKPT_EVERY} steps, top_k "
          f"{CKPT_TOP_K}), bytes: " + ", ".join(f"{n} {b}" for n, b in files.items()))

    t0 = time.perf_counter()
    data = a.snapshot()
    t1 = time.perf_counter()
    timed = os.path.join(root, "timed.ckpt")
    write_checkpoint_bytes(timed, data)
    t2 = time.perf_counter()
    load_checkpoint(timed)
    t3 = time.perf_counter()
    print(f"checkpoint I/O, {len(data)} bytes (host clock): serialize (device to host, "
          f"msgpack) {t1 - t0:.4f} s, write {t2 - t1:.4f} s, read and verify {t3 - t2:.4f} s")

    t0 = time.perf_counter()
    b = build_trainer(checkpoint_config(os.path.join(root, "b")), device=device, verbose=False)
    t1 = time.perf_counter()
    meta = b.restore(mid)
    first: list = []
    dispatch = b._dispatch

    def timed_block(*args, **kw):
        out = dispatch(*args, **kw)
        if not first:
            first.append(time.perf_counter())  # the losses' readback synchronized
        return out

    b._dispatch = timed_block
    resumed = b.train()
    del b._dispatch
    print(f"resume from the mid-epoch latest.ckpt (epoch {meta['epoch']}, {meta['batch_in_epoch']} "
          f"of {b.train_steps_per_epoch} batches consumed, host clock): build_trainer "
          f"{t1 - t0:.4f} s, restore to the end of the first block {first[0] - t1:.4f} s")
    print(f"resumed history: {json.dumps(resumed)}")
    for mode in ("train", "validate"):
        if not np.allclose(resumed[mode], history[mode], rtol=CPU_LOSS_RTOL, atol=0):
            fail(f"resumed {mode} losses {resumed[mode]} vs uninterrupted {history[mode]}")
    rel = {}
    for k, v in b.model.state_dict().items():
        want_k = a.model.state_dict()[k].cpu()
        rel[k] = ((v.cpu() - want_k).norm() / (want_k - initial[k]).norm()).item()
    worst = max(rel, key=rel.get)
    if not rel[worst] <= CPU_UPDATE_RTOL:
        fail(f"resumed run: {worst}'s parameters differ by {rel[worst]:.3e} of the run's update")
    results = b.test()  # best.ckpt in B's own out_dir
    if not all(np.isfinite(v) for r in results.values() for v in r.values()):
        fail("resumed run: non-finite test metrics")
    print(f"resumed run agrees with the uninterrupted one: epoch losses within rtol "
          f"{CPU_LOSS_RTOL}, each tensor within {rel[worst]:.3e} of its update ({worst}; rtol "
          f"{CPU_UPDATE_RTOL}); its test() from best.ckpt: " + json.dumps(results))
    return a


def serve_checkpoint(device, a) -> None:
    """Phase 17: ``Forecaster.from_checkpoint(best.ckpt)`` on the card →
    ``ServingEngine``: predictions equal to the trainer's evaluation of the
    same parameters; then ``watch_checkpoints`` under four concurrent
    callers while run A trains one more epoch and writes a newer
    checkpoint: one swap, every response one generation's and equal to it,
    responses after the poll on the new one; a truncated ``latest`` is
    quarantined, counted in ``rejected``, and the generation stays."""
    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig
    from stmgcn_tpu_torch.experiment import build_model
    from stmgcn_tpu_torch.models import from_jax_params
    from stmgcn_tpu_torch.obs import graphmon
    from stmgcn_tpu_torch.train.checkpoint import load_checkpoint

    fc = Forecaster.from_checkpoint(a.best_path, device=device)
    if any(p.device.type != device.type for p in fc.model.parameters()):
        fail("Forecaster.from_checkpoint left parameters off the card")
    ds, m = a.dataset, a.model.m_graphs
    supports = a.supports.cpu().numpy()
    windows = ds.denormalize(ds.arrays("test")[0])
    best = {k: v.to(device) for k, v in
            from_jax_params(load_checkpoint(a.best_path, load_opt_state=False)[1], m).items()}
    evaluated = ds.denormalize(a._predict_mode("test", best)[0][0])  # city 0: (pred, true)

    def state_forecaster(path):
        state = from_jax_params(load_checkpoint(path, load_opt_state=False)[1], m)
        model = build_model(fc.config, fc.derived["input_dim"], device=device)
        return Forecaster(model, state, fc.normalizer, fc.config, fc.derived, device=device)

    engine = fc.serving_engine(supports, config=ServingConfig(buckets=BUCKETS), device=device)
    try:
        worst = 0.0
        for n in (1, 3, BUCKETS[-1], OVERSIZED):
            got = engine.predict(windows[:n])
            worst = max(worst, float(np.abs(got - evaluated[:n]).max()))
            if not np.allclose(got, evaluated[:n], rtol=SERVE_RTOL, atol=SERVE_ATOL):
                fail(f"served best.ckpt vs trainer evaluation, {n} rows: max |err| {worst:.3e}")
        print(f"Forecaster.from_checkpoint(best.ckpt) on the card -> ServingEngine: requests of "
              f"1, 3, {BUCKETS[-1]} and {OVERSIZED} rows equal the trainer's evaluation of the "
              f"file's parameters, max |err| {worst:.3e} (rtol {SERVE_RTOL}, atol {SERVE_ATOL}, "
              "raw units)")

        watcher = engine.watch_checkpoints(a.out_dir)
        if watcher.poll():
            fail("the watcher swapped before any newer checkpoint landed")
        stop, responses, errors = threading.Event(), [], []

        def caller(k):
            rows = windows[8 * k: 8 * k + 8]
            try:
                while not stop.is_set():
                    t_start = time.perf_counter()
                    out, gen = engine.predict(rows, with_generation=True)
                    responses.append((k, t_start, gen, out))
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=caller, args=(k,)) for k in range(CALLERS)]
        for t in threads:
            t.start()
        a.n_epochs = EPOCHS + 1  # one more epoch: latest.ckpt (and best.ckpt if it improves)
        a.verbose = False
        a.train()
        swaps0 = graphmon.snapshot()
        t_swap0 = time.perf_counter()
        swapped = watcher.poll()
        t_swap1 = time.perf_counter()
        swaps1 = graphmon.snapshot()
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=300)
        if errors or any(t.is_alive() for t in threads):
            fail(f"callers under the swap: errors={errors!r}")
        if not swapped or engine.generation != 1 or watcher.swaps != 1:
            fail(f"watcher: swapped={swapped}, generation {engine.generation}")
        want = {0: fc, 1: state_forecaster(watcher.last_path)}
        late = [r for r in responses if r[1] > t_swap1]
        if not late or any(gen != 1 for _, _, gen, _ in late):
            fail(f"{len(late)} responses after the poll, generations "
                 f"{sorted({r[2] for r in late})}")
        expected = {(k, g): want[g].predict(supports, windows[8 * k: 8 * k + 8])
                    for k in range(CALLERS) for g in (0, 1)}
        for k, _, gen, out in responses:
            if gen not in (0, 1) or not np.allclose(out, expected[k, gen], rtol=SERVE_RTOL,
                                                    atol=SERVE_ATOL):
                fail(f"caller {k}: a generation-{gen} response differs from that generation")
        if np.allclose(expected[0, 0], expected[0, 1], rtol=SERVE_RTOL, atol=SERVE_ATOL):
            fail("the swapped checkpoint predicts what the old one did")
        gens = [sum(r[2] == g for r in responses) for g in (0, 1)]
        print(f"hot swap under {CALLERS} callers: {os.path.basename(watcher.last_path)} swapped "
              f"in by poll() in {t_swap1 - t_swap0:.4f} s (host clock); {len(responses)} "
              f"responses, {gens[0]} of generation 0 and {gens[1]} of generation 1, each equal "
              f"to its generation's Forecaster; the {len(late)} after the poll all generation 1")
        print(f"the swap captured {swaps1['swap_captures'] - swaps0['swap_captures']} rungs "
              f"(counted apart: captures {swaps1['captures'] - swaps0['captures']}, "
              f"recaptures_after_warmup {swaps1['recaptures_after_warmup']}); the new "
              f"generation's graph pool {engine.graph_pool_bytes} bytes")

        latest = a.latest_path
        with open(latest, "rb") as f:
            data = f.read()
        with open(latest, "wb") as f:
            f.write(data[: len(data) // 2])
        later = time.time() + 5
        os.utime(latest, (later, later))
        if watcher.poll() or watcher.rejected != 1 or engine.generation != 1:
            fail(f"truncated latest.ckpt: rejected {watcher.rejected}, generation "
                 f"{engine.generation}")
        if not os.path.exists(latest + ".corrupt"):
            fail("truncated latest.ckpt was not quarantined")
        if engine.predict(windows[:1], with_generation=True)[1] != 1:
            fail("after the rejected checkpoint, responses left generation 1")
        print("truncated latest.ckpt: quarantined as latest.ckpt.corrupt, rejected 1, the "
              "engine stays on generation 1")
    finally:
        engine.close()
    torch.cuda.synchronize()


def cli_runs(root: str) -> None:
    """Phase 18: ``python -m stmgcn_tpu_torch.cli`` on the card in
    subprocesses: train the smoke preset one epoch, ``--test-only`` (the
    same results from best.ckpt), ``--resume`` to a second epoch, and bare
    ``--resume`` on an empty directory, which exits 1 as the reference
    does."""
    repo = os.path.dirname(os.path.abspath(__file__))
    out, empty = os.path.join(root, "cli"), os.path.join(root, "cli_empty")
    base = [sys.executable, "-m", "stmgcn_tpu_torch.cli", "--preset", "smoke",
            "--timesteps", str(CLI_TIMESTEPS)]
    results = {}
    for what, args, code in (
            ("train", ["--out-dir", out, "--epochs", "1"], 0),
            ("test-only", ["--out-dir", out, "--test-only"], 0),
            ("resume", ["--out-dir", out, "--epochs", "2", "--resume"], 0),
            ("resume, nothing to resume", ["--out-dir", empty, "--resume"], 1)):
        t0 = time.perf_counter()
        proc = subprocess.run(base + args, cwd=repo, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != code:
            fail(f"cli {what}: exit {proc.returncode}, expected {code}; stderr "
                 f"{proc.stderr[-2000:]}")
        if code == 0:
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            results[what] = line["results"]
            if not all(np.isfinite(v) for r in line["results"].values() for v in r.values()):
                fail(f"cli {what}: non-finite metrics")
        print(f"cli {what} ({' '.join(args[2:]) or 'train'}): exit {proc.returncode} in "
              f"{seconds:.1f} s" + (f"; {proc.stderr.strip().splitlines()[-1]}" if code else ""))
    for mode, report in results["train"].items():
        for key, value in report.items():
            if not math.isclose(value, results["test-only"][mode][key], rel_tol=1e-6):
                fail(f"cli --test-only {mode} {key}: {results['test-only'][mode][key]} vs the "
                     f"training run's {value}")
    print("cli --test-only scored best.ckpt as the training run did: " + json.dumps(
        results["test-only"]))


# -- the metro city: the tiled and block-sparse path ---------------------------

def metro_city(rows: int, cols: int, n_timesteps: int, seed: int = 0):
    """Synthetic metro city with three STRUCTURED sparse graphs: a copy of
    ``bench.py``'s ``_largen_city`` (which imports the JAX package).

    Uniform random links (``synthetic_dataset``'s transport graph) would
    weld distant regions together and defeat the bandwidth reorder, so the
    graphs follow a city's structure:

    - spatial: grid rook adjacency (degree <= 4);
    - transport: transit lines along every 8th row/column with stops
      every 4 cells, consecutive stops linked — sparse corridor paths;
    - similarity: top-3 demand-profile similarity *within 8x8 districts*.
    """
    from stmgcn_tpu_torch.data.loader import ADJ_KEYS, DemandData
    from stmgcn_tpu_torch.data.synthetic import grid_adjacency, synthetic_demand

    n = rows * cols
    demand = synthetic_demand(n_timesteps, n, 1, 24, seed)

    trans = np.zeros((n, n), np.float32)

    def _line(ids):
        for a, b in zip(ids, ids[1:]):
            trans[a, b] = trans[b, a] = 1.0

    for r in range(0, rows, 8):
        _line([r * cols + c for c in range(0, cols, 4)])
    for c in range(0, cols, 8):
        _line([r * cols + c for r in range(0, rows, 4)])

    profile = demand[:, :, 0].T  # (N, T)
    profile = profile - profile.mean(axis=1, keepdims=True)
    norms = np.linalg.norm(profile, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    profile = profile / norms
    sim = np.zeros((n, n), np.float32)
    for r0 in range(0, rows, 8):
        for c0 in range(0, cols, 8):
            ids = np.array(
                [r * cols + c
                 for r in range(r0, min(r0 + 8, rows))
                 for c in range(c0, min(c0 + 8, cols))]
            )
            s = profile[ids] @ profile[ids].T
            np.fill_diagonal(s, -np.inf)
            top = np.argsort(s, axis=1)[:, -3:]
            for i, js in enumerate(top):
                sim[ids[i], ids[js]] = 1.0
    sim = np.maximum(sim, sim.T)

    return DemandData(
        demand=demand,
        adjs={
            ADJ_KEYS[0]: grid_adjacency(rows, cols),
            ADJ_KEYS[1]: trans,
            ADJ_KEYS[2]: sim,
        },
    )


def chebyshev_stack(adjs, device=None) -> np.ndarray:
    """``SupportConfig("chebyshev", 2).build_all(adjs)``; with ``device``
    its two costly parts made cheap, the rest as the library builds them
    (at N = 8,192 they took about 55 s of the metro start-up on the
    card's host): ``lambda_max`` by the same Lanczos solver (ARPACK's
    ``eigsh``) over the sparse Laplacian rather than its dense copy, and
    the one product of order N^3, ``T_2 = 2 x @ x - I``, in float64 on the
    card; each another float64 rounding of the same numbers."""
    import scipy.sparse
    import torch
    from scipy.sparse.linalg import eigsh

    from stmgcn_tpu_torch.ops import SupportConfig
    from stmgcn_tpu_torch.ops.graph import normalized_laplacian, rescale_laplacian

    if device is None:
        return SupportConfig("chebyshev", 2).build_all(adjs)
    stacks = []
    for adj in adjs:
        lap = normalized_laplacian(adj)
        lam = eigsh(scipy.sparse.csr_matrix(lap), k=1, which="LA", return_eigenvectors=False)
        x = rescale_laplacian(lap, lambda_max=float(lam[0]))
        x_dev = torch.from_numpy(x).to(device)
        eye = torch.eye(x.shape[0], dtype=torch.float64, device=device)
        t2 = (2.0 * (x_dev @ x_dev) - eye).cpu().numpy()
        del x_dev, eye
        stacks.append(np.stack([np.eye(x.shape[0]), x, t2]).astype(np.float32))
    torch.cuda.empty_cache()
    return np.stack(stacks)


def metro_host(device=None):
    """Phase 11: the metro city, its dense Chebyshev supports and their
    tiled plan, built as ``bench.py`` builds them (with ``device``, the
    supports' one N^3 product on the card: :func:`chebyshev_stack`)."""
    from stmgcn_tpu_torch.data import DemandDataset, WindowSpec
    from stmgcn_tpu_torch.ops.tiling import plan_tiling

    rows, cols = METRO_ROWS, 2 * METRO_ROWS
    t0 = time.perf_counter()
    ds = DemandDataset(metro_city(rows, cols, METRO_TIMESTEPS),
                       WindowSpec(METRO_SERIAL, 1, 1, 24))
    t1 = time.perf_counter()
    dense = chebyshev_stack(ds.adjs.values(), device)
    t2 = time.perf_counter()
    plan = plan_tiling(dense, tile=METRO_TILE)
    t3 = time.perf_counter()
    st = plan.tile_stats()
    stored = plan.m_graphs * plan.n_supports * plan.block_rows * plan.block_cols
    print(f"metro city: {rows}x{cols} grid, N={ds.n_nodes}, {METRO_TIMESTEPS} timesteps "
          f"({ds.mode_size('train')} training windows); host seconds: city {t1 - t0:.2f}, "
          f"dense (M, K, N, N) supports {t2 - t1:.2f}, tiled plan {t3 - t2:.2f}")
    print(f"metro plan at tile {plan.tile}: R={plan.block_rows} block rows, C={plan.block_cols} "
          f"stored block columns (C_t={plan.data_t.shape[3]} transposed); {st['blocks_kept']} of "
          f"{stored} stored blocks nonzero (waste {1 - st['blocks_kept'] / stored:.3f}), density "
          f"{st['density']:.4f} of the dense block grid; plan {st['nbytes'] / 1e6:.1f} MB vs "
          f"dense {st['dense_nbytes'] / 1e6:.1f} MB")
    return ds, dense, plan


def spmm_err(got, want, what: str, rtol: float = SPMM_RTOL, atol: float = SPMM_ATOL) -> float:
    """Max |got - want|; fails past ``rtol`` plus ``atol`` of the largest
    |want|."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=rtol, atol=atol * scale):
        fail(f"{what}: max |err| {err:.3e} over rtol {rtol} + {atol} x {scale:.3e}")
    return err


def nonzero_blocks(data) -> int:
    """The stored ``(t, t)`` blocks of ``data`` that hold a nonzero."""
    return int((data != 0).any(dim=-1).any(dim=-1).sum().item())


def spmm_bound(nblk, idx, tile: int, F: int, src_elems: int, out_elems: int):
    """``(bounds, FLOPs, bytes)`` of one block-CSR product over the real
    blocks that the counts ``nblk`` name (the kernels skip the padding):
    each multiplied once, and read once with the count and index arrays,
    the signal read once and the output written once."""
    nz = int(nblk.sum().item())
    flops = 2 * nz * tile * tile * F
    n_bytes = 4 * (nz * tile * tile + idx.numel() + nblk.numel() + src_elems + out_elems)
    return route_bounds(flops, n_bytes), flops, n_bytes


def spmm_record(name, replaces, err, ms, plain_ms, library_ms, bound) -> dict:
    return {"name": name, "route": "cuda", "source": "stmgcn_tpu_torch/csrc/spmm_stack.cu",
            "replaces": replaces, "launches": None,  # filled from the main path's run
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": library_ms}


def blocks_read(st, F: int) -> str:
    """The blocks one B3 and one B4 launch read (the real ones, once per
    column tile) against those stored."""
    from stmgcn_tpu_torch.ops.spmm import kernel_plan

    tiles = -(-F // kernel_plan(st.tile, F)["column_tile"])
    return (f"B3 reads {int(st.nblk.sum()) * tiles} of {st.idx.numel()} stored blocks, B4 "
            f"{int(st.nblk_t.sum()) * tiles} of {st.idx_t.numel()}")


def check_spmm_kernels(device, dense, dense_dev, plan) -> list:
    """Phase 12: B3, B4 and B5 against their plain versions on the card at
    the metro city's shapes, then each timed beside its bound, its plain
    version and the dense cuBLAS product over the same supports (TF32 off,
    in the plan's node order)."""
    import torch

    from stmgcn_tpu_torch.ops.tiling import plan_tiling

    S = importlib.import_module("stmgcn_tpu_torch.ops.spmm")
    M, K, N, t = plan.m_graphs, plan.n_supports, plan.n, plan.tile
    T, H, B = METRO_SERIAL + 2, 64, METRO_BATCH
    gen = torch.Generator(device=device).manual_seed(11)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    stack = plan.as_stack().to(device)
    cases = [
        ("gate conv, batch 2, shared x", stack, randn(N, B * T)),
        ("graph conv, batch 2, per-branch x", stack, randn(M, N, B * H)),
        ("gate conv, rung 4", stack, randn(N, 4 * T)),
        ("graph conv, rung 4", stack, randn(M, N, 4 * H)),
    ]
    n, f = RAGGED_N, RAGGED_F
    for tile in (128, 64):  # a sub-city: N and F not multiples of the tile
        sub = plan_tiling(dense[:, :, :n, :n], tile=tile).as_stack().to(device)
        cases += [(f"ragged N={n} F={f} t={tile}, shared x", sub, randn(n, f)),
                  (f"ragged N={n} F={f} t={tile}, per-branch x", sub, randn(M, n, f))]
    for st in (stack, *(c[1] for c in cases[4::2])):
        if nonzero_blocks(st.data) != int(st.nblk.sum()) or (
                nonzero_blocks(st.data_t) != int(st.nblk_t.sum())):
            fail("the plan's counts disagree with its nonzero blocks")
    # every stored slot counted as real: the padding blocks are multiplied too
    full = dataclasses.replace(stack, nblk=torch.full_like(stack.nblk, stack.idx.shape[-1]),
                               nblk_t=torch.full_like(stack.nblk_t, stack.idx_t.shape[-1]))
    err3 = err4 = 0.0
    for what, st, x in cases:
        shared = x.dim() == 2
        with torch.no_grad():
            got = S.spmm_stack(st, x)
        err3 = max(err3, spmm_err(got, S.spmm_stack_reference(st, x), f"B3 {what}"))
        g = randn(*got.shape)
        dx = S.spmm_stack_bwd(st, g, shared=shared)
        again = S.spmm_stack_bwd(st, g, shared=shared)
        torch.cuda.synchronize()
        if not torch.equal(dx, again):
            fail(f"B4 {what}: two runs on the same inputs differ")
        err4 = max(err4, spmm_err(dx, S.spmm_stack_bwd_reference(st, g, shared=shared),
                                  f"B4 {what}"))
        if st is stack:
            with torch.no_grad():
                same = (torch.equal(got, S.spmm_stack(full, x)),
                        torch.equal(dx, S.spmm_stack_bwd(full, g, shared=shared)))
            torch.cuda.synchronize()
            if not all(same):
                fail(f"{what}: the run over every stored slot differs from the counted run "
                     f"(B3 equal: {same[0]}, B4 equal: {same[1]})")
        print(f"{what}: {blocks_read(st, x.shape[-1])}")
        del got, g, dx, again
    print(f"B3 (spmm_stack) vs plain: max |err| {err3:.3e}; B4 (its backward) vs plain: max "
          f"|err| {err4:.3e}, two runs bitwise equal; tolerance rtol {SPMM_RTOL} + {SPMM_ATOL} x "
          "max |want|; cases: " + "; ".join(w for w, _, _ in cases))
    print("B3 and B4 over every stored slot (padding multiplied) bitwise equal to the counted "
          "runs at the metro plan: " + "; ".join(w for w, st, _ in cases if st is stack))

    bs = S.from_dense(dense[0, 2], tile=METRO_TILE).to(device)  # T_2 of the spatial graph
    bs_ragged = S.from_dense(dense[1, 2, :n, :n], tile=64).to(device)
    err5 = 0.0
    for what, b, x in (("metro T_2 spatial, F=10", bs, randn(N, B * T)),
                       ("metro T_2 spatial, F=128", bs, randn(N, B * H)),
                       (f"ragged N={n} F={f} t=64", bs_ragged, randn(n, f))):
        for transpose in (False, True):
            err5 = max(err5, spmm_err(S.block_spmm(b, x, transpose=transpose),
                                      S.spmm_reference(b, x, transpose=transpose),
                                      f"B5 {what} transpose={transpose}"))
    print(f"B5 (spmm) vs plain, A @ x and A^T @ x: max |err| {err5:.3e} (metro support C="
          f"{bs.block_cols_per_row}, ragged sub-support)")

    x_gate, x_gcn, g_gcn = cases[0][2], cases[1][2], randn(M, K, N, B * H)
    x5 = randn(N, B * H)
    perm = plan.perm.to(device).long()
    dense_p = dense_dev.index_select(2, perm).index_select(3, perm)  # the plan's order
    with torch.no_grad():
        gate = (cuda_ms(lambda: S.spmm_stack(stack, x_gate), 20),
                cuda_ms(lambda: S.spmm_stack_reference(stack, x_gate), 5),
                cuda_ms(lambda: torch.einsum("mkij,jf->mkif", dense_p, x_gate), 5))
        fwd = (cuda_ms(lambda: S.spmm_stack(stack, x_gcn), 20),
               cuda_ms(lambda: S.spmm_stack_reference(stack, x_gcn), 5),
               cuda_ms(lambda: torch.einsum("mkij,mjf->mkif", dense_p, x_gcn), 5))
        bwd = (cuda_ms(lambda: S.spmm_stack_bwd(stack, g_gcn, shared=False), 20),
               cuda_ms(lambda: S.spmm_stack_bwd_reference(stack, g_gcn, shared=False), 5),
               cuda_ms(lambda: torch.einsum("mkij,mkif->mjf", dense_p, g_gcn), 5))
        a5 = dense_dev[0, 2]
        one = (cuda_ms(lambda: S.block_spmm(bs, x5), 20),
               cuda_ms(lambda: S.spmm_reference(bs, x5), 5),
               cuda_ms(lambda: a5 @ x5, 10))
        try:  # torch.sparse's block-CSR product, where this build runs it on the card
            bsr = a5.to_sparse_bsr((METRO_TILE, METRO_TILE))
            bsr_ms = f"{cuda_ms(lambda: bsr @ x5, 10):.4f} ms"
        except (RuntimeError, NotImplementedError) as e:
            bsr_ms = f"not measured ({type(e).__name__}: {str(e).splitlines()[0][:100]})"
    del dense_p
    b_gate = spmm_bound(stack.nblk, stack.idx, t, B * T, N * B * T, M * K * N * B * T)
    b_fwd = spmm_bound(stack.nblk, stack.idx, t, B * H, M * N * B * H, M * K * N * B * H)
    b_bwd = spmm_bound(stack.nblk_t, stack.idx_t, t, B * H, M * K * N * B * H, M * N * B * H)
    b_one = spmm_bound(bs.nblk, bs.idx, t, B * H, N * B * H, N * B * H)
    for what, (ms, plain, lib), (b, flops, n_bytes) in (
            ("B3 gate conv (shared x, F=10)", gate, b_gate),
            ("B3 graph conv (per-branch x, F=128)", fwd, b_fwd),
            ("B4 graph-conv backward (F=128)", bwd, b_bwd),
            (f"B5 one support (C={bs.block_cols_per_row}, F=128)", one, b_one)):
        print(f"{what} at the metro city, batch 2 (ms, CUDA events, mean): kernel {ms:.4f}, "
              f"plain {plain:.4f}, dense cuBLAS {lib:.4f}; {bounds_text(b, flops, n_bytes, ms)}")
    print(f"bounds count the nonzero blocks the counts name ({int(stack.nblk.sum())} of "
          f"{stack.idx.numel()} stored, {int(stack.nblk_t.sum())} of {stack.idx_t.numel()} "
          f"transposed, B5 {int(bs.nblk.sum())} of {bs.idx.numel()}), each read and multiplied "
          "once, the count and index arrays, the signal read once and the output written once")
    print(f"torch.sparse BSR matmul on B5's support and signal: {bsr_ms}")
    return [
        spmm_record("spmm_stack_fwd", "stmgcn_tpu/ops/spmm.py:339", err3, *fwd, b_fwd[0]),
        spmm_record("spmm_stack_bwd", "stmgcn_tpu/ops/spmm.py:379", err4, *bwd, b_bwd[0]),
        spmm_record("spmm", "stmgcn_tpu/ops/spmm.py:125", err5, *one, b_one[0]),
        spmm_record("spmm_stack_fwd_gate", "stmgcn_tpu/ops/spmm.py:339", err3, *gate,
                    b_gate[0]),
    ]


def metro_config(mode: str):
    """The ``default`` flagship at full width, at the metro point, in
    support mode ``mode``."""
    cfg = pallas_preset("default")
    cfg.data.serial_len = METRO_SERIAL
    cfg.model.tiled, cfg.model.sparse = mode == "tiled", mode == "sparse"
    cfg.model.tile_size = METRO_TILE
    cfg.train.batch_size, cfg.train.epochs = METRO_BATCH, METRO_EPOCHS
    cfg.train.steps_per_superstep = SUPERSTEP
    cfg.train.out_dir = scratch(f"metro_{mode}")
    return cfg


def metro_model(mode: str, ds, device):
    """The flagship in support mode ``mode``, weights from seed 0 (the
    same in every mode: the parameters do not depend on it)."""
    import torch

    from stmgcn_tpu_torch.experiment import build_model

    return build_model(metro_config(mode), ds.n_feats, device=device,
                       generator=torch.Generator().manual_seed(0))


def metro_serve(device, ds, dense_dev, plan_dev) -> None:
    """Phase 13: ``Forecaster`` and ``ServingEngine`` on the tiled plan."""
    from stmgcn_tpu_torch import Forecaster, ServingConfig

    model = metro_model("tiled", ds, device)
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    derived = {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}
    fc = Forecaster(model, state, ds.normalizer, metro_config("tiled"), derived, device=device)
    windows = ds.denormalize(ds.arrays("test")[0])  # raw demand units
    if windows.shape[0] < METRO_SIZES[-1] + METRO_ROUNDS - 1:
        fail(f"metro test split holds only {windows.shape[0]} windows")
    config = ServingConfig(buckets=METRO_BUCKETS, max_batch=METRO_BUCKETS[-1])
    engine = fc.serving_engine(plan_dev, config=config, device=device)
    try:
        for b in METRO_BUCKETS:  # warm every rung
            engine.predict_direct(windows[:b])
        engine.stats.reset()
        reset_counts()
        fc_calls = 0
        for r in range(METRO_ROUNDS):
            for n in METRO_SIZES:
                rows = windows[r:r + n]
                got, want = engine.predict(rows), fc.predict(plan_dev, rows)
                fc_calls += 1
                if got.shape != want.shape or not np.isfinite(got).all():
                    fail(f"tiled predict({n} rows): got {got.shape}, want {want.shape}")
                if not np.allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL):
                    fail(f"tiled predict({n} rows): max |engine - forecaster| "
                         f"{np.abs(got - want).max():.3e}")
        counts = read_counts()
        snapshot = engine.stats.snapshot()
        dispatches = snapshot["totals"]["dispatches"]
        forwards = dispatches + fc_calls
        check_counts(counts, {"B1": 1, "B3": 2, "B3 shared": 1}, {}, forwards, 0,
                     "tiled serving")
        print(f"tiled serving at the metro city: requests of {METRO_SIZES} rows x "
              f"{METRO_ROUNDS} rounds, every response finite and equal to Forecaster.predict; "
              f"{forwards} model forwards ({dispatches} engine dispatches + {fc_calls} "
              f"Forecaster calls), launches {counts_text(counts)} (per forward: B1 1, B3 2, one "
              "of them on the shared signal)")
        for b, s in snapshot["buckets"].items():
            print(f"tiled bucket {b}: {s['dispatches']} dispatches, p50 latency "
                  f"{s['latency_ms']['p50']} ms, p50 dispatch {s['device_ms']['p50']} ms")
        trace_rungs(engine, windows, (METRO_BUCKETS[0], METRO_BUCKETS[-1]),
                    {"B1": LSTM_PARTS["B1 forward"], "B3": SPMM_PARTS["B3"]}, "tiled serving")
    finally:
        engine.close()
    dense_fc = Forecaster(metro_model("dense", ds, device), state, ds.normalizer,
                          metro_config("dense"), derived, device=device)
    rows = windows[:METRO_BUCKETS[-1]]
    got, want = fc.predict(plan_dev, rows), dense_fc.predict(dense_dev, rows)
    err = np.abs(got - want).max()
    if not np.allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL):
        fail(f"tiled vs dense model on the card: max |err| {err:.3e}")
    print(f"tiled vs dense model on the card, {len(rows)} windows: max |err| {err:.3e} "
          f"(rtol {SERVE_RTOL}, atol {SERVE_ATOL}, raw units)")


def metro_train(device, ds, dense_dev, plan_dev) -> dict:
    """Phase 14: ``Trainer(model, dataset, plan)`` at the metro city, then
    its step p50, the tiled model against the dense one over CPU_STEPS
    steps from one state, and a trace of two steps. Returns the counts."""
    from stmgcn_tpu_torch import Trainer

    def trainer(mode, supports, state=None):
        t = metro_config(mode).train
        return Trainer(metro_model(mode, ds, device), ds, supports, lr=t.lr,
                       weight_decay=t.weight_decay, n_epochs=METRO_EPOCHS,
                       batch_size=METRO_BATCH, steps_per_superstep=SUPERSTEP,
                       out_dir=scratch(f"metro_{mode}"), initial_state=state,
                       device=device, verbose=False)

    tiled = trainer("tiled", plan_dev)
    state = {k: v.detach().cpu().clone() for k, v in tiled.model.state_dict().items()}
    _, counts = train_and_test(tiled, {"B1": 1, "B3": 2, "B3 shared": 1}, {"B2": 1, "B4": 1},
                               "tiled training at the metro city")
    step_times(tiled, "tiled training step at the metro city")
    agree_over_steps(trainer("tiled", plan_dev, state), trainer("dense", dense_dev, state),
                     state, "tiled vs dense training on the card")
    trace_training(tiled, {**LSTM_PARTS, **SPMM_PARTS}, "tiled training at the metro city")
    return counts


def ktuple_of(stack):
    """A one-branch ``BlockSparseStack``'s K supports as ``BlockSparse``,
    each cut to its own block-column widths: the arrays ``from_dense`` of
    that support gives (each row's nonzero blocks first, in column order,
    at one common width in the stack), without scanning the dense supports
    again."""
    S = importlib.import_module("stmgcn_tpu_torch.ops.spmm")
    out = []
    for k in range(stack.n_supports):
        c = max(int(stack.nblk[k].max()), 1)
        c_t = max(int(stack.nblk_t[k].max()), 1)
        out.append(S.BlockSparse(
            data=stack.data[k, :, :c].contiguous(), idx=stack.idx[k, :, :c].contiguous(),
            nblk=stack.nblk[k].contiguous(), data_t=stack.data_t[k, :, :c_t].contiguous(),
            idx_t=stack.idx_t[k, :, :c_t].contiguous(), nblk_t=stack.nblk_t[k].contiguous(),
            n=stack.n_rows, tile=stack.tile))
    return tuple(out)


def metro_sparse(device, ds, dense, dense_dev, plan_dev):
    """Phase 15: the block-sparse mode (per-branch ``BlockSparseStack``,
    B3/B4) and the K-tuple of ``BlockSparse`` (B5), plus the tiled plan
    with an input gradient (B4 on the shared gate signal): one forward and
    backward each against the dense model's output and input gradient.
    Returns the K-tuple run's B5 launches and the K-tuples."""
    import torch

    S = importlib.import_module("stmgcn_tpu_torch.ops.spmm")
    M, K = dense.shape[:2]
    t0 = time.perf_counter()
    host = tuple(S.stack_from_dense(dense[m]) for m in range(M))
    stacks = S.place_supports(host, device)
    t1 = time.perf_counter()
    ktuples = S.place_supports(tuple(ktuple_of(st) for st in host), device)
    t2 = time.perf_counter()
    print(f"block-sparse supports of the metro city in the original node order, host seconds: "
          f"per-branch stacks {t1 - t0:.2f} (C {[s.data.shape[2] for s in stacks]}), K-tuples "
          f"cut from them {t2 - t1:.2f} (C {[[b.block_cols_per_row for b in g] for g in ktuples]};"
          f" the arrays from_dense gives, tests/test_torch_tiling.py)")
    obs = torch.as_tensor(ds.arrays("test")[0][:METRO_BATCH], device=device)
    w = torch.randn(obs.shape[0], obs.shape[2], obs.shape[3], device=device,
                    generator=torch.Generator(device=device).manual_seed(3))

    def fwd_bwd(mode, supports):
        x = obs.clone().requires_grad_(True)
        out = metro_model(mode, ds, device)(supports, x)
        (out * w).sum().backward()
        return out.detach(), x.grad

    ref_out, ref_grad = fwd_bwd("dense", dense_dev)
    runs = {}
    for what, mode, supports, per_forward in (
            ("block-sparse stacks", "sparse", stacks,
             {"B1": 1, "B2": 1, "B3": 2 * M, "B3 shared": 2 * M, "B4": 2 * M}),
            ("K-tuples of BlockSparse", "sparse", ktuples, {"B1": 1, "B2": 1, "B5": 4 * M * K}),
            ("tiled plan with an input gradient", "tiled", plan_dev,
             {"B1": 1, "B2": 1, "B3": 2, "B3 shared": 1, "B4": 2})):
        reset_counts()
        out, grad = fwd_bwd(mode, supports)
        counts = read_counts()
        check_counts(counts, per_forward, {}, 1, 0, what)
        out_err = (out - ref_out).abs().max().item()
        if not torch.allclose(out, ref_out, rtol=MODEL_RTOL, atol=MODEL_ATOL):
            fail(f"{what}: output max |err| {out_err:.3e} vs the dense model")
        rel = ((grad - ref_grad).norm() / ref_grad.norm()).item()
        if not rel <= GRAD_RTOL:
            fail(f"{what}: input gradient differs by {rel:.3e} of its norm (rtol {GRAD_RTOL})")
        print(f"{what} at the metro city, one forward + backward (batch {METRO_BATCH}): output "
              f"max |err| {out_err:.3e} (rtol {MODEL_RTOL}, atol {MODEL_ATOL}), input gradient "
              f"within {rel:.3e} of its norm (rtol {GRAD_RTOL}; max |err| "
              f"{(grad - ref_grad).abs().max().item():.3e} of max "
              f"{ref_grad.abs().max().item():.3e}) vs the dense model; launches "
              f"{counts_text(counts)}")
        runs[what] = counts
    return runs["K-tuples of BlockSparse"]["B5"], ktuples


# -- bf16: the kernels' bf16 forms, mixed-precision training, bf16 serving ------

def bf16_bounds(flops: float, n_bytes: float) -> dict:
    """A bf16 form's bound (ms): its products at the bf16 tensor-core peak
    or its bytes over the HBM rate, the larger."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def bf16_bounds_text(bound: dict, flops: float, n_bytes: float, ms: float) -> str:
    return (f"bound (bf16 tensor cores at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, or bytes) "
            f"{bound['bound_ms']:.4f} ({bound['bound_by']}; {flops / 1e9:.2f} GFLOP, "
            f"{n_bytes / 1e6:.1f} MB) = {bound['bound_ms'] / ms:.3f} of the kernel's time")


def bf16_err(got, want, what: str) -> float:
    """Elementwise within BF16_RTOL plus BF16_ATOL_REL of the largest
    |want|, after both are taken to float32; returns max |got - want|."""
    import torch

    err = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{what}: shape {tuple(a.shape)} vs {tuple(b.shape)} or non-finite")
        scale = b.abs().max().item()
        err = max(err, (a - b).abs().max().item())
        if not torch.allclose(a, b, rtol=BF16_RTOL, atol=BF16_ATOL_REL * scale):
            fail(f"{what}: max |err| {err:.3e} over rtol {BF16_RTOL} + {BF16_ATOL_REL} x "
                 f"{scale:.3e}")
    return err


def bf16_wgrad_err(got, want, what: str) -> float:
    """Weight gradients normwise: |got - want| <= BF16_WGRAD_NORM |want|."""
    import torch

    worst = 0.0
    for name, a, b in zip(("dwh0", "dwxh", "db"), got, want):
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{what} {name}: shape {tuple(a.shape)} vs {tuple(b.shape)} or non-finite")
        rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        if rel > BF16_WGRAD_NORM:
            fail(f"{what} {name}: normwise error {rel:.3e} over {BF16_WGRAD_NORM}")
        worst = max(worst, rel)
    return worst


def bf16_record(name, source, replaces, err, ms, plain_ms, library_ms, bound) -> dict:
    return {"name": name, "dtype": "bfloat16", "route": "cuda", "source": source,
            "replaces": replaces, "launches": None,  # filled from the bf16 main path's run
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound,
            "library_ms": library_ms}


def bf16_lstm_case(M, R, T, L, H, device, seed):
    """Phase 3/4's operands and cotangents in bf16 (round to nearest even)."""
    import torch

    (x, wx0, b0), ops = lstm_bwd_case(M, R, T, L, H, device, seed)
    xp, wh, wx, b, _, _, g_out, g_hfin, g_cfin = ops
    bf = [t.to(torch.bfloat16).contiguous() for t in (xp, wh, wx, b)]
    from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm

    hseq, cseq = fused_lstm(*bf, with_residuals=True)[3:]
    cots = [t.to(torch.bfloat16) for t in (g_out, g_hfin, g_cfin)]
    return (x, wx0, b0), bf, (*bf, hseq, cseq, *cots)


def check_lstm_kernels_bf16(device) -> list:
    """Phase 19: B1 and B2 in bf16 against their plain bf16 versions on the
    card at the main path's shape (M=3 x 16,384 rows, T=12, L=3, H=64),
    with residuals on and off, a ragged row count and every (H, L) the
    kernels take; B2 twice bitwise equal; then CUDA-event times of kernel,
    plain version and cuDNN's ``nn.LSTM`` in bf16, beside the bf16 bound.
    Returns B1's and B2's bf16 records."""
    import torch

    from stmgcn_tpu_torch.ops.fused_lstm import (
        KERNEL_HIDDEN,
        KERNEL_MAX_LAYERS,
        fused_lstm,
        fused_lstm_bwd,
        fused_lstm_bwd_reference,
        fused_lstm_reference,
    )

    M, R, T, L, H = 3, BATCH * GRID * GRID, SERIAL + 2, 3, 64
    (x, wx0, b0), bf, case = bf16_lstm_case(M, R, T, L, H, device, seed=30)
    fwd_err = 0.0
    for res in (False, True):
        got = fused_lstm(*bf, with_residuals=res)
        if any(t.dtype != torch.bfloat16 for t in got):
            fail("fused_lstm in bf16 returned another dtype")
        fwd_err = max(fwd_err, bf16_err(got, fused_lstm_reference(*bf, with_residuals=res),
                                        f"bf16 fused_lstm M={M} R={R} residuals={res}"))
        del got
    got = fused_lstm_bwd(*case)
    want = fused_lstm_bwd_reference(*case)
    bwd_err = bf16_err(got[:1], want[:1], f"bf16 fused_lstm_bwd M={M} R={R} dxp")
    wg = bf16_wgrad_err(got[1:], want[1:], f"bf16 fused_lstm_bwd M={M} R={R}")
    again = fused_lstm_bwd(*case)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("bf16 fused_lstm_bwd: two runs on the same inputs differ")
    del got, want, again
    sweep_f = sweep_b = 0.0
    for h in KERNEL_HIDDEN:
        for layers in range(1, KERNEL_MAX_LAYERS + 1):
            for rows in (77, 1000) if (h, layers) == (64, 3) else (77,):
                _, ops, c = bf16_lstm_case(2, rows, 5, layers, h, device, seed=h + layers + rows)
                sweep_f = max(sweep_f, bf16_err(fused_lstm(*ops, with_residuals=True),
                                                fused_lstm_reference(*ops, with_residuals=True),
                                                f"bf16 fused_lstm H={h} L={layers} R={rows}"))
                g, w = fused_lstm_bwd(*c), fused_lstm_bwd_reference(*c)
                sweep_b = max(sweep_b, bf16_err(g[:1], w[:1],
                                                f"bf16 fused_lstm_bwd H={h} L={layers} R={rows}"))
                wg = max(wg, bf16_wgrad_err(g[1:], w[1:], f"bf16 fused_lstm_bwd H={h} L={layers}"))
    print(f"bf16 fused_lstm vs plain bf16: max |err| {max(fwd_err, sweep_f):.3e}; bf16 "
          f"fused_lstm_bwd dxp max |err| {max(bwd_err, sweep_b):.3e}, weight gradients "
          f"normwise {wg:.3e} (elementwise rtol {BF16_RTOL} + {BF16_ATOL_REL} x max |want|; "
          f"normwise {BF16_WGRAD_NORM}); two backward runs bitwise equal; at M={M} R={R} T={T} "
          f"L={L} H={H}, ragged R=1000 and H in {KERNEL_HIDDEN} x L in 1..{KERNEL_MAX_LAYERS} "
          "(M=2, R=77, T=5)")

    cudnn = [lstm.to(torch.bfloat16) for lstm in cudnn_lstms(wx0, b0, case[1].float(),
                                                           case[2].float(), case[3].float())]
    xb = x.to(torch.bfloat16)
    with torch.no_grad():
        ms = cuda_ms(lambda: fused_lstm(*bf), iters=20)
        plain_ms = cuda_ms(lambda: fused_lstm_reference(*bf), iters=5)
        library_ms = cuda_ms(lambda: [cudnn[m](xb[m]) for m in range(M)], iters=5)
    flops = M * R * T * (2 * H * 4 * H + (L - 1) * 2 * (2 * H) * (4 * H))
    n_bytes = 2 * (sum(t.numel() for t in bf) + M * R * T * H + 2 * M * L * R * H)
    bound = bf16_bounds(flops, n_bytes)
    print(f"bf16 fused_lstm times (ms, CUDA events, mean): kernel {ms:.4f}, plain {plain_ms:.4f}, "
          f"cuDNN bf16 x{M} {library_ms:.4f}; {bf16_bounds_text(bound, flops, n_bytes, ms)}")
    records = [bf16_record("fused_lstm_fwd", "stmgcn_tpu_torch/csrc/fused_lstm_fwd.cu",
                           "stmgcn_tpu/ops/pallas_lstm.py:172", max(fwd_err, sweep_f), ms,
                           plain_ms, library_ms, bound)]

    ms = cuda_ms(lambda: fused_lstm_bwd(*case), iters=10)
    plain_ms = cuda_ms(lambda: fused_lstm_bwd_reference(*case), iters=3)
    xs = [xb[m].clone().requires_grad_(True) for m in range(M)]
    params = [p for lstm in cudnn for p in lstm.parameters()]
    g_out, g_hfin, g_cfin = case[6:]

    def library():
        outs, grads = [], []
        for m in range(M):
            out, (h_n, c_n) = cudnn[m](xs[m])
            outs += [out, h_n, c_n]
            grads += [g_out[m], g_hfin[m], g_cfin[m]]
        torch.autograd.grad(outs, xs + params, grads)

    def ours():
        res = fused_lstm(*bf, with_residuals=True)
        fused_lstm_bwd(*bf, res[3], res[4], g_out, g_hfin, g_cfin)

    fwd_bwd_ms = cuda_ms(ours, iters=10)
    library_ms = cuda_ms(library, iters=5)
    flops = 3 * flops
    n_bytes = (2 * (sum(t.numel() for t in case) + bf[0].numel())
               + 4 * sum(t.numel() for t in bf[1:]))  # dxp in bf16, weight grads fp32
    bound = bf16_bounds(flops, n_bytes)
    print(f"bf16 fused_lstm_bwd times (ms, CUDA events, mean): kernel {ms:.4f}, plain "
          f"{plain_ms:.4f}; forward with residuals + backward kernels {fwd_bwd_ms:.4f} vs cuDNN "
          f"bf16 forward + backward x{M} {library_ms:.4f}; "
          f"{bf16_bounds_text(bound, flops, n_bytes, ms)}")
    records.append(bf16_record("fused_lstm_bwd", "stmgcn_tpu_torch/csrc/fused_lstm_bwd.cu",
                               "stmgcn_tpu/ops/pallas_lstm.py:212", max(bwd_err, sweep_b), ms,
                               plain_ms, library_ms, bound))
    records[-1]["fwd_bwd_ms"] = fwd_bwd_ms
    return records


def check_lstm_route_bf16(device) -> None:
    """Phase 19, route: the kernel route at a bf16 compute dtype where the
    kernels do not take the shape directly, H=48 (padded to 64) with L=3 and
    H=64 with L=5 (two groups), at M=3 x 2,048 rows and T=12: the card's
    kernels against the CPU's plain versions on the same weights, input and
    cotangent, ceil(L/4) launches each way; outputs elementwise at the bf16
    kernels' tolerance, every gradient normwise at BF16_WGRAD_NORM."""
    import torch

    from stmgcn_tpu_torch.ops.fused_lstm import KERNEL_MAX_LAYERS
    from stmgcn_tpu_torch.ops.lstm import StackedLSTM

    M, R, T = 3, 2048, SERIAL + 2
    for H, L in ROUTE_SHAPES[1:]:
        groups, runs = -(-L // KERNEL_MAX_LAYERS), {}
        for dev in (device, torch.device("cpu")):
            lstm = StackedLSTM(1, H, L, branches=M, device=dev, backend="pallas",
                               generator=torch.Generator().manual_seed(H + L))
            lstm.compute_dtype = torch.bfloat16
            g = torch.Generator().manual_seed(H * L)
            x = (torch.randn(M, R, T, 1, generator=g) * 2.0).to(dev).requires_grad_(True)
            g_out = torch.randn(M, R, T, H, generator=g).to(dev)
            reset_counts()
            out, _ = lstm(x)
            (out.float() * g_out).sum().backward()
            if dev.type == "cuda":
                counts = read_counts()
            runs[dev.type] = (out.detach().cpu(),
                              [x.grad.cpu()] + [p.grad.cpu() for p in lstm.parameters()])
        if (counts["B1"], counts["B2"]) != (groups, groups):
            fail(f"bf16 LSTM route H={H} L={L}: {counts['B1']} forward and {counts['B2']} "
                 f"backward launches, expected {groups} each")
        err = bf16_err([runs["cuda"][0]], [runs["cpu"][0]], f"bf16 LSTM route H={H} L={L}")
        worst = 0.0
        for a, b in zip(runs["cuda"][1], runs["cpu"][1]):
            rel = ((a - b).norm() / b.norm()).item()
            if not rel <= BF16_WGRAD_NORM:
                fail(f"bf16 LSTM route H={H} L={L}: a gradient differs by {rel:.3e} of its norm")
            worst = max(worst, rel)
        print(f"bf16 LSTM route H={H} L={L} ({groups} group(s)), card vs CPU plain versions at "
              f"M={M} R={R} T={T}: output max |err| {err:.3e}, gradients (input and every "
              f"parameter) within {worst:.3e} of their norms ({BF16_WGRAD_NORM}); launches B1 "
              f"{counts['B1']}, B2 {counts['B2']}")


def bf16_config(batch: int, out_dir: str, *, dtype: str = "float32"):
    """The flagship at the bench point, trained at ``precision="bf16"``."""
    cfg = flagship_config(batch)
    cfg.train.precision, cfg.model.dtype, cfg.train.out_dir = "bf16", dtype, out_dir
    return cfg


def steps_checking_grads(trainer, batches) -> tuple:
    """One optimizer step per batch; returns the losses and, per step,
    whether every gradient it left behind is finite and nonzero."""
    losses, seen = [], []
    for b in batches:
        losses.append(trainer.train_batch(b).item())
        seen.append(all(grads_ok(trainer).values()))
    return losses, seen


def bf16_training(device) -> dict:
    """Phase 20: the dense flagship at ``precision="bf16"``. A twin drill:
    fp32 and bf16 trainers from one initial state take TWIN_STEPS steps on
    the same batches, every bf16 loss within TWIN_ATOL of the fp32 one,
    every loss and gradient finite, the parameters float32 masters; their
    step p50s in this call and a trace of two bf16 steps; then ``train()``
    (two epochs) and ``test()`` of
    the bf16 trainer with its launches counted (B1 per forward, B2 per
    step); then an ``sr_seed`` run of a few steps, finite and equal to a
    second run of the same seed. Returns the bf16 run's launch counts."""
    import torch

    from stmgcn_tpu_torch import build_trainer

    t32 = build_trainer(flagship_config(BATCH), device=device, verbose=False)
    state = {k: v.detach().cpu().clone() for k, v in t32.model.state_dict().items()}
    t16 = build_trainer(bf16_config(BATCH, scratch("bf16_twin")), device=device,
                        initial_state=state, verbose=False)
    batches = list(t32.batches("train"))[:TWIN_STEPS]
    l32 = [t32.train_batch(b).item() for b in batches]
    l16, seen = steps_checking_grads(t16, batches)
    gap = max(abs(a - b) for a, b in zip(l16, l32))
    if not all(math.isfinite(v) for v in l16) or not all(seen):
        fail(f"bf16 twin drill: non-finite losses {l16} or gradients at steps "
             f"{[i for i, ok in enumerate(seen) if not ok]}")
    if gap > TWIN_ATOL:
        fail(f"bf16 twin drill: losses {l16} vs fp32 {l32}, gap {gap:.3e} over {TWIN_ATOL}")
    dtypes = {p.dtype for p in t16.model.parameters()}
    if dtypes != {torch.float32}:
        fail(f"bf16 training left parameters in {dtypes}")
    print(f"bf16 twin drill ({TWIN_STEPS} steps, batch {BATCH}, one initial state): bf16 losses "
          f"{[f'{v:.6g}' for v in l16]} vs fp32 {[f'{v:.6g}' for v in l32]}, max gap {gap:.3e} "
          f"(band {TWIN_ATOL}); 0 non-finite losses and gradients; parameters {dtypes}")
    step_times(t32, "training step, fp32 (same call)")
    step_times(t16, "training step, bf16")
    trace_training(t16, LSTM_PARTS, "bf16 dense training")
    del t32, t16
    torch.cuda.empty_cache()

    trainer = build_trainer(bf16_config(BATCH, scratch("bf16_train")), device=device)
    _, counts = train_and_test(trainer, {"B1": 1}, {"B2": 1}, "bf16 dense training")
    del trainer

    runs = []
    for _ in range(2):
        cfg = bf16_config(BATCH, scratch("bf16_sr"))
        cfg.train.sr_seed = SR_SEED
        sr = build_trainer(cfg, device=device, initial_state=state, verbose=False)
        runs.append([sr.train_batch(b).item() for b in batches[:SR_STEPS]])
        del sr
    if runs[0] != runs[1] or not all(math.isfinite(v) for v in runs[0]):
        fail(f"sr_seed runs: {runs[0]} vs {runs[1]} (must be finite and equal)")
    gap = max(abs(a - b) for a, b in zip(runs[0], l16))
    print(f"sr_seed={SR_SEED} bf16 run, {SR_STEPS} steps: losses {runs[0]} (a second run of the "
          f"seed equal bitwise); max gap to round-to-nearest bf16 {gap:.3e}")
    torch.cuda.empty_cache()
    return counts


def bf16_gap(got, want) -> tuple:
    """``(max |got - want| / max |want|, ||got - want|| / ||want||)``: the
    two readings the bf16 serving limits hold."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (float(np.abs(got - want).max() / np.abs(want).max()),
            float(np.linalg.norm(got - want) / np.linalg.norm(want)))


def gap_text(gap) -> str:
    return (f"max |err| {gap[0]:.3e} of max |want| (limit {BF16_SERVE_MAX}), ||err|| "
            f"{gap[1]:.3e} of ||want|| (limit {BF16_SERVE_NORM})")


def bf16_check(got, want, what: str, control=None) -> str:
    """Fail unless ``got`` is within the bf16 serving limits of ``want``;
    with ``control`` (the fp32 model's prediction from the same weights and
    rows), fail too unless the limits reject it. Returns the readings."""
    gap = bf16_gap(got, want)
    text = gap_text(gap)
    within = gap[0] <= BF16_SERVE_MAX and gap[1] <= BF16_SERVE_NORM
    if control is not None:
        cgap = bf16_gap(control, want)
        text += f"; the fp32 control: {gap_text(cgap)}"
        if cgap[0] <= BF16_SERVE_MAX and cgap[1] <= BF16_SERVE_NORM:
            fail(f"{what}: the bf16 limits do not reject the fp32 control: {text}")
    if not within:
        fail(f"{what}: {text}")
    return text


def tapped(fc, supports, rows, city) -> tuple:
    """``fc.predict(supports, rows, city=city)`` with hooks on the model:
    ``(raw forecasts, the head's float32 output (the last value before the
    serve boundary's cast to the compute dtype), the model's output)``,
    the last two on the host."""
    import torch

    taps = {"head": [], "out": []}
    hooks = [fc.model.head.register_forward_hook(
                 lambda m, a, o: taps["head"].append(o.float().cpu())),
             fc.model.register_forward_hook(lambda m, a, o: taps["out"].append(o.cpu()))]
    try:
        raw = fc.predict(supports, rows, city=city)
    finally:
        for h in hooks:
            h.remove()
    return raw, torch.cat(taps["head"]).numpy(), torch.cat(taps["out"])


def bf16_steps(a, b):
    """How many bf16 values lie between bf16 tensors ``a`` and ``b``,
    elementwise (0: equal; 1: neighbours)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def rung_p50(snapshot) -> str:
    return ", ".join(f"rung {b} {s['device_ms']['p50']} ms" for b, s in snapshot["buckets"].items())


def bf16_engines(device, fc32, fc16, supports, windows, buckets, sizes, rounds, what,
                 per_forward, parts):
    """The same requests through an fp32 and a bf16 engine over one set of
    weights: every bf16 response finite and equal to the bf16 Forecaster
    (BF16_SERVE_MAX, BF16_SERVE_NORM), B1/B3 launches per bf16 forward as
    ``per_forward``, each rung's p50 dispatch beside fp32's, and a trace of
    the bf16 engine's smallest and largest rung (``parts``: the kernels'
    shares)."""
    from stmgcn_tpu_torch import ServingConfig

    config = ServingConfig(buckets=buckets, max_batch=buckets[-1])
    snaps, worst = {}, (0.0, 0.0)
    for name, fc in (("fp32", fc32), ("bf16", fc16)):
        engine = fc.serving_engine(supports, config=config, device=device)
        try:
            for b in buckets:
                engine.predict_direct(windows[:b])
            engine.stats.reset()
            reset_counts()
            calls = 0
            for r in range(rounds):
                for n in sizes:
                    got = engine.predict(windows[r:r + n])
                    if name == "bf16":
                        want = fc.predict(supports, windows[r:r + n])
                        calls += 1
                        if got.dtype != np.float32 or not np.isfinite(got).all():
                            fail(f"{what} bf16 predict({n}): {got.dtype}, finite "
                                 f"{np.isfinite(got).all()}")
                        bf16_check(got, want, f"{what} bf16 predict({n}), engine vs "
                                   "Forecaster")
                        worst = tuple(map(max, worst, bf16_gap(got, want)))
            counts = read_counts()
            snaps[name] = engine.stats.snapshot()
            if name == "bf16":
                check_counts(counts, per_forward, {},
                             snaps[name]["totals"]["dispatches"] + calls, 0, f"{what} bf16")
                trace_rungs(engine, windows, (buckets[0], buckets[-1]), parts, what)
        finally:
            engine.close()
    print(f"{what}: bf16 engine vs bf16 Forecaster.predict, requests of {sizes} rows x {rounds} "
          f"rounds: at worst {gap_text(worst)}; launches per bf16 forward "
          f"{counts_text(per_forward)}")
    print(f"{what}, p50 dispatch per rung (ms, host clock, same requests, same call): bf16 "
          f"{rung_p50(snaps['bf16'])}; fp32 {rung_p50(snaps['fp32'])}")


def bf16_serve_dense(device) -> None:
    """Phase 21: the dense flagship served in bf16 (``model.dtype=
    "bfloat16"``): engine vs Forecaster, per-rung p50 beside fp32, and a
    bucket-4 batch on the card against the CPU port at bf16 (its plain
    versions)."""
    import torch

    from stmgcn_tpu_torch import Forecaster
    from stmgcn_tpu_torch.experiment import build_dataset, build_model, build_supports

    cfg = pallas_preset("default")
    cfg.data.rows, cfg.data.serial_len = GRID, SERIAL
    ds = build_dataset(cfg)
    supports = build_supports(cfg, ds)
    derived = {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}
    model = build_model(cfg, ds.n_feats, device=device, generator=torch.Generator().manual_seed(0))
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    fc32 = Forecaster(model, state, ds.normalizer, cfg, derived, device=device)
    cfg16 = pallas_preset("default")
    cfg16.data.rows, cfg16.data.serial_len, cfg16.model.dtype = GRID, SERIAL, "bfloat16"
    fc16 = Forecaster(build_model(cfg16, ds.n_feats, device=device), state, ds.normalizer,
                      cfg16, derived, device=device)
    windows = ds.denormalize(ds.arrays("test")[0])
    bf16_engines(device, fc32, fc16, supports, windows, BUCKETS, SIZES, ROUNDS,
                 "bf16 dense serving", {"B1": 1}, {"B1": LSTM_PARTS["B1 forward"]})
    cpu = Forecaster(build_model(cfg16, ds.n_feats, device="cpu"), state, ds.normalizer, cfg16,
                     derived, device="cpu")
    rows = windows[:4]
    got, want = fc16.predict(supports, rows), cpu.predict(supports, rows)
    text = bf16_check(got, want, "bf16 dense serving, card vs CPU",
                      control=fc32.predict(supports, rows))
    print(f"bf16 dense serving, a bucket-4 batch, card vs CPU port at bf16 (max |want| "
          f"{np.abs(want).max():.4e} raw units): {text}")


def bf16_checkpoints(device, root: str) -> dict:
    """Phase 22: a bf16 model (``model.dtype="bfloat16"``, ``precision=
    "bf16"``) trains two epochs writing checkpoints, a mid-epoch ``latest``
    every CKPT_EVERY steps: the meta says bf16, the payload is float32
    masters; a second trainer restores the first mid-epoch file and must end
    with the first run's losses and parameters exactly; an fp32 trainer
    restores the bf16 file (precision is provenance); and
    ``Forecaster.from_checkpoint(best.ckpt)`` serves in bf16, equal to the
    trainer's evaluation. Returns the launch counts of the first run."""
    import torch

    from stmgcn_tpu_torch import Forecaster, build_trainer
    from stmgcn_tpu_torch.models import from_jax_params
    from stmgcn_tpu_torch.train.checkpoint import load_checkpoint, write_checkpoint_bytes

    def config(name):
        cfg = bf16_config(BATCH, os.path.join(root, name), dtype="bfloat16")
        cfg.train.checkpoint_every_steps = CKPT_EVERY
        return cfg

    a = build_trainer(config("a"), device=device, verbose=False)
    mid, kept, save = os.path.join(root, "mid_epoch.ckpt"), [], a._save

    def save_and_keep(path):
        data = save(path)
        if path == a.latest_path and a._batch_in_epoch and not kept:
            kept.append(a._batch_in_epoch)
            write_checkpoint_bytes(mid, data)
        return data

    a._save = save_and_keep
    history, counts = train_and_test(a, {"B1": 1}, {"B2": 1}, "bf16 checkpointed training")
    a._save = save
    meta, params, _ = load_checkpoint(a.latest_path)
    leaves = {str(np.asarray(v).dtype) for v in _leaves(params)}
    if meta.get("precision") != "bf16" or leaves != {"float32"} or not kept:
        fail(f"bf16 checkpoint: meta precision {meta.get('precision')}, payload {leaves}, "
             f"mid-epoch file {bool(kept)}")
    b = build_trainer(config("b"), device=device, verbose=False)
    meta = b.restore(mid)
    resumed = b.train()
    same = all(torch.equal(v, a.model.state_dict()[k]) for k, v in b.model.state_dict().items())
    if resumed != history or not same:
        fail(f"bf16 mid-epoch resume: history {resumed} vs {history}, parameters equal {same}")
    c = build_trainer(flagship_config(BATCH), device=device, verbose=False)
    c.restore(a.latest_path)
    if not all(torch.equal(v, a.model.state_dict()[k]) for k, v in c.model.state_dict().items()):
        fail("an fp32 trainer did not restore the bf16 run's masters exactly")
    fc = Forecaster.from_checkpoint(a.best_path, device=device)
    if fc.model.compute_dtype != torch.bfloat16:
        fail(f"Forecaster.from_checkpoint of a bf16 model serves in {fc.model.compute_dtype}")
    ds = a.dataset
    windows = ds.denormalize(ds.arrays("test")[0])
    best = {k: v.to(device) for k, v in from_jax_params(
        load_checkpoint(a.best_path, load_opt_state=False)[1], a.model.m_graphs).items()}
    evaluated = ds.denormalize(a._predict_mode("test", best)[0][0])  # city 0: (pred, true)
    got = fc.predict(a.supports.cpu().numpy(), windows[:BUCKETS[-1]])
    text = bf16_check(got, evaluated[:BUCKETS[-1]],
                      "bf16 best.ckpt served vs the trainer's evaluation")
    print(f"bf16 checkpoints: meta precision bf16, float32 masters; the resume from the "
          f"mid-epoch latest.ckpt (epoch {meta['epoch']}, {meta['batch_in_epoch']} batches in) "
          f"ends with the uninterrupted run's losses and parameters exactly; an fp32 trainer "
          f"restores the file exactly; Forecaster.from_checkpoint(best.ckpt) serves in bf16, "
          f"{BUCKETS[-1]} windows against the trainer's evaluation: {text}")
    return counts


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def check_spmm_kernels_bf16(device, dense, dense_dev, plan) -> list:
    """Phase 23: B3, B4 and B5 in bf16 against their plain versions on the
    card at the metro plan (bf16 blocks, signals and B4's cotangent,
    float32 out), B4 twice bitwise equal; a float32 cotangent that bf16
    cannot hold, through autograd, gives the gradient of its bf16 rounding,
    as on the CPU; each timed beside its bf16 bound, its plain
    version and the bf16 cuBLAS product with an fp32 result over the same
    supports. Returns the bf16 records of B3 (graph conv), B4, B5 and B3
    (gate conv)."""
    import torch

    S = importlib.import_module("stmgcn_tpu_torch.ops.spmm")
    bf = torch.bfloat16
    M, K, N, t = plan.m_graphs, plan.n_supports, plan.n, plan.tile
    T, H, B = METRO_SERIAL + 2, 64, METRO_BATCH
    gen = torch.Generator(device=device).manual_seed(23)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(bf)

    stack = plan.as_stack().to(device).astype(bf)
    x_gate, x_gcn = randn(N, B * T), randn(M, N, B * H)
    err3 = err4 = 0.0
    for what, x in (("gate conv, shared x", x_gate), ("graph conv, per-branch x", x_gcn),
                    ("graph conv, rung 4", randn(M, N, 4 * H))):
        shared = x.dim() == 2
        got = S.spmm_stack(stack, x)
        err3 = max(err3, spmm_err(got, S.spmm_stack_reference(stack, x), f"bf16 B3 {what}"))
        g = randn(*got.shape)
        dx, again = S.spmm_stack_bwd(stack, g, shared=shared), S.spmm_stack_bwd(stack, g,
                                                                              shared=shared)
        torch.cuda.synchronize()
        if not torch.equal(dx, again):
            fail(f"bf16 B4 {what}: two runs differ")
        err4 = max(err4, spmm_err(dx, S.spmm_stack_bwd_reference(stack, g, shared=shared),
                                  f"bf16 B4 {what}"))
        del got, g, dx, again
    bs = S.from_dense(dense[0, 2], tile=METRO_TILE).to(device).astype(bf)  # T_2, spatial
    x5 = randn(N, B * H)
    err5 = max(spmm_err(S.block_spmm(bs, x5), S.spmm_reference(bs, x5), "bf16 B5"),
               spmm_err(S.block_spmm(bs, x5, transpose=True),
                        S.spmm_reference(bs, x5, transpose=True), "bf16 B5 transposed"))
    # autograd casts a float32 cotangent to the signal's bf16 before B4, on
    # either device: the card's gradient is the plain B4 of the rounded one
    xg = x_gate.clone().requires_grad_(True)
    out = S.spmm_stack(stack, xg)
    cot = torch.randn(out.shape, generator=gen, device=device)
    out.backward(cot)
    want = S.spmm_stack_bwd_reference(stack, cot.to(bf), shared=True)
    cot_err = spmm_err(xg.grad.float(), want.to(bf).float(), "bf16 B4 of a float32 cotangent",
                       rtol=2.0**-7, atol=2.0**-7)
    del xg, out, cot, want
    print(f"bf16 B3 vs plain: max |err| {err3:.3e}; bf16 B4 vs plain: max |err| {err4:.3e}, two "
          f"runs bitwise equal; bf16 B5 (and its transpose) vs plain: max |err| {err5:.3e} "
          f"(rtol {SPMM_RTOL} + {SPMM_ATOL} x max |want|: exact bf16 products, fp32 sums); a "
          f"float32 cotangent through autograd: the bf16 gradient within {cot_err:.3e} of plain "
          f"B4 on its bf16 rounding (rtol 2^-7 + 2^-7 x max |want|: one bf16 rounding)")

    g_gcn = randn(M, K, N, B * H)
    perm = plan.perm.to(device).long()
    dense_p = dense_dev.index_select(2, perm).index_select(3, perm).to(bf)  # the plan's order
    with torch.no_grad():
        gate = (cuda_ms(lambda: S.spmm_stack(stack, x_gate), 20),
                cuda_ms(lambda: S.spmm_stack_reference(stack, x_gate), 5),
                cuda_ms(lambda: bf16_library_mm(dense_p.flatten(0, 1), x_gate), 5))
        fwd = (cuda_ms(lambda: S.spmm_stack(stack, x_gcn), 20),
               cuda_ms(lambda: S.spmm_stack_reference(stack, x_gcn), 5),
               cuda_ms(lambda: bf16_library_mm(dense_p, x_gcn), 5))
        bwd = (cuda_ms(lambda: S.spmm_stack_bwd(stack, g_gcn, shared=False), 20),
               cuda_ms(lambda: S.spmm_stack_bwd_reference(stack, g_gcn, shared=False), 5),
               cuda_ms(lambda: bf16_library_mm(dense_p.transpose(-1, -2), g_gcn)
                       .view(M, K, N, -1).sum(1), 5))
        a5 = dense_dev[0, 2].to(bf)
        one = (cuda_ms(lambda: S.block_spmm(bs, x5), 20),
               cuda_ms(lambda: S.spmm_reference(bs, x5), 5),
               cuda_ms(lambda: bf16_library_mm(a5, x5), 10))
    del dense_p
    b_gate = spmm_bf16_bound(stack.nblk, stack.idx, t, B * T, 2 * N * B * T, M * K * N * B * T)
    b_fwd = spmm_bf16_bound(stack.nblk, stack.idx, t, B * H, 2 * M * N * B * H,
                            M * K * N * B * H)
    b_bwd = spmm_bf16_bound(stack.nblk_t, stack.idx_t, t, B * H, 2 * M * K * N * B * H,
                            M * N * B * H)
    b_one = spmm_bf16_bound(bs.nblk, bs.idx, t, B * H, 2 * N * B * H, N * B * H)
    for what, (ms, plain, lib), (b, flops, n_bytes) in (
            ("bf16 B3 gate conv (shared x, F=10)", gate, b_gate),
            ("bf16 B3 graph conv (per-branch x, F=128)", fwd, b_fwd),
            ("bf16 B4 graph-conv backward (F=128)", bwd, b_bwd),
            (f"bf16 B5 one support (C={bs.block_cols_per_row}, F=128)", one, b_one)):
        print(f"{what} at the metro city, batch 2 (ms, CUDA events, mean): kernel {ms:.4f}, plain "
              f"{plain:.4f}, dense cuBLAS bf16 {lib:.4f}; "
              f"{bf16_bounds_text(b, flops, n_bytes, ms)}")
    src = "stmgcn_tpu_torch/csrc/spmm_stack.cu"
    return [
        bf16_record("spmm_stack_fwd", src, "stmgcn_tpu/ops/spmm.py:339", err3, *fwd, b_fwd[0]),
        bf16_record("spmm_stack_bwd", src, "stmgcn_tpu/ops/spmm.py:379", err4, *bwd, b_bwd[0]),
        bf16_record("spmm", src, "stmgcn_tpu/ops/spmm.py:125", err5, *one, b_one[0]),
        bf16_record("spmm_stack_fwd_gate", src, "stmgcn_tpu/ops/spmm.py:339", err3, *gate,
                    b_gate[0]),
    ]


def spmm_bf16_bound(nblk, idx, tile: int, F: int, src_bytes: int, out_elems: int):
    """``(bounds, FLOPs, bytes)`` of one bf16 block-CSR product over the
    real blocks the counts name: each read once (2 bytes a value) and
    multiplied once, the count and index arrays, the signal read once
    (``src_bytes``, 2 a value) and the fp32 output written once."""
    nz = int(nblk.sum().item())
    flops = 2 * nz * tile * tile * F
    n_bytes = 2 * nz * tile * tile + 4 * (idx.numel() + nblk.numel() + out_elems) + src_bytes
    return bf16_bounds(flops, n_bytes), flops, n_bytes


def bf16_library_mm(a, b):
    """The library yardstick: ``a @ b`` on bf16 operands through cuBLAS
    with an fp32 result (``out_dtype``), batched over leading axes."""
    import torch

    if a.dim() == 2 and b.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    a3 = a.reshape(-1, *a.shape[-2:])
    b3 = b.reshape(-1, *b.shape[-2:]) if b.dim() > 2 else b.expand(a3.shape[0], *b.shape)
    if b3.shape[0] != a3.shape[0]:  # per-branch signal against M x K supports
        b3 = b3.repeat_interleave(a3.shape[0] // b3.shape[0], dim=0)
    return torch.bmm(a3, b3, out_dtype=torch.float32)


def bf16_metro(device, ds, plan_dev, dense_dev) -> dict:
    """Phase 24: the metro city in bf16 on the tiled plan: an fp32 and a
    bf16 engine over one set of weights (ladder 1, 2, 4), bf16 responses
    equal to the bf16 Forecaster, per-rung p50 beside fp32; one window on
    the card against the CPU port at bf16; then METRO_BF16_STEPS steps of
    ``precision="bf16"`` tiled training, finite, with B1, B2, B3 (two, one
    shared) and B4 launched per step, its step p50 and a trace of two
    steps. Returns that run's counts."""
    from stmgcn_tpu_torch import Forecaster, Trainer

    model = metro_model("tiled", ds, device)
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    derived = {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}
    cfg16 = metro_config("tiled")
    cfg16.model.dtype = "bfloat16"
    from stmgcn_tpu_torch.experiment import build_model

    fc32 = Forecaster(model, state, ds.normalizer, metro_config("tiled"), derived, device=device)
    fc16 = Forecaster(build_model(cfg16, ds.n_feats, device=device), state, ds.normalizer, cfg16,
                      derived, device=device)
    windows = ds.denormalize(ds.arrays("test")[0])
    bf16_engines(device, fc32, fc16, plan_dev, windows, METRO_BUCKETS, METRO_SIZES, METRO_ROUNDS,
                 "bf16 tiled serving at the metro city", {"B1": 1, "B3": 2, "B3 shared": 1},
                 {"B1": LSTM_PARTS["B1 forward"], "B3": SPMM_PARTS["B3"]})
    plan_cpu = plan_dev.to("cpu")
    cpu = Forecaster(build_model(cfg16, ds.n_feats, device="cpu"), state, ds.normalizer, cfg16,
                     derived, device="cpu")
    got, want = fc16.predict(plan_dev, windows[:1]), cpu.predict(plan_cpu, windows[:1])
    text = bf16_check(got, want, "bf16 tiled serving, card vs CPU",
                      control=fc32.predict(plan_dev, windows[:1]))
    print(f"bf16 tiled serving at the metro city, one window, card vs CPU port at bf16 (max "
          f"|want| {np.abs(want).max():.4e} raw units): {text}")
    del cpu, plan_cpu

    t = cfg16.train
    trainer = Trainer(metro_model("tiled", ds, device), ds, plan_dev, lr=t.lr,
                      weight_decay=t.weight_decay, n_epochs=1, batch_size=METRO_BATCH,
                      out_dir=scratch("metro_bf16"), initial_state=state, precision="bf16",
                      device=device, verbose=False)
    reset_counts()
    losses, seen = steps_checking_grads(trainer,
                                        list(trainer.batches("train"))[:METRO_BF16_STEPS])
    counts = read_counts()
    if not all(math.isfinite(v) for v in losses) or not all(seen):
        fail(f"bf16 tiled training: losses {losses}, finite gradients {seen}")
    check_counts(counts, {"B1": 1, "B3": 2, "B3 shared": 1}, {"B2": 1, "B4": 1},
                 METRO_BF16_STEPS, METRO_BF16_STEPS, "bf16 tiled training at the metro city")
    print(f"bf16 tiled training at the metro city, {METRO_BF16_STEPS} steps at batch "
          f"{METRO_BATCH}: losses {[f'{v:.6g}' for v in losses]}, every gradient finite; "
          f"launches {counts_text(counts)}")
    step_times(trainer, "bf16 tiled training step at the metro city")
    trace_training(trainer, {**LSTM_PARTS, **SPMM_PARTS}, "bf16 tiled training at the metro city")
    return counts


def bf16_sparse(device, ds, dense_dev, ktuples) -> int:
    """Phase 25: the bf16 block-sparse K-tuple route (B5) at the metro
    city, one forward and backward of the bf16 model against the bf16 model
    on the dense supports: output and input gradient within bf16 tolerance.
    Returns its B5 launches."""
    import torch

    from stmgcn_tpu_torch.experiment import build_model

    M, K = dense_dev.shape[:2]
    obs = torch.as_tensor(ds.arrays("test")[0][:METRO_BATCH], device=device)
    w = torch.randn(obs.shape[0], obs.shape[2], obs.shape[3], device=device,
                    generator=torch.Generator(device=device).manual_seed(3))

    def fwd_bwd(mode, supports):
        cfg = metro_config(mode)
        cfg.model.dtype = "bfloat16"
        model = build_model(cfg, ds.n_feats, device=device,
                            generator=torch.Generator().manual_seed(0))
        x = obs.clone().requires_grad_(True)
        out = model(supports, x)
        (out.float() * w).sum().backward()
        return out.detach().float(), x.grad

    reset_counts()
    out, grad = fwd_bwd("sparse", ktuples)
    counts = read_counts()
    check_counts(counts, {"B1": 1, "B2": 1, "B5": 4 * M * K}, {}, 1, 0, "bf16 K-tuples")
    ref_out, ref_grad = fwd_bwd("dense", dense_dev)
    text = bf16_check(out.cpu().numpy(), ref_out.cpu().numpy(),
                      "bf16 K-tuples vs bf16 dense, output")
    rel = ((grad - ref_grad).norm() / ref_grad.norm()).item()
    if not rel <= BF16_GRAD_RTOL:
        fail(f"bf16 K-tuples vs bf16 dense: input gradient {rel:.3e} of its norm")
    print(f"bf16 K-tuples of BlockSparse at the metro city, one forward + backward, vs the bf16 "
          f"dense model: output {text}; input gradient within {rel:.3e} of its norm "
          f"({BF16_GRAD_RTOL}); launches {counts_text(counts)}")
    return counts["B5"]


# -- fleets: heterogeneous cities in shape classes (phases 26-29) ----------------

def fleet_config(out_dir: str, batch=None):
    """The ``multicity`` preset on one card: its dp=8 mesh is multi-device
    work, so ``mesh`` is reset to one device, as the JAX package's tiled
    fleet test does (``tests/test_tiling.py:271-272``); fleet blocks of
    FLEET_S over EPOCHS epochs."""
    from stmgcn_tpu_torch.config import MeshConfig

    cfg = pallas_preset("multicity")
    cfg.mesh = MeshConfig()
    cfg.train.fleet, cfg.train.steps_per_superstep = True, FLEET_S
    cfg.train.epochs, cfg.train.out_dir = EPOCHS, out_dir
    if batch is not None:
        cfg.train.batch_size = batch
    return cfg


def check_fleet(trainer, classes, what: str) -> None:
    """The trainer took the fleet blocks over the expected shape classes."""
    got = [(c.n_nodes, c.cities) for c in trainer.fleet_plan.classes]
    if trainer.train_path != "fleet_superstep" or got != classes:
        fail(f"{what}: train_path {trainer.train_path!r}, classes {got} (expected "
             f"'fleet_superstep' over {classes}; {trainer.fallback_reason})")


def fleet_train(device):
    """Phase 26: the multicity cities as one shape class on the card:
    ``train()`` and ``test()`` with one B1 launch per forward and one B2
    per step (no block-CSR kernel), the step p50, and the card against the
    CPU port over steps of both cities, the padded one included. Returns
    the trainer."""
    import torch

    from stmgcn_tpu_torch import build_trainer

    trainer = build_trainer(fleet_config(scratch("fleet")), device=device)
    check_fleet(trainer, [(144, (0, 1))], "multicity fleet")
    train_and_test(trainer, {"B1": 1}, {"B2": 1}, "multicity fleet training")
    step_times(trainer, "multicity fleet training step")
    cfg = fleet_config(scratch("fleet_cpu"), batch=CPU_BATCH)
    card = build_trainer(cfg, device=device, verbose=False)
    state = {k: v.detach().cpu().clone() for k, v in card.model.state_dict().items()}
    cpu = build_trainer(cfg, device="cpu", initial_state=state, verbose=False)
    batches = list(card.batches("train"))
    pick = [b for b in batches if b.city == 0][:1] + [b for b in batches if b.city == 1][:2]
    agree_over_steps(card, cpu, state, "multicity fleet, card vs CPU (cities 0, 1, 1)", pick)
    del card, cpu
    torch.cuda.empty_cache()
    return trainer


def fleet_serve(device, trainer) -> None:
    """Phase 27: ``best.ckpt`` of phase 26 through ``FleetServingEngine``:
    concurrent callers for both cities, every answer equal to
    ``Forecaster.predict(city=)`` on the card, dispatches that coalesce the
    two cities, and a ``swap_params`` that every class serves from."""
    from stmgcn_tpu_torch import Forecaster, ServingConfig
    from stmgcn_tpu_torch.experiment import build_model, build_supports
    from stmgcn_tpu_torch.obs import graphmon

    fc = Forecaster.from_checkpoint(trainer.best_path, device=device)
    ds = trainer.dataset
    sups = build_supports(fc.config, ds)
    windows = {c: ds.denormalize(ds.city_arrays("test", c)[0], city=c) for c in (0, 1)}
    engine = fc.fleet_engine(sups, config=ServingConfig(buckets=BUCKETS), device=device)

    def check(got, rows, c, what, forecaster=fc):
        want = forecaster.predict(sups.for_city(c), rows, city=c)
        if got.shape != want.shape or not np.isfinite(got).all():
            fail(f"{what}: got {got.shape}, want {want.shape}")
        if not np.allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL):
            fail(f"{what}: max |engine - forecaster| {np.abs(got - want).max():.3e}")

    try:
        for c in (0, 1):
            for b in BUCKETS:
                engine.predict_direct(windows[c][:b], city=c)
        cls = engine.class_of(0)
        engine.class_stats[cls].reset()
        results, errors = {}, []
        barrier = threading.Barrier(CALLERS)  # CALLERS // 2 threads per city

        def caller(c, k):
            try:
                rows = windows[c][8 * k:8 * k + 8]
                barrier.wait(timeout=60)
                results[(c, k)] = (rows, [engine.predict(rows, city=c) for _ in range(ROUNDS)])
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=caller, args=(c, k))
                   for c in (0, 1) for k in range(CALLERS // 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if errors or any(t.is_alive() for t in threads):
            fail(f"fleet concurrent callers: errors={errors!r}")
        for (c, k), (rows, outs) in results.items():
            for out in outs:
                check(out, rows, c, f"fleet caller {k} of city {c}")
        for n in SIZES + (OVERSIZED,):
            for c in (0, 1):
                rows = windows[c][:n]  # past the top rung: split over two dispatches
                check(engine.predict(rows, city=c), rows, c,
                      f"fleet predict({len(rows)} rows) of city {c}")
        if engine.cross_city_dispatches == 0:
            fail("no fleet dispatch coalesced the two cities")
        snapshot = engine.class_stats[cls].snapshot()
        print(f"fleet serving, one class at rung 144 for cities 0 and 1: "
              f"{snapshot['totals']['dispatches']} dispatches, "
              f"{engine.cross_city_dispatches} of them coalescing both cities; every "
              f"answer equal to Forecaster.predict(city=) on the card (rtol {SERVE_RTOL}, "
              f"atol {SERVE_ATOL})")
        for b, st in snapshot["buckets"].items():
            print(f"fleet bucket {b}: {st['dispatches']} dispatches, p50 latency "
                  f"{st['latency_ms']['p50']} ms, p50 dispatch {st['device_ms']['p50']} ms")
        new = {k: v * 0.9 for k, v in fc.state_dict.items()}
        scaled = Forecaster(build_model(fc.config, fc.derived["input_dim"], device=device), new,
                            None, fc.config, fc.derived, fc.normalizers, device=device)
        before = graphmon.snapshot()["swap_captures"]
        gen = engine.swap_params(new)
        swap_captures = graphmon.snapshot()["swap_captures"] - before
        for c in (0, 1):
            out, got_gen = engine.predict(windows[c][:4], city=c, with_generation=True)
            if got_gen != gen:
                fail(f"city {c} answered from generation {got_gen} after the swap to {gen}")
            check(out, windows[c][:4], c, f"city {c} after the swap", scaled)
        print(f"fleet swap_params: generation {gen} serves both cities, equal to a "
              f"Forecaster on the new weights; the swap captured {swap_captures} (class, "
              "rung) programs, counted apart from recaptures")
    finally:
        engine.close()


def bench_fleet(device) -> None:
    """Phase 28: bench.py's 8-city fleet point at the default model's full
    width: one epoch (train, validate, checkpoints) of fleet blocks of
    FLEET_BENCH_S, then one of the per-city loop (``fleet=False``, one
    batch a step at each city's own shape), from one set of weights."""
    import torch

    from stmgcn_tpu_torch import CitySupports, Trainer
    from stmgcn_tpu_torch.data import HeteroCityDataset, WindowSpec, synthetic_dataset
    from stmgcn_tpu_torch.models import STMGCN
    from stmgcn_tpu_torch.ops import SupportConfig

    datas = [synthetic_dataset(rows=r, cols=c, n_timesteps=24 * 7 * 4 + 12 * i, seed=i + 1)
             for i, (r, c) in enumerate(BENCH_FLEET_DIMS)]
    sups = CitySupports(SupportConfig("chebyshev", 2).build_all(d.adjs.values())
                        for d in datas)
    seconds = {}
    for name, superstep, fleet, graphs in (
            ("fleet, graphed", FLEET_BENCH_S, True, True),
            ("per-city loop, graphed", 1, False, True),
            ("per-city loop, eager", 1, False, False),
            ("fleet, eager", FLEET_BENCH_S, True, False)):
        ds = HeteroCityDataset(datas, WindowSpec(BENCH_FLEET_SERIAL, 1, 1, 24))
        model = STMGCN(3, 3, BENCH_FLEET_SERIAL + 2, 1, device=device,
                       generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, ds, sups, n_epochs=1, batch_size=BENCH_FLEET_BATCH,
                          steps_per_superstep=superstep, fleet=fleet,
                          out_dir=scratch(f"bench_fleet_{superstep}_{graphs}"), device=device,
                          graphs=graphs, verbose=False)
        if fleet:
            check_fleet(trainer, [(6, (6, 7)), (16, (0, 1, 2, 3, 4, 5))], "bench fleet")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        history = trainer.train()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        if not np.isfinite(history["train"]).all():
            fail(f"bench fleet, {name}: non-finite loss")
        print(f"bench fleet point, {name} (train_path {trainer.train_path}): one epoch of "
              f"{trainer.global_step} steps at batch {BENCH_FLEET_BATCH} plus validation in "
              f"{seconds[name]:.3f} s ({seconds[name] / trainer.global_step * 1e3:.3f} ms a "
              f"step); train loss {history['train'][0]:.6g}")
    for route in ROUTES:
        print(f"bench fleet point, {route}, epoch fleet / per-city loop: "
              f"{seconds[f'fleet, {route}'] / seconds[f'per-city loop, {route}']:.4f}")
    for path in ("fleet", "per-city loop"):
        print(f"bench fleet point, {path}, epoch graphed / eager: "
              f"{seconds[f'{path}, graphed'] / seconds[f'{path}, eager']:.4f}")


def tiled_fleet(device) -> None:
    """Phase 29: a tiled fleet of three cities at tile 128 in one class at
    rung 1,024: B3 and B4 on each grown plan against their plain versions
    at the training shapes, ``train()`` and ``test()`` with the tiled
    launches per forward and step, the step p50, and each city served in a
    private exact-fit class of ``FleetServingEngine`` from ``best.ckpt``."""
    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig, build_trainer
    from stmgcn_tpu_torch.ops.spmm import (
        spmm_stack,
        spmm_stack_bwd,
        spmm_stack_bwd_reference,
        spmm_stack_reference,
    )

    cfg = fleet_config(scratch("tiled_fleet"), batch=TILED_FLEET_BATCH)
    cfg.data.n_cities, cfg.data.city_rows = len(TILED_FLEET_ROWS), TILED_FLEET_ROWS
    cfg.data.cols, cfg.data.city_timesteps = TILED_FLEET_COLS, None
    cfg.data.n_timesteps = TILED_FLEET_TIMESTEPS
    cfg.model.tiled, cfg.model.tile_size = True, TILED_FLEET_TILE
    t0 = time.perf_counter()
    trainer = build_trainer(cfg, device=device)
    print(f"tiled fleet: three cities planned and grown on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    check_fleet(trainer, [(max(TILED_FLEET_ROWS) * TILED_FLEET_COLS, (0, 1, 2))], "tiled fleet")
    B, T, H = TILED_FLEET_BATCH, cfg.data.seq_len, cfg.model.lstm_hidden_dim
    gen = torch.Generator(device=device).manual_seed(3)
    for c, rows in enumerate(TILED_FLEET_ROWS):
        plan = trainer.supports.for_city(c)
        st = plan.as_stack()
        M, K = plan.m_graphs, plan.n_supports
        grown_rows = plan.block_rows - -(-rows * TILED_FLEET_COLS // TILED_FLEET_TILE)
        errs = []
        for what, x in (("gate conv", torch.randn(plan.n, B * T, device=device, generator=gen)),
                        ("graph conv", torch.randn(M, plan.n, B * H, device=device,
                                                   generator=gen))):
            errs.append(spmm_err(spmm_stack(st, x), spmm_stack_reference(st, x),
                                 f"B3 ({what}) on city {c}'s grown plan"))
            g = torch.randn(M, K, plan.n, x.shape[-1], device=device, generator=gen)
            shared = x.dim() == 2
            dx = spmm_stack_bwd(st, g, shared=shared)
            errs.append(spmm_err(dx, spmm_stack_bwd_reference(st, g, shared=shared),
                                 f"B4 ({what}) on city {c}'s grown plan"))
            if not torch.equal(dx, spmm_stack_bwd(st, g, shared=shared)):
                fail(f"B4 ({what}) on city {c}'s grown plan: two runs differ")
        print(f"tiled fleet, city {c} ({rows * TILED_FLEET_COLS} nodes grown to {plan.n}, "
              f"block rows added: {grown_rows}; C {plan.block_cols}, C_t "
              f"{plan.data_t.shape[3]}): "
              f"B3 and B4 against their plain versions at F = {B * T} and {B * H} (B4 twice, "
              f"bitwise equal), max |err| "
              f"{max(errs):.3e} (rtol {SPMM_RTOL} + {SPMM_ATOL} of the largest)")
    train_and_test(trainer, {"B1": 1, "B3": 2, "B3 shared": 1}, {"B2": 1, "B4": 1},
                   "tiled fleet training")
    step_times(trainer, "tiled fleet training step")
    fc = Forecaster.from_checkpoint(trainer.best_path, device=device)
    from stmgcn_tpu_torch.experiment import build_dataset, build_supports

    ds = build_dataset(fc.config)
    plans = build_supports(fc.config, ds)
    config = ServingConfig(buckets=METRO_BUCKETS, max_batch=METRO_BUCKETS[-1])
    with fc.fleet_engine(plans, config=config, device=device) as engine:
        if len({engine.class_of(c) for c in range(3)}) != 3:
            fail("tiled fleet cities share a serving class")
        for c in range(3):
            rows = ds.denormalize(ds.city_arrays("test", c)[0][:METRO_BUCKETS[-1] + 1], city=c)
            plan = plans.for_city(c)
            want = fc.predict(plan, rows, city=c)
            for got in (engine.predict(rows, city=c), engine.predict_direct(rows, city=c)):
                if got.shape != want.shape or not np.allclose(got, want, rtol=SERVE_RTOL,
                                                              atol=SERVE_ATOL):
                    fail(f"tiled fleet serving, city {c}: max |err| "
                         f"{np.abs(got - want).max():.3e}")
    print(f"tiled fleet serving: each city in a private exact-fit class, "
          f"{METRO_BUCKETS[-1] + 1} windows equal to Forecaster.predict(city=)")


def fleet_phases(device) -> dict:
    """Phases 26-29: B1 and B2 must launch on the dense fleet, B3 and B4
    on the tiled fleet only. Returns every kernel's launches summed over
    the three paths (the records' ``fleet_launches``), each counted from
    its ``train_and_test``'s reset (or, for phase 28, a reset before it)
    to its end."""
    import torch

    t0 = time.perf_counter()
    trainer = fleet_train(device)
    fleet_serve(device, trainer)
    dense = read_counts()
    if not dense["B1"] or not dense["B2"] or any(dense[k] for k in ("B3", "B4", "B5")):
        fail(f"the dense fleet path's launches: {counts_text(dense)}")
    print(f"dense fleet path (train, test, step p50, card vs CPU, serve, swap): launches "
          f"{counts_text(dense)}")
    fleet_ab(device, trainer)
    del trainer
    torch.cuda.empty_cache()
    reset_counts()
    bench_fleet(device)
    bench = read_counts()
    print(f"bench fleet point (one epoch on each path): launches {counts_text(bench)}")
    torch.cuda.empty_cache()
    tiled_fleet(device)
    tiled = read_counts()
    if not tiled["B3"] or not tiled["B4"]:
        fail(f"the tiled fleet path did not launch B3 and B4: {counts_text(tiled)}")
    print(f"tiled fleet path (train, test, serve): launches {counts_text(tiled)}")
    torch.cuda.empty_cache()
    print(f"fleet phases took {time.perf_counter() - t0:.1f} s")
    return {k: dense[k] + bench[k] + tiled[k] for k in dense}


# -- captured programs: graphed against eager (phases 30-34) -------------------

#: the two routes of every A/B: CUDA graphs (the default) and graphs=False
ROUTES = ("graphed", "eager")
#: graphed-vs-eager p50s: host-clock calls per route, taken in turns
#: (graphed, eager, eager, graphed), AB_CALLS // 2 per turn; training A/Bs
#: compare AB_BLOCKS blocks of S and a tail step
AB_CALLS, AB_BLOCKS = 24, 3


def ab_p50(fns: dict, calls: int = AB_CALLS) -> dict:
    """Each route's median host-clock ms of ``fns[route]()`` ending in a
    synchronize, measured in turns first, second, second, first (graphed,
    eager, eager, graphed for the A/Bs; one warm-up call each first)."""
    import torch

    times: dict = {route: [] for route in fns}
    for fn in fns.values():
        fn()
    first, second = fns
    for route in (first, second, second, first):
        for _ in range(calls // 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[route]()
            torch.cuda.synchronize()
            times[route].append((time.perf_counter() - t0) * 1e3)
    return {route: float(np.median(t)) for route, t in times.items()}


def p50_text(p50: dict) -> str:
    return (f"graphed {p50['graphed']:.4f} ms, eager {p50['eager']:.4f} ms "
            f"(eager / graphed {p50['eager'] / p50['graphed']:.3f})")


def serve_check(got, want, what: str) -> None:
    """The fp32 serving tolerance (engine vs Forecaster, card vs CPU)."""
    if got.shape != want.shape or not np.isfinite(got).all():
        fail(f"{what}: got {got.shape}, want {want.shape}")
    if not np.allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL):
        fail(f"{what}: max |err| {np.abs(got - want).max():.3e} (rtol {SERVE_RTOL}, atol "
             f"{SERVE_ATOL})")


def ab_outputs(outs: dict, check, what: str) -> str:
    """Hold the graphed route's outputs against the eager route's (``check``
    fails past the path's tolerance); returns the largest difference and
    whether every output was bitwise equal."""
    worst, bitwise = 0.0, True
    for key, got in outs["graphed"].items():
        want = outs["eager"][key]
        check(got, want, f"{what}, {key}, graphed vs eager")
        worst = max(worst, float(np.abs(np.asarray(got, np.float64) - want).max()))
        bitwise &= bool(np.array_equal(got, want))
    return f"max |graphed - eager| {worst:.3e}, bitwise equal: {bitwise}"


def serve_ab(device, make_engine, requests: dict, check, what: str, parts) -> None:
    """Phase 30 (and 32, 34): the same weights served graphed and eager in
    one call (``make_engine(graphs)``): every request of ``requests``
    (name -> ``predict_direct`` keyword arguments) held graphed against
    eager with ``check``, the kernels' launches equal on both routes, each
    request's dispatch p50 in turns, the graphed generation's pool bytes,
    and each route's smallest request traced."""
    engines = {route: make_engine(route == "graphed") for route in ROUTES}
    try:
        if not engines["graphed"].graphs or engines["eager"].graphs:
            fail(f"{what}: the engines' routes are not graphed and eager")
        outs, counts = {}, {}
        for route, engine in engines.items():
            reset_counts()
            outs[route] = {name: engine.predict_direct(**kw) for name, kw in requests.items()}
            counts[route] = read_counts()
        text = ab_outputs(outs, check, what)
        if counts["graphed"] != counts["eager"]:
            fail(f"{what}: launches graphed {counts_text(counts['graphed'])} vs eager "
                 f"{counts_text(counts['eager'])}")
        print(f"{what}, graphed vs eager, same weights: {text}; launches equal on both routes "
              f"({counts_text(counts['graphed'])} over {len(requests)} requests); graph pool "
              f"{engines['graphed'].graph_pool_bytes} bytes")
        for name, kw in requests.items():
            p50 = ab_p50({route: lambda e=e, kw=kw: e.predict_direct(**kw)
                          for route, e in engines.items()})
            print(f"{what}, {name}, p50 dispatch (host clock, synchronized): {p50_text(p50)}")
        name, kw = next(iter(requests.items()))
        for route, engine in engines.items():
            for _ in range(3):
                engine.predict_direct(**kw)
            wall, dev = profiled(lambda e=engine: e.predict_direct(**kw), 10)
            shares(f"{what}, {name}, {route}, per dispatch", wall, dev, parts)
    finally:
        for engine in engines.values():
            engine.close()


def concurrent_rungs(engine, requests: dict, want: dict, what: str) -> None:
    """Phase 35: concurrent callers on every rung (and class) of one graphed
    generation, whose programs share one graph pool. CALLERS threads start
    together and call every request of ``requests`` (name -> keyword
    arguments) in turn, each from its own offset, ROUNDS times; the odd
    threads dispatch inline (``predict_direct``), the even ones through the
    batchers (``predict``). Every answer is held to ``want[name]`` (the
    Forecaster's) at the serving tolerance."""
    if not engine.graphs:
        fail(f"{what}: the engine is not graphed")
    names = list(requests)
    outs, errors = [], []
    barrier = threading.Barrier(CALLERS)

    def caller(k):
        try:
            call = engine.predict_direct if k % 2 else engine.predict
            barrier.wait(timeout=60)
            for _ in range(ROUNDS):
                for i in range(len(names)):
                    name = names[(k + i) % len(names)]
                    outs.append((name, call(**requests[name])))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=caller, args=(k,)) for k in range(CALLERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        fail(f"{what}, concurrent callers: errors={errors!r}")
    for name, got in outs:
        serve_check(got, want[name], f"{what}, {name}, concurrent callers")
    print(f"{what}: {CALLERS} concurrent callers (inline and batched) over {len(names)} "
          f"requests x {ROUNDS} rounds on one graph pool ({engine.graph_pool_bytes} bytes): "
          f"all {len(outs)} answers within rtol {SERVE_RTOL}, atol {SERVE_ATOL} of "
          "Forecaster.predict")


def update_gap(a, b, state) -> tuple:
    """``(worst tensor, its |p_a - p_b| / |p_b - p_initial|, max |p_a - p_b|)``
    over the two trainers' parameters."""
    want = {k: v.cpu() for k, v in b.model.state_dict().items()}
    rel, elem = {}, {}
    for k, v in a.model.state_dict().items():
        diff = v.cpu() - want[k]
        rel[k] = (diff.norm() / (want[k] - state[k]).norm()).item()
        elem[k] = diff.abs().max().item()
    worst = max(rel, key=rel.get)
    return worst, rel[worst], max(elem.values())


def train_ab(make_trainer, what: str, parts, blocks: int = AB_BLOCKS, bitwise: bool = False):
    """Phase 31 (and 32, 34): two trainers from one state, graphed and eager
    (``make_trainer(graphs, state)``), over the same ``blocks`` blocks of S
    and one one-step tail: losses within agree_over_steps' tolerances
    (``bitwise``: exactly), every tensor's update likewise, the kernels'
    launches equal per step on both routes, the p50 of a step inside a
    block and of a one-step program in turns, the graph pool's bytes and a
    trace of one block on each route. Returns the graphed trainer."""
    import torch

    trainers = {"graphed": make_trainer(True, None)}
    state = {k: v.detach().cpu().clone() for k, v in
             trainers["graphed"].model.state_dict().items()}
    trainers["eager"] = make_trainer(False, state)
    g = trainers["graphed"]
    if not g.graphs or trainers["eager"].graphs:
        fail(f"{what}: the trainers' routes are not graphed and eager")
    every = g._blocks(list(g.batches("train")), 0)
    full = [b for b in every if len(b) == g.steps_per_superstep][:blocks]
    tails = [b for b in every if len(b) == 1][:1]
    if not full or not tails:
        fail(f"{what}: the epoch has no full block or no tail step")
    picked = full + tails
    losses, counts = {}, {}
    for route, trainer in trainers.items():
        reset_counts()
        losses[route] = [v for block in picked for v in trainer._run_block(block)]
        counts[route] = read_counts()
    steps = len(losses["graphed"])
    same = losses["graphed"] == losses["eager"] and all(
        torch.equal(v, trainers["eager"].model.state_dict()[k])
        for k, v in g.model.state_dict().items())
    for i, (a, b) in enumerate(zip(losses["graphed"], losses["eager"])):
        if not math.isclose(a, b, rel_tol=CPU_LOSS_RTOL) or (bitwise and a != b):
            fail(f"{what}, step {i + 1}: graphed loss {a} vs eager {b}")
    worst, rel, elem = update_gap(g, trainers["eager"], state)
    if not rel <= CPU_UPDATE_RTOL or (bitwise and not same):
        fail(f"{what}: {worst}'s update differs by {rel:.3e} of its norm graphed vs eager")
    if counts["graphed"] != counts["eager"]:
        fail(f"{what}: launches graphed {counts_text(counts['graphed'])} vs eager "
             f"{counts_text(counts['eager'])}")
    S = g.steps_per_superstep
    print(f"{what}, graphed vs eager from one state, {len(full)} blocks of {S} and a tail step "
          f"({steps} steps, batch {g.batch_size}): losses within rtol {CPU_LOSS_RTOL}, each "
          f"tensor's update within {rel:.3e} of its norm ({worst}), parameters max |diff| "
          f"{elem:.3e}; bitwise equal: {same}; launches equal on both routes "
          f"({counts_text(counts['graphed'])}); {len(g._programs)} captured programs, graph "
          f"pool {g.graph_pool.reserved_bytes} bytes")
    block, batch = full[0], picked[-1][0]
    p50 = ab_p50({r: lambda t=t: t._run_block(block) for r, t in trainers.items()}, 8)
    print(f"{what}, p50 of a step inside a block of {S} (block time / {S}): " + p50_text(
        {r: v / S for r, v in p50.items()}))
    STEP_P50[what] = p50["graphed"] / S
    p50 = ab_p50({r: lambda t=t: t.train_batch(batch) for r, t in trainers.items()}, 12)
    print(f"{what}, p50 of a one-step program (a tail step): {p50_text(p50)}")
    for route, trainer in trainers.items():
        wall, dev = profiled(lambda t=trainer: t._run_block(block), 2)
        shares(f"{what}, {route}, per step inside a block of {S}", wall / S,
               {k: v / S for k, v in dev.items()}, parts, top=6)
    return g


def dense_ab(device) -> None:
    """Phases 30-31 at the dense flagship: serving, fp32 and bf16, every
    rung (engine vs engine, same weights), then training, fp32 and bf16,
    and stochastically rounded bf16 training, which is captured one step
    at a time and must agree with the eager route bitwise."""
    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig, build_trainer
    from stmgcn_tpu_torch.experiment import build_dataset, build_model, build_supports

    cfg = pallas_preset("default")
    cfg.data.rows, cfg.data.serial_len = GRID, SERIAL
    ds = build_dataset(cfg)
    supports = build_supports(cfg, ds)
    derived = {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}
    model = build_model(cfg, ds.n_feats, device=device, generator=torch.Generator().manual_seed(0))
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    windows = ds.denormalize(ds.arrays("test")[0])
    requests = {f"rung {b}": {"history": windows[:b]} for b in BUCKETS}
    for dtype, check in (("float32", serve_check), ("bfloat16", bf16_check)):
        c = pallas_preset("default")
        c.data.rows, c.data.serial_len, c.model.dtype = GRID, SERIAL, dtype
        fc = Forecaster(build_model(c, ds.n_feats, device=device), state, ds.normalizer, c,
                        derived, device=device)
        serve_ab(device, lambda graphs, fc=fc: fc.serving_engine(
            supports, config=ServingConfig(buckets=BUCKETS), device=device, graphs=graphs),
            requests, check, f"dense serving, {dtype}", {"B1": LSTM_PARTS["B1 forward"]})
        if dtype == "float32":
            with fc.serving_engine(supports, config=ServingConfig(buckets=BUCKETS),
                                   device=device) as engine:
                concurrent_rungs(engine, requests, {
                    name: fc.predict(supports, kw["history"]) for name, kw in requests.items()},
                    "dense serving, every rung")
    torch.cuda.empty_cache()
    for precision, sr_seed in (("fp32", None), ("bf16", None), ("bf16", SR_SEED)):
        def make(graphs, initial, precision=precision, sr_seed=sr_seed):
            c = flagship_config(BATCH)
            c.train.precision, c.train.sr_seed = precision, sr_seed
            c.train.out_dir = scratch(f"ab_dense_{precision}_{sr_seed}_{graphs}")
            return build_trainer(c, device=device, graphs=graphs, initial_state=initial,
                                 verbose=False)

        what = f"dense training, {precision}" + (f", sr_seed {sr_seed}" if sr_seed else "")
        train_ab(make, what, LSTM_PARTS, blocks=1 if sr_seed else AB_BLOCKS,
                 bitwise=sr_seed is not None)
        torch.cuda.empty_cache()


def fleet_ab(device, trainer) -> None:
    """Phase 32: the multicity fleet graphed against eager: its ``best.ckpt``
    through two ``FleetServingEngine``s (both cities, every rung), then
    fleet training blocks of the class from one state."""
    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig, build_trainer
    from stmgcn_tpu_torch.experiment import build_supports

    fc = Forecaster.from_checkpoint(trainer.best_path, device=device)
    ds = trainer.dataset
    sups = build_supports(fc.config, ds)
    windows = {c: ds.denormalize(ds.city_arrays("test", c)[0], city=c) for c in (0, 1)}
    requests = {f"city {c}, rung {b}": {"history": windows[c][:b], "city": c}
                for c in (0, 1) for b in BUCKETS}
    serve_ab(device, lambda graphs: fc.fleet_engine(
        sups, config=ServingConfig(buckets=BUCKETS), device=device, graphs=graphs),
        requests, serve_check, "multicity fleet serving", {"B1": LSTM_PARTS["B1 forward"]})
    # no padding allowed: each city in a class of its own, one pool for both
    with fc.fleet_engine(sups, config=ServingConfig(buckets=BUCKETS), max_pad_waste=0.0,
                         device=device) as engine:
        if engine.class_of(0) == engine.class_of(1):
            fail("multicity fleet with max_pad_waste=0: the cities share a class")
        concurrent_rungs(engine, requests, {
            name: fc.predict(sups.for_city(kw["city"]), kw["history"], city=kw["city"])
            for name, kw in requests.items()}, "multicity fleet serving, two classes")
    torch.cuda.empty_cache()

    def make(graphs, initial):
        return build_trainer(fleet_config(scratch(f"ab_fleet_{graphs}")), device=device,
                             graphs=graphs, initial_state=initial, verbose=False)

    train_ab(make, "multicity fleet training", LSTM_PARTS)
    torch.cuda.empty_cache()


def metro_ab(device, ds, plan_dev) -> None:
    """Phase 34: the metro city's tiled plan graphed against eager: serving
    (fp32 and bf16, every rung) and tiled training (fp32 and bf16)."""
    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig, Trainer
    from stmgcn_tpu_torch.experiment import build_model

    state = {k: v.detach().cpu().clone()
             for k, v in metro_model("tiled", ds, device).state_dict().items()}
    derived = {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}
    windows = ds.denormalize(ds.arrays("test")[0])
    config = ServingConfig(buckets=METRO_BUCKETS, max_batch=METRO_BUCKETS[-1])
    requests = {f"rung {b}": {"history": windows[:b]} for b in METRO_BUCKETS}
    parts = {"B1": LSTM_PARTS["B1 forward"], "B3": SPMM_PARTS["B3"]}
    for dtype, check in (("float32", serve_check), ("bfloat16", bf16_check)):
        cfg = metro_config("tiled")
        cfg.model.dtype = dtype
        fc = Forecaster(build_model(cfg, ds.n_feats, device=device), state, ds.normalizer, cfg,
                        derived, device=device)
        serve_ab(device, lambda graphs, fc=fc: fc.serving_engine(
            plan_dev, config=config, device=device, graphs=graphs),
            requests, check, f"tiled serving at the metro city, {dtype}", parts)
        torch.cuda.empty_cache()
    for precision in ("fp32", "bf16"):
        def make(graphs, initial, precision=precision):
            t = metro_config("tiled").train
            return Trainer(metro_model("tiled", ds, device), ds, plan_dev, lr=t.lr,
                           weight_decay=t.weight_decay, n_epochs=1, batch_size=METRO_BATCH,
                           steps_per_superstep=SUPERSTEP, precision=precision,
                           out_dir=scratch(f"ab_metro_{precision}_{graphs}"),
                           initial_state=initial, device=device, graphs=graphs, verbose=False)

        train_ab(make, f"tiled training at the metro city, {precision}",
                 {**LSTM_PARTS, **SPMM_PARTS})
        torch.cuda.empty_cache()


# -- resilience and health (phases 36-40) ---------------------------------------

#: the health stats of one step on the card against the CPU's plain versions
#: from one state: the losses at CPU_LOSS_RTOL, the norms (sums of squares
#: over every gradient entry, in other orders on the two sides) at
#: HEALTH_RTOL, the counts exactly; against a recomputation from the same
#: card tensors after the step, the norms at HEALTH_SELF_RTOL (the same sums
#: in another order) and the update ratio, whose update is recovered as
#: p_after - p_before in float32, at HEALTH_RATIO_RTOL
HEALTH_RTOL, HEALTH_SELF_RTOL, HEALTH_RATIO_RTOL = 1e-4, 1e-5, 1e-3
#: the guard drill's poisoned batch (epoch, ordinal): inside the second
#: block of SUPERSTEP, which is rolled back and replayed step by step
POISON_AT = (1, 5)
#: the in-process preemption drill's SIGTERM (epoch, ordinal)
SIGTERM_AT = (2, 6)
#: the CLI preemption drill: the default preset at the flagship's GRID
#: (its 1,344 timesteps) for PREEMPT_EPOCHS epochs (long enough that the
#: signal lands inside train()), SIGTERM once the first epoch's latest.ckpt
#: lands; the parent waits at most PREEMPT_WAIT_S for it
PREEMPT_EPOCHS, PREEMPT_WAIT_S = 8, 300
#: drift: held-out traffic stays under DRIFT_CALM_PSI (the JAX tests' stable
#: rule), traffic scaled by DRIFT_SHIFT passes DRIFT_FIRE_PSI and
#: DRIFT_FIRE_Z; dispatch-slow's sleep against the drill's deadline
DRIFT_CALM_PSI, DRIFT_FIRE_PSI, DRIFT_FIRE_Z, DRIFT_SHIFT = 0.1, 0.25, 10.0, 2.0
SLOW_MS, SLOW_DEADLINE_MS = 60.0, 20.0


def release() -> None:
    """Free the graph pools of trainers and engines no longer referenced:
    their programs' bodies close over them, so only the cycle collector
    frees them, and a dense training pool holds about 4 GB."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def resilience_trainer(device, out: str, *, precision="fp32", initial=None, health_k=None,
                       drift=False, plan=None, batch=BATCH, epochs=EPOCHS, **train):
    """The flagship at the bench point (``flagship_config``), with health
    every ``health_k`` dispatches (None: off), ``health.drift``, a fault
    plan and train fields (the guard's)."""
    from stmgcn_tpu_torch import build_trainer

    cfg = flagship_config(batch)
    cfg.train.precision, cfg.train.out_dir, cfg.train.epochs = precision, out, epochs
    cfg.health.enabled, cfg.health.every_k = health_k is not None, health_k or 1
    cfg.health.drift = drift
    for key, value in train.items():
        setattr(cfg.train, key, value)
    return build_trainer(cfg, device=device, initial_state=initial, verbose=False,
                         fault_plan=plan)


def state_of(trainer) -> dict:
    return {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}


def end_state(trainer) -> list:
    """A trainer's parameters and Adam moments, copied to the host."""
    opt = trainer.optimizer
    return [t.detach().cpu().clone() for t in
            list(trainer.model.state_dict().values()) + opt.exp_avg + opt.exp_avg_sq]


def same_state(a, b) -> bool:
    """Whether two trainers (or :func:`end_state` lists) hold bitwise the
    same parameters and moments."""
    import torch

    a, b = (end_state(t) if not isinstance(t, list) else t for t in (a, b))
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def recording_params(trainer) -> list:
    """After every dispatch of ``trainer``, a copy of its flattened
    parameters on the card (the list returned)."""
    import torch

    log, dispatch = [], trainer._dispatch

    def recorded(*args, **kw):
        out = dispatch(*args, **kw)
        log.append(torch.cat([p.detach().flatten() for p in trainer.model.parameters()]))
        return out

    trainer._dispatch = recorded
    return log


def health_stats_check(device, precision: str) -> None:
    """The health row of one step on the card against a recomputation from
    the card's tensors after it, and (fp32) against the CPU port's plain
    versions from the same state, a clean step and a NaN- and an
    Inf-poisoned one: counts exact."""
    import torch

    card = resilience_trainer(device, scratch(f"health_card_{precision}"), precision=precision,
                              health_k=1, batch=CPU_BATCH)
    state = state_of(card)
    batch = next(iter(card.batches("train")))
    names = [g for g, _ in card._health_groups]
    before = [p.detach().clone() for p in card.model.parameters()]
    losses, rows = card._dispatch([batch], "train", health=True)
    row = rows[0]
    grads = [p.grad for p in card.model.parameters()]
    update = [p.detach() - b for p, b in zip(card.model.parameters(), before)]
    norm = lambda ts: float(torch.sqrt(sum(torch.sum(t.double() ** 2) for t in ts)))
    groups = [norm([grads[i] if m is None else grads[i][m] for i, m in members])
              for _, members in card._health_groups]
    want = [norm(grads), norm(update) / norm(before)]
    for got, ref, what, rtol in ((row[1], want[0], "grad_norm", HEALTH_SELF_RTOL),
                                 (row[2], want[1], "update_ratio", HEALTH_RATIO_RTOL),
                                 *((row[5 + j], g, f"group {n}", HEALTH_SELF_RTOL)
                                   for j, (n, g) in enumerate(zip(names, groups)))):
        if not math.isclose(float(got), ref, rel_tol=rtol):
            fail(f"health {precision}: in-graph {what} {got} vs {ref} from the card's tensors")
    nonfinite = sum(int((~torch.isfinite(g)).sum()) for g in grads)
    if row[3] != nonfinite or row[4] != 0 or not np.isfinite(row[:3]).all():
        fail(f"health {precision}: counts {row[3:5]} vs {nonfinite} non-finite gradients")
    print(f"health {precision} (batch {CPU_BATCH}): the in-graph row of one step agrees with "
          f"the card's tensors after it (grad_norm {row[1]:.6g}, update_ratio {row[2]:.6g}, "
          "groups " + ", ".join(f"{n} {v:.6g}" for n, v in zip(names, row[5:])) + f"; norms "
          f"rtol {HEALTH_SELF_RTOL}, ratio {HEALTH_RATIO_RTOL}; counts exact)")
    if precision != "fp32":
        return
    cpu = resilience_trainer("cpu", scratch("health_cpu"), initial=state, health_k=1,
                             batch=CPU_BATCH)
    card.model.load_state_dict(state)
    card.optimizer.load_state_tree(cpu.optimizer.state_tree(cpu._param_names, 3),
                                   card._param_names, 3)
    for trainer in (card, cpu):
        trainer._take_snapshot()
    norms = [0, 1, 2] + list(range(5, 5 + len(names)))  # the loss, norms and the ratio
    for poison in (None, float("nan"), float("inf")):
        poisons = {} if poison is None else {0: poison}
        out = {}
        for side, trainer in (("card", card), ("cpu", cpu)):
            trainer._rollback()
            out[side] = trainer._dispatch([batch], "train", health=True, poisons=poisons)[1][0]
        a, b = out["card"], out["cpu"]
        if a[3] != b[3] or a[4] != b[4]:
            fail(f"health, poison {poison}: non-finite counts card {a[3:5]} vs CPU {b[3:5]}")
        if poison is None:
            if not math.isclose(a[0], b[0], rel_tol=CPU_LOSS_RTOL) or not np.allclose(
                    a[norms[1:]], b[norms[1:]], rtol=HEALTH_RTOL, atol=0):
                fail(f"health: card row {a.tolist()} vs CPU {b.tolist()} (rtol {HEALTH_RTOL})")
        print(f"health fp32, card vs CPU plain versions from one state, "
              f"{'clean' if poison is None else f'poison {poison}'} step: "
              f"nonfinite_grads {int(a[3])} / {int(b[3])}, nonfinite_loss {int(a[4])} / "
              f"{int(b[4])}" + ("" if poison is not None else
                                f"; loss, norms and ratio within rtol {HEALTH_RTOL} "
                                f"(max rel {float(np.max(np.abs(a[norms] / b[norms] - 1))):.3e})"))


def health_dense(device, precision: str):
    """Phase 36, dense: two epochs in blocks of SUPERSTEP with health every
    dispatch, the parameters after every dispatch bitwise a plain trainer's
    from the same state; one health.jsonl record per dispatch, one per
    second with ``every_k=2``; the twin's step p50 beside the plain step's,
    and the graph pools' bytes. Returns (health trainer, the initial
    state, the plain run's history and its end state)."""
    import torch

    from stmgcn_tpu_torch.obs.health import load_health

    plain = resilience_trainer(device, scratch(f"plain_{precision}"), precision=precision)
    state = state_of(plain)
    twin = resilience_trainer(device, scratch(f"health_{precision}"), precision=precision,
                              initial=state, health_k=1, drift=precision == "fp32")
    logs = {"health": recording_params(twin), "plain": recording_params(plain)}
    h_twin, h_plain = twin.train(), plain.train()
    del twin._dispatch, plain._dispatch
    n = len(logs["plain"])
    if len(logs["health"]) != n or not all(torch.equal(a, b) for a, b in
                                           zip(logs["health"], logs["plain"])):
        fail(f"health {precision}: parameters differ from the plain run's after a dispatch")
    reference = end_state(plain)
    if h_twin != h_plain or not same_state(twin, reference):
        fail(f"health {precision}: history {h_twin} vs plain {h_plain}")
    every2 = resilience_trainer(device, scratch(f"health2_{precision}"), precision=precision,
                                initial=state, health_k=2)
    every2.train()
    meta, records = load_health(twin._health_out_path())
    _, records2 = load_health(every2._health_out_path())
    if len(records) != n or len(records2) != (n + 1) // 2:
        fail(f"health {precision}: {len(records)} and {len(records2)} records for {n} "
             "dispatches (every_k 1 and 2)")
    if any(r["nonfinite_grads"] or r["nonfinite_loss"] or not np.isfinite(r["grad_norm"])
           for r in records):
        fail(f"health {precision}: a record with non-finite stats")
    print(f"health {precision}, {EPOCHS} epochs in blocks of {SUPERSTEP} at batch {BATCH}: the "
          f"parameters after each of {n} dispatches bitwise the plain run's; health.jsonl "
          f"{len(records)} records (every_k 1), {len(records2)} (every_k 2), groups "
          f"{meta['groups']}; last: loss {records[-1]['loss']:.6g}, grad_norm "
          f"{records[-1]['grad_norm']:.6g}, update_ratio {records[-1]['update_ratio']:.6g}")
    block = [b for b in plain._blocks(list(plain.batches("train")), 0)
             if len(b) == SUPERSTEP][0]
    p50 = ab_p50({"health": lambda: twin._dispatch(block, "train", True),
                  "plain": lambda: plain._dispatch(block)}, 8)
    print(f"health {precision}, p50 of a step inside a block of {SUPERSTEP} (host clock, "
          f"synchronized; block time / {SUPERSTEP}): twin {p50['health'] / SUPERSTEP:.4f} ms, "
          f"plain {p50['plain'] / SUPERSTEP:.4f} ms (twin / plain "
          f"{p50['health'] / p50['plain']:.3f})")
    pool = {k: t.graph_pool and t.graph_pool.reserved_bytes
            for k, t in (("plain", plain), ("twin", twin), ("both", every2))}
    print(f"health {precision}, graph pool bytes: plain programs only {pool['plain']}, twins "
          f"only {pool['twin']}, both (every_k 2) {pool['both']}")
    del plain, every2
    release()
    return twin, state, h_plain, reference


def health_fleet(device):
    """Phase 36, fleet: the multicity fleet one epoch with health and drift;
    in every fleet block's ``city_loss`` the block city's slot holds its
    step losses exactly and every other slot 0. Returns the trainer (its
    best.ckpt carries the baseline)."""
    from stmgcn_tpu_torch import build_trainer

    cfg = fleet_config(scratch("fleet_health"))
    cfg.train.epochs = 1
    cfg.health.enabled, cfg.health.drift = True, True
    trainer = build_trainer(cfg, device=device, verbose=False)
    emitted, emit, train_block, city = [], trainer._health_emit, trainer._train_block, [None]

    def spy(stats, cities=None):
        emitted.append((stats.copy(), cities, city[0]))
        return emit(stats, cities=cities)

    def block_of(block):
        city[0] = block[0].city
        return train_block(block)

    trainer._health_emit, trainer._train_block = spy, block_of
    trainer.train()
    del trainer._health_emit, trainer._train_block
    fleet = [e for e in emitted if e[1] is not None]
    groups = len(trainer._health_groups)
    if not fleet:
        fail("fleet health: no fleet block emitted city_loss")
    for stats, cities, c in fleet:
        city_loss = stats[:, 5 + groups:]
        slot = list(cities).index(c) if c in cities else None
        others = np.delete(city_loss, slot, axis=1) if slot is not None else None
        if (slot is None or city_loss.shape[1] != len(cities) or others.any()
                or not np.array_equal(city_loss[:, slot], stats[:, 0])):
            fail(f"fleet health: city {c}'s block (class members {cities}): city_loss "
                 f"{city_loss} vs losses {stats[:, 0]}")
    print(f"fleet health: {len(fleet)} fleet blocks (cities "
          f"{sorted({c for _, _, c in fleet})}), each step's loss exactly in its city's "
          f"city_loss slot and 0 in the others; {len(emitted) - len(fleet)} one-step records")
    return trainer


def guard_drills(device, state, reference) -> None:
    """Phase 37 (dense fp32, from ``state``; ``reference`` the end state of
    the unpoisoned run): a poison at POISON_AT with the
    guard's skip ends bitwise equal to a drop run; defer retries at the
    epoch's end and lr_cut lands in meta; three poisons in a row abort with
    the hint; the guard-on block p50 beside guard-off."""
    from stmgcn_tpu_torch.resilience import DivergenceError, FaultPlan, FaultSpec
    from stmgcn_tpu_torch.train.checkpoint import verify_checkpoint

    epoch, step = POISON_AT
    skip = resilience_trainer(device, scratch("guard_skip"), initial=state,
                              divergence_guard=True,
                              plan=FaultPlan(FaultSpec("poison", epoch=epoch, step=step)))
    drop = resilience_trainer(device, scratch("guard_drop"), initial=state,
                              plan=FaultPlan(FaultSpec("drop", epoch=epoch, step=step)))
    h_skip, h_drop = skip.train(), drop.train()
    if skip._guard.total != 1 or h_skip != h_drop or not same_state(skip, drop):
        fail(f"guard skip vs drop: trips {skip._guard.total}, histories {h_skip} / {h_drop}")
    if not np.isfinite(h_skip["train"]).all() or same_state(skip, reference):
        fail("guard skip: non-finite losses, or the poisoned batch was not skipped")
    print(f"guard, poison at epoch {epoch} ordinal {step} (inside a block of {SUPERSTEP}): "
          f"rolled back, replayed step by step and skipped; {EPOCHS} epochs end bitwise equal "
          f"to a drop run (parameters, moments, history {json.dumps(h_skip)})")
    block = [b for b in drop._blocks(list(drop.batches("train")), 0) if len(b) == SUPERSTEP][0]
    p50 = ab_p50({"on": lambda: skip._train_block(block),
                  "off": lambda: drop._train_block(block)}, 8)
    print(f"guard, p50 of a block of {SUPERSTEP} (host clock, synchronized): guard on "
          f"{p50['on']:.4f} ms, off {p50['off']:.4f} ms (on / off {p50['on'] / p50['off']:.3f})")
    del skip, drop
    release()
    defer = resilience_trainer(device, scratch("guard_defer"), initial=state, epochs=1,
                               divergence_guard=True, divergence_action="defer",
                               divergence_lr_cut=0.5,
                               plan=FaultPlan(FaultSpec("poison", epoch=epoch, step=step)))
    defer.train()
    meta = verify_checkpoint(defer.latest_path)
    if (defer._guard.total != 1 or defer.global_step != defer.train_steps_per_epoch
            or meta.get("lr_scale") != 0.5 or defer.optimizer.lr_scale != 0.5):
        fail(f"guard defer: trips {defer._guard.total}, steps {defer.global_step}, lr_scale "
             f"{meta.get('lr_scale')}")
    print(f"guard defer + lr_cut 0.5: the poisoned batch retried at the epoch's end "
          f"({defer.global_step} steps of {defer.train_steps_per_epoch}), meta lr_scale "
          f"{meta['lr_scale']}")
    del defer
    release()
    abort = resilience_trainer(device, scratch("guard_abort"), initial=state,
                               divergence_guard=True, divergence_patience=3,
                               plan=FaultPlan(*(FaultSpec("poison", epoch=1, step=k)
                                                for k in (1, 2, 3))))
    try:
        abort.train()
        fail("three poisons in a row did not abort")
    except DivergenceError as e:
        if "--checkify nan" not in str(e):
            fail(f"the abort lacks the hint: {e}")
        print(f"guard, three poisons in a row: DivergenceError ({str(e)[:80]}...)")


def write_fault_drills(device) -> None:
    """Phase 37, files: truncate-, corrupt- and torn-write on epoch 2's
    latest.ckpt (the smoke preset on the card): the recovery chain falls
    back to epoch 1's latest.prev, quarantining a bad file; the torn write
    leaves latest untouched and a partial temp file."""
    from stmgcn_tpu_torch import build_trainer, preset
    from stmgcn_tpu_torch.resilience import FaultPlan, FaultSpec

    for kind in ("truncate-write", "corrupt-write", "torn-write"):
        cfg = preset("smoke")
        cfg.data.n_timesteps, cfg.train.epochs = CLI_TIMESTEPS, 2
        cfg.train.out_dir = out = scratch(f"write_{kind}")
        plan = FaultPlan(FaultSpec(kind, path_glob="latest.ckpt", write_index=1))
        trainer = build_trainer(cfg, device=device, verbose=False, fault_plan=plan)
        try:
            trainer.train()
            raised = None
        except RuntimeError as e:  # the async writer's torn write, surfaced
            raised = e
        if (raised is not None) != (kind == "torn-write"):
            fail(f"{kind}: train() raised {raised!r}")
        meta = build_trainer(cfg, device=device, verbose=False).restore_auto()
        names = sorted(os.listdir(out))
        bad = "latest.ckpt.corrupt" in names
        torn = any(".tmp." in n for n in names)
        if meta is None or meta["epoch"] != 1 or bad == (kind == "torn-write") or (
                torn != (kind == "torn-write")):
            fail(f"{kind}: restored {meta and meta['epoch']}, files {names}")
        left = ("the write crashed before its rename, leaving a partial temp file" if torn else
                "the bad file quarantined as latest.ckpt.corrupt")
        print(f"{kind} on epoch 2's latest.ckpt: restore_auto resumed epoch 1 from "
              f"latest.prev ({left})")


def sigterm_in_process(device, state, reference, history) -> None:
    """Phase 38, in process: a ``sigterm`` fault at SIGTERM_AT raises
    ``Preempted`` after the emergency checkpoint; a fresh trainer resumes
    and ends bitwise equal to the uninterrupted run (its end state
    ``reference`` and ``history``)."""
    from stmgcn_tpu_torch.resilience import FaultPlan, FaultSpec, Preempted
    from stmgcn_tpu_torch.train.checkpoint import verify_checkpoint

    out = scratch("sigterm")
    epoch, step = SIGTERM_AT
    run = resilience_trainer(device, out, initial=state,
                             plan=FaultPlan(FaultSpec("sigterm", epoch=epoch, step=step)))
    try:
        run.train()
        fail("the sigterm fault did not preempt")
    except Preempted as e:
        print(f"sigterm fault at epoch {epoch} ordinal {step}: Preempted ({e})")
    meta = verify_checkpoint(run.latest_path)
    t0 = time.perf_counter()
    resumed = resilience_trainer(device, out)
    t1 = time.perf_counter()
    resumed.restore_auto()
    first: list = []
    dispatch = resumed._dispatch

    def timed(*args, **kw):
        got = dispatch(*args, **kw)
        if not first:
            first.append(time.perf_counter())
        return got

    resumed._dispatch = timed
    resumed_history = resumed.train()
    del resumed._dispatch
    if not same_state(resumed, reference) or any(
            resumed_history[m] != history[m][epoch - 1:] for m in history):
        fail(f"the resumed run ({resumed_history}) does not end where the uninterrupted one "
             f"({history}) did")
    if not first:
        fail(f"the resume from cursor {meta['batch_in_epoch']} ran no step")
    print(f"preempted at epoch {meta['epoch']}, cursor {meta['batch_in_epoch']} of "
          f"{run.train_steps_per_epoch}; a fresh trainer resumed (build_trainer {t1 - t0:.4f} "
          f"s, restore to the end of its first dispatch {first[0] - t1:.4f} s, host clock) and "
          "ended bitwise equal to the uninterrupted run")


def sigterm_cli(root: str) -> None:
    """Phase 38, the CLI: ``python -m stmgcn_tpu_torch.cli --preset
    default`` at the flagship's width trains on the card in a subprocess;
    once the first epoch's latest.ckpt lands the parent sends SIGTERM:
    exit 143 and an emergency latest.ckpt, whose landing (a new file
    renamed into place) the parent times on its own clock; then
    ``--resume`` finishes the run."""
    import signal

    from stmgcn_tpu_torch.train.checkpoint import verify_checkpoint

    repo = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "preempt")
    base = [sys.executable, "-m", "stmgcn_tpu_torch.cli", "--preset", "default", "--rows",
            str(GRID), "--batch-size", str(BATCH), "--epochs", str(PREEMPT_EPOCHS),
            "--steps-per-superstep", str(SUPERSTEP), "--out-dir", out]
    latest = os.path.join(out, "latest.ckpt")
    os.makedirs(root, exist_ok=True)
    log = open(os.path.join(root, "preempt.err"), "w+")
    proc = subprocess.Popen(base, cwd=repo, stdout=subprocess.DEVNULL, stderr=log)
    try:
        deadline = time.time() + PREEMPT_WAIT_S
        while not os.path.exists(latest) and proc.poll() is None and time.time() < deadline:
            time.sleep(0.005)
        if proc.poll() is not None or not os.path.exists(latest):
            fail(f"cli preemption: no latest.ckpt before the run ended (exit {proc.poll()})")
        first = verify_checkpoint(latest)
        inode = os.stat(latest).st_ino
        proc.send_signal(signal.SIGTERM)
        t_signal, landed = time.perf_counter(), None
        while landed is None and time.perf_counter() - t_signal < PREEMPT_WAIT_S:
            try:
                if os.stat(latest).st_ino != inode:
                    landed = time.perf_counter()
            except FileNotFoundError:
                pass
            if landed is None and proc.poll() is not None:
                break
            time.sleep(0.0002)
        proc.wait(timeout=PREEMPT_WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log.seek(0)
    err = log.read()
    log.close()
    if proc.returncode != 143:
        fail(f"cli preemption: exit {proc.returncode}, expected 143; stderr {err[-2000:]}")
    meta = verify_checkpoint(latest)
    if landed is None or (meta["epoch"], meta["batch_in_epoch"]) == (
            first["epoch"], first["batch_in_epoch"]):
        fail(f"cli preemption: no emergency latest.ckpt after the signal (epoch "
             f"{meta['epoch']}, cursor {meta['batch_in_epoch']}; epoch 1's file had epoch "
             f"{first['epoch']}, cursor {first['batch_in_epoch']})")
    print(f"cli SIGTERM after epoch 1 (--preset default, {GRID}x{GRID} grid, batch {BATCH}, "
          f"blocks of {SUPERSTEP}): exit 143 ({err.strip().splitlines()[-1]}); emergency "
          f"latest.ckpt at epoch {meta['epoch']}, cursor {meta['batch_in_epoch']}, "
          f"{os.path.getsize(latest)} bytes, renamed into place {landed - t_signal:.4f} s "
          "after the signal (the parent's host clock, polled every 0.2 ms)")
    t0 = time.perf_counter()
    done = subprocess.run(base + ["--resume"], cwd=repo, capture_output=True, text=True,
                          timeout=600)
    if done.returncode != 0:
        fail(f"cli --resume after preemption: exit {done.returncode}; {done.stderr[-2000:]}")
    results = json.loads(done.stdout.strip().splitlines()[-1])["results"]
    if not all(np.isfinite(v) for r in results.values() for v in r.values()):
        fail("cli --resume after preemption: non-finite metrics")
    final = verify_checkpoint(latest)
    if final["epoch"] < meta["epoch"] or final["batch_in_epoch"]:
        fail(f"cli --resume ended at epoch {final['epoch']}, cursor {final['batch_in_epoch']}")
    print(f"cli --resume finished the run (to epoch {final['epoch']}, early stopping "
          f"allowed) in "
          f"{time.perf_counter() - t0:.1f} s (process start, build and all); test "
          + json.dumps(results))


def drift_serving(device, twin) -> None:
    """Phase 39: ``best.ckpt`` of the health run (health_baseline, drift on)
    through a dense ``ServingEngine``: held-out windows silent, shifted
    ones firing, the reset on ``swap_params``, the rung-1 p50 with drift on
    and off; then the serve-fault drills: ``batcher-die`` degrading to the
    inline path, ``dispatch-slow`` shedding under a deadline, and the
    watcher's ``corrupt-checkpoint`` hook rejecting the file."""
    from stmgcn_tpu_torch import Forecaster, ServingConfig
    from stmgcn_tpu_torch.resilience import ServeFaultPlan, ServeFaultSpec
    from stmgcn_tpu_torch.serving.admission import DeadlineExceeded

    fc = Forecaster.from_checkpoint(twin.best_path, device=device)
    if fc.health_baseline is None or not fc.config.health.drift:
        fail("the health run's best.ckpt carries no drift baseline")
    ds, supports = twin.dataset, twin.supports.cpu().numpy()
    windows = ds.denormalize(ds.arrays("test")[0])
    rows = windows[:BUCKETS[-1]]
    with fc.serving_engine(supports, config=ServingConfig(buckets=BUCKETS),
                           device=device) as engine:
        if engine.drift is None:
            fail("from_forecaster did not attach the drift monitor")
        served = engine.predict(rows)
        calm = engine.drift_snapshot()["cities"]["0"]
        engine.swap_params(fc.model.state_dict())
        reset = engine.drift_snapshot()
        engine.predict(rows * DRIFT_SHIFT)
        hot = engine.drift_snapshot()["cities"]["0"]["input"]
        if calm["input"]["psi"] >= DRIFT_CALM_PSI or reset["cities"] or reset["generation"] != 1:
            fail(f"drift: held-out {calm}, after the swap {reset}")
        if hot["psi"] <= DRIFT_FIRE_PSI or hot["z_max"] <= DRIFT_FIRE_Z:
            fail(f"drift: shifted traffic {hot}")
        print(f"drift, dense engine from best.ckpt: held-out {len(rows)} windows input psi "
              f"{calm['input']['psi']:.4g} (held below {DRIFT_CALM_PSI}) z_max "
              f"{calm['input']['z_max']:.4g} over n {calm['input']['n']} values, a mean shift "
              f"of {calm['input']['z_max'] / math.sqrt(calm['input']['n']):.4g} baseline sd "
              f"(not held); reset on swap_params (generation 1, no sketches); traffic "
              f"x{DRIFT_SHIFT} psi {hot['psi']:.4g} z_max {hot['z_max']:.4g}")
        drift_prediction_gauge(fc.health_baseline, calm["prediction"], served,
                               ds.denormalize(ds.arrays("test")[1][:len(rows)]))
        monitor = engine.drift
        one = windows[:1]

        def rung1(on, call):
            engine.drift = monitor if on else None
            call(one)

        for what, call in (("micro-batched", engine.predict), ("direct", engine.predict_direct)):
            p50 = ab_p50({"on": lambda c=call: rung1(True, c),
                          "off": lambda c=call: rung1(False, c)})
            print(f"drift, rung-1 p50 (host clock, synchronized, {what}): drift on "
                  f"{p50['on']:.4f} ms, off {p50['off']:.4f} ms (on / off "
                  f"{p50['on'] / p50['off']:.3f})")
        engine.drift = monitor
    want = fc.predict(supports, windows[:3])
    plan = ServeFaultPlan(ServeFaultSpec("batcher-die", dispatch=1))
    with fc.serving_engine(supports, config=ServingConfig(buckets=BUCKETS), device=device,
                           fault_plan=plan) as engine:
        for _ in range(3):  # before, at and after the batcher's death
            got = engine.predict(windows[:3])
            if not np.allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL):
                fail(f"batcher-die: max |err| {np.abs(got - want).max():.3e}")
    print("batcher-die at dispatch 1: the engine degraded to the inline path; all three "
          "answers equal Forecaster.predict")
    config = ServingConfig(buckets=BUCKETS, deadline_ms=SLOW_DEADLINE_MS, max_delay_ms=1.0)
    plan = ServeFaultPlan(ServeFaultSpec("dispatch-slow", slow_ms=SLOW_MS))
    shed = []
    with fc.serving_engine(supports, config=config, device=device, fault_plan=plan) as engine:
        def call():
            try:
                engine.predict(windows[:1])
            except DeadlineExceeded as e:
                shed.append(e)

        threads = [threading.Thread(target=call) for _ in range(CALLERS)]
        for t in threads:
            t.start()
            time.sleep(0.005)
        for t in threads:
            t.join(timeout=60)
    if not shed:
        fail("dispatch-slow: nothing shed under the deadline")
    print(f"dispatch-slow {SLOW_MS} ms under a {SLOW_DEADLINE_MS} ms deadline: {len(shed)} of "
          f"{CALLERS} callers shed with DeadlineExceeded")
    plan = ServeFaultPlan(ServeFaultSpec("corrupt-checkpoint", path_glob="latest.ckpt"))
    with fc.serving_engine(supports, config=ServingConfig(buckets=BUCKETS), device=device,
                           fault_plan=plan) as engine:
        watcher = engine.watch_checkpoints(twin.out_dir)
        twin.n_epochs += 1
        twin.train()  # a newer latest.ckpt; the hook flips it at rest
        if watcher.poll() or watcher.rejected != 1 or engine.generation != 0:
            fail(f"corrupt-checkpoint: rejected {watcher.rejected}, generation "
                 f"{engine.generation}")
        if not os.path.exists(twin.latest_path + ".corrupt"):
            fail("corrupt-checkpoint: the flipped file was not quarantined")
    print("corrupt-checkpoint: the watcher's hook flipped latest.ckpt at rest; the poll "
          "rejected it (rejected 1, quarantined), the engine stays on generation 0")


def drift_prediction_gauge(baseline: dict, gauge: dict, served, targets) -> None:
    """The prediction gauge of the held-out traffic (``gauge``): equal to
    a host monitor fed the served predictions, so it reads what was
    served. Its baseline is the denormalized series, so it reads silent
    only for a model whose predictions track the data: a host monitor fed
    the held-out targets (what such a model would serve) stays under
    DRIFT_CALM_PSI. The two-epoch model's own reading is printed, not
    held."""
    from stmgcn_tpu_torch.obs.drift import DriftMonitor

    read = {}
    for what, values in (("served", served), ("targets", targets)):
        monitor = DriftMonitor(baseline)
        monitor.observe_prediction("0", np.asarray(values, dtype=np.float64))
        read[what] = monitor.snapshot()["cities"]["0"]["prediction"]
    if read["served"]["n"] != gauge["n"] or not all(
            math.isclose(read["served"][k], gauge[k], rel_tol=1e-9) for k in ("psi", "z_max")):
        fail(f"drift prediction gauge {gauge} vs the served predictions on the host "
             f"{read['served']}")
    if read["targets"]["psi"] >= DRIFT_CALM_PSI:
        fail(f"drift prediction gauge fed the held-out targets: {read['targets']}")
    pcc = float(np.corrcoef(np.ravel(served), np.ravel(targets))[0, 1])
    print(f"drift, prediction gauge: the served predictions read psi {gauge['psi']:.4g} z_max "
          f"{gauge['z_max']:.4g} (the engine's gauge equals a host monitor's over them; not "
          f"held: the two-epoch model's predictions, pcc {pcc:.4g} with the targets, are "
          f"nearly constant against a baseline of the denormalized series); the held-out "
          f"targets read psi {read['targets']['psi']:.4g} (held below {DRIFT_CALM_PSI}) z_max "
          f"{read['targets']['z_max']:.4g}")


def drift_fleet(device, fleet) -> None:
    """Phase 39, fleet: the health fleet's best.ckpt through
    ``FleetServingEngine`` with drift over both cities: city 0 held-out and
    silent, city 1 shifted and firing; the reset on ``swap_params``."""
    from stmgcn_tpu_torch import Forecaster, ServingConfig
    from stmgcn_tpu_torch.experiment import build_supports

    fc = Forecaster.from_checkpoint(fleet.best_path, device=device)
    ds = fleet.dataset
    with fc.fleet_engine(build_supports(fc.config, ds), device=device,
                         config=ServingConfig(buckets=BUCKETS)) as engine:
        if engine.drift is None:
            fail("fleet engine: no drift monitor from a drift checkpoint")
        for c, scale in ((0, 1.0), (1, DRIFT_SHIFT)):
            held_out = ds.city_arrays("test", c)[0][:BUCKETS[-1]]
            engine.predict(ds.denormalize(held_out, city=c) * scale, city=c)
        snap = engine.drift_snapshot()["cities"]
        calm, hot = snap["0"]["input"], snap["1"]["input"]
        if calm["psi"] >= DRIFT_CALM_PSI or hot["psi"] <= DRIFT_FIRE_PSI:
            fail(f"fleet drift: city 0 {calm}, city 1 {hot}")
        engine.swap_params(fc.model.state_dict())
        if engine.drift_snapshot()["cities"]:
            fail("fleet drift: sketches survived the swap")
    print(f"drift, fleet engine: city 0 held-out input psi {calm['psi']:.4g} (held) z_max "
          f"{calm['z_max']:.4g} (not held), prediction psi {snap['0']['prediction']['psi']:.4g} "
          f"(not held, as on the dense engine); city 1 x{DRIFT_SHIFT} input psi "
          f"{hot['psi']:.4g} z_max {hot['z_max']:.4g}; reset on swap_params")


def resilience_phases(device) -> dict:
    """Phases 36-39 at the dense flagship and the multicity fleet, fp32,
    counted from a reset here to the read at their end (the fp32 B1/B2
    records' ``resilience_launches``); then the bf16 health phase, counted
    apart (the bf16 records'). Returns ``(fp32 counts, bf16 counts)``."""
    import torch

    t0 = time.perf_counter()
    reset_counts()
    health_stats_check(device, "fp32")
    release()
    twin, state, history, reference = health_dense(device, "fp32")
    fleet = health_fleet(device)
    guard_drills(device, state, reference)
    write_fault_drills(device)
    release()
    sigterm_in_process(device, state, reference, history)
    release()
    sigterm_cli(scratch("cli_preempt"))
    drift_serving(device, twin)
    release()
    drift_fleet(device, fleet)
    fp32 = read_counts()
    if not fp32["B1"] or not fp32["B2"] or any(fp32[k] for k in ("B3", "B4", "B5")):
        fail(f"the dense resilience path's launches: {counts_text(fp32)}")
    print(f"resilience and health phases, dense and fleet fp32: launches {counts_text(fp32)} "
          f"({time.perf_counter() - t0:.1f} s)")
    del twin, fleet
    release()
    reset_counts()
    health_stats_check(device, "bf16")
    release()
    health_dense(device, "bf16")
    bf16 = read_counts()
    if not bf16["B1"] or not bf16["B2"]:
        fail(f"the bf16 health path's launches: {counts_text(bf16)}")
    print(f"bf16 health phase: launches {counts_text(bf16)}")
    release()
    print(f"after the resilience phases: {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    return fp32, bf16


def metro_resilience(device, ds, plan_dev) -> dict:
    """Phase 40: the metro plan's tiled trainer with health for one epoch
    (B3 and B4 counted per forward and step), then a poison at POISON_AT
    under the guard's skip against a drop run from one state, one epoch
    each, held to agree_over_steps' tolerances (the bitwise verdict printed;
    phase 43 holds one tiled block bitwise per route).
    Returns the counts from a reset here."""
    from stmgcn_tpu_torch import Trainer
    from stmgcn_tpu_torch.obs.health import load_health
    from stmgcn_tpu_torch.resilience import FaultPlan, FaultSpec

    def tiled(name, state=None, plan=None, **kw):
        t = metro_config("tiled").train
        return Trainer(metro_model("tiled", ds, device), ds, plan_dev, lr=t.lr,
                       weight_decay=t.weight_decay, n_epochs=1, batch_size=METRO_BATCH,
                       steps_per_superstep=SUPERSTEP, out_dir=scratch(f"metro_{name}"),
                       initial_state=state, device=device, verbose=False, fault_plan=plan,
                       **kw)

    reset_counts()
    health = tiled("health", health=True)
    health.train()
    counts = read_counts()
    steps = health.global_step
    forwards = steps + ds.num_batches("validate", METRO_BATCH)
    check_counts(counts, {"B1": 1, "B3": 2, "B3 shared": 1}, {"B2": 1, "B4": 1}, forwards,
                 steps, "tiled health training at the metro city")
    _, records = load_health(health._health_out_path())
    print(f"tiled health training at the metro city, one epoch: {len(records)} health records "
          f"over {steps} steps, last grad_norm {records[-1]['grad_norm']:.6g}; launches "
          f"{counts_text(counts)}")
    state = state_of(health)
    epoch, step = POISON_AT
    skip = tiled("skip", state, FaultPlan(FaultSpec("poison", epoch=epoch, step=step)),
                 divergence_guard=True)
    drop = tiled("drop", state, FaultPlan(FaultSpec("drop", epoch=epoch, step=step)))
    h_skip, h_drop = skip.train(), drop.train()
    if skip._guard.total != 1 or skip.global_step != drop.global_step:
        fail(f"metro guard: trips {skip._guard.total}, steps {skip.global_step} vs "
             f"{drop.global_step}")
    for mode in h_skip:
        if not np.allclose(h_skip[mode], h_drop[mode], rtol=CPU_LOSS_RTOL, atol=0):
            fail(f"metro guard skip vs drop, {mode}: {h_skip[mode]} vs {h_drop[mode]}")
    worst, rel, elem = update_gap(skip, drop, state)
    if not rel <= CPU_UPDATE_RTOL:
        fail(f"metro guard skip vs drop: {worst}'s update differs by {rel:.3e} of its norm")
    print(f"metro guard, poison at epoch {epoch} ordinal {step}: skip vs drop over one epoch, "
          f"losses within rtol {CPU_LOSS_RTOL}, each tensor's update within {rel:.3e} of its "
          f"norm ({worst}), parameters max |diff| {elem:.3e}; bitwise equal: "
          f"{same_state(skip, drop)}")
    return read_counts()


# -- phases 41-45: the xla form, a repeatable tiled step, sanitizers, tracing --


def xla_lstm_case(M, R, T, L, H, device, seed):
    """The xla form's operands (phase 3's float32 draws: the kernels round
    the weights to bf16), its residuals and phase 4's cotangents."""
    import torch

    from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm

    (x, wx0, b0), ops = lstm_bwd_case(M, R, T, L, H, device, seed)
    xp, wh, wx, b, _, _, g_out, g_hfin, g_cfin = ops
    hseq, cseq = fused_lstm(xp, wh, wx, b, with_residuals=True, products=torch.bfloat16)[3:]
    return (x, wx0, b0), (xp, wh, wx, b), (xp, wh, wx, b, hseq, cseq, g_out, g_hfin, g_cfin)


def check_lstm_kernels_xla(device) -> list:
    """Phase 41: B1 and B2 in the xla form (float32 storage, bf16 products:
    the JAX default bf16 LSTM) against their plain versions on the card at
    the main path's shape (M=3 x 16,384 rows, T=12, L=3, H=64), residuals
    on and off, both weight-gradient roundings (``round_wx_steps``), a
    ragged row count and every (H, L) the kernels take; B2 twice bitwise
    equal; the fused schedule over a bf16 shadow of the weights (stochastic
    rounding: the weight gradients summed in bf16); CUDA-event times of
    kernel, plain version and cuDNN's ``nn.LSTM`` x3 in bf16, beside the
    bound with float32 bytes. The
    tolerances are the bf16 forms' (BF16_RTOL, BF16_ATOL_REL elementwise,
    BF16_WGRAD_NORM normwise): the rounding sites coincide, and an fp32
    sum in another order flips a bf16 rounding of a product's operand (h)
    or of a step's weight-gradient partial now and then. Returns the two
    records."""
    import torch

    from stmgcn_tpu_torch.ops.fused_lstm import (
        KERNEL_HIDDEN,
        KERNEL_MAX_LAYERS,
        fused_lstm,
        fused_lstm_bwd,
        fused_lstm_bwd_reference,
        fused_lstm_reference,
    )

    bf = torch.bfloat16
    M, R, T, L, H = 3, BATCH * GRID * GRID, SERIAL + 2, 3, 64
    (x, wx0, b0), ops, case = xla_lstm_case(M, R, T, L, H, device, seed=41)
    fwd_err = 0.0
    for res in (False, True):
        got = fused_lstm(*ops, with_residuals=res, products=bf)
        if any(t.dtype != torch.float32 for t in got):
            fail("fused_lstm in the xla form returned another dtype than float32")
        fwd_err = max(fwd_err, bf16_err(
            got, fused_lstm_reference(*ops, with_residuals=res, products=bf),
            f"xla fused_lstm M={M} R={R} residuals={res}"))
        del got
    bwd_err = wg = 0.0
    # the layered and fused schedules' roundings, and the fused one over a bf16
    # shadow of the weights and biases (stochastic rounding: bf16 carries)
    shadow = case[:1] + tuple(t.to(bf) for t in case[1:4]) + case[4:]
    for round_wx, c in ((False, case), (True, case), (True, shadow)):
        what = f"xla fused_lstm_bwd R={R} round_wx={round_wx} shadow={c is shadow}"
        got = fused_lstm_bwd(*c, products=bf, round_wx_steps=round_wx)
        want = fused_lstm_bwd_reference(*c, products=bf, round_wx_steps=round_wx)
        bwd_err = max(bwd_err, bf16_err(got[:1], want[:1], f"{what} dxp"))
        wg = max(wg, bf16_wgrad_err(got[1:], want[1:], what))
        again = fused_lstm_bwd(*c, products=bf, round_wx_steps=round_wx)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail("xla fused_lstm_bwd: two runs on the same inputs differ")
        del got, want, again
    sweep_f = sweep_b = 0.0
    for h in KERNEL_HIDDEN:
        for layers in range(1, KERNEL_MAX_LAYERS + 1):
            for rows in (77, 1000) if (h, layers) == (64, 3) else (77,):
                _, o, c = xla_lstm_case(2, rows, 5, layers, h, device, seed=h + layers + rows)
                sweep_f = max(sweep_f, bf16_err(
                    fused_lstm(*o, with_residuals=True, products=bf),
                    fused_lstm_reference(*o, with_residuals=True, products=bf),
                    f"xla fused_lstm H={h} L={layers} R={rows}"))
                g = fused_lstm_bwd(*c, products=bf, round_wx_steps=layers % 2 == 0)
                w = fused_lstm_bwd_reference(*c, products=bf, round_wx_steps=layers % 2 == 0)
                sweep_b = max(sweep_b, bf16_err(g[:1], w[:1],
                                                f"xla fused_lstm_bwd H={h} L={layers} R={rows}"))
                wg = max(wg, bf16_wgrad_err(g[1:], w[1:], f"xla fused_lstm_bwd H={h} L={layers}"))
    print(f"xla fused_lstm vs plain: max |err| {max(fwd_err, sweep_f):.3e}; xla fused_lstm_bwd "
          f"dxp max |err| {max(bwd_err, sweep_b):.3e}, weight gradients normwise {wg:.3e} "
          f"(elementwise rtol {BF16_RTOL} + {BF16_ATOL_REL} x max |want|; normwise "
          f"{BF16_WGRAD_NORM}); two backward runs bitwise equal (both schedules, and the "
          f"fused one over bf16 shadow weights); at M={M} "
          f"R={R} T={T} L={L} H={H}, ragged R=1000 and H in {KERNEL_HIDDEN} x L in "
          f"1..{KERNEL_MAX_LAYERS} (M=2, R=77, T=5)")

    wh, wx, b = case[1:4]
    cudnn = [lstm.to(bf) for lstm in cudnn_lstms(wx0, b0, wh, wx, b)]
    xb = x.to(bf)
    with torch.no_grad():
        ms = cuda_ms(lambda: fused_lstm(*ops, products=bf), iters=20)
        plain_ms = cuda_ms(lambda: fused_lstm_reference(*ops, products=bf), iters=5)
        library_ms = cuda_ms(lambda: [cudnn[m](xb[m]) for m in range(M)], iters=5)
    flops = M * R * T * (2 * H * 4 * H + (L - 1) * 2 * (2 * H) * (4 * H))
    # float32 x_proj0, biases, out and final states; bf16 weights
    n_bytes = (4 * (ops[0].numel() + ops[3].numel() + M * R * T * H + 2 * M * L * R * H)
               + 2 * (ops[1].numel() + ops[2].numel()))
    bound = bf16_bounds(flops, n_bytes)
    print(f"xla fused_lstm times (ms, CUDA events, mean): kernel {ms:.4f}, plain {plain_ms:.4f}, "
          f"cuDNN bf16 x{M} {library_ms:.4f}; {bf16_bounds_text(bound, flops, n_bytes, ms)}")
    records = [bf16_record("fused_lstm_fwd_xla", "stmgcn_tpu_torch/csrc/fused_lstm_fwd.cu",
                           "stmgcn_tpu/ops/pallas_lstm.py:172", max(fwd_err, sweep_f), ms,
                           plain_ms, library_ms, bound)]

    ms = cuda_ms(lambda: fused_lstm_bwd(*case, products=bf), iters=10)
    plain_ms = cuda_ms(lambda: fused_lstm_bwd_reference(*case, products=bf), iters=3)
    xs = [xb[m].clone().requires_grad_(True) for m in range(M)]
    params = [p for lstm in cudnn for p in lstm.parameters()]
    g_out, g_hfin, g_cfin = (t.to(bf) for t in case[6:])

    def library():
        outs, grads = [], []
        for m in range(M):
            out, (h_n, c_n) = cudnn[m](xs[m])
            outs += [out, h_n, c_n]
            grads += [g_out[m], g_hfin[m], g_cfin[m]]
        torch.autograd.grad(outs, xs + params, grads)

    def ours():
        res = fused_lstm(*ops, with_residuals=True, products=bf)
        fused_lstm_bwd(*ops, res[3], res[4], *case[6:], products=bf)

    fwd_bwd_ms = cuda_ms(ours, iters=10)
    library_ms = cuda_ms(library, iters=5)
    flops = 3 * flops
    # float32 reads (x_proj0, biases, residuals, cotangents) and writes (dxp,
    # weight gradients); bf16 weights
    w = ops[1].numel() + ops[2].numel()
    n_bytes = (4 * (sum(t.numel() for t in case) - w) + 2 * w
               + 4 * (ops[0].numel() + w + ops[3].numel()))
    bound = bf16_bounds(flops, n_bytes)
    print(f"xla fused_lstm_bwd times (ms, CUDA events, mean): kernel {ms:.4f}, plain "
          f"{plain_ms:.4f}; forward with residuals + backward kernels {fwd_bwd_ms:.4f} vs cuDNN "
          f"bf16 forward + backward x{M} {library_ms:.4f}; "
          f"{bf16_bounds_text(bound, flops, n_bytes, ms)}")
    records.append(bf16_record("fused_lstm_bwd_xla", "stmgcn_tpu_torch/csrc/fused_lstm_bwd.cu",
                               "stmgcn_tpu/ops/pallas_lstm.py:212", max(bwd_err, sweep_b), ms,
                               plain_ms, library_ms, bound))
    records[-1]["fwd_bwd_ms"] = fwd_bwd_ms
    for rec in records:
        rec["form"] = "xla"
    return records


def xla_config(batch: int, out: str, precision: str = "fp32", sr_seed=None):
    """The ``default`` preset at the bench point with ``model.dtype=
    "bfloat16"`` and the preset's own LSTM form, ``lstm_backend="xla"``."""
    from stmgcn_tpu_torch import preset

    cfg = preset("default")
    cfg.data.rows, cfg.data.serial_len, cfg.model.dtype = GRID, SERIAL, "bfloat16"
    cfg.train.batch_size, cfg.train.epochs = batch, EPOCHS
    cfg.train.steps_per_superstep, cfg.train.out_dir = SUPERSTEP, out
    cfg.train.precision, cfg.train.sr_seed = precision, sr_seed
    return cfg


def xla_default(device) -> dict:
    """Phase 42: the ``default`` preset at ``model.dtype="bfloat16"`` in the
    JAX default LSTM form (``lstm_backend="xla"``). Serving the ladder,
    graphed: an fp32 and an xla bf16 engine over one set of weights, every
    xla response equal to the xla Forecaster and a bucket-4 batch on the
    card equal to the CPU port's plain versions within the bf16 serving
    limits (2^-9, 2^-13; the fp32 model the control they must reject), B1 in
    the xla form once per forward; then a training block of SUPERSTEP steps
    at ``precision="bf16"``, without and with ``sr_seed``, finite, with B1
    and B2 in the xla form per forward and step; then the xla and pallas
    forms' rung-1 dispatch p50s and block-step p50s, in turns. The counts
    are set to 0 at its start and read at its end: the xla records'
    launches."""
    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig, build_trainer
    from stmgcn_tpu_torch.experiment import build_dataset, build_model, build_supports

    reset_counts()
    cfg16 = xla_config(BATCH, scratch("xla_serve"))
    cfg32 = xla_config(BATCH, scratch("xla_serve32"))
    cfg32.model.dtype = "float32"
    ds = build_dataset(cfg16)
    supports = build_supports(cfg16, ds)
    derived = {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}
    model = build_model(cfg32, ds.n_feats, device=device,
                        generator=torch.Generator().manual_seed(0))
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    fc32 = Forecaster(model, state, ds.normalizer, cfg32, derived, device=device)
    fc16 = Forecaster(build_model(cfg16, ds.n_feats, device=device), state, ds.normalizer,
                      cfg16, derived, device=device)
    if fc16.model.branches.cg_lstm.lstm.backend != "xla":
        fail("the default preset's bf16 model did not take the xla form")
    windows = ds.denormalize(ds.arrays("test")[0])
    bf16_engines(device, fc32, fc16, supports, windows, BUCKETS, SIZES, ROUNDS,
                 "xla bf16 dense serving", {"B1": 1, "B1 xla": 1},
                 {"B1": LSTM_PARTS["B1 forward"]})
    cpu = Forecaster(build_model(cfg16, ds.n_feats, device="cpu"), state, ds.normalizer,
                     cfg16, derived, device="cpu")
    rows = windows[:4]
    text = bf16_check(fc16.predict(supports, rows), cpu.predict(supports, rows),
                      "xla bf16 dense serving, card vs CPU", control=fc32.predict(supports, rows))
    print(f"xla bf16 dense serving, a bucket-4 batch, card vs CPU port: {text}")
    counts = read_counts()
    serving = counts["B1 xla"]
    torch.cuda.empty_cache()

    trainers = {}
    for sr_seed in (None, SR_SEED):
        tr = build_trainer(xla_config(BATCH, scratch(f"xla_train_{sr_seed}"), "bf16", sr_seed),
                           device=device, initial_state=state, verbose=False)
        block = [b for b in tr._blocks(list(tr.batches("train")), 0)
                 if len(b) == SUPERSTEP][0]
        before = read_counts()
        losses = tr._run_block(block)
        after = read_counts()
        grads = grads_ok(tr)
        if not all(math.isfinite(v) for v in losses) or not all(grads.values()):
            fail(f"xla bf16 training block, sr_seed {sr_seed}: losses {losses}, gradients "
                 f"finite and nonzero {grads}")
        got = {k: after[k] - before[k] for k in ("B1 xla", "B2 xla", "B1", "B2")}
        if got != {"B1 xla": SUPERSTEP, "B2 xla": SUPERSTEP, "B1": SUPERSTEP,
                   "B2": SUPERSTEP}:
            fail(f"xla bf16 training block, sr_seed {sr_seed}: launches {got}")
        print(f"xla bf16 training, one block of {SUPERSTEP} steps (batch {BATCH}, sr_seed "
              f"{sr_seed}): losses {losses}; every gradient finite and nonzero; launches "
              f"{counts_text(got)}")
        trainers[sr_seed] = (tr, block)
    counts = read_counts()

    # the two bf16 forms side by side: rung 1 and a block step, in turns
    cfgp = xla_config(BATCH, scratch("pallas_serve"))
    cfgp.model.lstm_backend = "pallas"
    fcp = Forecaster(build_model(cfgp, ds.n_feats, device=device), state, ds.normalizer, cfgp,
                     derived, device=device)
    config = ServingConfig(buckets=BUCKETS)
    engines = {"xla": fc16.serving_engine(supports, config=config, device=device),
               "pallas": fcp.serving_engine(supports, config=config, device=device)}
    one = windows[:1]
    p50 = ab_p50({k: lambda e=e: e.predict_direct(one) for k, e in engines.items()}, 40)
    for e in engines.values():
        e.close()
    print(f"bf16 dense serving, rung-1 p50 (predict_direct, host clock, in turns): xla form "
          f"{p50['xla']:.4f} ms, pallas form {p50['pallas']:.4f} ms "
          f"(xla / pallas {p50['xla'] / p50['pallas']:.3f})")
    cfgt = xla_config(BATCH, scratch("pallas_train"), "bf16")
    cfgt.model.lstm_backend = "pallas"
    trp = build_trainer(cfgt, device=device, initial_state=state, verbose=False)
    tr, block = trainers[None]
    p50 = ab_p50({"xla": lambda: tr._run_block(block), "pallas": lambda: trp._run_block(block)},
                 8)
    print(f"bf16 dense training, step p50 inside a block of {SUPERSTEP} (block / {SUPERSTEP}, "
          f"in turns): xla form {p50['xla'] / SUPERSTEP:.4f} ms, pallas form "
          f"{p50['pallas'] / SUPERSTEP:.4f} ms (xla / pallas {p50['xla'] / p50['pallas']:.3f})")
    if not serving:
        fail("the xla bf16 serving path never launched B1's xla form")
    del trainers, tr, trp
    torch.cuda.empty_cache()
    return counts


def pool_bytes(trainer) -> int:
    """The bytes a trainer's graph pool reserved (0 without graphs)."""
    return trainer.graph_pool.reserved_bytes if trainer.graph_pool is not None else 0


def checks_phase(device, ds, plan_dev) -> None:
    """Phase 44: the sanitizers (``train.checks``) at the dense bench point:
    a clean checked block (``"all"``) bitwise the unchecked one from one
    state; a NaN poison raising ``CheckError`` that names its step; an
    out-of-range window index clamped, raising and naming its step, and the
    next dispatch in the same process running (the CUDA context intact);
    the checked and unchecked block p50s in turns; then one checked epoch
    (``"all"``) of the metro city's tiled trainer."""
    import dataclasses as dc

    import torch

    from stmgcn_tpu_torch import Trainer, build_trainer
    from stmgcn_tpu_torch.resilience import FaultPlan, FaultSpec
    from stmgcn_tpu_torch.train.step import CheckError

    def trainer(checks, name, **kw):
        cfg = flagship_config(BATCH)
        cfg.train.checks, cfg.train.out_dir = checks, scratch(f"checks_{name}")
        return build_trainer(cfg, device=device, verbose=False, **kw)

    plain = trainer(None, "plain")
    state = {k: v.detach().cpu().clone() for k, v in plain.model.state_dict().items()}
    checked = trainer("all", "all", initial_state=state)
    block = [b for b in plain._blocks(list(plain.batches("train")), 0)
             if len(b) == SUPERSTEP][0]
    lp, lc = plain._run_block(block), checked._run_block(block)
    same = lp == lc and same_state(plain, checked)
    if not same:
        fail(f"a clean checked block differs from the unchecked one: {lc} vs {lp}")
    p50 = ab_p50({"checked": lambda: checked._run_block(block),
                  "unchecked": lambda: plain._run_block(block)}, 8)
    print(f"sanitizers at the dense bench point: a clean checked block (checks='all') bitwise "
          f"the unchecked one: {same}; block p50 (in turns) checked {p50['checked']:.4f} ms, "
          f"unchecked {p50['unchecked']:.4f} ms (checked / unchecked "
          f"{p50['checked'] / p50['unchecked']:.4f}); graph pools {pool_bytes(checked)} / "
          f"{pool_bytes(plain)} bytes")
    del plain, checked
    torch.cuda.empty_cache()

    poisoned = trainer("nan", "poison", fault_plan=FaultPlan(FaultSpec("poison", epoch=1,
                                                                       step=POISON_AT[1])))
    try:
        poisoned.train()
        fail("a NaN poison under checks='nan' did not raise")
    except CheckError as e:
        if e.check != "nan" or f"step {POISON_AT[1]} " not in str(e):
            fail(f"the NaN poison's error names another check or step: {e}")
        print(f"sanitizers, NaN poison at epoch 1 step {POISON_AT[1]}: raised {e}")
    del poisoned
    indexed = trainer("index", "index")
    block = [b for b in indexed._blocks(list(indexed.batches("train")), 0)
             if len(b) == SUPERSTEP][0]
    bad = dc.replace(block[1], indices=np.asarray(block[1].indices) + 10**6)
    try:
        indexed._run_block([block[0], bad] + block[2:])
        fail("an out-of-range window index under checks='index' did not raise")
    except CheckError as e:
        if e.check != "index" or "step 1 " not in str(e):
            fail(f"the index drill's error names another check or step: {e}")
        text = str(e)
    after = indexed._run_block(block)
    torch.cuda.synchronize()
    if not all(math.isfinite(v) for v in after):
        fail(f"the dispatch after the index drill: losses {after}")
    print(f"sanitizers, index drill (batch 1 of a block offset by 10^6): raised {text}; the "
          f"next dispatch ran in the same process, losses {after}")
    del indexed
    torch.cuda.empty_cache()

    t = metro_config("tiled").train
    metro = Trainer(metro_model("tiled", ds, device), ds, plan_dev, lr=t.lr,
                    weight_decay=t.weight_decay, n_epochs=1, batch_size=METRO_BATCH,
                    steps_per_superstep=SUPERSTEP, checks="all",
                    out_dir=scratch("checks_metro"), device=device, verbose=False)
    reset_counts()
    history = metro.train()
    counts = read_counts()
    if not all(math.isfinite(v) for v in history["train"] + history["validate"]):
        fail(f"checked metro epoch: {history}")
    if not counts["B3"] or not counts["B4"]:
        fail(f"checked metro epoch did not launch B3 and B4: {counts_text(counts)}")
    print(f"sanitizers, one checked epoch (checks='all') of the metro plan's tiled trainer: "
          f"losses {history}; launches {counts_text(counts)}")
    del metro
    torch.cuda.empty_cache()


def tracing_phase(device) -> None:
    """Phase 45: tracing (``stmgcn_tpu_torch/obs/trace.py``): a traced dense
    run of EPOCHS epochs at the bench point, then 64 micro-batched requests
    to an engine on its weights; the JSONL written and the port's ``obs``
    report rendering it (one JSON line, the span coverage of the wall
    window); then traced against untraced block p50 and micro-batched rung-1
    p50, in turns."""
    import contextlib
    import io

    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig, build_trainer
    from stmgcn_tpu_torch.experiment import build_dataset, build_supports
    from stmgcn_tpu_torch.obs import trace as obs_trace
    from stmgcn_tpu_torch.obs.cli import main as obs_main

    trc = obs_trace.configure(capacity=8192)
    try:
        cfg = flagship_config(BATCH)
        cfg.train.out_dir = scratch("traced")
        trainer = build_trainer(cfg, device=device, verbose=False)
        trainer.train()
        ds = build_dataset(cfg)
        supports = build_supports(cfg, ds)
        fc = Forecaster(trainer.model, trainer.model.state_dict(), ds.normalizer, cfg,
                        {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}, device=device)
        windows = ds.denormalize(ds.arrays("test")[0])
        engine = fc.serving_engine(supports, config=ServingConfig(buckets=BUCKETS),
                                   device=device)
        for i in range(64):
            engine.predict(windows[i:i + 1])
        path = scratch("trace.jsonl")
        n = trc.export_jsonl(path)
    finally:
        obs_trace.configure(enable=False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = obs_main([path, "--format", "json"])
    doc = json.loads(out.getvalue())
    names = {p["name"]: p for p in doc["summary"]["phases"]}
    want = {"train.superstep", "train.upload", "train.host_pack", "train.epoch",
            "train.eval_epoch", "train.checkpoint", "serve.admit", "serve.queue",
            "serve.device", "serve.scatter"}
    if code != 0 or not want <= set(names) or doc["meta"]["spans"] != n:
        fail(f"the traced run's report: exit {code}, phases {sorted(names)}")
    top = sorted(names.values(), key=lambda p: -p["self_ms"])[:6]
    print(f"tracing: {n} spans written (dropped {doc['meta']['dropped']}), the obs report "
          f"reads them: coverage {doc['summary']['coverage']} of {doc['summary']['wall_ms']} ms; "
          "top phases by self time: " + "; ".join(
              f"{p['name']} {p['count']} x {p['mean_ms']} ms" for p in top))

    block = [b for b in trainer._blocks(list(trainer.batches("train")), 0)
             if len(b) == SUPERSTEP][0]
    one = windows[:1]

    def traced(fn):
        def run():
            obs_trace.configure()
            try:
                fn()
            finally:
                obs_trace.configure(enable=False)
        return run

    def untraced(fn):
        def run():
            obs_trace.configure(enable=False)
            fn()
        return run

    step = lambda: trainer._run_block(block)  # noqa: E731
    p50 = ab_p50({"traced": traced(step), "untraced": untraced(step)}, 8)
    request = lambda: engine.predict(one)  # noqa: E731
    r50 = ab_p50({"traced": traced(request), "untraced": untraced(request)}, 40)
    engine.close()
    print(f"tracing, p50 in turns: a block of {SUPERSTEP} steps traced {p50['traced']:.4f} ms, "
          f"untraced {p50['untraced']:.4f} ms (traced / untraced "
          f"{p50['traced'] / p50['untraced']:.4f}); micro-batched rung 1 traced "
          f"{r50['traced']:.4f} ms, untraced {r50['untraced']:.4f} ms (traced / untraced "
          f"{r50['traced'] / r50['untraced']:.4f})")
    del trainer, engine
    torch.cuda.empty_cache()


def bitwise_diff(a: dict, b: dict) -> list:
    """The names of the tensors of two state dicts that differ, each with
    its max |difference|."""
    import torch

    return [f"{k} {(a[k].float() - b[k].float()).abs().max().item():.3e}"
            for k in a if not torch.equal(a[k], b[k])]


def metro_repeatability(device, ds, plan_dev) -> dict:
    """Phase 43 (the repeatability drill): one tiled training block of SUPERSTEP
    steps at the metro plan from one state, run twice graphed and twice
    eager (four fresh trainers), each pair compared bit for bit (losses,
    parameters and Adam moments); then one eager forward and backward
    twice, outputs and every parameter gradient compared (forward against
    backward); then the same block under
    ``torch.use_deterministic_algorithms(True)`` with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set for this phase only, where
    PyTorch raises at an op it knows to be nondeterministic. Fails unless
    both pairs are bitwise equal; returns the launches of the four blocks."""
    import torch

    from stmgcn_tpu_torch import Trainer
    from stmgcn_tpu_torch.train.step import masked_loss

    t = metro_config("tiled").train
    state = {k: v.detach().cpu().clone()
             for k, v in metro_model("tiled", ds, device).state_dict().items()}

    def trainer(graphs, name):
        return Trainer(metro_model("tiled", ds, device), ds, plan_dev, lr=t.lr,
                       weight_decay=t.weight_decay, n_epochs=1, batch_size=METRO_BATCH,
                       steps_per_superstep=SUPERSTEP, out_dir=scratch(f"repeat_{name}"),
                       initial_state=state, device=device, graphs=graphs, verbose=False)

    def block_of(tr):
        return [b for b in tr._blocks(list(tr.batches("train")), 0)
                if len(b) == SUPERSTEP][0]

    def run(graphs, name):
        tr = trainer(graphs, name)
        losses = tr._run_block(block_of(tr))
        torch.cuda.synchronize()
        names = list(tr.model.state_dict())
        names += [f"{n} (Adam m)" for n in tr._param_names]
        names += [f"{n} (Adam v)" for n in tr._param_names]
        out = ([float(v) for v in losses], dict(zip(names, end_state(tr), strict=True)))
        del tr
        torch.cuda.empty_cache()
        return out

    reset_counts()
    verdict, first = {}, {}
    for route, graphs in (("graphed", True), ("eager", False)):
        (la, sa), (lb, sb) = run(graphs, f"{route}_a"), run(graphs, f"{route}_b")
        diff = bitwise_diff(sa, sb)
        verdict[route], first[route] = la == lb and not diff, (la, sa)
        print(f"metro repeatability, {route} against {route}, one block of {SUPERSTEP} steps "
              f"from one state: losses equal {la == lb} ({la} vs {lb}); state tensors that "
              f"differ: {len(diff)} of {len(sa)} {diff[:4]}")
    counts = read_counts()
    (lg, sg), (le, se) = first["graphed"], first["eager"]
    diff = bitwise_diff(sg, se)
    print(f"metro repeatability, graphed against eager (two programs, not one run "
          f"repeated; held to agree_over_steps' tolerances in phase 34): losses equal "
          f"{lg == le}; state tensors that differ: {len(diff)} of {len(sg)} {diff[:4]}")

    # forward against backward, eager, one batch
    tr = trainer(False, "bisect")
    batch = block_of(tr)[0]
    runs = []
    x, y, mask = tr.place(batch, "train")
    data = tr._cities[batch.city]
    for _ in range(2):
        tr.model.zero_grad(set_to_none=True)
        loss = masked_loss(tr.loss, tr.model(data.supports, x, data.n_real), y, mask)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.detach().clone(), {n: p.grad.detach().clone()
                                             for n, p in tr.model.named_parameters()}))
    grads = bitwise_diff(runs[0][1], runs[1][1])
    print(f"metro repeatability, eager forward twice: losses bitwise equal "
          f"{torch.equal(runs[0][0], runs[1][0])}; parameter gradients that differ: "
          f"{len(grads)} of {len(runs[0][1])} {grads[:6]}")

    old = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        tr._run_block(block_of(tr))
        torch.cuda.synchronize()
        print("metro repeatability, deterministic algorithms: one eager block ran; PyTorch "
              "flagged no op")
    except RuntimeError as exc:
        print(f"metro repeatability, deterministic algorithms: PyTorch raised: "
              f"{str(exc).splitlines()[0]}")
    finally:
        torch.use_deterministic_algorithms(False)
        if old is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old
    del tr
    torch.cuda.empty_cache()
    for route, same in verdict.items():
        if not same:
            fail(f"metro repeatability: two {route} runs of one tiled block from one state "
                 "differ")
    return counts


#: the closed loop and the federation (phases 46-48). The ring: the JAX
#: default capacity and reorder window (``ContinualConfig``), RING_ROWS
#: source rows of the dense city through an IngestFaultPlan of RING_FAULTS
#: rounds of late, duplicate, gap, nonfinite and stale rows, the allocated
#: bytes read after RING_WARMUP arrivals. The loop: LOOP_LIVE rows ingested
#: live before each of its cycles, the held-out targets, the calm traffic
#: served before the first trigger (s), the bound on waiting for the
#: background daemon's decision (s). The federation: the multicity preset's
#: model over FED_CITY_ROWS grids (its two cities and a third, 3 replicas
#: need 3 cities) and their series lengths, FED_REPLICAS replicas and one
#: warm spare over one GlobalBudget of 2 x the replicas' queue bound, the
#: ladder FED_BUCKETS, FED_CALLS scatters for the predict_many p50, the
#: drills' scatter ordinals and the herd burst
RING_ROWS, RING_FAULTS, RING_WARMUP = 2000, 8, 200
LOOP_LIVE, LOOP_HOLDOUT, LOOP_CALM_S, LOOP_WAIT_S = 20, 4, 1.0, 60.0
FED_CITY_ROWS, FED_CITY_TIMESTEPS = (12, 10, 11), (24 * 7 * 4, 24 * 7 * 3, 24 * 7 * 3)
FED_REPLICAS, FED_BUCKETS, FED_CALLS = 3, (1, 4, 16), 30
FED_KILL_AT, FED_HERD_AT, FED_HERD_BURST = 2, 4, 32


def ring_phase(device) -> None:
    """Phase 46: the ingest ring at the dense city (N = 256) and the JAX
    default capacity: RING_ROWS rows of the synthetic series through a fault
    plan, the card's ring against a CPU ring fed the same arrivals (every
    outcome, ``series()``, ``target_indices`` and ``window_at`` bitwise),
    no allocation growth after warmup, the p50 host time of an ingest."""
    import torch

    from stmgcn_tpu_torch.config import ContinualConfig
    from stmgcn_tpu_torch.data import SeriesRing, StaleObservationError
    from stmgcn_tpu_torch.experiment import build_dataset
    from stmgcn_tpu_torch.resilience import IngestFaultPlan, IngestFaultSpec

    ccfg = ContinualConfig()
    cfg = pallas_preset("default")
    cfg.data.rows, cfg.data.serial_len, cfg.data.n_timesteps = GRID, SERIAL, RING_ROWS + 64
    ds = build_dataset(cfg)
    series = ds.series()
    specs = []
    for k in range(RING_FAULTS):
        base = 100 + k * (RING_ROWS - 200) // RING_FAULTS
        specs += [IngestFaultSpec(kind="out-of-order", row=base, delay=2),
                  IngestFaultSpec(kind="duplicate", row=base + 30),
                  IngestFaultSpec(kind="gap", row=base + 60),
                  IngestFaultSpec(kind="nonfinite", row=base + 90),
                  IngestFaultSpec(kind="out-of-order", row=base + 120,
                                  delay=ccfg.reorder_window + 3)]
    plan = IngestFaultPlan(specs)
    arrivals = [a for t in range(RING_ROWS) for a in plan.feed(t, series[t])]
    rings = {d: SeriesRing(ccfg.ring_capacity, ds.n_nodes, ds.n_feats,
                           reorder_window=ccfg.reorder_window, device=d)
             for d in (device, "cpu")}
    card, host = rings[device], rings["cpu"]
    address = card.buffer.data_ptr()
    outcomes = {d: [] for d in rings}
    ms, allocated = [], None
    for i, (ts, row) in enumerate(arrivals):
        for d, ring in rings.items():
            t0 = time.perf_counter()
            try:
                outcomes[d].append(ring.ingest(ts, row))
            except StaleObservationError:
                outcomes[d].append("stale")
            if ring is card:
                ms.append((time.perf_counter() - t0) * 1e3)
        if i == RING_WARMUP and device.type == "cuda":
            torch.cuda.synchronize()
            allocated = torch.cuda.memory_allocated(device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated(device) - allocated
        if grown:
            fail(f"ring: {grown} more bytes allocated on the card after warmup")
    if outcomes[device] != outcomes["cpu"]:
        fail("ring: the card's and the CPU's outcomes differ")
    kinds = {k: outcomes["cpu"].count(k) for k in sorted(set(outcomes["cpu"]))}
    if set(kinds) != {"append", "gap-fill", "late", "duplicate", "nonfinite", "stale"}:
        fail(f"ring: the fault mix gave outcomes {kinds}")
    if card.buffer.data_ptr() != address:
        fail("ring: the buffer moved")
    spec = ds.window
    got, want = card.series().cpu(), host.series()
    targets = card.target_indices(spec)
    same = (torch.equal(got, want) and np.array_equal(targets, host.target_indices(spec))
            and all(np.array_equal(card.window_at(spec, card.origin_ts + int(t)),
                                   host.window_at(spec, host.origin_ts + int(t)))
                    for t in targets[::97]))
    if not same or not torch.isfinite(got).all():
        fail("ring: the card's series, targets or windows differ from the CPU ring's")
    for attr in ("count", "rows", "gaps", "out_of_order", "duplicates", "nonfinite"):
        if getattr(card, attr) != getattr(host, attr):
            fail(f"ring: {attr} {getattr(card, attr)} on the card, {getattr(host, attr)} on "
                 "the CPU")
    print(f"ring (N = {ds.n_nodes}, capacity {ccfg.ring_capacity}, reorder window "
          f"{ccfg.reorder_window}): {len(arrivals)} arrivals of {RING_ROWS} source rows, "
          f"outcomes {kinds}; series ({len(card)} rows, origin slot {card.origin_slot}), "
          f"{len(targets)} targets and windows bitwise the CPU ring's; allocated bytes "
          f"unchanged after {RING_WARMUP} arrivals, the buffer in place; ingest p50 "
          f"{np.percentile(ms, 50):.4f} ms, p99 {np.percentile(ms, 99):.4f} ms (host clock)")


def _timed(obj, name: str, log: list):
    """Wrap method ``name`` of ``obj`` to append the host ms of each call
    that returns to ``log``."""
    fn = getattr(obj, name)

    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        log.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(obj, name, timed)


def _drift_peak(snapshot) -> tuple:
    """The largest ``z_max`` and ``psi`` of any city and phase."""
    gauges = [g for phases in (snapshot or {}).get("cities", {}).values()
              for g in phases.values()]
    return (max((float(g.get("z_max", 0.0)) for g in gauges), default=0.0),
            max((float(g.get("psi", 0.0)) for g in gauges), default=0.0))


def closed_loop_phase(device) -> dict:
    """Phase 47: the closed loop at the dense flagship, fp32. A graphed
    ``ServingEngine`` with drift on (the baseline of a one-epoch health
    run), a ring pre-filled past its capacity, a ``ContinualTrainer`` at
    the JAX defaults and a ``PromotionGate`` with a real held-out eval,
    supervised by a ``ContinualDaemon``, while a serving thread answers
    held-out windows throughout. Five cycles: a clean promotion, a poisoned
    fine-tune (rejected ``nonfinite``), a corrupt candidate write
    (``corrupt``), a raise retried after the daemon's backoff (promoted),
    one run of the background thread and a bounded stop. The card's first
    candidate against a CPU port fine-tune from the same start, normwise.
    Returns the launches of its main path."""
    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig
    from stmgcn_tpu_torch.config import ContinualConfig
    from stmgcn_tpu_torch.data import SeriesRing
    from stmgcn_tpu_torch.obs import graphmon
    from stmgcn_tpu_torch.resilience import FaultPlan, FaultSpec
    from stmgcn_tpu_torch.serving import PromotionGate
    from stmgcn_tpu_torch.train import (
        ContinualDaemon,
        ContinualTrainer,
        make_holdout_eval,
        make_optimizer,
    )

    root = scratch("closed_loop")
    base = resilience_trainer(device, os.path.join(root, "train"), health_k=1, drift=True,
                              epochs=1)
    base.train()
    fc = Forecaster.from_checkpoint(base.best_path, device=device)
    ds, supports = base.dataset, base.supports.cpu().numpy()
    del base
    release()
    if fc.health_baseline is None:
        fail("closed loop: the health run's best.ckpt carries no drift baseline")
    series, spec = ds.series(), ds.window
    ccfg = ContinualConfig(enabled=True)
    warm = series.shape[0] - 5 * LOOP_LIVE
    adam = functools.partial(make_optimizer, lr=1e-3)
    initial = {k: v.detach().cpu().clone() for k, v in fc.model.state_dict().items()}

    reset_counts()
    ring = SeriesRing.from_series(series[:warm], capacity=ccfg.ring_capacity,
                                  reorder_window=ccfg.reorder_window, device=device)
    engine = fc.serving_engine(supports, config=ServingConfig(buckets=BUCKETS), device=device)
    if engine.drift is None or engine.graphs != (device.type == "cuda"):
        fail("closed loop: the engine is not graphed with drift on")
    plan = FaultPlan(FaultSpec("poison", epoch=1, step=0),
                     FaultSpec("corrupt-write", path_glob="candidate-0002.ckpt"),
                     FaultSpec("raise", epoch=3, step=0))
    trainer = ContinualTrainer(fc.model, adam, supports, ring, spec, ccfg, root,
                               holdout=LOOP_HOLDOUT, fault_plan=plan,
                               health_baseline=fc.health_baseline, device=device)
    gate = PromotionGate.from_config(
        engine, os.path.join(root, "watch"), ccfg, live_params=initial,
        holdout_eval=make_holdout_eval(fc.model, supports, ring, spec, holdout=LOOP_HOLDOUT,
                                       device=device))
    events: list = []
    daemon = ContinualDaemon(trainer, gate, config=ccfg, log=events.append)
    times = {"finetune": [], "gate": [], "swap": []}
    _timed(trainer, "finetune", times["finetune"])
    _timed(gate, "_evaluate", times["gate"])
    _timed(engine, "swap_params", times["swap"])

    windows = ds.denormalize(ds.arrays("test")[0])
    stop = threading.Event()
    seen = {"answers": 0, "errors": [], "back": 0, "first": {}}

    def serving():
        last, k = -1, 0
        while not stop.is_set():
            rows = windows[k % len(windows)][None]
            k += 1
            try:
                out, gen = engine.predict(rows, with_generation=True)
            except Exception as e:  # noqa: BLE001 — reported below
                seen["errors"].append(repr(e))
                continue
            if not np.isfinite(out).all():
                seen["errors"].append(f"non-finite answer at generation {gen}")
            seen["back"] += gen < last
            seen["first"].setdefault(gen, time.perf_counter())
            last = gen
            seen["answers"] += 1

    def feed(n: int) -> float:
        for _ in range(n):
            ring.ingest(ring.next_ts, series[ring.next_ts])
        return time.perf_counter()

    def wait_for(generation: int) -> float:
        deadline = time.perf_counter() + LOOP_WAIT_S
        while generation not in seen["first"] and time.perf_counter() < deadline:
            time.sleep(0.001)
        if generation not in seen["first"]:
            fail(f"closed loop: no answer of generation {generation} within {LOOP_WAIT_S} s")
        return seen["first"][generation]

    thread = threading.Thread(target=serving, name="closed-loop-serving", daemon=True)
    thread.start()
    try:
        time.sleep(LOOP_CALM_S)
        z_calm, psi_calm = _drift_peak(engine.drift_snapshot())
        fired = daemon.should_retrain()
        print(f"closed loop, calm held-out traffic ({seen['answers']} answers in "
              f"{LOOP_CALM_S} s): drift z_max {z_calm:.4f} (drift_z_max {ccfg.drift_z_max}), "
              f"psi {psi_calm:.4f} (drift_psi {ccfg.drift_psi}); should_retrain -> {fired!r}")

        # the CPU twin of the first fine-tune: the same ring contents and start
        cpu_ring = SeriesRing.from_series(ring.series().cpu().numpy(),
                                          start_ts=ring.origin_ts, capacity=len(ring),
                                          reorder_window=ccfg.reorder_window, device="cpu")
        t_trigger = feed(LOOP_LIVE)
        for ts in range(cpu_ring.next_ts, ring.next_ts):
            cpu_ring.ingest(ts, series[ts])
        cpu_trainer = ContinualTrainer(fc.model, adam, supports, cpu_ring, spec, ccfg,
                                       os.path.join(root, "cpu"), params=initial,
                                       holdout=LOOP_HOLDOUT, device="cpu")
        cycles = [daemon.retrain(fired or "cadence")]
        if cycles[0] is None or not cycles[0].accepted:
            fail(f"closed loop: the clean cycle gave {cycles[0]}; log {events}")
        t_new = wait_for(1)
        graphmon.mark_warmup_complete()
        cpu_trainer.finetune()
        cpu_trainer.commit()
        worst = max(float((trainer.params[k] - cpu_trainer.params[k]).norm()
                          / (cpu_trainer.params[k] - initial[k]).norm()) for k in initial)
        if not worst <= CPU_UPDATE_RTOL:
            fail(f"closed loop: the card's candidate differs from the CPU port's by {worst:.3e} "
                 f"of its update (limit {CPU_UPDATE_RTOL})")
        for _ in range(3):  # poison, corrupt write, raise then retry
            feed(LOOP_LIVE)
            cycles.append(daemon.retrain("drift"))
        feed(LOOP_LIVE)
        daemon.config = dataclasses.replace(ccfg, cadence_s=0.05)
        decided = len(gate.decisions)
        daemon.start(poll_s=0.05)
        deadline = time.perf_counter() + LOOP_WAIT_S
        while len(gate.decisions) == decided and time.perf_counter() < deadline:
            time.sleep(0.01)
        t0 = time.perf_counter()
        stopped = daemon.stop()
        stop_ms = (time.perf_counter() - t0) * 1e3
        if len(gate.decisions) == decided or not stopped:
            fail(f"closed loop: the background daemon decided {len(gate.decisions) - decided} "
                 f"candidates, stop() -> {stopped}")
        cycles.append(gate.decisions[-1])
        time.sleep(0.1)
    finally:
        stop.set()
        thread.join(timeout=60)
        daemon.stop()
    counts = read_counts()
    reasons = [None if d is None else d.reason for d in cycles]
    if reasons[:4] != ["promoted", "nonfinite", "corrupt", "promoted"] or daemon.restarts != 1:
        fail(f"closed loop: cycles {reasons}, daemon restarts {daemon.restarts}, log {events}")
    if seen["errors"] or seen["back"] or thread.is_alive():
        fail(f"closed loop: serving errors {seen['errors'][:3]}, generation went back "
             f"{seen['back']} times")
    if max(seen["first"]) != engine.generation or engine.generation != gate.promotions:
        fail(f"closed loop: serving saw generations {sorted(seen['first'])}, the engine is at "
             f"{engine.generation} after {gate.promotions} promotions")
    recaptures = graphmon.snapshot()["recaptures_after_warmup"]
    if recaptures:
        fail(f"closed loop: {recaptures} recaptures after the first fine-tune")
    if not counts["B1"] or not counts["B2"] or any(counts[k] for k in ("B3", "B4", "B5")):
        fail(f"closed loop: launches {counts_text(counts)}")
    capture_ms = getattr(trainer._program, "capture_ms", None)
    pool = trainer.graph_pool and trainer.graph_pool.reserved_bytes
    print(f"closed loop cycles: {reasons} (daemon restarts {daemon.restarts}, background stop "
          f"{stop_ms:.1f} ms); serving thread {seen['answers']} answers, 0 errors, generations "
          f"{sorted(seen['first'])} never going back; recaptures after the first fine-tune 0")
    print(f"closed loop times (host clock): fine-tune {ccfg.finetune_steps} steps at batch "
          f"{ccfg.finetune_batch} (with the candidate write) first {times['finetune'][0]:.2f} ms "
          f"(capture {capture_ms} ms), then p50 "
          f"{np.percentile(times['finetune'][1:], 50):.2f} ms; gate checks (verify, two held-out "
          f"evaluations) p50 {np.percentile(times['gate'], 50):.2f} ms; swap (the ladder's "
          f"capture) p50 {np.percentile(times['swap'], 50):.2f} ms; triggering row to the first "
          f"answer of generation 1 {(t_new - t_trigger) * 1e3:.2f} ms; fine-tune pool "
          f"{pool} bytes")
    print(f"closed loop, card vs CPU port fine-tune from one start: worst tensor "
          f"|card - cpu| / |cpu update| {worst:.3e} (limit {CPU_UPDATE_RTOL}); the held-out "
          f"eval of the first promotion {cycles[0].checks['eval']}")
    print(f"closed loop launches: {counts_text(counts)}")
    engine.close()
    del engine, trainer, gate, daemon, cpu_trainer
    release()
    return counts


def federation_phase(device) -> dict:
    """Phase 48: the multicity preset's fleet engines as a replica tier:
    FED_REPLICAS replicas and a warm spare sharing one ``GlobalBudget`` of
    twice the replicas' queue bound behind a ``FederationRouter`` with the
    four serve-bench drills of one ``FederationFaultPlan`` (a poisoned
    candidate quarantined once by a ``TierPromotionGate``, a replica killed
    at a scatter, a herd spike on one city, hang-on-drain), a tier
    promotion cutting every live replica over, the spare's promotion;
    scattered answers bitwise the owning engine's direct answers, the
    predict_many p50, and the reserved memory after ``close()``. Returns
    the launches of its main path."""
    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig, to_jax_params
    from stmgcn_tpu_torch.config import FederationConfig, MeshConfig
    from stmgcn_tpu_torch.experiment import build_dataset, build_model, build_supports
    from stmgcn_tpu_torch.resilience import FederationFaultPlan, FederationFaultSpec
    from stmgcn_tpu_torch.serving import (
        FederationRouter,
        FleetServingEngine,
        GlobalBudget,
        ShedError,
        TierPromotionGate,
    )
    from stmgcn_tpu_torch.train import save_checkpoint

    cfg = pallas_preset("multicity")
    cfg.mesh = MeshConfig()
    cfg.data.n_cities = len(FED_CITY_ROWS)
    cfg.data.city_rows, cfg.data.city_timesteps = FED_CITY_ROWS, FED_CITY_TIMESTEPS
    ds = build_dataset(cfg)
    sups = build_supports(cfg, ds)
    model = build_model(cfg, ds.n_feats, device=device, generator=torch.Generator().manual_seed(0))
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    n_nodes = ds.city_n_nodes
    fc = Forecaster(model, state, None, cfg, {"input_dim": ds.n_feats, "n_nodes": n_nodes},
                    ds.normalizers, device=device)
    cities = range(len(n_nodes))
    hists = {c: ds.denormalize(ds.city_arrays("test", c)[0][:1], city=c) for c in cities}
    top = FED_BUCKETS[-1]
    serving = ServingConfig(buckets=FED_BUCKETS, max_batch=top, queue_bound_rows=4 * top)
    fed = FederationConfig(enabled=True, replicas=FED_REPLICAS, spares=1,
                           global_queue_bound_rows=2 * serving.queue_bound_rows)
    bad = fed.violations(serving=serving, n_cities=len(n_nodes))
    if bad:
        fail(f"federation: config {bad}")
    drain_rid, kill_rid, spare_rid = 1, FED_REPLICAS - 1, FED_REPLICAS
    plan = FederationFaultPlan(
        FederationFaultSpec(kind="poisoned-candidate", path_glob="candidate-0.ckpt"),
        FederationFaultSpec(kind="replica-kill", replica=kill_rid, dispatch=FED_KILL_AT),
        FederationFaultSpec(kind="herd-spike", city=0, dispatch=FED_HERD_AT,
                            burst=FED_HERD_BURST),
        FederationFaultSpec(kind="hang-on-drain", replica=drain_rid, hang_ms=80.0))
    cuda = device.type == "cuda"
    release()
    reserved0 = torch.cuda.memory_reserved(device) if cuda else 0

    reset_counts()
    budget = GlobalBudget(fed.global_queue_bound_rows)
    engines = [FleetServingEngine.from_forecaster(fc, sups, config=serving, device=device,
                                                  global_budget=budget)
               for _ in range(FED_REPLICAS + 1)]
    router = FederationRouter(engines[:FED_REPLICAS], cities, config=fed,
                              spare_engines=engines[FED_REPLICAS:], global_budget=budget,
                              fault_plan=plan)
    reserved1 = torch.cuda.memory_reserved(device) if cuda else 0
    root = scratch("federation")
    gate = TierPromotionGate(router, os.path.join(root, "watch"))
    clean = {"nonfinite": 0, "grad_norm_max": 1.0, "update_ratio_max": 0.01}
    m = cfg.model.m_graphs
    checks, ms = [], []

    def scatter(what: str, direct: bool = True) -> dict:
        """One predict_many over every city (the fault plan's scatter
        ordinals count these); with ``direct``, each answer held bitwise to
        the answering engine's direct call (the same rung-1 program)."""
        t0 = time.perf_counter()
        outs = router.predict_many(hists)
        ms.append((time.perf_counter() - t0) * 1e3)
        gens = {o.generation for o in outs.values() if o.ok}
        if len(gens) > 1:
            fail(f"federation, {what}: a mixed-generation response {gens}")
        for c, o in outs.items():
            if o.ok and direct:
                got = engines[o.replica].predict_direct(hists[c], city=c)
                checks.append(np.array_equal(o.prediction, got))
        return outs

    try:
        poisoned = os.path.join(root, "candidate-0.ckpt")
        save_checkpoint(poisoned, to_jax_params(state, m), None, {"drill": "poison"})
        rejected = gate.consider(poisoned, clean)
        if (rejected.reason, gate.rejections) != ("corrupt", 1) or any(
                e.generation for e in router.engines().values()):
            fail(f"federation: the poisoned candidate gave {rejected.reason}, "
                 f"{gate.rejections} rejections")
        herd = {"ok": 0, "shed": 0}
        herd_threads = []
        for k in range(FED_CALLS):
            for city, burst in plan.herd_burst(k):
                def hammer(city=city, n=burst // 4):
                    for _ in range(n):
                        try:
                            router.predict(hists[city], city=city)
                            herd["ok"] += 1
                        except ShedError:
                            herd["shed"] += 1
                herd_threads = [threading.Thread(target=hammer) for _ in range(4)]
                for t in herd_threads:
                    t.start()
            outs = scatter(f"scatter {k}", direct=not herd_threads)
            if k > FED_KILL_AT and not all(o.ok for o in outs.values()):
                fail("federation: after the kill, " + ", ".join(
                    f"city {c} {o.error!r}" for c, o in outs.items() if not o.ok))
            for t in herd_threads:  # herd answers may share a rung with a scatter's
                t.join(timeout=60)
            herd_threads = []
        if router.kills != 1 or kill_rid in router.assignment().values():
            fail(f"federation: kills {router.kills}, assignment {router.assignment()}")
        if herd["ok"] + herd["shed"] == 0:
            fail("federation: the herd spike sent nothing")
        good = os.path.join(root, "candidate-1.ckpt")
        new = {k: v * 1.001 for k, v in state.items()}
        save_checkpoint(good, to_jax_params(new, m), None, {"drill": "promote"})
        live = sorted(router.engines())
        promoted = gate.consider(good, clean)
        tier = promoted.checks.get("tier", {})
        if not promoted.accepted or tier.get("swapped") != live or tier.get("failed"):
            fail(f"federation: the tier promotion gave {promoted.reason}, {tier}")
        if {e.generation for e in router.engines().values()} != {1}:
            fail("federation: a live replica missed the cutover")
        outs = scatter("after the cutover")
        ref = Forecaster(build_model(cfg, ds.n_feats, device=device), new, None, cfg,
                         fc.derived, ds.normalizers, device=device)
        for c, o in outs.items():
            want = ref.predict(sups.for_city(c), hists[c], city=c)
            if not o.ok or o.generation != 1 or not np.allclose(o.prediction, want,
                                                                rtol=SERVE_RTOL,
                                                                atol=SERVE_ATOL):
                fail(f"federation: city {c} after the cutover: {o}")
        drained = router.drain(drain_rid)
        if not drained["flushed"] or drained["watcher_wedged"]:
            fail(f"federation: drain {drained}")
        if not all(o.ok for o in scatter("after the drain").values()):
            fail("federation: a city went unanswered after the drain")
        joined = router.promote_spare(spare_rid)
        if spare_rid not in router.assignment().values() or not joined["handover_flushed"]:
            fail(f"federation: the spare did not join: {joined}")
        if not all(o.ok for o in scatter("after the spare joined").values()):
            fail("federation: a city went unanswered after the spare joined")
        if not all(checks):
            fail(f"federation: {checks.count(False)} of {len(checks)} scattered answers differ "
                 "from the owning engine's direct answer")
        health = router.health()
        pools = sum(e.graph_pool_bytes or 0 for e in engines)  # the live generations'
        reserved_live = torch.cuda.memory_reserved(device) if cuda else 0
    finally:
        router.close()
    counts = read_counts()
    del engines, router, gate
    release()
    reserved2 = torch.cuda.memory_reserved(device) if cuda else 0
    if cuda and reserved_live - reserved2 < 0.75 * pools:
        fail(f"federation: close() returned {reserved_live - reserved2} reserved bytes of the "
             f"live graph pools' {pools}")
    # what stays reserved: cuBLAS keeps a workspace per (handle, stream), and
    # each graph pool captured on a stream of its own
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if cuda and clear is not None:
        clear()
        torch.cuda.empty_cache()
    reserved3 = torch.cuda.memory_reserved(device) if cuda else 0
    if not counts["B1"] or any(counts[k] for k in ("B2", "B3", "B4", "B5")):
        fail(f"federation: launches {counts_text(counts)}")
    print(f"federation ({FED_REPLICAS} replicas + 1 spare, cities N = {n_nodes}, budget "
          f"{budget.total_rows} rows): the poisoned candidate quarantined once "
          f"({os.path.basename(rejected.path)}); "
          f"replica {kill_rid} killed at scatter {FED_KILL_AT}, every city answered after; "
          f"herd spike on city 0: {herd['ok']} answered, {herd['shed']} shed; tier promotion "
          f"to generation 1 on replicas {tier['swapped']}; drain of replica {drain_rid} "
          f"(hang 80 ms) {drained['drain_ms']} ms, {drained['moved_cities']} cities moved; "
          f"spare {spare_rid} joined, {joined['moved_cities']} cities moved")
    print(f"federation: {len(checks)} scattered answers bitwise the owning engine's; "
          f"predict_many p50 over {len(n_nodes)} cities {np.percentile(ms, 50):.4f} ms "
          f"(host clock); budget {health['budget']}; reserved MiB: {reserved0 / 2**20:.1f} "
          f"before the tier, {reserved1 / 2**20:.1f} built, {reserved_live / 2**20:.1f} before "
          f"close() (live graph pools {pools / 2**20:.1f}), {reserved2 / 2**20:.1f} after it, "
          f"{reserved3 / 2**20:.1f} with cuBLAS's workspaces cleared; launches "
          f"{counts_text(counts)}")
    return counts


# -- export artifacts, serve-bench, profile and MFU (phases 49-51) -------------

#: phase 49: the requests each artifact answers (batches 1, 3 and 7 from one
#: symbolic batch, and the top rung), and the rung-1 calls per route and turn
EXPORT_BATCHES = (1, 3, 7, 64)
OP_AB_CALLS = 40
#: the graphed block-step p50 (ms) of each dense training A/B of phase 31, by
#: its name: phase 51's MFU reads it
STEP_P50: dict = {}


def export_phase(device) -> dict:
    """Phase 49: the ``default`` flagship (dense city, N = 256, seeded random
    weights) exported in fp32 and in bf16 (the xla form of B1), each file
    loaded into a fresh ``ExportedForecaster`` on the card and on the CPU:
    requests of EXPORT_BATCHES rows against ``Forecaster.predict`` on the
    card (fp32 at SERVE_RTOL/SERVE_ATOL, bf16 within BF16_SERVE_MAX and
    BF16_SERVE_NORM with the fp32 model as the control the limits must
    reject) and against the CPU load of the same file; B1's launches per
    predict (one, and in bf16 one in the xla form); the file's bytes, the
    export and load seconds. Then a graphed ``from_artifact`` engine beside
    a graphed ``from_forecaster`` one (every rung equal, the launches equal,
    each rung's p50 in turns, no capture after warmup), the artifact's own
    ``predict`` routed through the engine, ``swap_params`` refused, and
    rung 1 through the B1 operator against the launch called directly from
    Python (the route before the operator). Returns the launches of the
    export path (``fp32``: B1 in fp32, ``xla``: B1 in the xla form)."""
    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig, ServingEngine, preset
    from stmgcn_tpu_torch.experiment import build_dataset, build_model, build_supports
    from stmgcn_tpu_torch.export import ExportedForecaster, export_forecaster
    from stmgcn_tpu_torch.obs import graphmon

    cfg = preset("default")
    cfg.data.rows, cfg.data.serial_len = GRID, SERIAL
    ds = build_dataset(cfg)
    supports = build_supports(cfg, ds)
    derived = {"input_dim": ds.n_feats, "n_nodes": ds.n_nodes}
    model = build_model(cfg, ds.n_feats, device=device, generator=torch.Generator().manual_seed(0))
    state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    windows = ds.denormalize(ds.arrays("test")[0])
    fcs = {"fp32": Forecaster(model, state, ds.normalizer, cfg, derived, device=device)}
    cfg16 = preset("default")
    cfg16.data.rows, cfg16.data.serial_len, cfg16.model.dtype = GRID, SERIAL, "bfloat16"
    fcs["bf16"] = Forecaster(build_model(cfg16, ds.n_feats, device=device), state,
                             ds.normalizer, cfg16, derived, device=device)
    per_predict = {"fp32": {"B1": 1}, "bf16": {"B1": 1, "B1 xla": 1}}
    launches = {"fp32": 0, "xla": 0}
    loaded = {}
    for name, fc in fcs.items():
        path = scratch(f"flagship_{name}.stmgx")
        t0 = time.perf_counter()
        export_forecaster(fc, path)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ex = ExportedForecaster.load(path)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ex_cpu = ExportedForecaster.load(path, device="cpu")
        cpu_load_s = time.perf_counter() - t0
        if ex.device.type != "cuda" or ex.meta["dtype"] != ("float32" if name == "fp32"
                                                            else "bfloat16"):
            fail(f"export {name}: loaded on {ex.device}, meta dtype {ex.meta['dtype']}")
        nodes = [n.target for n in ex.exported.graph.nodes if n.op == "call_function"]
        n_ops = sum("stmgcn.fused_lstm_fwd" in str(t) for t in nodes)
        if n_ops != 1:
            fail(f"export {name}: the program holds {n_ops} B1 operator nodes, expected one")
        texts = []
        for b in EXPORT_BATCHES:
            rows = windows[:b]
            reset_counts()
            got = ex.predict(supports, rows)
            counts = read_counts()
            check_counts(counts, per_predict[name], {}, 1, 0, f"export {name}, predict({b})")
            launches["fp32" if name == "fp32" else "xla"] += 1
            want, cpu = fc.predict(supports, rows), ex_cpu.predict(supports, rows)
            if got.shape != want.shape or got.dtype != np.float32:
                fail(f"export {name}, predict({b}): {got.shape} {got.dtype}, want {want.shape}")
            if name == "fp32":
                serve_check(got, want, f"export fp32, predict({b}), artifact vs Forecaster")
                serve_check(got, cpu, f"export fp32, predict({b}), card vs CPU load")
                texts.append(f"{b} rows: max |err| vs Forecaster {np.abs(got - want).max():.3e}, "
                             f"vs CPU {np.abs(got - cpu).max():.3e}")
            else:
                control = fcs["fp32"].predict(supports, rows)
                a = bf16_check(got, want, f"export bf16, predict({b}), artifact vs Forecaster",
                               control=control)
                c = bf16_check(got, cpu, f"export bf16, predict({b}), card vs CPU load",
                               control=control)
                texts.append(f"{b} rows: vs Forecaster {a}; vs CPU {c}")
        print(f"export {name}: {os.path.getsize(path)} bytes, export {export_s:.3f} s (traced on "
              f"the CPU), load {load_s:.3f} s on the card, {cpu_load_s:.3f} s on the CPU; "
              f"launches per predict {counts_text(per_predict[name])}, held at every batch")
        for text in texts:
            print(f"export {name}, {text}")
        loaded[name] = ex

    config = ServingConfig(buckets=BUCKETS, max_batch=BUCKETS[-1])
    requests = {b: windows[:b] for b in BUCKETS}
    ex = loaded["fp32"]
    with ServingEngine.from_artifact(ex, supports, config=config) as art, \
            fcs["fp32"].serving_engine(supports, config=config, device=device) as ref:
        if not art.graphs or not ref.graphs:
            fail("export: the from_artifact or from_forecaster engine is not graphed")
        graphmon.mark_warmup_complete()
        outs, counts = {}, {}
        for name, engine in (("artifact", art), ("forecaster", ref)):
            reset_counts()
            outs[name] = {b: engine.predict_direct(rows) for b, rows in requests.items()}
            counts[name] = read_counts()
        for b in BUCKETS:
            serve_check(outs["artifact"][b], outs["forecaster"][b],
                        f"export, rung {b}, from_artifact vs from_forecaster")
        if counts["artifact"] != counts["forecaster"]:
            fail(f"export: launches from_artifact {counts_text(counts['artifact'])} vs "
                 f"from_forecaster {counts_text(counts['forecaster'])}")
        launches["fp32"] += counts["artifact"]["B1"]
        p50s = {b: ab_p50({"artifact": lambda r=rows: art.predict_direct(r),
                           "forecaster": lambda r=rows: ref.predict_direct(r)})
                for b, rows in requests.items()}
        art.stats.reset()
        reset_counts()
        routed = ex.predict(supports, windows[:3])
        if art.stats.snapshot()["totals"]["requests"] != 1:
            fail("export: ex.predict did not route through the from_artifact engine")
        serve_check(routed, art.predict_direct(windows[:3]),
                    "export, ex.predict through the engine")
        launches["fp32"] += read_counts()["B1"]
        try:
            art.swap_params(state)
        except RuntimeError as e:
            refused = str(e)
        else:
            fail("export: a from_artifact engine accepted swap_params")
        recaptures = graphmon.snapshot()["recaptures_after_warmup"]
        if recaptures:
            fail(f"export: {recaptures} captures after warmup")
        print(f"export, graphed from_artifact vs from_forecaster, same weights: every rung within "
              f"rtol {SERVE_RTOL}, atol {SERVE_ATOL}; launches equal "
              f"({counts_text(counts['artifact'])} over {len(BUCKETS)} rungs); graph pools "
              f"{art.graph_pool_bytes} and {ref.graph_pool_bytes} bytes; 0 captures after warmup; "
              f"ex.predict routed through the engine; swap_params refused ({refused[:60]}...)")
        print("export, p50 dispatch per rung (ms, host clock, synchronized, in turns): "
              + "; ".join(f"rung {b} from_artifact {p['artifact']:.4f}, from_forecaster "
                          f"{p['forecaster']:.4f}" for b, p in p50s.items()))
    op_route_ab(device, fcs["fp32"], supports, windows)
    return launches


def op_route_ab(device, fc, supports, windows) -> None:
    """Phase 49, end: rung 1 of the dense flagship, graphed and eager, with
    B1 launched through its operator (``torch.ops.stmgcn.fused_lstm_fwd``)
    and called directly from Python as before the operator existed (the
    operator's CUDA implementation as a plain function): outputs bitwise
    equal, the same launches, each route's p50 in turns."""
    import torch

    from stmgcn_tpu_torch import ServingConfig

    fl = importlib.import_module("stmgcn_tpu_torch.ops.fused_lstm")
    ns, packet = torch.ops.stmgcn, torch.ops.stmgcn.fused_lstm_fwd
    config = ServingConfig(buckets=(1,), max_batch=1)
    rows = windows[:1]
    routes = {"operator": packet, "direct": fl._fwd_cuda}
    engines, outs, counts = {}, {}, {}
    try:
        for route, launch in routes.items():
            ns.fused_lstm_fwd = launch
            for graphs in (True, False):
                key = (route, "graphed" if graphs else "eager")
                engines[key] = fc.serving_engine(supports, config=config, device=device,
                                                 graphs=graphs)
                reset_counts()
                outs[key] = engines[key].predict_direct(rows)
                counts[key] = read_counts()
        ns.fused_lstm_fwd = packet
        want = outs["operator", "graphed"]
        for key, out in outs.items():
            if not np.array_equal(out, want) or counts[key] != counts["operator", "graphed"]:
                fail(f"B1 operator vs direct launch, {key}: outputs bitwise equal "
                     f"{np.array_equal(out, want)}, launches {counts_text(counts[key])}")
        times: dict = {key: [] for key in engines}
        for route in ("operator", "direct", "direct", "operator"):
            ns.fused_lstm_fwd = routes[route]
            for mode in ("graphed", "eager"):
                engine = engines[route, mode]
                for _ in range(OP_AB_CALLS // 2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    engine.predict_direct(rows)
                    torch.cuda.synchronize()
                    times[route, mode].append((time.perf_counter() - t0) * 1e3)
        ns.fused_lstm_fwd = packet
        p50 = {key: float(np.median(t)) for key, t in times.items()}
        print("B1 operator vs direct launch (the route before it), dense flagship rung 1, p50 "
              "dispatch (host clock, synchronized, in turns): " + "; ".join(
                  f"{mode}: operator {p50['operator', mode]:.4f} ms, direct "
                  f"{p50['direct', mode]:.4f} ms" for mode in ("graphed", "eager"))
              + "; outputs bitwise equal, launches equal")
    finally:
        ns.fused_lstm_fwd = packet
        for engine in engines.values():
            engine.close()


#: phase 50: serve-bench at the default preset's full width on the dense
#: city, with the soak (and its closed-loop drill) and a 2-replica federation
SERVE_BENCH_ARGS = ("--full-model", "--rows", str(GRID), "--soak", "--federation", "2")
SERVE_BENCH_LEGS = ("forecaster/b1", "exported/b1", "engine/b1", "forecaster/b16",
                    "exported/b16", "engine/b16", "engine/microbatch16")
FLEET_BENCH_LEGS = ("naive/b1-alternating", "engine/b1-alternating",
                    "engine/microbatch-mixed-city")


def serve_bench_phase() -> dict:
    """Phase 50: ``python -m stmgcn_tpu_torch.cli serve-bench`` with
    SERVE_BENCH_ARGS in a subprocess on the card: exactly one JSON line on
    stdout; every leg (and the fleet's) with predictions_per_sec > 0 and
    the fleet's per-city parity; the soak with no hung client, its hot swap
    applied and each generation bitwise the Forecaster of its parameters;
    its closed-loop drill with one promotion and one ``nonfinite``
    rejection; every federation drill passing (the poisoned candidate
    rejected once with every replica untouched, a replica killed, the herd
    spike fired, the drain flushed, the spare's handover flushed, no
    cross-generation response, the mid-soak promotion accepted, every city
    serveable after). Prints the legs' p50s, the speedups, the soak's and
    the federation's readings. Returns the record."""
    repo = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "stmgcn_tpu_torch.cli", "serve-bench", *SERVE_BENCH_ARGS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"serve-bench: exit {proc.returncode}; stderr {proc.stderr[-3000:]}")
    lines = [line for line in proc.stdout.splitlines() if line.strip()]
    if len(lines) != 1:
        fail(f"serve-bench printed {len(lines)} lines on stdout, expected one JSON line")
    record = json.loads(lines[0])
    legs, fleet = record["legs"], record["fleet"]
    for name, group, want in (("legs", legs, SERVE_BENCH_LEGS),
                              ("fleet legs", fleet["legs"], FLEET_BENCH_LEGS)):
        bad = [k for k in want if not group.get(k, {}).get("predictions_per_sec", 0) > 0]
        if bad or set(group) != set(want):
            fail(f"serve-bench {name}: {sorted(group)}, without throughput: {bad}")
    soak, fed = record["soak"], record["federation"]
    swap, loop = soak["hot_swap"], soak["continual"]
    drills = fed["drills"]
    checks = {
        "fleet parity": fleet["parity"],
        "soak: no hung client": soak["hung_clients"] == 0,
        "soak: swap applied": swap["swap_applied"] and swap["generation_after"] == 1,
        "soak: per-generation parity": swap["parity_gen0"] and swap["parity_gen1"],
        "continual: one promotion": loop["promotions"] == 1 and loop["generation"] == 1,
        "continual: one nonfinite rejection": (loop["rejections"] == 1
                                               and loop["rejection_reason"] == "nonfinite"),
        "federation: tier rejection": (not drills["tier_rejection"]["accepted"]
                                       and drills["tier_rejection"]["rejections_counted"] == 1
                                       and drills["tier_rejection"]["generations_untouched"]),
        "federation: replica kill": drills["replica_kill"]["kills"] == 1,
        "federation: herd spike": drills["herd"]["extra_ok"] + drills["herd"]["extra_shed"] > 0,
        "federation: drain": drills["drain"]["flushed"] and not drills["drain"]["watcher_wedged"],
        "federation: spare re-shard": (
            drills["reshard_promote"]["handover_flushed"]
            and drills["reshard_promote"]["burst_cross_generation"] == 0),
        "federation: no hung caller, no cross-generation response": (
            fed["soak"]["hung_clients"] == 0 and fed["soak"]["cross_generation"] == 0),
        "federation: mid-soak promotion": (isinstance(fed["promotion"]["mid_soak"], dict)
                                           and fed["promotion"]["mid_soak"]["accepted"]),
        "federation: every city serveable": (fed["recovery"]["cities_serveable"]
                                             == fed["recovery"]["cities_total"]),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"serve-bench record: {bad}; soak {json.dumps(soak)[:1500]}; federation "
             f"{json.dumps(fed)[:1500]}")
    print(f"serve-bench ({' '.join(SERVE_BENCH_ARGS)}): exit 0 in {seconds:.1f} s, one JSON line; "
          f"shapes {json.dumps(record['shapes'])}; every check held ({len(checks)})")
    print("serve-bench legs, p50 ms / predictions per s: " + "; ".join(
        f"{k} {v['p50_ms']} / {v['predictions_per_sec']}" for k, v in legs.items()))
    print(f"serve-bench speedup {json.dumps(record['speedup'])}; fleet legs: " + "; ".join(
        f"{k} {v['p50_ms']} ms / {v['predictions_per_sec']} per s" for k, v in
        fleet["legs"].items()) + f"; fleet speedup {json.dumps(fleet['speedup'])}, shape classes "
        f"{json.dumps(fleet['cities']['shape_classes'])}")
    print(f"serve-bench soak: calibration {json.dumps(soak['calibration'])}, admitted "
          f"{soak['admitted']}, shed {json.dumps(soak['shed'])}, admitted latency "
          f"{json.dumps(soak['admitted_latency_ms'])} vs SLO {soak['slo_target_ms']} ms "
          f"(met {soak['slo_met']}), responses by generation "
          f"{json.dumps(swap['responses_by_generation'])}, contended {soak['contended']}; "
          "continual " + json.dumps({k: loop[k] for k in (
              "promotions", "rejections", "rejection_reason", "generation")}))
    print(f"serve-bench federation: calibration {json.dumps(fed['calibration'])}, capacity "
          f"{json.dumps(fed['capacity'])}, outcomes {json.dumps(fed['soak']['outcomes'])}, "
          f"request latency {json.dumps(fed['soak']['request_latency_ms'])} vs SLO "
          f"{fed['soak']['slo_target_ms']} ms (met {fed['soak']['slo_met']}), drain "
          f"{drills['drain']['drain_ms']} ms, handover "
          f"{drills['reshard_promote']['handover_ms']} ms")
    return record


def profile_phase(root: str) -> None:
    """Phase 51: ``python -m stmgcn_tpu_torch.cli --preset smoke --profile
    DIR`` on the card (one epoch): the Chrome trace exists and names the B1
    and B2 kernels; then the MFU of phase 31's graphed dense block steps
    (fp32 and bf16): ``stmgcn_step_flops`` at the bench point over the
    step's p50, against the TF32 and bf16 peaks of ``device_peak_flops``
    (and the fp32-FMA peak beside the fp32 step's)."""
    import glob

    from stmgcn_tpu_torch.experiment import build_dataset
    from stmgcn_tpu_torch.utils import device_peak_flops, mfu, stmgcn_step_flops

    repo = os.path.dirname(os.path.abspath(__file__))
    out, prof = os.path.join(root, "out"), os.path.join(root, "prof")
    cmd = [sys.executable, "-m", "stmgcn_tpu_torch.cli", "--preset", "smoke", "--timesteps",
           str(CLI_TIMESTEPS), "--epochs", "1", "--out-dir", out, "--profile", prof]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"cli --profile: exit {proc.returncode}; stderr {proc.stderr[-2000:]}")
    traces = glob.glob(os.path.join(prof, "*.json"))
    if len(traces) != 1:
        fail(f"cli --profile wrote {traces}, expected one Chrome trace")
    with open(traces[0]) as f:
        text = f.read()
    found = {part: sum(text.count(k) for k in keys) for part, keys in LSTM_PARTS.items()}
    if not found["B1 forward"] or not found["B2 sweep"] or not found["B2 weight gradients"]:
        fail(f"cli --profile: the trace does not name B1 and B2: {found}")
    print(f"cli --profile (smoke preset, one epoch): exit 0 in {seconds:.1f} s, trace "
          f"{os.path.basename(traces[0])} {len(text)} bytes, kernel name occurrences "
          + ", ".join(f"{k} {v}" for k, v in found.items()))
    cfg = flagship_config(BATCH)
    ds = build_dataset(cfg)
    m = cfg.model
    flops = stmgcn_step_flops(BATCH, cfg.data.seq_len, ds.n_nodes, ds.n_feats, m.m_graphs,
                              m.n_supports, m.lstm_hidden_dim, m.lstm_num_layers,
                              m.gcn_hidden_dim, horizon=cfg.data.horizon)
    texts = []
    for name, peaks in (("fp32", ("tf32", "fp32")), ("bf16", ("bf16",))):
        ms = STEP_P50.get(f"dense training, {name}")
        if ms is None:
            fail(f"MFU: phase 31 left no graphed {name} block-step p50")
        texts.append(f"{name} step {ms:.4f} ms: " + ", ".join(
            f"MFU {mfu(flops, ms / 1e3, device_peak_flops(precision=p)):.4f} of the {p} peak "
            f"({device_peak_flops(precision=p) / 1e12:.1f} TFLOP/s)" for p in peaks))
    print(f"MFU of the graphed dense block step (phase 31; batch {BATCH}, N={ds.n_nodes}, "
          f"analytic {flops / 1e9:.3f} GFLOP per step): " + "; ".join(texts))


# -- phases 52-56: data placement, bf16 fleets, lint and kernel budgets ---------

#: the streaming route's prefetch depths (phase 52) and the metro drill's;
#: extra epochs timed per route for the step p50s
PLACEMENT_PREFETCH, METRO_PREFETCH, PLACEMENT_TIMED_EPOCHS = (0, 1, 2), 2, 2


def placement_config(out: str, precision: str = "fp32", **train):
    """The ``default`` preset (its own ``"xla"`` bf16 form) at the bench
    point, batch 64, two epochs, shuffled, with ``train`` fields."""
    from stmgcn_tpu_torch import preset

    cfg = preset("default")
    cfg.data.rows, cfg.data.serial_len = GRID, SERIAL
    cfg.train.batch_size, cfg.train.epochs, cfg.train.shuffle = BATCH, EPOCHS, True
    cfg.train.precision, cfg.train.out_dir = precision, out
    for key, value in train.items():
        setattr(cfg.train, key, value)
    return cfg


def placed_training(make, per_forward, per_step, what: str) -> tuple:
    """``make()`` a trainer, ``train()`` it with every kernel's launches
    counted around the call (set to 0 just before, read just after), held
    to ``per_forward``/``per_step``; returns ``(trainer, history,
    counts)``."""
    trainer = make()
    reset_counts()
    history = trainer.train()
    counts = read_counts()
    if not all(np.isfinite(history[m]).all() for m in history):
        fail(f"{what}: non-finite epoch loss {history}")
    steps, epochs = trainer.global_step, len(history["train"])
    forwards = steps + epochs * trainer.dataset.num_batches("validate", trainer.batch_size)
    check_counts(counts, per_forward, per_step, forwards, steps, what)
    return trainer, history, counts


def route_p50(trainer, epochs: int = PLACEMENT_TIMED_EPOCHS) -> tuple:
    """``(p50 ms of an optimizer step, host->device bytes per step)`` over
    ``epochs`` more training epochs of the trainer's own loop (placement,
    prefetch and blocks included): the host clock between consecutive
    dispatch completions over the steps each covered, and every upload
    of those epochs (``graphmon``)."""
    from stmgcn_tpu_torch.obs import graphmon

    times, last = [], []
    up0, step0 = graphmon.snapshot()["upload_bytes"], trainer.global_step
    after = trainer._after_train_batch

    def stamp():
        now, step = time.perf_counter(), trainer.global_step
        if last:
            t0, s0 = last[0]
            if step > s0:
                times.extend([(now - t0) * 1e3 / (step - s0)] * (step - s0))
        last[:] = [(now, step)]
        after()

    trainer._after_train_batch = stamp
    try:
        for _ in range(epochs):
            trainer.epoch += 1
            last.clear()
            last.append((time.perf_counter(), trainer.global_step))
            trainer._run_train_epoch()
    finally:
        del trainer._after_train_batch
    uploaded = graphmon.snapshot()["upload_bytes"] - up0
    return float(np.median(times)), uploaded / (trainer.global_step - step0)


def placement_dense(device) -> dict:
    """Phase 52: the dense city at the bench point, fp32 and bf16 (the
    preset's xla form), two epochs at batch 64 from one state four ways:
    window-free resident in blocks of 4, materialized resident in blocks of
    4 (bitwise the first), window-free resident one step at a time, and
    streamed at each prefetch depth (bitwise the third), graphed and eager;
    the launches per forward and step of every run, the host->device bytes
    per step and each route's step p50 in turns. Returns the launches of
    the graphed runs, fp32 and bf16."""
    from stmgcn_tpu_torch import build_trainer

    totals = {}
    for precision in ("fp32", "bf16"):
        xla = precision == "bf16"
        per_forward = {"B1": 1, "B1 xla": 1} if xla else {"B1": 1}
        per_step = {"B2": 1, "B2 xla": 1} if xla else {"B2": 1}
        state = state_of(build_trainer(placement_config(scratch("place_init"), precision),
                                       device=device, verbose=False))
        routes = {"window-free S=4": dict(steps_per_superstep=SUPERSTEP),
                  "materialized S=4": dict(steps_per_superstep=SUPERSTEP, window_free=False),
                  "window-free S=1": {}}
        routes.update({f"stream prefetch {k}": dict(data_placement="stream", prefetch=k)
                       for k in PLACEMENT_PREFETCH})
        runs, total = {}, {}
        for name, train in routes.items():
            for graphs in (True, False) if "S=4" not in name else (True,):
                what = f"placement, dense {precision}, {name}, {'graphed' if graphs else 'eager'}"
                out = scratch("place_" + name.replace(" ", "_").replace("=", ""))

                def make(train=train, graphs=graphs, out=out):
                    return build_trainer(placement_config(out, precision, **train), device=device,
                                         initial_state=state, graphs=graphs, verbose=False)

                trainer, history, counts = placed_training(make, per_forward, per_step, what)
                runs[name, graphs] = (trainer, history, end_state(trainer))
                if graphs:
                    for k, v in counts.items():
                        total[k] = total.get(k, 0) + v
                print(f"{what}: train_path {trainer.train_path}, resident {trainer._resident}, "
                      f"window-free {trainer._window_free}; {trainer.global_step} steps, "
                      f"launches {counts_text(counts)}; epoch losses {history['train']}")
        for ref, others in (("window-free S=4", ["materialized S=4"]),
                            ("window-free S=1", [n for n in routes if n.startswith("stream")])):
            base = runs[ref, True]
            for name in others:
                for graphs in (True, False):
                    if (name, graphs) not in runs:
                        continue
                    got = runs[name, graphs]
                    if got[1] != base[1] or not same_state(got[2], base[2]):
                        fail(f"placement, dense {precision}: {name} "
                             f"({'graphed' if graphs else 'eager'}) is not bitwise {ref} "
                             f"graphed: {got[1]} vs {base[1]}")
            if (ref, False) in runs and not (runs[ref, False][1] == base[1]
                                             and same_state(runs[ref, False][2], base[2])):
                fail(f"placement, dense {precision}: {ref} eager is not bitwise graphed")
        blocks_vs_steps = (runs["window-free S=4", True][1] == runs["window-free S=1", True][1]
                           and same_state(runs["window-free S=4", True][2],
                                          runs["window-free S=1", True][2]))
        print(f"placement, dense {precision}: materialized S=4 bitwise window-free S=4; every "
              f"stream run (prefetch {PLACEMENT_PREFETCH}, graphed and eager) and the eager "
              f"window-free S=1 bitwise window-free S=1 graphed (losses, parameters, Adam "
              f"moments); blocks of 4 vs one step at a time bitwise: {blocks_vs_steps}")
        p50 = {}
        for _ in range(2):  # in turns, twice
            for (name, graphs), run in runs.items():
                if graphs:
                    p50.setdefault(name, []).append(route_p50(run[0]))
        print(f"placement, dense {precision}, step p50 (ms, host clock between dispatch "
              f"completions, graphed, two turns; host->device bytes a training step): "
              + "; ".join(f"{n} {v[0][0]:.4f} / {v[1][0]:.4f} ({v[0][1]:.0f} B)"
                          for n, v in p50.items()))
        totals[precision] = total
        del runs
        release()
    return totals


def trace_streams(run, path: str, batch_bytes: int, skip: int = 0) -> dict:
    """``run`` under ``torch.profiler``, its Chrome trace read back: the
    batch uploads (host->device copies of at least ``batch_bytes``), the
    streams they and the kernels ran on, how many uploads after the first
    ``skip`` (in device start order) overlapped a kernel on another stream,
    and the device's idle share (1 - the union of kernel and copy time over
    the span from the first to the last)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        return {"measured": False}
    kernels = [(e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream")) for e in dev
               if e["cat"] == "kernel"]
    uploads = [(e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream")) for e in dev
               if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]
               and e.get("args", {}).get("bytes", 0) >= batch_bytes]
    overlapped = sum(1 for a, b, s in sorted(uploads)[skip:]
                     if any(ka < b and a < kb and ks != s for ka, kb, ks in kernels))
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"measured": True, "uploads": len(uploads), "overlapped": overlapped,
            "upload_streams": sorted({s for _, _, s in uploads}, key=str),
            "kernel_streams": sorted({s for _, _, s in kernels}, key=str),
            "idle_share": 1 - busy / (spans[-1][1] - spans[0][0])}


def placement_metro(device, ds, plan_dev) -> dict:
    """Phase 53: the metro plan, fp32, one epoch at batch 2 from one state,
    resident (window-free, one step at a time) against streamed at
    prefetch METRO_PREFETCH, graphed: bitwise losses and parameters, B3/B4
    launches per step, host->device bytes per step, both step p50s in
    turns, and a ``torch.profiler`` trace of one more epoch of each: the
    batch uploads' stream against the kernels', how many of the later ones
    overlapped the previous step's kernels (at least one must, on a stream
    of their own), and the device's idle share. Returns the launches of
    both runs."""
    from stmgcn_tpu_torch import Trainer

    state = {k: v.detach().cpu().clone()
             for k, v in metro_model("tiled", ds, device).state_dict().items()}
    runs, total = {}, {}
    for name, place in (("resident", {}),
                        ("stream", dict(data_placement="stream", prefetch=METRO_PREFETCH))):
        t = metro_config("tiled").train

        def make(place=place, name=name):
            return Trainer(metro_model("tiled", ds, device), ds, plan_dev, lr=t.lr,
                           weight_decay=t.weight_decay, n_epochs=1, batch_size=METRO_BATCH,
                           shuffle=True, out_dir=scratch(f"metro_place_{name}"),
                           initial_state=state, device=device, verbose=False, **place)

        trainer, history, counts = placed_training(
            make, {"B1": 1, "B3": 2, "B3 shared": 1}, {"B2": 1, "B4": 1},
            f"placement, metro {name}")
        runs[name] = (trainer, history, end_state(trainer))
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        print(f"placement, metro {name}: train_path {trainer.train_path}, resident "
              f"{trainer._resident}; {trainer.global_step} steps, launches "
              f"{counts_text(counts)} (per step B2 1, B4 1; per forward B1 1, B3 2); "
              f"epoch loss {history['train']}")
    res, stream = runs["resident"], runs["stream"]
    if stream[1] != res[1] or not same_state(stream[2], res[2]):
        fail(f"placement, metro: stream is not bitwise resident: {stream[1]} vs {res[1]}")
    p50 = {n: [] for n in runs}
    for _ in range(2):
        for n, run in runs.items():
            p50[n].append(route_p50(run[0], 1))
    print("placement, metro: stream (prefetch {}) bitwise resident (losses, parameters, Adam "
          "moments); step p50 (ms, host clock, two turns; host->device bytes a training "
          "step): {}".format(METRO_PREFETCH, "; ".join(
              f"{n} {v[0][0]:.4f} / {v[1][0]:.4f} ({v[0][1]:.0f} B)" for n, v in p50.items())))
    batch_bytes = METRO_BATCH * ds.arrays("train")[1][0].nbytes  # a batch's y, its smaller upload
    for n, run in runs.items():
        trainer = run[0]

        def epoch(trainer=trainer):
            trainer.epoch += 1
            trainer._run_train_epoch()

        # the stream route's later batches (after the first prefetch + 1, each
        # an x and a y) are placed once the previous step's program is enqueued
        ahead = 2 * (METRO_PREFETCH + 1) if n == "stream" else 0
        tr = trace_streams(epoch, scratch(f"trace_{n}.json"), batch_bytes, skip=ahead)
        if not tr["measured"]:
            fail(f"trace, metro {n} epoch: the profiler recorded no device events")
        steps = trainer.train_steps_per_epoch
        expected = 2 * max(steps - METRO_PREFETCH - 1, 0) if n == "stream" else 0
        print(f"trace, metro {n} epoch ({steps} steps): {tr['uploads']} batch uploads on "
              f"stream(s) {tr['upload_streams']} (expected {2 * steps if ahead else 0}), "
              f"kernels on {tr['kernel_streams']}; of the uploads after the first "
              f"{ahead}, {tr['overlapped']} overlapped a kernel on another stream "
              f"(expected {expected}); device idle share {tr['idle_share']:.3f}")
        if n == "stream" and (not tr["uploads"]
                              or set(tr["upload_streams"]) & set(tr["kernel_streams"])
                              or not tr["overlapped"]):
            fail(f"trace, metro stream epoch: the batch uploads did not run on a copy "
                 f"stream of their own beside the step's kernels: {tr}")
        if n == "resident" and tr["uploads"]:
            fail(f"trace, metro resident epoch: {tr['uploads']} batch uploads")
    del runs
    release()
    return total


def placement_auto(device, ds, plan_dev) -> None:
    """Phase 54: the "auto" decision on the card: ``_resident_cap_bytes()``
    and what "auto" picks at both cities; a class ``RESIDENT_CAP_BYTES``
    above the free memory becomes the budget (and "auto" stays resident);
    under a budget below the metro city's materialized windows "auto"
    streams them, and keeps the window-free series resident if it fits
    (at the metro city's 200 timesteps, 168 of them the weekly window's
    burn-in, the series is the larger)."""
    from unittest import mock

    import torch

    from stmgcn_tpu_torch import Trainer, build_trainer

    def metro(**kw):
        return Trainer(metro_model("tiled", ds, device), ds, plan_dev, n_epochs=1,
                       batch_size=METRO_BATCH, out_dir=scratch("metro_auto"), device=device,
                       verbose=False, **kw)

    dense = build_trainer(placement_config(scratch("auto")), device=device, verbose=False)
    free, total = torch.cuda.mem_get_info(device)
    for name, tr in (("dense", dense), ("metro", metro())):
        d = tr.dataset
        print(f"auto placement, {name} city: _resident_cap_bytes() {tr._resident_cap_bytes():,} "
              f"(card free {free:,} of {total:,}); series {d.resident_nbytes:,} bytes, "
              f"windows {d.nbytes:,}; auto picks resident {tr._resident}, window-free "
              f"{tr._window_free}, train_path {tr.train_path}")
        if not (tr._resident and tr._window_free):
            fail(f"auto placement, {name}: not window-free resident on the card")
    floor = Trainer.RESIDENT_CAP_BYTES
    try:
        Trainer.RESIDENT_CAP_BYTES = free + (1 << 30)
        tr = metro(window_free=False)
        if tr._resident_cap_bytes() != Trainer.RESIDENT_CAP_BYTES or not tr._resident:
            fail("auto placement: a class RESIDENT_CAP_BYTES above the free memory is not "
                 "the budget")
    finally:
        Trainer.RESIDENT_CAP_BYTES = floor
    cap = ds.nbytes - 1
    with mock.patch.object(Trainer, "_resident_cap_bytes", lambda self: cap):
        mat, wf = metro(window_free=False), metro()
    series_fits = ds.resident_nbytes <= cap
    if mat._resident or mat.fallback_reason or wf._resident != series_fits:
        fail(f"auto placement under a {cap:,}-byte budget: materialized resident "
             f"{mat._resident}, window-free resident {wf._resident} (series "
             f"{ds.resident_nbytes:,} bytes)")
    print(f"auto placement, metro: a class RESIDENT_CAP_BYTES of free + 1 GiB "
          f"({free + (1 << 30):,}) is the budget and auto stays resident; under a budget of "
          f"{cap:,} bytes (the windows less one) auto streams the materialized windows "
          f"(prefetch {mat.prefetch}, train_path {mat.train_path}) and "
          f"{'keeps' if series_fits else 'streams'} the {ds.resident_nbytes:,}-byte "
          "window-free series")


def fleet_bf16(device) -> dict:
    """Phase 55: bf16 fleets (the ``multicity`` preset's own xla form). From
    one state, per-step losses of the fleet at ``precision="bf16"`` against
    the bf16 per-city loop and against the fp32 fleet, within TWIN_ATOL,
    over steps of both cities; then two epochs of the bf16 fleet with its
    launches counted (returned); then ``FleetServingEngine`` at
    ``model.dtype="bfloat16"``, equal to the card's bf16 Forecaster, against
    the CPU port's bf16 Forecaster per city, the fp32 model the control that
    the bf16 serving limits must reject: on seeded weights the served
    outputs; on the trained checkpoint's weights the model's float32 output
    before the serve boundary's bf16 cast, and the served bf16 outputs at
    most one bf16 step apart (``scripts/bf16_fleet_gap.py``: on these
    weights the card and the CPU differ after that cast only by flips of
    its rounding, one step of which is about 1e-2 of the largest output in
    raw units)."""
    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig, build_trainer, preset
    from stmgcn_tpu_torch.config import MeshConfig
    from stmgcn_tpu_torch.experiment import build_model, build_supports

    def config(out, precision="bf16", fleet=True, dtype="float32"):
        cfg = preset("multicity")
        cfg.mesh = MeshConfig()
        cfg.train.fleet, cfg.train.steps_per_superstep = fleet, FLEET_S
        cfg.train.epochs, cfg.train.out_dir, cfg.train.precision = EPOCHS, out, precision
        cfg.model.dtype = dtype
        return cfg

    fleet16 = build_trainer(config(scratch("fleet16")), device=device, verbose=False)
    check_fleet(fleet16, [(144, (0, 1))], "bf16 multicity fleet")
    state = state_of(fleet16)
    loop16 = build_trainer(config(scratch("loop16"), fleet=False), device=device,
                           initial_state=state, verbose=False)
    fleet32 = build_trainer(config(scratch("fleet32"), "fp32"), device=device,
                            initial_state=state, verbose=False)
    if loop16.fleet_plan is not None or fleet32.train_path != "fleet_superstep":
        fail("bf16 fleet drill: the per-city loop engaged a fleet, or the fp32 fleet did not")
    batches = list(fleet16.batches("train"))
    pick = ([b for b in batches if b.city == 0][:TWIN_STEPS // 2]
            + [b for b in batches if b.city == 1][:TWIN_STEPS // 2])
    gaps = {"per-city loop bf16": [], "fleet fp32": []}
    for batch in pick:
        got = fleet16.train_batch(batch).item()
        for name, other in (("per-city loop bf16", loop16), ("fleet fp32", fleet32)):
            gaps[name].append(abs(got - other.train_batch(batch).item()))
    for name, g in gaps.items():
        if not max(g) <= TWIN_ATOL:
            fail(f"bf16 fleet vs {name}: per-step loss gaps {g} (limit {TWIN_ATOL})")
    print(f"bf16 fleet (one class at rung 144, xla form) over {len(pick)} steps of cities 0 and "
          "1 from one state: per-step loss gaps " + "; ".join(
              f"vs {n} max {max(g):.3e}" for n, g in gaps.items()) + f" (limit {TWIN_ATOL})")
    del loop16, fleet32
    release()
    trainer = build_trainer(config(scratch("fleet16_run")), device=device, initial_state=state,
                            verbose=False)
    _, counts = train_and_test(trainer, {"B1": 1, "B1 xla": 1}, {"B2": 1, "B2 xla": 1},
                               "bf16 multicity fleet training")
    step_times(trainer, "bf16 multicity fleet training step")
    trained = Forecaster.from_checkpoint(trainer.best_path, device=device)
    ds = trainer.dataset
    sups = build_supports(trained.config, ds)
    cfg32 = config(scratch("fleet32_serve"), dtype="float32")
    cfg16 = config(scratch("fleet16_serve"), dtype="bfloat16")
    derived, norms = trained.derived, trained.normalizers
    seeded = build_model(cfg32, derived["input_dim"], device="cpu",
                         generator=torch.Generator().manual_seed(0)).state_dict()
    # seeded weights, as phases 21, 24 and 42 serve, at the bf16 limits; the
    # trained checkpoint's at the same limits before the final bf16 cast, and
    # within one bf16 step after it
    for name, weights in (("seeded", seeded), ("trained", trained.state_dict)):
        fc32, fc16, cpu16 = (Forecaster(build_model(c, derived["input_dim"], device=dev), weights,
                                        None, c, derived, norms, device=dev)
                             for c, dev in ((cfg32, device), (cfg16, device), (cfg16, "cpu")))
        engine = fc16.fleet_engine(sups, config=ServingConfig(buckets=BUCKETS), device=device)
        try:
            for c in (0, 1):
                rows = ds.denormalize(ds.city_arrays("test", c)[0], city=c)[:4]
                got = engine.predict(rows, city=c)
                want, want_head, want_out = tapped(cpu16, sups.for_city(c), rows, c)
                same, head, out = tapped(fc16, sups.for_city(c), rows, c)
                control, control_head, _ = tapped(fc32, sups.for_city(c), rows, c)
                if not np.allclose(got, same, rtol=SERVE_RTOL, atol=SERVE_ATOL):
                    fail(f"bf16 fleet engine, {name} weights, city {c}: max |engine - "
                         f"Forecaster| {np.abs(got - same).max():.3e}")
                what = f"bf16 fleet serving, {name} weights, city {c}, card vs CPU"
                if name == "seeded":
                    text = bf16_check(got, want, what, control=control)
                else:
                    text = "before the bf16 cast (model units): " + bf16_check(
                        head, want_head, f"{what}, before the bf16 cast", control=control_head)
                    steps = bf16_steps(out, want_out)
                    text += (f"; after it, {int((steps == 1).sum())} of {steps.numel()} "
                             f"outputs one bf16 step apart, at most {int(steps.max())} "
                             f"(limit 1), served {gap_text(bf16_gap(got, want))}")
                    if steps.max() > 1:
                        fail(f"{what}: bf16 outputs more than one bf16 step apart: {text}")
                print(f"{what} (FleetServingEngine at model.dtype=bfloat16, 4 windows, max "
                      f"|want| {np.abs(want).max():.4e} raw units): {text}")
            snap = engine.class_stats[engine.class_of(0)].snapshot()
            print(f"bf16 fleet serving, {name} weights: {rung_p50(snap)}")
        finally:
            engine.close()
    return counts


def lint_and_budgets() -> None:
    """Phase 56: ``python -m stmgcn_tpu_torch.cli lint --format json
    --include-suppressed`` in a subprocess, every pass (the whole-program
    AST and concurrency passes over the package, every config and mesh
    pass over every preset): exit 0, no unsuppressed finding, a program
    database of more than zero modules and classes; the findings by rule,
    the suppressed count and the lint's seconds; each multi-device
    preset's per-rank footprint (``estimate_shard_footprint``) beside
    ``Trainer._resident_cap_bytes()`` on this card; the lint's Python
    mirror of every kernel plan against what each built kernel form
    reports (``stmgcn_lstm_*_smem``, ``stmgcn_spmm_plan``); and each
    compiled instance's ``cudaFuncGetAttributes`` (registers, spilled bytes,
    max threads) within the budgets the lint holds them to, beside
    ptxas's."""
    import types

    import torch

    from stmgcn_tpu_torch.analysis import kernel_check as kc
    from stmgcn_tpu_torch.analysis.spmd_check import estimate_shard_footprint
    from stmgcn_tpu_torch.config import PRESETS, preset
    from stmgcn_tpu_torch.train.trainer import Trainer

    fused_lstm = importlib.import_module("stmgcn_tpu_torch.ops.fused_lstm")
    spmm = importlib.import_module("stmgcn_tpu_torch.ops.spmm")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "stmgcn_tpu_torch.cli", "lint", "--format",
                           "json", "--include-suppressed"], capture_output=True, text=True,
                          timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"lint exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    report = json.loads(proc.stdout)
    db = re.search(r"program database of (\d+) modules, (\d+) classes; whole-program pass "
                   r"([0-9.]+) s", proc.stderr)
    if db is None or min(int(db.group(1)), int(db.group(2))) == 0:
        fail(f"lint: the program database came out empty or unreported: {proc.stderr[-2000:]}")
    live = [f for f in report["findings"] if not f["suppressed"]]
    if live or report["errors"] or report["warnings"]:
        fail(f"lint: unsuppressed findings on the shipped tree: {live}")
    by_rule = collections.Counter(f["rule"] for f in report["findings"])
    print(f"lint (every pass, the package and every preset): exit 0, {report['errors']} errors, "
          f"{report['warnings']} warnings; program database {db.group(1)} modules, "
          f"{db.group(2)} classes; suppressed findings by rule {dict(sorted(by_rule.items()))} "
          f"({sum(by_rule.values())} in all, none live); {seconds:.2f} s in the subprocess "
          f"(whole-program pass {db.group(3)} s)")
    cap = Trainer._resident_cap_bytes(types.SimpleNamespace(
        device=torch.device("cuda"), RESIDENT_CAP_BYTES=Trainer.RESIDENT_CAP_BYTES))
    for name in PRESETS:
        cfg = preset(name)
        if cfg.mesh.n_devices == 1:
            continue
        est = estimate_shard_footprint(cfg)
        if est["total_bytes"] > cap:
            fail(f"lint: {name}'s per-rank footprint {est['total_bytes']:,} bytes exceeds "
                 f"_resident_cap_bytes() {cap:,} on this card")
        print(f"  spmd-shard-footprint {name} ({cfg.mesh.dp}x{cfg.mesh.region}x"
              f"{cfg.mesh.branch}): {est['total_bytes']:,} bytes a rank (supports "
              f"{est['supports_bytes']:,} + batch {est['batch_bytes']:,}) beside "
              f"_resident_cap_bytes() {cap:,} on this card (the lint's floor "
              f"{Trainer.RESIDENT_CAP_BYTES:,})")
    mismatches, checked = [], 0
    for dtype, form in ((torch.float32, "fp32"), (torch.bfloat16, "bf16"), ("xla", "xla")):
        for h in kc.KERNEL_HIDDEN:
            for layers in range(1, kc.KERNEL_MAX_LAYERS + 1):
                got = fused_lstm.kernel_resources(layers, h, dtype)
                want = {"block_rows": kc.lstm_block_rows(h),
                        "lstm_fwd_kernel": kc.lstm_fwd_smem(layers, h, form),
                        "lstm_bwd_sweep": kc.lstm_bwd_smem(layers, h, form),
                        "lstm_bwd_wgrad": kc.lstm_bwd_smem(0, h, form)}
                checked += len(want)
                mismatches += [(form, h, layers, k, got[k], v) for k, v in want.items()
                               if got[k] != v]
        for tile in kc.KERNEL_TILES if form != "xla" else ():
            for f in (10, 20, 37, 128):
                got, want = spmm.kernel_plan(tile, f, dtype), kc.spmm_plan(tile, f, form == "bf16")
                checked += len(want)
                mismatches += [(form, tile, f, k, got[k], v) for k, v in want.items()
                               if got[k] != v]
    if mismatches:
        fail(f"kernel plans: the lint's mirror disagrees with the built kernels: {mismatches}")
    print(f"kernel plans: the lint's mirror equals all {checked} figures the built kernels "
          "report (LSTM forms fp32, bf16, xla at every H and L; block-CSR tiles 64 and 128 at "
          "every column tile, fp32 and bf16)")
    worst = {}
    for dtype, form in ((torch.float32, "fp32"), (torch.bfloat16, "bf16"), ("xla", "xla")):
        for h in kc.KERNEL_HIDDEN:
            for layers in range(1, kc.KERNEL_MAX_LAYERS + 1):
                attrs = fused_lstm.kernel_attributes(layers, h, dtype)
                for name, a in attrs.items():
                    threads = 512 if name == "lstm_bwd_sweep" else 256
                    worst.setdefault((name, form), []).append((a, threads, (layers, h)))
        for tile in kc.KERNEL_TILES if form != "xla" else ():
            for f in (16, 32, 64, 128):
                for role, name in enumerate(spmm.KERNEL_ROLES):
                    a = spmm.kernel_attributes(role, tile, f, dtype)
                    worst.setdefault((name, form), []).append((a, 256, (tile, f)))
    over = []
    for (name, form), entries in worst.items():
        regs = max(a["registers"] for a, _, _ in entries)
        spill = max(a["local_bytes"] for a, _, _ in entries)
        threads = entries[0][1]
        budget = kc.register_budget(threads)
        over += [(name, form, shape, a) for a, t, shape in entries
                 if a["registers"] > kc.register_budget(t) or a["max_threads"] < t]
        print(f"  cudaFuncGetAttributes {name} ({form}, {len(entries)} instances, {threads} "
              f"threads a block): registers max {regs} (budget {budget}), local (spilled) bytes "
              f"per thread max {spill}, max threads per block min "
              f"{min(a['max_threads'] for a, _, _ in entries)}")
    if over:
        fail(f"kernel attributes past their budgets: {over}")
    main = [(n, f, a) for (n, f), entries in worst.items() for a, _, shape in entries
            if shape in ((3, 64), (128, 16), (128, 128))]
    print("  at the main paths' shapes (LSTM L=3, H=64; block-CSR tile 128, column tiles 16 "
          "and 128): " + "; ".join(f"{n} {f} {a['registers']} registers, {a['local_bytes']} "
                                   "spilled bytes" for n, f, a in main))
    logs = [info.log for info in (
        *(fused_lstm.kernel_library(f)[1] for f in range(3)),
        *(fused_lstm.bwd_kernel_library(f)[2] for f in range(3)), spmm.kernel_library()[1])]
    lines = [line for log in logs for line in log.splitlines()]
    regs = [int(line.split("Used ")[1].split()[0]) for line in lines if "registers" in line]
    spills = [line for line in lines if "spill stores" in line
              and not (" 0 bytes spill stores" in line and " 0 bytes spill loads" in line)]
    print(f"  ptxas (the LSTM libraries of every form and the block-CSR library, {len(regs)} "
          f"entries): registers max {max(regs)}; entries spilling: {len(spills)}"
          + "".join(f"\n  ptxas: {line.strip()}" for line in spills[:8]))


# -- the mesh phases (57-60) -------------------------------------------------------

#: the mesh phases: epochs of each preset (the one cut: the presets' 100);
#: a rank job's seconds before the parent kills it and fails; the twin
#: tolerances of tests/test_parallel.py:96-104 (per-step losses rtol 1e-5;
#: parameters rtol 5e-4, atol 2e-5: gloo's ring sums the dp gradients and
#: the branch fusion in another order than one device does, so allclose,
#: not bitwise) and the bf16 twin drill's TWIN_ATOL
MESH_EPOCHS, MESH_BF16_EPOCHS, MESH_TIMEOUT = 2, 1, 420
MESH_LOSS_RTOL, MESH_PARAM_RTOL, MESH_PARAM_ATOL = 1e-5, 5e-4, 2e-5
#: phase 59's whole-epoch rule: a bf16 run whose sums go in another order is
#: another bf16 run, so the mesh may sit as far from the fp32 twin (of the
#: same epochs) as the bf16 twin does, and no more than BF16_GAP_FACTOR
#: times that: every step's loss against the bf16 twin's largest loss gap,
#: and normwise each parameter tensor of at least BF16_NORM_MIN entries (a
#: norm over fewer is too few roundings to compare) and the whole state
BF16_GAP_FACTOR, BF16_NORM_MIN = 2.0, 1024
#: the analytic counts of phases 57-58 (fp32, default widths: M=3, K=2 with
#: 3 supports, a 3-layer 64-wide LSTM, gcn 64, T=5): 286,283 parameters;
#: 95,406 per branch plus the head's 65; B1's rows a launch per rank
#: (B/dp x N x M/branch: 8 x 144 x 3 and 8 x 100 x 3 for the multicity
#: cities, 8 x 100 x 1 for branchpar); the fusion's bytes a forward per rank
#: (8 x 100 x gcn 64 float32)
MESH_PARAMS, BRANCH_PARAMS, HEAD_PARAMS = 286_283, 95_406, 65
MULTICITY_ROWS, BRANCHPAR_ROWS = {8 * 144 * 3, 8 * 100 * 3}, {8 * 100 * 1}
FUSION_BYTES = 8 * 100 * 64 * 4
#: rows of test windows the Forecaster check serves
MESH_SERVE_ROWS = 64


def mesh_config(name: str, out: str, *, dtype: str = "float32", epochs: int = MESH_EPOCHS,
                seed: int | None = None):
    """The preset as configured, its epochs cut to ``epochs``; ``seed``
    (None: the preset's) seeds the data, the weights and the batch order."""
    from stmgcn_tpu_torch.config import preset

    cfg = preset(name)
    cfg.train.epochs, cfg.train.out_dir, cfg.model.dtype = epochs, out, dtype
    if seed is not None:
        cfg.data.seed = cfg.train.seed = seed
    return cfg


def recorded(trainer) -> dict:
    """Record each dispatch's losses and host seconds (each ends in its
    readback), each model forward, each LSTM launch's rows (the ``(M, R,
    T, F)`` input of the branch-stacked LSTM: ``M x R`` rows), each health
    record's rows and each divergence-guard trip."""
    rec = {"losses": [], "seconds": [], "forwards": 0, "rows": set(), "health": [],
           "trips": []}
    dispatch, emit = trainer._dispatch, trainer._health_emit

    def timed(*a, **k):
        t0 = time.perf_counter()
        losses, stats = dispatch(*a, **k)
        rec["losses"] += losses
        rec["seconds"].append(time.perf_counter() - t0)
        return losses, stats

    def emitted(stats, cities=None):  # each health record's rows
        rec["health"].append(np.array(stats))
        emit(stats, cities)

    if trainer._guard is not None:  # each trip's (epoch, step)
        trip = trainer._guard.trip

        def tripped(loss, epoch, step):
            rec["trips"].append((epoch, step))
            trip(loss, epoch, step)

        trainer._guard.trip = tripped
    trainer._health_emit = emitted

    def forward(module, args, out):
        rec["forwards"] += 1

    def lstm(module, args):
        rec["rows"].add(int(args[0].shape[0] * args[0].shape[1]))

    trainer._dispatch = timed
    trainer.model.register_forward_hook(forward)
    trainer.model.branches.cg_lstm.lstm.register_forward_pre_hook(lstm)
    return rec


def p50_ms(seconds) -> float:
    return float(np.median(seconds) * 1e3) if seconds else float("nan")


def mesh_train(cfg, device, *, test: bool = False, dataset=None, supports=None,
               fault_plan=None) -> dict:
    """One rank (or the twin) of a phase: build (on ``dataset`` and its
    dense ``supports``, None: the config's; with ``fault_plan``), train
    with the recorder on, read the launches, the comm counts, the initial
    and final (whole) parameters, the health records (and the lines of
    the lead's ``health.jsonl``), the node pads and fleet rungs; then one
    more step under ``step_comm_report`` for the manifest check."""
    import torch

    from stmgcn_tpu_torch.analysis.spmd_check import (
        manifest_findings,
        param_bytes,
        wire_figures,
        wire_findings,
    )
    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.models import from_jax_params
    from stmgcn_tpu_torch.parallel import banded_meta, check_executed, manifest_for_config
    from stmgcn_tpu_torch.utils import comm, step_comm_report

    t_build = time.perf_counter()
    trainer = build_trainer(cfg, device=device, verbose=False, dataset=dataset,
                            supports=supports, fault_plan=fault_plan)
    t_build = time.perf_counter() - t_build
    init = from_jax_params(trainer.state_trees()[0], trainer.model.m_graphs)
    rec = recorded(trainer)
    comm.STATS.reset()
    reset_counts()
    t0 = time.perf_counter()
    trainer.train()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    stats = comm.collective_stats()
    params, _ = trainer.state_trees()
    out = {"losses": list(rec["losses"]), "p50_ms": p50_ms(rec["seconds"]),
           "seconds": seconds, "build_s": t_build,
           "steps": len(rec["losses"]), "forwards": rec["forwards"],
           "rows": sorted(rec["rows"]), "counts": counts, "comm": stats,
           "path": trainer.train_path, "graphs": trainer.graphs,
           "state": from_jax_params(params, trainer.model.m_graphs), "init": init,
           "best_val": trainer.best_val, "health": rec["health"], "trips": rec["trips"],
           "node_pads": trainer._node_pads,
           "rungs": [c.n_nodes for c in trainer.fleet_plan.classes] if trainer.fleet_plan else [],
           "health_writer": trainer._health_writer is not None}
    health = trainer._health_out_path()
    if trainer.health and trainer.is_lead and os.path.exists(health):
        with open(health) as f:
            out["health_lines"] = sum(1 for _ in f)
    if test:
        out["test"] = trainer.test(modes=("test",), checkpoint="best")["test"]
    if trainer.mesh is not None:
        out["mesh"] = {**trainer.mesh.shape, "coords": trainer.mesh.coords,
                       "backend": trainer.mesh.backend}
        batch = next(iter(trainer.batches("train")))
        report = step_comm_report(trainer.train_batch, batch)
        out["step_comm"] = {k: v for k, v in report.items() if k != "result"}
        banded = "banded" in trainer.model.support_modes
        manifest = manifest_for_config(cfg, banded=banded, transport=trainer.mesh.backend)
        out["manifest"] = check_executed(manifest, report)
        out["numel"] = sum(p.numel() for p in trainer.model.parameters())
        # the lint's executed half on this rank's step: any finding fails the job
        meta = dict(banded_meta(trainer, cfg), param_bytes=param_bytes(trainer.model))
        spmd = (manifest_findings("train", manifest, report)
                + wire_findings("train", report, meta))
        if spmd:
            fail(f"rank {trainer.mesh.rank}: the step's spmd findings: "
                 + "; ".join(str(f) for f in spmd))
        out["wire"] = wire_figures(report, meta)
    out["trainer"] = trainer
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out


def spmd_text(gots: list) -> str:
    """The lint's wire figures of a phase's ranks (``wire_figures`` of each
    rank's one step; a rank with an ``spmd-collective-manifest`` or
    ``spmd-wire-budget`` finding failed its job): the largest dp
    all-reduce a step beside ``2 x param_bytes + 4096``, the largest halo
    permute call beside its boundary-rows cap."""
    figs = [g["wire"] for g in gots]
    parts = [f"0 spmd findings on {len(figs)} ranks"]
    dp = [f["dp_bytes"] for f in figs if f.get("dp_bytes") is not None]
    if dp:
        parts.append(f"dp all-reduce a step {max(dp):,} bytes (cap 2 x param_bytes + 4096 = "
                     f"{min(f['dp_cap'] for f in figs):,})")
    perm = [f["permute_max"] for f in figs if f.get("permute_max") is not None]
    if perm:
        parts.append(f"largest halo permute call {max(perm):,} bytes (cap halo x B_local x "
                     f"M_local x F_cap x 4 = {min(f['permute_cap'] for f in figs):,})")
    return "; ".join(parts)


def check_mesh_run(got: dict, twin: dict, what: str, *, loss_atol: float = 0.0,
                   loss_rtol: float = MESH_LOSS_RTOL, params: bool = True,
                   steps: int | None = None) -> str:
    """A rank's run against its single-device twin: the per-step losses
    (the first ``steps`` of them, None: all; every one finite) and the
    final parameters."""
    a, b = np.asarray(got["losses"]), np.asarray(twin["losses"])
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        fail(f"{what}: {a.shape[0]} finite-checked steps against the twin's {b.shape[0]}")
    n = a.shape[0] if steps is None else steps
    if not np.allclose(a[:n], b[:n], rtol=loss_rtol, atol=loss_atol):
        fail(f"{what}: per-step losses of the first {n} steps differ from the twin's by up "
             f"to {np.max(np.abs(a[:n] - b[:n])):.3e} (rtol {loss_rtol}, atol {loss_atol})")
    worst = 0.0
    if params:
        for name, value in got["state"].items():
            want = twin["state"][name].cpu().numpy()
            value = value.cpu().numpy()
            worst = max(worst, float(np.max(np.abs(value - want))))
            if not np.allclose(value, want, rtol=MESH_PARAM_RTOL, atol=MESH_PARAM_ATOL):
                fail(f"{what}: parameter {name} differs from the twin's by up to "
                     f"{np.max(np.abs(value - want)):.3e} (rtol {MESH_PARAM_RTOL}, atol "
                     f"{MESH_PARAM_ATOL})")
    return (f"{a.shape[0]} steps, losses max |diff| {np.max(np.abs(a - b)):.3e}"
            + (f" ({np.max(np.abs(a[:n] - b[:n])):.3e} over the first {n})" if n < a.shape[0]
               else "") + (f", parameters max |diff| {worst:.3e}" if params else ""))


def check_bf16_run(got: dict, twin16: dict, twin32: dict, what: str) -> str:
    """Phase 59: a bf16 mesh run against its bf16 twin and its fp32 twin of
    the same epochs. The first TWIN_STEPS losses within TWIN_ATOL of the
    bf16 twin's (the drill's window), then the whole epoch by the
    BF16_GAP_FACTOR rule: every step's loss, each large tensor and the
    whole final state as far from the fp32 twin as the bf16 twin is, at
    most that factor more."""
    text = check_mesh_run(got, twin16, what, loss_rtol=0.0, loss_atol=TWIN_ATOL,
                          params=False, steps=TWIN_STEPS)
    a, b, f = (np.asarray(r["losses"]) for r in (got, twin16, twin32))
    if not a.shape == b.shape == f.shape:
        fail(f"{what}: {a.shape[0]} steps, the bf16 twin {b.shape[0]}, the fp32 twin "
             f"{f.shape[0]}")
    twin_gap, gaps = float(np.max(np.abs(b - f))), np.abs(a - f)
    limit = BF16_GAP_FACTOR * twin_gap
    if np.any(gaps > limit):
        i = int(np.argmax(gaps > limit))
        fail(f"{what}: step {i}'s loss sits {gaps[i]:.3e} from the fp32 twin's, past "
             f"{BF16_GAP_FACTOR} x the bf16 twin's largest gap {twin_gap:.3e}")
    worst, sq = (0.0, ""), [0.0, 0.0]
    for name, value in got["state"].items():
        ref = twin32["state"][name].float().cpu().numpy()
        mine = float(np.linalg.norm(value.float().cpu().numpy() - ref))
        theirs = float(np.linalg.norm(twin16["state"][name].float().cpu().numpy() - ref))
        sq[0], sq[1] = sq[0] + mine ** 2, sq[1] + theirs ** 2
        if value.numel() < BF16_NORM_MIN:
            continue
        if mine > BF16_GAP_FACTOR * theirs:
            fail(f"{what}: parameter {name} sits {mine:.3e} from the fp32 twin's (norm), "
                 f"past {BF16_GAP_FACTOR} x the bf16 twin's {theirs:.3e}")
        worst = max(worst, (mine / max(theirs, 1e-30), name))
    whole = (float(np.sqrt(sq[0])), float(np.sqrt(sq[1])))
    if whole[0] > BF16_GAP_FACTOR * whole[1]:
        fail(f"{what}: the final state sits {whole[0]:.3e} from the fp32 twin's (norm), past "
             f"{BF16_GAP_FACTOR} x the bf16 twin's {whole[1]:.3e}")
    return (f"{text}; gap to the fp32 twin, losses {np.max(gaps):.3e} (the bf16 twin's "
            f"{twin_gap:.3e}), whole state {whole[0]:.3e} (the bf16 twin's {whole[1]:.3e}), "
            f"worst tensor {worst[1]} at {worst[0]:.3f} of the bf16 twin's gap (limit "
            f"{BF16_GAP_FACTOR})")


def finite_steps(got: dict) -> dict:
    """A run's record without its non-finite losses (the steps of a
    poisoned block, rolled back)."""
    losses = np.asarray(got["losses"])
    return {**got, "losses": losses[np.isfinite(losses)].tolist()}


def check_features(got16: dict, got32: dict, twin16: dict, twin32: dict, what: str) -> str:
    """Phase 67: a rank's two runs with every opt-in feature (bf16 with
    stochastic rounding, and fp32 without) against the one-device twins of
    the same plan. In both, the non-finite steps (the poisoned block's)
    and the guard's trips where the twin's are, the non-finite counts of
    the health records equal, the health stats' branch all-reduce one a
    step of ``3 P + 2`` floats (P parameters), and the lead alone wrote
    ``health.jsonl`` with the twin's lines. At fp32 the finite losses and
    the final state by phase 57's rules (:func:`check_mesh_run`) and every
    health record's norms within HEALTH_RTOL (relative) of the twin's; at
    bf16 the losses and the final state by phase 59's rule
    (:func:`check_bf16_run`) and, as its losses, every health record's
    norms no farther from the fp32 twin's than BF16_GAP_FACTOR times the
    bf16 twin's largest gap (relative; each dp rank rounds its
    half-batch's bf16 gradient products, one device the whole batch's, so
    a gradient norm moves by bf16 roundings from the first step)."""
    from stmgcn_tpu_torch.train.step import HEALTH_COLUMNS

    counts = [HEALTH_COLUMNS.index(c) for c in ("nonfinite_grads", "nonfinite_loss")]

    def rel(a, b):  # the largest relative gap of a's health norms to b's
        norms = [i for i in range(1, b.shape[-1]) if i not in counts]
        return float(np.max(np.abs(a[..., norms] - b[..., norms])
                            / np.maximum(np.abs(b[..., norms]), 1e-30)))

    texts = []
    for got, twin, dtype in ((got16, twin16, "bf16"), (got32, twin32, "fp32")):
        where = f"{what}, {dtype}"
        a, b = np.asarray(got["losses"]), np.asarray(twin["losses"])
        if a.shape != b.shape or not np.array_equal(np.isfinite(a), np.isfinite(b)):
            fail(f"{where}: {a.shape[0]} steps, non-finite at {np.flatnonzero(~np.isfinite(a))};"
                 f" the twin's {b.shape[0]} at {np.flatnonzero(~np.isfinite(b))}")
        if not got["trips"] or got["trips"] != twin["trips"]:
            fail(f"{where}: the guard tripped at {got['trips']}, the twin's at {twin['trips']}")
        rows, want = got["health"], twin["health"]
        if len(rows) != len(want) or not rows or any(
                not np.array_equal(r[:, counts], w[:, counts]) for r, w in zip(rows, want)):
            fail(f"{where}: {len(rows)} health records, the twin's {len(want)}, or their "
                 "non-finite counts differ")
        lead = got["mesh"]["coords"] == {"dp": 0, "region": 0, "branch": 0}
        if got["health_writer"] != lead or (lead and got["health_lines"] != twin["health_lines"]):
            fail(f"{where}: health writer {got['health_writer']} (lead {lead}), lines "
                 f"{got.get('health_lines')} against the twin's {twin['health_lines']}")
        h = got["comm"]["what"].get("all-reduce/branch/health", {"calls": 0, "bytes": 0})
        if h != {"calls": got["steps"], "bytes": got["steps"] * 4 * (3 * got["params"] + 2)}:
            fail(f"{where}: the health all-reduce {h}; expected one of "
                 f"{4 * (3 * got['params'] + 2)} bytes a step over {got['steps']} steps")
        gap = max(rel(r, w) for r, w in zip(rows, want))
        if dtype == "fp32":
            text = check_mesh_run(finite_steps(got), finite_steps(twin), where)
            if gap > HEALTH_RTOL:
                fail(f"{where}: the health norms sit up to {gap:.3e} (relative) from the "
                     f"twin's (rule {HEALTH_RTOL})")
            text += f"; health norms within {gap:.3e} of the twin's (relative)"
        else:
            text = check_bf16_run(finite_steps(got), finite_steps(twin),
                                  finite_steps(twin32), where)
            mine = max(rel(r, f) for r, f in zip(rows, twin32["health"]))
            theirs = max(rel(w, f) for w, f in zip(want, twin32["health"]))
            if mine > BF16_GAP_FACTOR * theirs:
                fail(f"{where}: a health record's norms sit {mine:.3e} (relative) from the fp32 "
                     f"twin's, past {BF16_GAP_FACTOR} x the bf16 twin's largest gap {theirs:.3e}")
            text += (f"; health norms within {gap:.3e} of the twin's (relative), at most "
                     f"{mine:.3e} from the fp32 twin's (the bf16 twin's largest gap {theirs:.3e})")
        agreed = {k.split("/")[-1]: v["calls"] for k, v in got["comm"]["what"].items()
                  if k.startswith("all-reduce/world/")}
        texts.append(f"{dtype}: {text}; trips {got['trips']}, {len(rows)} health records, "
                     f"world agreements {agreed}")
    return "; ".join(texts)


def param_gaps(got: dict, twin: dict) -> dict:
    """Per tensor, a rank's final parameters against its twin's: the
    largest elementwise difference, whether the elementwise tolerance of
    phase 57 holds (and at how many entries it does not), and the
    normwise update gap ``|p - p_twin| / |p_twin - p_init|``. Where
    entries are past the tolerance and the twin kept its Adam moments
    (``twin["rms_grad"]``, :func:`mesh_twin`): the twin's rms gradient at
    them (median) beside the tensor's median (an entry whose gradient is
    near zero takes a step of O(lr) whatever its size, so a reordered
    sum moves it the most)."""
    out = {}
    for name, value in got["state"].items():
        value, want = value.cpu().numpy(), twin["state"][name].cpu().numpy()
        update = np.linalg.norm(want - twin["init"][name].cpu().numpy())
        close = np.isclose(value, want, rtol=MESH_PARAM_RTOL, atol=MESH_PARAM_ATOL)
        out[name] = {"max_diff": float(np.max(np.abs(value - want))),
                     "elementwise_ok": bool(close.all()), "past": int((~close).sum()),
                     "update_gap": float(np.linalg.norm(value - want) / max(update, 1e-30))}
        rms = twin.get("rms_grad", {}).get(name)
        if rms is not None and not close.all():
            out[name].update(rms_grad_at_past=float(np.median(rms[~close])),
                             rms_grad_median=float(np.median(rms)))
    return out


def gaps_text(gaps: dict) -> str:
    """The tensors past phase 57's elementwise tolerance, for a line."""
    past = {k: v for k, v in gaps.items() if not v["elementwise_ok"]}
    return "; ".join(
        f"{k} {v['past']} of its entries (max |diff| {v['max_diff']:.3e}"
        + (f", the twin's rms gradient there {v['rms_grad_at_past']:.3e} against the "
           f"tensor's median {v['rms_grad_median']:.3e}" if "rms_grad_at_past" in v else "")
        + ")" for k, v in past.items()) or "none"


def check_comm(got: dict, what: str, *, grads: int, fusion: int = 0, steps: int) -> None:
    """A rank's collective counts over its run: one gradient all-reduce of
    ``grads`` bytes a step, and (branch meshes) one fusion all-reduce of
    ``fusion`` bytes a forward; its extra step kept to the manifest."""
    table = got["comm"]["what"]
    g = table.get("all-reduce/dp/grads", {"calls": 0, "bytes": 0})
    if g["calls"] != steps or g["bytes"] != steps * grads:
        fail(f"{what}: the dp gradient all-reduce ran {g['calls']} times, {g['bytes']} bytes; "
             f"expected {steps} x {grads}")
    if fusion:
        f = table.get("all-reduce/branch/fusion", {"calls": 0, "bytes": 0})
        if f["calls"] != got["forwards"] or f["bytes"] != got["forwards"] * fusion:
            fail(f"{what}: the fusion all-reduce ran {f['calls']} times, {f['bytes']} bytes; "
                 f"expected {got['forwards']} forwards x {fusion}")
    if got["manifest"]:
        fail(f"{what}: the step broke its collective manifest: {got['manifest']}")
    step = got["step_comm"]["ops"]
    if "all-reduce/dp" not in step or (fusion and "all-reduce/branch" not in step):
        fail(f"{what}: the step's required collectives did not run: {step}")


def check_mesh_launches(got: dict, what: str, rows: set, xla: bool = False) -> None:
    """One B1 launch per forward (of ``rows`` rows) and one B2 per step,
    on this rank, in the form named."""
    c = got["counts"]
    b1, b2 = (c["B1 xla"], c["B2 xla"]) if xla else (c["B1"], c["B2"])
    steps = got["steps"]
    if b1 != got["forwards"] or b2 != steps or not b1 or not b2:
        fail(f"{what}: {b1} B1 and {b2} B2 launches for {got['forwards']} forwards and "
             f"{steps} steps ({counts_text(c)})")
    if set(got["rows"]) != rows:
        fail(f"{what}: B1 took {got['rows']} rows a launch, expected {sorted(rows)}")
    if any(c[k] for k in ("B3", "B4", "B5")):
        fail(f"{what}: the dense mesh path launched block-CSR kernels: {counts_text(c)}")


def digest(state: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for name in sorted(state):
        h.update(name.encode())
        h.update(state[name].detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def mesh_job_multicity(args, out: str, device) -> dict:
    """Phase 57 in one rank: ``multicity`` at its dp=8 mesh (``args["dp"]``:
    another extent, as ``scripts/mesh_nccl.py`` runs it)."""
    cfg = mesh_config("multicity", os.path.join(out, "run"))
    cfg.mesh.dp = args.get("dp", cfg.mesh.dp)
    got = mesh_train(cfg, device)
    del got["trainer"]
    return {"57": got}


def mesh_job_bf16(args, out: str, device) -> dict:
    """Phase 59 alone in one rank of a 6-rank job, at ``args["seed"]`` (the
    data, weights and batch order; ``scripts/mesh_gaps.py``)."""
    got = mesh_train(mesh_config("branchpar", os.path.join(out, "run"), dtype="bfloat16",
                                 epochs=MESH_BF16_EPOCHS, seed=args.get("seed")), device)
    del got["trainer"]
    return {"59": got}


#: phase 67: ``branchpar`` at bf16 (the xla form) for one epoch, window-free
#: resident in blocks of FEATURE_S, with every opt-in feature: stochastic
#: rounding (SR_SEED), health at every dispatch, the index sanitizers (a NaN
#: check would stop the run at the poisoned step before the guard sees it:
#: phase 68b's drill), the divergence guard (skip) and a fault plan that
#: poisons step FEATURE_POISON (a block rolled back and replayed step by
#: step) and drops step FEATURE_DROP (a block run step by step); the health
#: norms' rule against the twin (relative)
FEATURE_S, FEATURE_POISON, FEATURE_DROP, HEALTH_RTOL = 4, 5, 9, 1e-5


def feature_config(out: str, dtype: str = "bfloat16"):
    """Phase 67's config (``dtype="float32"``: its fp32 yardstick, the same
    without stochastic rounding)."""
    cfg = mesh_config("branchpar", out, dtype=dtype, epochs=MESH_BF16_EPOCHS)
    t = cfg.train
    t.steps_per_superstep, t.window_free, t.data_placement = FEATURE_S, True, "resident"
    t.divergence_guard, t.divergence_action, t.checks = True, "skip", "index"
    if dtype == "bfloat16":
        t.precision, t.sr_seed = "bf16", SR_SEED
    cfg.health.enabled, cfg.health.every_k = True, 1
    return cfg


def feature_plan():
    """Phase 67's fault plan (a fresh one per run)."""
    from stmgcn_tpu_torch.resilience import FaultPlan, FaultSpec

    return FaultPlan(FaultSpec("poison", epoch=1, step=FEATURE_POISON),
                     FaultSpec("drop", epoch=1, step=FEATURE_DROP))


def mesh_job_branchpar(args, out: str, device) -> dict:
    """Phases 58, 60 (the files), 59 and 67 in one rank of the 6-rank job
    (``args["phases"]``: fewer)."""
    import torch

    phases = args.get("phases", ("58", "59", "67"))
    res = {}
    if "58" in phases:
        res.update(branchpar_files(args, device))
    if "59" in phases:  # the preset in its bf16 (xla) form
        got = mesh_train(mesh_config("branchpar", os.path.join(out, "bf16"),
                                     dtype="bfloat16", epochs=MESH_BF16_EPOCHS), device)
        del got["trainer"]
        res["59"] = got
        torch.cuda.empty_cache()
    if "67" in phases:  # every opt-in feature, at bf16 and at fp32
        res["67"] = {}
        for dtype in ("bfloat16", "float32"):
            got = mesh_train(feature_config(os.path.join(out, f"features-{dtype}"), dtype),
                             device, fault_plan=feature_plan())
            got["params"] = len(got.pop("trainer")._param_names)
            res["67"][dtype] = got
            torch.cuda.empty_cache()
    return res


def branchpar_files(args, device) -> dict:
    """Phases 58 and 60 in one rank: ``branchpar`` at fp32 with
    ``test()``, then the lead's files read, resumed and corrupted."""
    import torch

    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.models import from_jax_params
    from stmgcn_tpu_torch.train.checkpoint import load_checkpoint

    run = os.path.join(args["root"], "branchpar")
    got = mesh_train(mesh_config("branchpar", run), device, test=True)
    trainer = got.pop("trainer")
    res = {"58": got}
    # 60: the lead wrote best/latest; the best file's parameters evaluated on
    # the mesh (gathered over dp), for the parent's one-device Forecaster
    _, _, params, _ = trainer._lead_read(
        lambda: (trainer.best_path, *load_checkpoint(trainer.best_path, load_opt_state=False)))
    best = {k: v.to(device) for k, v in
            from_jax_params(params, trainer.model.m_graphs, trainer._branches()).items()}
    pred = trainer._predict_mode("test", best)[0][0][:MESH_SERVE_ROWS]
    res["60"] = {"evaluated": trainer.dataset.denormalize(pred)}
    del trainer
    # a mesh resume: every rank from the lead's latest.ckpt (the others read nothing)
    t0 = time.perf_counter()
    fresh = build_trainer(mesh_config("branchpar", run, epochs=MESH_EPOCHS + 1), device=device,
                          verbose=False)
    meta = fresh.restore_auto()
    res["60"].update(resume_s=time.perf_counter() - t0, resumed_epoch=meta["epoch"],
                     digest=digest(from_jax_params(fresh.state_trees()[0], 3)))
    if fresh.is_lead:
        res["60"]["file_digest"] = digest(from_jax_params(
            load_checkpoint(fresh.latest_path, load_opt_state=False)[1], 3))
        with open(fresh.latest_path, "rb") as f:
            data = bytearray(f.read())
        data[len(data) // 2] ^= 0xFF
        with open(os.path.join(run, "corrupt.ckpt"), "wb") as f:
            f.write(data)
    t0 = time.perf_counter()
    try:
        fresh.restore(os.path.join(run, "corrupt.ckpt"))
        res["60"]["corrupt"] = None
    except Exception as e:  # noqa: BLE001 — every rank must raise; the parent checks
        res["60"]["corrupt"] = f"{type(e).__name__}: {e}"
    res["60"]["corrupt_s"] = time.perf_counter() - t0
    del fresh
    torch.cuda.empty_cache()
    return res


MESH_JOBS = {"multicity": mesh_job_multicity, "branchpar": mesh_job_branchpar,
             "branchpar-bf16": mesh_job_bf16}


def mesh_rank(job: str, out: str) -> int:
    """A rank process of a mesh job (``chip_smoke.py --mesh-rank JOB DIR``,
    started by :func:`run_ranks`): joins the job, runs it, saves its
    results to ``DIR/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from stmgcn_tpu_torch.parallel import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_distributed(device="cuda", timeout=MESH_TIMEOUT)
    args = torch.load(os.path.join(out, "args.pt"), weights_only=False)
    result = MESH_JOBS[job](args, out, device)
    torch.save(result, os.path.join(out, f"rank{dist.get_rank()}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def launch_ranks(cmd, world: int, out: str, timeout: float) -> list:
    """``cmd`` in ``world`` local rank processes (``launch_local``: the
    ``torchrun`` environment, the kernels prebuilt), each logging to
    ``out/rank<r>.log``. Any rank that fails or outlives ``timeout`` fails
    the run, the others killed. Returns each rank's log."""
    from stmgcn_tpu_torch.ops._build import PREBUILT_ENV
    from stmgcn_tpu_torch.parallel.mesh import launch_local

    _, problem = launch_local(cmd, world, env={PREBUILT_ENV: "1"}, log_dir=out,
                              timeout=timeout, cwd=os.path.dirname(os.path.abspath(__file__)))
    logs = [open(os.path.join(out, f"rank{r}.log")).read() for r in range(world)]
    if problem is not None:
        tails = "".join(f"\n--- rank {r} ---\n{log[-3000:]}" for r, log in enumerate(logs))
        fail(f"{' '.join(cmd[-4:])}: {problem}{tails}")
    return logs


def run_ranks(job: str, world: int, **args) -> list:
    """The mesh job ``job`` in ``world`` rank processes of this script on
    the card (gloo: the ranks share it); each rank's results."""
    import torch

    out = scratch(f"mesh-{job}")
    os.makedirs(out, exist_ok=True)
    torch.save(args, os.path.join(out, "args.pt"))
    launch_ranks([sys.executable, os.path.abspath(__file__), "--mesh-rank", job, out], world,
                 out, MESH_TIMEOUT)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def mesh_twin(name: str, device, *, dtype: str = "float32", epochs: int = MESH_EPOCHS,
              test: bool = False, seed: int | None = None, cfg=None, dataset=None,
              supports=None, fault_plan=None) -> dict:
    """The preset's single-device twin on the card (graphed, as a user
    runs it): the same config without the mesh, the same seed (``cfg``: a
    mesh config of its own, its mesh removed; ``dataset`` and its dense
    ``supports``: the data it trains on; ``fault_plan``: the rank's)."""
    from stmgcn_tpu_torch.config import MeshConfig

    if cfg is None:
        cfg = mesh_config(name, scratch(f"twin-{name}-{dtype}-{epochs}-{seed}"), dtype=dtype,
                          epochs=epochs, seed=seed)
    cfg.mesh = MeshConfig()
    got = mesh_train(cfg, device, test=test, dataset=dataset, supports=supports,
                     fault_plan=fault_plan)
    got["cfg"] = cfg
    opt = got["trainer"].optimizer  # Adam's rms gradient per entry, for param_gaps
    got["rms_grad"] = {n: np.sqrt(v.detach().float().cpu().numpy())
                       for n, v in zip(got["trainer"]._param_names, opt.exp_avg_sq)}
    return got


def mesh_phases(device, card: str) -> dict:
    """Phases 57-60; returns the B1/B2 launches summed over the ranks:
    ``{"fp32": {"B1", "B2"}, "xla": {"B1 xla", "B2 xla"}}``."""
    t0 = time.perf_counter()
    # 57: multicity at its dp=8 mesh
    twin = mesh_twin("multicity", device)
    twin.pop("trainer")
    release()
    ranks = [r["57"] for r in run_ranks("multicity", 8)]
    rows = MULTICITY_ROWS
    for r, got in enumerate(ranks):
        what = f"phase 57 (multicity dp=8) rank {r}"
        text = check_mesh_run(got, twin, what)
        check_comm(got, what, grads=8 * MESH_PARAMS, steps=got["steps"])
        check_mesh_launches(got, what, rows)
        if got["mesh"]["backend"] != "gloo" or got["path"] != "per_step" or got["graphs"]:
            fail(f"{what}: ran {got['path']} over {got['mesh']['backend']}, graphs "
                 f"{got['graphs']}; expected per_step (streamed), gloo, eager")
        print(f"{what}: {text}; dp all-reduce {got['comm']['what']['all-reduce/dp/grads']}"
              f" ({8 * MESH_PARAMS} bytes a step); B1 {got['counts']['B1']} launches of "
              f"{got['rows']} rows, B2 {got['counts']['B2']}; manifest clean; step p50 "
              f"{got['p50_ms']:.2f} ms ({card})")
    print(f"phase 57 lint, executed half: {spmd_text(ranks)}")
    print(f"phase 57 twin (one device, graphed, {twin['path']}): step p50 "
          f"{twin['p50_ms']:.2f} ms; the ranks' p50s "
          f"{[round(g['p50_ms'], 2) for g in ranks]} ms (eight processes sharing the card "
          f"over gloo; {card}); {time.perf_counter() - t0:.1f} s")
    launches = {"fp32": {k: sum(g["counts"][k] for g in ranks) for k in ("B1", "B2")}}

    # 58-60: branchpar at dp=2 x branch=3 (and its bf16 form, 59)
    twin = mesh_twin("branchpar", device, test=True)
    twin_trainer = twin.pop("trainer")
    twin16 = mesh_twin("branchpar", device, dtype="bfloat16", epochs=MESH_BF16_EPOCHS)
    twin16.pop("trainer")
    twin32 = mesh_twin("branchpar", device, epochs=MESH_BF16_EPOCHS)  # 59's fp32 yardstick
    twin32.pop("trainer")
    feat16 = mesh_twin("branchpar", device, cfg=feature_config(scratch("twin-67")),
                       fault_plan=feature_plan())  # 67's bf16 twin and its fp32 yardstick
    feat16.pop("trainer")
    feat32 = mesh_twin("branchpar", device,
                       cfg=feature_config(scratch("twin-67-fp32"), "float32"),
                       fault_plan=feature_plan())
    feat32.pop("trainer")
    release()
    results = run_ranks("branchpar", 6, root=scratch("mesh-files"))
    rows, fusion = BRANCHPAR_ROWS, FUSION_BYTES
    for r, res in enumerate(results):
        got, what = res["58"], f"phase 58 (branchpar dp=2 x branch=3) rank {r}"
        text = check_mesh_run(got, twin, what)
        check_comm(got, what, grads=8 * (BRANCH_PARAMS + HEAD_PARAMS), fusion=fusion,
                   steps=got["steps"])
        check_mesh_launches(got, what, rows)
        for key in ("mse", "mae"):
            if not np.isclose(got["test"][key], twin["test"][key], rtol=1e-4):
                fail(f"{what}: test() {key} {got['test'][key]} vs the twin's "
                     f"{twin['test'][key]}")
        print(f"{what} at {got['mesh']['coords']}: {text}; fusion all-reduce "
              f"{got['comm']['what']['all-reduce/branch/fusion']} ({fusion} bytes a forward), "
              f"dp all-reduce {got['comm']['what']['all-reduce/dp/grads']} "
              f"({8 * (BRANCH_PARAMS + HEAD_PARAMS)} bytes a step); B1 "
              f"{got['counts']['B1']} launches of {got['rows']} rows, B2 {got['counts']['B2']};"
              f" test() mse {got['test']['mse']:.6g} (twin {twin['test']['mse']:.6g}); step "
              f"p50 {got['p50_ms']:.2f} ms ({card})")
        got16, what = res["59"], f"phase 59 (branchpar bf16, xla form) rank {r}"
        text = check_bf16_run(got16, twin16, twin32, what)
        check_mesh_launches(got16, what, rows, xla=True)
        if got16["comm"]["what"]["all-reduce/branch/fusion"]["bytes"] != (
                got16["forwards"] * fusion):
            fail(f"{what}: the bf16 fusion is not an fp32 all-reduce of {fusion} bytes")
        print(f"{what}: {text} (atol {TWIN_ATOL}); B1 xla {got16['counts']['B1 xla']}, B2 xla "
              f"{got16['counts']['B2 xla']}; step p50 {got16['p50_ms']:.2f} ms "
              f"(twin {twin16['p50_ms']:.2f} ms; {card})")
        got67, what = res["67"], f"phase 67 (branchpar, every opt-in feature) rank {r}"
        text = check_features(got67["bfloat16"], got67["float32"], feat16, feat32, what)
        for dtype, twin67 in (("bfloat16", feat16), ("float32", feat32)):
            got = got67[dtype]
            check_mesh_launches(got, f"{what}, {dtype}", rows, xla=dtype == "bfloat16")
            check_comm(got, f"{what}, {dtype}", grads=8 * (BRANCH_PARAMS + HEAD_PARAMS),
                       fusion=fusion, steps=got["steps"])
            text += (f"; {dtype} step p50 {got['p50_ms']:.2f} ms (twin {twin67['p50_ms']:.2f}"
                     " ms)")
        print(f"{what}: {text}; B1/B2 xla {got67['bfloat16']['counts']['B1 xla']}/"
              f"{got67['bfloat16']['counts']['B2 xla']}, fp32 {got67['float32']['counts']['B1']}/"
              f"{got67['float32']['counts']['B2']}; manifests clean ({card})")
    for phase, gots in (("58", [r["58"] for r in results]), ("59", [r["59"] for r in results]),
                        ("67", [r["67"][d] for r in results for d in ("bfloat16", "float32")])):
        print(f"phase {phase} lint, executed half: {spmd_text(gots)}")
    print(f"phase 58 twin (one device, graphed): step p50 {twin['p50_ms']:.2f} ms; "
          f"{time.perf_counter() - t0:.1f} s")
    launches["fp32"] = {k: launches["fp32"][k] + sum(r["58"]["counts"][k]
                                                     + r["67"]["float32"]["counts"][k]
                                                     for r in results) for k in ("B1", "B2")}
    launches["xla"] = {k: sum(r["59"]["counts"][k] + r["67"]["bfloat16"]["counts"][k]
                              for r in results) for k in ("B1 xla", "B2 xla")}
    mesh_files(device, results, twin_trainer, card)
    del twin_trainer
    release()
    mesh_cli()
    print(f"mesh phases done in {time.perf_counter() - t0:.1f} s")
    return launches


def mesh_files(device, results, twin_trainer, card: str) -> None:
    """Phase 60: the lead's files. ``Forecaster.from_checkpoint`` of the
    mesh's ``best.ckpt`` on one device serves what the mesh evaluated from
    the file (and the twin's own best beside it); every rank resumed the
    lead's digest; a corrupt lead file raised on every rank."""
    from stmgcn_tpu_torch import Forecaster

    run = os.path.join(scratch("mesh-files"), "branchpar")
    files = sorted(os.listdir(run))
    if "best.ckpt" not in files or "latest.ckpt" not in files:
        fail(f"phase 60: the lead wrote {files}, not best.ckpt and latest.ckpt")
    fc = Forecaster.from_checkpoint(os.path.join(run, "best.ckpt"), device=device)
    ds = twin_trainer.dataset
    windows = ds.denormalize(ds.arrays("test")[0])[:MESH_SERVE_ROWS]
    supports = twin_trainer.supports.cpu().numpy()
    served = fc.predict(supports, windows)
    evaluated = results[0]["60"]["evaluated"]
    err = float(np.max(np.abs(served - evaluated)))
    if not np.allclose(served, evaluated, rtol=SERVE_RTOL, atol=SERVE_ATOL):
        fail(f"phase 60: Forecaster.from_checkpoint of the mesh's best.ckpt vs the mesh's "
             f"evaluation of it: max |err| {err:.3e}")
    twin_fc = Forecaster.from_checkpoint(twin_trainer.best_path, device=device)
    gap = float(np.max(np.abs(served - twin_fc.predict(supports, windows))))
    print(f"phase 60: the lead wrote {files}; Forecaster.from_checkpoint(best.ckpt) on one "
          f"device serves the mesh's evaluation of the file, {MESH_SERVE_ROWS} test windows, "
          f"max |err| {err:.3e} (rtol {SERVE_RTOL}, atol {SERVE_ATOL}, raw units); the twin's "
          f"own best.ckpt served beside it: max |diff| {gap:.3e}")
    digests = {r["60"]["digest"] for r in results}
    want = results[0]["60"]["file_digest"]
    if digests != {want}:
        fail(f"phase 60: a mesh resume gave digests {digests}, the lead's file {want}")
    errors = [r["60"]["corrupt"] for r in results]
    if any(e is None for e in errors) or not all("CRC32 mismatch" in e for e in errors):
        fail(f"phase 60: a corrupt lead file did not raise on every rank: {errors}")
    print(f"phase 60: a mesh resume (epoch {results[0]['60']['resumed_epoch']}) gave every rank "
          f"the lead's parameter digest {want} in "
          f"{max(r['60']['resume_s'] for r in results):.2f} s; a corrupt lead file raised on "
          f"all 6 ranks in {max(r['60']['corrupt_s'] for r in results):.2f} s: "
          f"{errors[0][:60]}... / {errors[1][:70]}...")


def mesh_cli() -> None:
    """Phase 60, end: ``python -m stmgcn_tpu_torch.cli --preset branchpar
    --distributed`` in six processes launched as torchrun would (one card,
    so gloo): one JSON line for the job, from the lead."""
    out = scratch("mesh-cli")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    logs = launch_ranks([sys.executable, "-m", "stmgcn_tpu_torch.cli", "--preset", "branchpar",
                         "--distributed", "--epochs", "1", "--out-dir", os.path.join(out, "run")],
                        6, out, MESH_TIMEOUT)
    lines = [line for log in logs for line in log.splitlines() if line.startswith('{"preset"')]
    if len(lines) != 1 or json.loads(lines[0])["preset"] != "branchpar":
        fail(f"phase 60: the CLI job printed {len(lines)} JSON lines, expected one")
    transport = [line for line in logs[0].splitlines() if line.startswith("[mesh]")]
    print(f"phase 60: the CLI on 6 ranks (--distributed, {transport[0] if transport else '?'}) "
          f"printed one JSON line in {time.perf_counter() - t0:.1f} s: "
          f"test mse {json.loads(lines[0])['results']['test']['mse']:.6g}")


# -- the region phases (61-63) -------------------------------------------------------

#: the region phases: the epochs of each run (the one cut: the preset's 100;
#: one epoch is 22 steps at batch 16) and the CLI run's series length
REGION_EPOCHS, REGION_CLI_TIMESTEPS = 1, 24 * 7 + 120
#: scaled at full width, as routed: each branch's mode, the grid branch's
#: halo, the node padding, and B1's rows a launch per rank (M=3 x B 16 x
#: N_local 313)
REGION_MODES, REGION_HALO, REGION_PAD, REGION_ROWS = (
    ("banded", "dense", "dense"), 150, 4, {3 * 16 * 313})


def cotangent_bytes(calls: int, whole: int, region: int, transport: str) -> dict:
    """The region convs' input-cotangent sums of a step (``what``
    ``node-rows-grad``): over NCCL a reduce-scatter whose output is a
    rank's rows (a ``1/region`` of the ``whole`` cotangent's bytes), over
    gloo an all-reduce of the whole (``comm.reduce_scatter``)."""
    if transport == "nccl":
        return {"reduce-scatter/region/node-rows-grad": {"calls": calls,
                                                         "bytes": whole // region}}
    return {"all-reduce/region/node-rows-grad": {"calls": calls, "bytes": whole}}


def region_bytes(cfg, numel: int, halo: int, n_nodes: int, modes,
                 transport: str = "gloo") -> dict:
    """The collectives one training step of a region mesh moves, per rank
    (``comm``'s ``what`` table: calls and output bytes), from the config,
    the parameter count, the banded branches' halo, the padded node count
    and the routes. Forward, each graph conv (the gate's over the T-step
    history, the branch's over the LSTM's H states) moves its signal in
    the compute dtype: a dense branch all-gathers the whole node axis, a
    banded one permutes ``halo`` rows each way; the gate pools once (``(M,
    B, T)``, float64 at fp32, float32 under bf16). Backward only the branch
    convs' signals carry
    gradients (the gate's is data): a banded branch permutes the halos'
    cotangents back (compute dtype), a dense one all-reduces its float32
    whole-axis cotangent (over NCCL reduce-scatters it,
    :func:`cotangent_bytes`); the pooling's cotangent; then the float64
    gradient bucket and the 4-byte loss."""
    b, t = cfg.train.batch_size // cfg.mesh.dp, cfg.data.seq_len
    h, m = cfg.model.lstm_hidden_dim, cfg.model.m_graphs
    isz = 2 if cfg.model.dtype == "bfloat16" else 4
    pool = 4 if cfg.model.dtype == "bfloat16" else 8
    dense, banded = modes.count("dense"), modes.count("banded")
    want = {
        "all-reduce/region/node-pool": {"calls": 1, "bytes": pool * m * b * t},
        "all-reduce/region/node-pool-grad": {"calls": 1, "bytes": pool * m * b * t},
        "all-reduce/region/grads": {"calls": 1, "bytes": 8 * numel},
        "all-reduce/region/loss": {"calls": 1, "bytes": 4},
    }
    if dense:
        want["all-gather/region/node-rows"] = {"calls": 2 * dense,
                                               "bytes": dense * isz * b * n_nodes * (t + h)}
        want.update(cotangent_bytes(dense, dense * 4 * b * n_nodes * h, cfg.mesh.region,
                                    transport))
    if banded:
        want["collective-permute/region/halo"] = {"calls": 4 * banded,
                                                  "bytes": banded * 2 * isz * halo * b * (t + h)}
        want["collective-permute/region/halo-grad"] = {"calls": 2 * banded,
                                                       "bytes": banded * 2 * isz * halo * b * h}
    return want


def scaled_config(out: str, dtype: str, epochs: int = REGION_EPOCHS):
    """The ``scaled`` preset at ``dtype``, its epochs cut to ``epochs``."""
    return mesh_config("scaled", out, dtype=dtype, epochs=epochs)


def scaled_city(region: int | None = None) -> dict:
    """The scaled phases' city, built once per process: the dataset and
    its dense (node-padded at ``region``, None: the preset's) Chebyshev
    stack, which phases 61, 62 and 64 (and their dense twins) share: each
    ``build_trainer`` would build the same arrays again (N = 2,504: about
    40 s a rank while eight ranks build at once)."""
    from stmgcn_tpu_torch.experiment import build_dataset, build_supports

    cfg = scaled_config("", "float32")
    if region is not None:
        cfg.mesh.region = region
    key = ("scaled", cfg.mesh.region, cfg.mesh.n_devices)
    if key not in _CITIES:
        ds = build_dataset(cfg)
        _CITIES[key] = {"dataset": ds, "supports": build_supports(cfg, ds)}
    return _CITIES[key]


#: :func:`scaled_city`'s cities, by (preset, region, devices)
_CITIES: dict = {}


def route_info(trainer) -> dict:
    """A region trainer's routing: each branch's mode, the banded strips'
    halos, the node padding and the padded node count."""
    sup = trainer.supports if isinstance(trainer.supports, tuple) else ()
    pad = trainer._node_pads[0]
    return {"modes": trainer.model.support_modes,
            "halos": [s.halo for s in sup if hasattr(s, "halo")], "node_pad": pad,
            "n_nodes": trainer.dataset.n_nodes + pad}


def mesh_job_scaled(args, out: str, device) -> dict:
    """Phases 61 (bf16), 62 (fp32) and 63's mesh side (the lead's
    ``best.ckpt`` of 62 evaluated on the mesh), then 64-66 (the block-CSR
    strips, the region x branch routes, the sharded tiled plan), 68a (a
    fleet on a region mesh) and 68b (the NaN drill) in one rank of the
    8-rank job; ``args["region"]`` another extent and ``args["phases"]``
    fewer phases (``scripts/mesh_nccl.py``)."""
    import torch

    from stmgcn_tpu_torch.models import from_jax_params
    from stmgcn_tpu_torch.train.checkpoint import load_checkpoint

    res = {}
    phases = args.get("phases", ("61", "62", "64", "65", "66", "68", "68b"))
    for phase, dtype in (("61", "bfloat16"), ("62", "float32")):
        if phase not in phases:
            continue
        cfg = scaled_config(os.path.join(args["root"], dtype), dtype)
        cfg.mesh.region = args.get("region", cfg.mesh.region)
        got = mesh_train(cfg, device, **scaled_city(cfg.mesh.region))
        trainer = got.pop("trainer")
        got["route"] = route_info(trainer)
        res[phase] = got
        if phase == "62" and args.get("files", True):
            _, _, params, _ = trainer._lead_read(lambda: (
                trainer.best_path, *load_checkpoint(trainer.best_path, load_opt_state=False)))
            best = {k: v.to(device) for k, v in from_jax_params(params, 3).items()}
            pred = trainer._predict_mode("test", best)[0][0][:MESH_SERVE_ROWS]
            res["63"] = {"evaluated": trainer.dataset.denormalize(pred),
                         "best": trainer.best_path}
        del trainer
        torch.cuda.empty_cache()
    if "64" in phases:
        res["64"] = strip_rank(args, device)
    if "65" in phases:
        res["65"] = {route: branch_rank(route, args, device) for route in BRANCH_ROUTES}
    if "66" in phases:
        res["66"] = tiled_rank(args["tiled"], device)
    if "68" in phases:
        got = mesh_train(fleet_region_config(os.path.join(args["root"], "fleet")), device)
        del got["trainer"]
        res["68"] = got
        torch.cuda.empty_cache()
    if "68b" in phases:
        res["68b"] = nan_drill(args, device)
    return res


MESH_JOBS["scaled"] = mesh_job_scaled

#: phase 68a: blocks of FLEET_REGION_S; 68b: the NaN drill's node (rank 3's
#: rows of 313 at region=8), the training window at whose target its series
#: turns NaN (batch 16: step 2) and the most seconds between the ranks'
#: raises (MESH_TIMEOUT is 420)
FLEET_REGION_S, DRILL_NODE, DRILL_SAMPLE, DRILL_SPREAD_S = 4, 1000, 40, 30.0


def fleet_region_config(out: str):
    """Phase 68a: ``multicity`` (its two cities, batch 64, full width) on
    a ``region=8`` mesh, window-free resident in blocks of FLEET_REGION_S,
    REGION_EPOCHS epochs: the fleet's shape classes on a region mesh."""
    from stmgcn_tpu_torch.config import MeshConfig

    cfg = mesh_config("multicity", out, epochs=REGION_EPOCHS)
    cfg.mesh = MeshConfig(region=8)
    t = cfg.train
    t.window_free, t.data_placement, t.steps_per_superstep = True, "resident", FLEET_REGION_S
    return cfg


def nan_drill(args, device) -> dict:
    """Phase 68b in one rank: the scaled city (bf16, window-free resident)
    with a NaN in node DRILL_NODE's series, trained under ``checks="nan"``,
    then under ``debug_nans``: what each raised, at which step, when (the
    wall clock), and the launches. The series is restored after."""
    import torch

    from stmgcn_tpu_torch.experiment import build_trainer

    city = scaled_city(8)
    series = city["dataset"].series(0)
    t_nan = int(city["dataset"].mode_targets("train")[DRILL_SAMPLE])
    saved = float(series[t_nan, DRILL_NODE, 0])
    out = {}
    try:
        series[t_nan, DRILL_NODE, 0] = np.nan
        for kind in ("checks", "debug_nans"):
            cfg = scaled_config(os.path.join(args["root"], f"drill-{kind}"), "bfloat16")
            cfg.train.window_free, cfg.train.data_placement = True, "resident"
            cfg.train.checks = "nan" if kind == "checks" else None
            reset_counts()
            t0 = time.perf_counter()
            trainer = build_trainer(cfg, device=device, verbose=False,
                                    debug_nans=kind == "debug_nans", **city)
            t1 = time.perf_counter()
            nodes = trainer._nodes(0)
            try:
                trainer.train()
                raised = None
            except (RuntimeError, FloatingPointError) as e:  # CheckError: a RuntimeError
                raised = f"{type(e).__name__}: {e}"
            out[kind] = {"raised": raised, "at": time.time(), "step": trainer.global_step,
                         "build_s": t1 - t0, "train_s": time.perf_counter() - t1,
                         "counts": read_counts(), "holds": nodes.start <= DRILL_NODE < nodes.stop}
            del trainer
            torch.cuda.empty_cache()
    finally:
        series[t_nan, DRILL_NODE, 0] = saved
    return out


def check_routes(got: dict, what: str, rows: set, halo: int | None = None,
                 pad: int | None = None) -> None:
    """A region rank's routing and B1's rows a launch: the preset's
    (REGION_HALO, REGION_PAD unless given)."""
    halo = REGION_HALO if halo is None else halo
    pad = REGION_PAD if pad is None else pad
    route = got["route"]
    if (route["modes"], route["halos"], route["node_pad"]) != (REGION_MODES, [halo], pad):
        fail(f"{what}: routed {route['modes']} at halos {route['halos']} with {route['node_pad']}"
             f" padded rows; expected {REGION_MODES} at [{halo}] with {pad}")
    if set(got["rows"]) != rows:
        fail(f"{what}: B1 took {got['rows']} rows a launch, expected {sorted(rows)}")


def check_region_comm(got: dict, cfg, what: str) -> dict:
    """A region rank's one-step collectives equal :func:`region_bytes`;
    one gradient all-reduce over ``region`` a step over the run; the
    manifest clean. Returns the step's table."""
    route = got["route"]
    want = region_bytes(cfg, got["numel"], route["halos"][0], route["n_nodes"], route["modes"],
                        got["mesh"]["backend"])
    step = got["step_comm"]["what"]
    if step != want:
        fail(f"{what}: one step moved {step}, the analytic counts are {want}")
    g = got["comm"]["what"].get("all-reduce/region/grads", {"calls": 0, "bytes": 0})
    if g["calls"] != got["steps"] or g["bytes"] != got["steps"] * 8 * got["numel"]:
        fail(f"{what}: the gradient all-reduce ran {g['calls']} times, {g['bytes']} bytes over "
             f"{got['steps']} steps; expected one of {8 * got['numel']} bytes a step")
    if got["manifest"]:
        fail(f"{what}: the step broke its collective manifest: {got['manifest']}")
    return step


def region_phases(device, card: str, tiled: dict) -> dict:
    """Phases 61-66 (64-66 in the same eight-rank job as 61-62; ``tiled``:
    phase 66's shards, :func:`tiled_shards`); returns the launches summed
    over the ranks: ``{"fp32": {"B1", "B2"}, "xla": {"B1 xla", "B2 xla"},
    "sparse": {...}}`` (``"sparse"``: phases 64-66)."""
    t0 = time.perf_counter()
    city = scaled_city(1)  # the unpadded city of the twins
    twin16 = mesh_twin("scaled", device, dtype="bfloat16", epochs=REGION_EPOCHS, **city)
    twin16.pop("trainer")
    twin32 = mesh_twin("scaled", device, epochs=REGION_EPOCHS, **city)  # 62's, 61's yardstick
    twin_trainer = twin32.pop("trainer")
    release()
    print(f"region twins (one device, graphed, N = 2,500 unpadded, dense): step p50 bf16 "
          f"{twin16['p50_ms']:.2f} ms, fp32 {twin32['p50_ms']:.2f} ms ({card}); "
          f"{time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    twins = {"64": strip_twin(device), "65": branch_twins(device)}
    fleet_twin = mesh_twin("multicity", device, cfg=fleet_region_config(scratch("twin-68")))
    fleet_twin.pop("trainer")
    release()
    print(f"phases 64-65 and 68a twins (one device, graphed): {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    results = run_ranks("scaled", 8, root=scratch("region-files"), tiled=tiled)
    print(f"the eight-rank job (phases 61-62, 63's mesh side, 64-66): "
          f"{time.perf_counter() - t1:.1f} s")
    cfgs = {"61": scaled_config("", "bfloat16"), "62": scaled_config("", "float32")}
    for r, res in enumerate(results):
        got, what = res["61"], f"phase 61 (scaled region=8, bf16) rank {r}"
        check_routes(got, what, REGION_ROWS)
        check_mesh_launches(got, what, REGION_ROWS, xla=True)
        step = check_region_comm(got, cfgs["61"], what)
        text = check_bf16_run(got, twin16, twin32, what)
        if r == 0:
            print(f"phase 61: routes {got['route']['modes']}, halo {got['route']['halos'][0]} "
                  f"rows, {got['route']['node_pad']} padded node rows ({got['route']['n_nodes']}"
                  f" = 8 x {got['route']['n_nodes'] // 8}); B1 rows a launch per rank "
                  f"{got['rows']} (M=3 x B 16 x N_local 313 = 3 x 5,008); one step moved "
                  f"{step} (the analytic counts)")
        print(f"{what} at {got['mesh']['coords']}: {text}; B1 xla {got['counts']['B1 xla']}, "
              f"B2 xla {got['counts']['B2 xla']} for {got['forwards']} forwards and "
              f"{got['steps']} steps; manifest clean; step p50 {got['p50_ms']:.2f} ms (twin "
              f"{twin16['p50_ms']:.2f} ms; {card})")
        got, what = res["62"], f"phase 62 (scaled region=8, fp32) rank {r}"
        check_routes(got, what, REGION_ROWS)
        check_mesh_launches(got, what, REGION_ROWS)
        check_region_comm(got, cfgs["62"], what)
        text = check_mesh_run(got, twin32, what)
        print(f"{what}: {text}; B1 {got['counts']['B1']}, B2 {got['counts']['B2']}; bytes and "
              f"manifest as analytic; step p50 {got['p50_ms']:.2f} ms (twin "
              f"{twin32['p50_ms']:.2f} ms; {card})")
    for phase in ("61", "62"):
        print(f"phase {phase} lint, executed half: {spmd_text([r[phase] for r in results])}")
    launches = {"fp32": {k: sum(r["62"]["counts"][k] for r in results) for k in ("B1", "B2")},
                "xla": {k: sum(r["61"]["counts"][k] for r in results)
                        for k in ("B1 xla", "B2 xla")}}
    launches["sparse"] = sparse_phases(device, card, results, twins, tiled)
    del twins
    fleet = fleet_region_phases(results, fleet_twin, card)
    for key in ("fp32", "xla"):
        launches[key] = {k: launches[key][k] + fleet[key][k] for k in launches[key]}
    print(f"sparse mesh phases (64-66) checked at {time.perf_counter() - t0:.1f} s of the region "
          "phases")
    region_files(device, results, twin_trainer)
    del twin_trainer
    release()
    region_cli()
    print(f"region phases done in {time.perf_counter() - t0:.1f} s")
    return launches


def fleet_region_phases(results, twin: dict, card: str) -> dict:
    """Phases 68a and 68b, checked: per rank, the fleet run's path, its
    losses and parameters against the one-device fleet twin (phase 57's
    rules), B1 one a forward of ``B x rung / 8 x M`` rows and B2 one a
    step, one gradient all-reduce over ``region`` a step, the manifest
    clean; the NaN drill's error, step and time the same on every rank.
    Returns the launches summed over the ranks (68a fp32, 68b xla)."""
    for r, res in enumerate(results):
        got, what = res["68"], f"phase 68a (multicity region=8, fleet classes) rank {r}"
        if (got["path"], twin["path"]) != ("fleet_superstep", "fleet_superstep"):
            fail(f"{what}: trained {got['path']}, the twin {twin['path']}; expected "
                 "fleet_superstep on both")
        text = check_mesh_run(got, twin, what)
        check_mesh_launches(got, what, {64 * (n // 8) * 3 for n in got["rungs"]})
        g = got["comm"]["what"].get("all-reduce/region/grads", {"calls": 0})
        if g["calls"] != got["steps"] or got["manifest"]:
            fail(f"{what}: {g['calls']} gradient all-reduces over {got['steps']} steps; "
                 f"manifest {got['manifest']}")
        print(f"{what}: rungs {got['rungs']} (the twin's {twin['rungs']}), node pads "
              f"{got['node_pads']}; {text}; B1 {got['counts']['B1']} launches of {got['rows']} "
              f"rows, B2 {got['counts']['B2']}; manifest clean; step p50 {got['p50_ms']:.2f} ms "
              f"(twin {twin['p50_ms']:.2f} ms; {card})")
    print(f"phase 68a lint, executed half: {spmd_text([res['68'] for res in results])}")
    for kind in ("checks", "debug_nans"):
        drill = [res["68b"][kind] for res in results]
        seen = {(d["raised"], d["step"]) for d in drill}
        spread = max(d["at"] for d in drill) - min(d["at"] for d in drill)
        holds = [r for r, d in enumerate(drill) if d["holds"]]
        if len(seen) != 1 or drill[0]["raised"] is None or spread > DRILL_SPREAD_S or len(
                holds) != 1:
            fail(f"phase 68b ({kind}): the ranks raised {seen}, {spread:.1f} s apart (at most "
                 f"{DRILL_SPREAD_S} s); node {DRILL_NODE} on ranks {holds}")
        print(f"phase 68b ({kind}, a NaN in node {DRILL_NODE}'s series, rank "
              f"{holds[0]}'s rows alone): every rank raised at global step "
              f"{drill[0]['step']} within {spread:.2f} s: {drill[0]['raised']} (build "
              f"{max(d['build_s'] for d in drill):.1f} s, train "
              f"{max(d['train_s'] for d in drill):.1f} s)")
    return {"fp32": {k: sum(res["68"]["counts"][k] for res in results) for k in ("B1", "B2")},
            "xla": {k: sum(res["68b"][kind]["counts"][k] for res in results
                           for kind in ("checks", "debug_nans")) for k in ("B1 xla", "B2 xla")}}


def region_files(device, results, twin_trainer) -> None:
    """Phase 63: the lead's ``best.ckpt`` of phase 62, in the JAX loop
    layout, served by ``Forecaster.from_checkpoint`` on one device (dense
    supports at the true N) equals what the mesh evaluated from it."""
    from stmgcn_tpu_torch import Forecaster
    from stmgcn_tpu_torch.train.checkpoint import load_checkpoint

    path = results[0]["63"]["best"]
    params = load_checkpoint(path, load_opt_state=False)[1]["params"]
    layout = sorted(k for k in params if k.startswith("branch"))
    if layout != ["branch_0", "branch_1", "branch_2"]:
        fail(f"phase 63: the lead's best.ckpt holds {layout}, not the loop layout")
    fc = Forecaster.from_checkpoint(path, device=device)
    ds = twin_trainer.dataset
    windows = ds.denormalize(ds.arrays("test")[0])[:MESH_SERVE_ROWS]
    served = fc.predict(twin_trainer.supports.cpu().numpy(), windows)
    evaluated = results[0]["63"]["evaluated"]
    err = float(np.max(np.abs(served - evaluated)))
    if served.shape != evaluated.shape or not np.allclose(served, evaluated, rtol=SERVE_RTOL,
                                                          atol=SERVE_ATOL):
        fail(f"phase 63: Forecaster.from_checkpoint of the mesh's best.ckpt vs the mesh's "
             f"evaluation of it: shapes {served.shape} / {evaluated.shape}, max |err| {err:.3e}")
    print(f"phase 63: the lead's best.ckpt ({layout}) served on one device at N = "
          f"{served.shape[1]} equals the region mesh's evaluation of it, {MESH_SERVE_ROWS} test "
          f"windows, max |err| {err:.3e} (rtol {SERVE_RTOL}, atol {SERVE_ATOL}, raw units)")


def region_cli() -> None:
    """Phase 63, end: ``python -m stmgcn_tpu_torch.cli --preset scaled
    --distributed --region-strategy auto`` in eight processes launched as
    torchrun would (one card, so gloo): one JSON line, from the lead."""
    out = scratch("region-cli")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    logs = launch_ranks([sys.executable, "-m", "stmgcn_tpu_torch.cli", "--preset", "scaled",
                         "--distributed", "--region-strategy", "auto", "--epochs", "1",
                         "--timesteps", str(REGION_CLI_TIMESTEPS),
                         "--out-dir", os.path.join(out, "run")], 8, out, MESH_TIMEOUT)
    lines = [line for log in logs for line in log.splitlines() if line.startswith('{"preset"')]
    if len(lines) != 1 or json.loads(lines[0])["preset"] != "scaled":
        fail(f"phase 63: the CLI job printed {len(lines)} JSON lines, expected one")
    print(f"phase 63: the CLI on 8 ranks (--distributed --region-strategy auto, series cut to "
          f"{REGION_CLI_TIMESTEPS} steps) printed one JSON line in "
          f"{time.perf_counter() - t0:.1f} s: test mse "
          f"{json.loads(lines[0])['results']['test']['mse']:.6g}")


# -- the block-CSR strips, region x branch and the sharded tiled plan (64-66) ---------

#: phase 64 (``scaled`` with ``model.sparse``, region=8, fp32, one epoch as
#: the region phases'): each rank's B3 per forward (the gate's shared-signal
#: launch and the graph conv's) and B4 per step; the signal width of the
#: strip probe
STRIP_PER_FORWARD = {"B1": 1, "B3": 2, "B3 shared": 1}
STRIP_PER_STEP = {"B2": 1, "B4": 1}
STRIP_PROBE_F = 64
#: phase 65: ``bandedbranch`` (dp=2 x region=2 x branch=2) on each route,
#: one epoch (22 steps at batch 16); per-step losses within BRANCH_LOSS_RTOL
#: of the one-device twin's; B1's rows a launch per rank (M/branch 1 x B/dp
#: 8 x N/region 32)
BRANCH_ROUTES = ("synthetic", "banded", "sparse")
BRANCH_LOSS_RTOL, BRANCH_ROWS = 1e-6, {1 * 8 * 32}
#: phase 66: the metro plan's branch 0 split over the largest region of
#: TILED_REGIONS its block bandwidth fits, checked against one device at
#: TILED_ATOL of the largest output (and input gradient) value; the
#: signal width (batch 2 x 64 hidden, the metro graph conv's)
TILED_REGIONS, TILED_ATOL, TILED_F = (8, 4, 2), 1e-5, 128


def strip_config(out: str):
    """Phase 64's config: ``scaled`` (region=8) at fp32 with block-CSR
    supports, one epoch as the region phases'."""
    cfg = scaled_config(out, "float32")
    cfg.model.sparse = True
    return cfg


def branch_config(route: str, out: str):
    """Phase 65's config of ``route``: ``bandedbranch`` at its width, fp32,
    one epoch; block-CSR supports on the sparse route."""
    cfg = mesh_config("bandedbranch", out, epochs=REGION_EPOCHS)
    cfg.model.sparse = route == "sparse"
    return cfg


def branch_data(route: str, cfg):
    """The route's data: the preset's synthetic graphs, or banded city
    adjacencies (``banded_dataset``, the JAX ``composed_trainer``'s)."""
    from stmgcn_tpu_torch.parallel import banded_dataset

    return None if route == "synthetic" else banded_dataset(cfg)


def stacked_bytes(cfg, numel: int, n_nodes: int, route: str, halo: int = 0,
                  transport: str = "gloo") -> dict:
    """The collectives one fp32 training step moves per rank on a region
    mesh whose branches are one stacked operand (phases 64-65): dense row
    strips or block-CSR strips (``route`` "dense"/"sparse": forward the
    gate's shared T-step signal and the graph conv's per-branch H states
    each one node-row all-gather, backward the graph conv's whole float32
    cotangent one all-reduce, a reduce-scatter over NCCL) or
    branch-stacked banded strips ("banded":
    each local branch's halo permutes, as ``region_bytes``); the gate's
    float64 pooling both ways; with a branch axis the fusion (a forward);
    the float64 gradient bucket and the 4-byte loss over ``region``, then
    ``dp``."""
    mesh = cfg.mesh
    b, t = cfg.train.batch_size // mesh.dp, cfg.data.seq_len
    h, m = cfg.model.lstm_hidden_dim, cfg.model.m_graphs // mesh.branch
    want = {
        "all-reduce/region/node-pool": {"calls": 1, "bytes": 8 * m * b * t},
        "all-reduce/region/node-pool-grad": {"calls": 1, "bytes": 8 * m * b * t},
    }
    for axis in ("region", "dp"):
        if getattr(mesh, axis) > 1:
            want[f"all-reduce/{axis}/grads"] = {"calls": 1, "bytes": 8 * numel}
            want[f"all-reduce/{axis}/loss"] = {"calls": 1, "bytes": 4}
    if mesh.branch > 1:
        n_local = n_nodes // mesh.region
        want["all-reduce/branch/fusion"] = {
            "calls": 1, "bytes": 4 * b * n_local * cfg.model.gcn_hidden_dim}
    if route == "banded":
        want["collective-permute/region/halo"] = {"calls": 4 * m,
                                                  "bytes": m * 2 * 4 * halo * b * (t + h)}
        want["collective-permute/region/halo-grad"] = {"calls": 2 * m,
                                                       "bytes": m * 2 * 4 * halo * b * h}
    else:
        want["all-gather/region/node-rows"] = {"calls": 2,
                                               "bytes": 4 * b * n_nodes * (t + m * h)}
        want.update(cotangent_bytes(1, 4 * m * b * n_nodes * h, mesh.region, transport))
    return want


def strip_info(strip) -> list:
    """Per branch of a rank's block-CSR strip: the widest row's real
    blocks (C), the transpose's (C_t), the real blocks stored and their
    share of the strip's dense block grid."""
    nblk, nblk_t = strip.nblk.cpu().numpy(), strip.nblk_t.cpu().numpy()
    k, r = nblk.shape[-2:]
    cols = nblk_t.shape[-1]
    out = []
    for m in range(nblk.shape[0]):
        blocks = int(nblk[m].sum())
        out.append({"C": int(nblk[m].max()), "C_t": int(nblk_t[m].max()), "blocks": blocks,
                    "density": blocks / (k * r * cols)})
    return out


def probe_signal(n_real: int, n_nodes: int, device):
    """Phase 64's strip probe: a seeded ``(n_nodes, STRIP_PROBE_F)`` signal,
    zero on the padded node rows."""
    import torch

    x = torch.randn(n_nodes, STRIP_PROBE_F, generator=torch.Generator().manual_seed(64))
    x[n_real:] = 0.0
    return x.to(device)


def strip_rank(args, device) -> dict:
    """Phase 64 in one rank: ``strip_config`` trained on the region=8 mesh
    (``mesh_train``), its routing and each branch's strip, and one conv's
    strip output on the probe signal (B3 over the rank's strip against the
    whole signal, outside the counted run)."""
    from stmgcn_tpu_torch.ops.spmm import stack_forward

    t0 = time.perf_counter()
    cfg = strip_config(os.path.join(args["root"], "sparse"))
    cfg.mesh.region = args.get("region", cfg.mesh.region)
    got = mesh_train(cfg, device, **scaled_city(cfg.mesh.region))
    trainer = got.pop("trainer")
    got["route"] = route_info(trainer)
    strip = trainer.supports
    got["strips"] = strip_info(strip)
    got["stored"] = (int(strip.data.shape[-3]), int(strip.data_t.shape[-3]))
    got["strip_type"] = type(strip).__name__
    x = probe_signal(trainer.dataset.n_nodes, strip.n, device)
    got["probe"] = stack_forward(strip.stack(), x).cpu()
    got["coords"] = trainer.mesh.coords
    got["job_s"] = time.perf_counter() - t0
    del trainer
    release()
    return got


def branch_rank(route: str, args, device) -> dict:
    """Phase 65 in one rank: ``branch_config(route)`` on its 2x2x2 mesh,
    trained; its branch modes and routed form."""
    t0 = time.perf_counter()
    cfg = branch_config(route, os.path.join(args["root"], f"branch-{route}"))
    got = mesh_train(cfg, device, dataset=branch_data(route, cfg))
    trainer = got.pop("trainer")
    sup = trainer.supports
    got.update(modes=trainer.model.branch_modes(), form=type(sup).__name__,
               branch_stacked=getattr(sup, "branch_stacked", None),
               halo=getattr(sup, "halo", 0), layout=trainer.layout,
               n_nodes=trainer.dataset.n_nodes + trainer._node_pads[0],
               job_s=time.perf_counter() - t0)
    del trainer
    release()
    return got


def tiled_shards(plan, plan_dev, device) -> dict:
    """Phase 66, the parent's half, while the metro city is on hand: branch
    0 of the metro plan split over the largest region of TILED_REGIONS
    its block bandwidth fits (``shard_tiled_plan``), each shard written to
    a scratch file with its rows of a seeded signal and cotangent and of
    the one-device B3 output and B4 input gradient on the same plan (the
    reference; these launches are not counted)."""
    import torch

    from stmgcn_tpu_torch.ops.spmm import spmm_stack_bwd, stack_forward
    from stmgcn_tpu_torch.ops.tiling import shard_tiled_plan

    t0 = time.perf_counter()
    refused = []
    for region in TILED_REGIONS:
        try:
            sharded = shard_tiled_plan(plan[0], region)
            break
        except ValueError as e:
            refused.append(f"region={region}: {e}")
    else:
        fail(f"phase 66: the metro plan fits no region of {TILED_REGIONS}: {refused}")
    gen = torch.Generator().manual_seed(66)
    n, k = plan.n, plan.n_supports
    n_pad = sharded.n_shards * sharded.block_rows_local * sharded.tile
    x = torch.zeros(n_pad, TILED_F)
    x[:n] = torch.randn(n, TILED_F, generator=gen)
    cot = torch.zeros(k, n_pad, TILED_F)
    cot[:, :n] = torch.randn(k, n, TILED_F, generator=gen)
    stack = plan_dev[0].as_stack()
    want = stack_forward(stack, x[:n].to(device)).cpu()
    want_dx = spmm_stack_bwd(stack, cot[:, :n].contiguous().to(device), shared=True).cpu()
    reset_counts()
    out = scratch("tiled-shards")
    os.makedirs(out, exist_ok=True)
    rows = sharded.block_rows_local * sharded.tile
    for j in range(sharded.n_shards):
        lo, hi = j * rows, min((j + 1) * rows, n)
        torch.save({"shard": sharded.shard(j), "x": x[j * rows:(j + 1) * rows].clone(),
                    "cot": cot[:, j * rows:(j + 1) * rows].clone(), "rows": (lo, hi),
                    "want": want[:, lo:hi].clone(), "want_dx": want_dx[lo:hi].clone()},
                   os.path.join(out, f"shard{j}.pt"))
    info = {"dir": out, "region": sharded.n_shards, "halo": sharded.halo,
            "halo_t": sharded.halo_t, "r_loc": sharded.block_rows_local, "refused": refused,
            "scale": float(want.abs().max()), "scale_dx": float(want_dx.abs().max()),
            "seconds": time.perf_counter() - t0}
    print(f"phase 66 (parent): the metro plan's branch 0 (R={plan.block_rows} block rows of "
          f"{plan.tile}) split over region={info['region']}: halo {info['halo']}, halo_t "
          f"{info['halo_t']} block rows, r_loc {info['r_loc']}"
          + (f" (refused: {'; '.join(refused)})" if refused else "")
          + f"; shards, signal and one-device B3/B4 reference written in {info['seconds']:.1f} s")
    return info


def tiled_rank(info: dict, device) -> dict:
    """Phase 66 in one rank: its shard of the metro plan on the card, the
    sharded apply forward (B3) and its input gradient (B4) against the
    one-device reference rows."""
    import torch

    from stmgcn_tpu_torch.config import MeshConfig
    from stmgcn_tpu_torch.ops.tiling import sharded_gathered_tiles_apply
    from stmgcn_tpu_torch.parallel import mesh_from_config

    t0 = time.perf_counter()
    region = info["region"]
    mesh = mesh_from_config(MeshConfig(dp=8 // region, region=region), device=device)
    j = mesh.coords["region"]
    part = torch.load(os.path.join(info["dir"], f"shard{j}.pt"), weights_only=False)
    shard = part["shard"].to(device)
    x = part["x"].to(device).requires_grad_()
    reset_counts()
    out = sharded_gathered_tiles_apply(shard, x, mesh)
    (out * part["cot"].to(device)).sum().backward()
    counts = read_counts()
    lo, hi = part["rows"]
    err = float((out.detach().cpu()[:, :hi - lo] - part["want"]).abs().max())
    err_dx = float((x.grad.cpu()[:hi - lo] - part["want_dx"]).abs().max())
    del shard
    release()
    return {"err": err, "err_dx": err_dx, "counts": counts, "coords": mesh.coords,
            "rows": (lo, hi), "job_s": time.perf_counter() - t0}


def strip_twin(device) -> dict:
    """Phase 64's twin: the one-device block-CSR trainer at N = 2,500 (per
    branch stacks, graphed), its stacks kept for the strip probe."""
    got = mesh_twin("scaled", device, cfg=strip_config(scratch("twin-sparse")))
    trainer = got.pop("trainer")
    got["n_real"] = trainer.dataset.n_nodes
    got["stacks"] = trainer.supports
    return got


def branch_twins(device) -> dict:
    """Phase 65's twins: each route's config on one device (graphed) on the
    same data, the same seed."""
    twins = {}
    for route in BRANCH_ROUTES:
        cfg = branch_config(route, scratch(f"twin-branch-{route}"))
        twins[route] = mesh_twin("bandedbranch", device, cfg=cfg, dataset=branch_data(route, cfg))
        twins[route].pop("trainer")
    return twins


def check_step_bytes(got: dict, want: dict, what: str) -> None:
    """A rank's one-step collectives equal ``want``; the run's gradient
    sums one a step; the manifest clean."""
    step = got["step_comm"]["what"]
    if step != want:
        fail(f"{what}: one step moved {step}, the analytic counts are {want}")
    g = got["comm"]["what"].get("all-reduce/region/grads", {"calls": 0, "bytes": 0})
    if g["calls"] != got["steps"] or g["bytes"] != got["steps"] * 8 * got["numel"]:
        fail(f"{what}: the gradient all-reduce ran {g['calls']} times, {g['bytes']} bytes over "
             f"{got['steps']} steps; expected one of {8 * got['numel']} bytes a step")
    if got["manifest"]:
        fail(f"{what}: the step broke its collective manifest: {got['manifest']}")


def check_block_counts(got: dict, what: str, rows: set, sparse: bool) -> None:
    """B1 one per forward (of ``rows`` rows) and B2 one per step; on a
    block-CSR route B3 two per forward (one on the gate's shared signal)
    and B4 one per step, none elsewhere; B5 never."""
    per_forward = dict(STRIP_PER_FORWARD) if sparse else {"B1": 1}
    per_step = dict(STRIP_PER_STEP) if sparse else {"B2": 1}
    counts = {k: v for k, v in got["counts"].items() if k not in ("B1 xla", "B2 xla")}
    check_counts(counts, per_forward, per_step, got["forwards"], got["steps"], what)
    if set(got["rows"]) != rows:
        fail(f"{what}: B1 took {got['rows']} rows a launch, expected {sorted(rows)}")


def sparse_phases(device, card: str, results, twins: dict, tiled: dict) -> dict:
    """Phases 64-66 checked: each rank's run against its twin (phase 62's
    rules for 64, BRANCH_LOSS_RTOL and phase 57's parameter rule for 65),
    launches, bytes against the analytic counts, the strip probe against
    the twin's rows, the sharded tiled plan against one device. Returns
    the launches summed over the ranks."""
    import torch

    from stmgcn_tpu_torch.ops.spmm import stack_forward

    t0 = time.perf_counter()
    sums = collections.Counter()
    # 64: the block-CSR strips at region=8
    twin = twins["64"]
    cfg = strip_config("")
    x = probe_signal(twin["n_real"], results[0]["64"]["route"]["n_nodes"], device)
    probe = torch.stack([stack_forward(st, x[:twin["n_real"]]) for st in twin["stacks"]]).cpu()
    bitwise, worst = 0, 0.0
    for r, res in enumerate(results):
        got, what = res["64"], f"phase 64 (scaled sparse region=8, fp32) rank {r}"
        route = got["route"]
        if route["modes"] != ("sparse",) * 3 or route["node_pad"] != REGION_PAD or (
                got["strip_type"] != "ShardedBlockSparse"):
            fail(f"{what}: routed {route['modes']} as {got['strip_type']} with "
                 f"{route['node_pad']} padded rows")
        check_block_counts(got, what, REGION_ROWS, sparse=True)
        check_step_bytes(got, stacked_bytes(cfg, got["numel"], route["n_nodes"], "sparse",
                                            transport=got["mesh"]["backend"]), what)
        text = check_mesh_run(got, twin, what)
        gaps = param_gaps(got, twin)
        n_local = route["n_nodes"] // cfg.mesh.region
        lo = got["coords"]["region"] * n_local
        hi = min(lo + n_local, twin["n_real"])
        mine, want = got["probe"][:, :, :hi - lo], probe[:, :, lo:hi]
        diff = float((mine - want).abs().max()) if hi > lo else 0.0
        same = bool(torch.equal(mine, want))
        bitwise += same
        worst = max(worst, diff)
        strips = "; ".join(f"branch {m}: C {s['C']}, C_t {s['C_t']}, {s['blocks']} blocks, "
                           f"density {s['density']:.4f}" for m, s in enumerate(got["strips"]))
        c = got["counts"]
        print(f"{what} at {got['mesh']['coords']}: {text}; B3 {c['B3']} ({c['B3 shared']} on "
              f"the gate's shared signal), B4 {c['B4']}, B1 {c['B1']}, B2 {c['B2']} for "
              f"{got['forwards']} forwards and {got['steps']} steps; strips (stored C "
              f"{got['stored'][0]}, C_t {got['stored'][1]}): {strips}; the strip probe against "
              f"the twin's rows {lo}-{hi}: bitwise {same}, max |diff| {diff:.3e}; bytes and "
              f"manifest as analytic; step p50 {got['p50_ms']:.2f} ms (twin "
              f"{twin['p50_ms']:.2f} ms; {card}); past phase 57's rule: {gaps_text(gaps)}; "
              f"rank job {got['job_s']:.1f} s (build {got['build_s']:.1f} s)")
        for k in ("B1", "B2", "B3", "B3 shared", "B4"):
            sums[k] += c[k]
    print(f"phase 64: one step moved {results[0]['64']['step_comm']['what']} (the analytic "
          f"counts); the strip probe equal bit for bit on {bitwise} of {len(results)} ranks, "
          f"max |diff| {worst:.3e}; twin (one device, graphed, per-branch stacks at N = 2,500) "
          f"step p50 {twin['p50_ms']:.2f} ms")
    print(f"phase 64 lint, executed half: {spmd_text([r['64'] for r in results])}")
    # 65: bandedbranch on each route
    for route in BRANCH_ROUTES:
        twin = twins["65"][route]
        cfg = branch_config(route, "")
        for r, res in enumerate(results):
            got, what = res["65"][route], f"phase 65 (bandedbranch 2x2x2, {route}) rank {r}"
            want_modes = {"synthetic": ("dense",) * 2, "banded": ("banded",) * 2,
                          "sparse": ("sparse",) * 2}[route]
            if got["modes"] != want_modes or got["layout"] != "vmapped" or (
                    got["branch_stacked"] != (None if route == "synthetic" else True)):
                fail(f"{what}: branch_modes {got['modes']}, {got['form']} (branch_stacked "
                     f"{got['branch_stacked']}), layout {got['layout']}")
            check_block_counts(got, what, BRANCH_ROWS, sparse=route == "sparse")
            plan = "dense" if route == "synthetic" else route
            check_step_bytes(got, stacked_bytes(cfg, got["numel"], got["n_nodes"], plan,
                                                got["halo"], got["mesh"]["backend"]), what)
            text = check_mesh_run(got, twin, what, loss_rtol=BRANCH_LOSS_RTOL)
            c = got["counts"]
            for k in ("B1", "B2", "B3", "B3 shared", "B4"):
                sums[k] += c[k]
            if r in (0, len(results) - 1):
                print(f"{what} at {got['mesh']['coords']}: branch_modes {got['modes']}, routed "
                      f"{got['form']} (branch_stacked {got['branch_stacked']}"
                      + (f", halo {got['halo']}" if got["halo"] else "") + f"); {text}; "
                      f"launches {counts_text(c)}; bytes and manifest as analytic; step p50 "
                      f"{got['p50_ms']:.2f} ms (twin {twin['p50_ms']:.2f} ms; {card}); rank job "
                      f"{got['job_s']:.1f} s")
        print(f"phase 65 ({route}): one step moved {results[0]['65'][route]['step_comm']['what']}"
              f"; lint, executed half: {spmd_text([r['65'][route] for r in results])}")
    # 66: the sharded tiled plan
    for r, res in enumerate(results):
        got, what = res["66"], f"phase 66 (metro plan, region={tiled['region']}) rank {r}"
        c = got["counts"]
        if (c["B3"], c["B4"]) != (1, 1) or any(c[k] for k in ("B1", "B2", "B5")):
            fail(f"{what}: launches {counts_text(c)}, expected B3 1 and B4 1")
        if got["err"] > TILED_ATOL * tiled["scale"] or got["err_dx"] > TILED_ATOL * tiled[
                "scale_dx"]:
            fail(f"{what}: output max |err| {got['err']:.3e}, input gradient {got['err_dx']:.3e} "
                 f"against the one-device B3/B4 (limit {TILED_ATOL} of {tiled['scale']:.3e}, "
                 f"{tiled['scale_dx']:.3e})")
        sums["B3"] += c["B3"]
        sums["B4"] += c["B4"]
        if r in (0, len(results) - 1):
            print(f"{what} at {got['coords']}, rows {got['rows']}: B3 {c['B3']}, B4 {c['B4']}; "
                  f"output max |err| {got['err']:.3e} (of max {tiled['scale']:.3e}), input "
                  f"gradient {got['err_dx']:.3e} (of max {tiled['scale_dx']:.3e}) against one "
                  f"device (limit {TILED_ATOL} of each); rank job {got['job_s']:.1f} s")
    print(f"phase 66: halo {tiled['halo']}, halo_t {tiled['halo_t']}, r_loc {tiled['r_loc']} "
          f"block rows at region={tiled['region']}; every rank within {TILED_ATOL} of the "
          f"largest value; checks {time.perf_counter() - t0:.1f} s")
    return dict(sums)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--mesh-rank":
        return mesh_rank(sys.argv[2], sys.argv[3])
    try:
        return run_phases()
    finally:
        for root in _SCRATCH:
            shutil.rmtree(root, ignore_errors=True)


def run_phases() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the GPU "
              "and has no CPU mode", file=sys.stderr)
        return 1
    from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm_bwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_start = time.perf_counter()

    tensor_core_rate(build_kernels())

    records = [check_lstm_kernel(device)]
    torch.cuda.empty_cache()
    records.append(check_lstm_bwd_kernel(device))
    torch.cuda.empty_cache()
    records[0]["route_shapes"], records[1]["route_shapes"] = check_lstm_shapes(device)
    bf16_records = check_lstm_kernels_bf16(device)
    check_lstm_route_bf16(device)
    torch.cuda.empty_cache()
    xla_records = check_lstm_kernels_xla(device)  # phase 41
    torch.cuda.empty_cache()

    reset_counts()
    snapshot, forwards, launches = serve(device)
    if launches == 0:
        fail("the serving path never launched the LSTM kernel")
    if launches != forwards:
        fail(f"{launches} LSTM kernel launches for {forwards} model forwards "
             "(expected one launch, all branches, per forward)")
    if fused_lstm_bwd.launches:
        fail(f"serving launched the backward kernel {fused_lstm_bwd.launches} times")
    print(f"LSTM kernel launches on the serving path: {launches} "
          f"(one per model forward; {forwards} forwards; no backward launches)")
    for b, s in snapshot["buckets"].items():
        print(f"bucket {b}: {s['dispatches']} dispatches, p50 latency "
              f"{s['latency_ms']['p50']} ms, p50 dispatch {s['device_ms']['p50']} ms")
    torch.cuda.empty_cache()

    trainer, counts = train_on_card(device)
    if counts["B1"] == 0 or counts["B2"] == 0:
        fail("the training path did not launch both LSTM kernels")
    step_times(trainer, "training step")
    card_vs_cpu(device)
    trace_training(trainer, LSTM_PARTS, "dense training")
    del trainer
    torch.cuda.empty_cache()
    print(f"dense phases done at {time.perf_counter() - t_start:.1f} s")

    # the main path of the checkpoint slice: train writing checkpoints,
    # resume, test() and serving from the files, a hot swap; counted from
    # the reset in its first train_and_test to the read below
    trained = checkpoints(device, scratch("checkpoints"))
    serve_checkpoint(device, trained)
    counts = read_counts()
    if counts["B1"] == 0 or counts["B2"] == 0:
        fail("the checkpoint path did not launch both LSTM kernels")
    if any(counts[k] for k in ("B3", "B4", "B5")):
        fail(f"the dense checkpoint path launched block-CSR kernels: {counts_text(counts)}")
    records[0]["launches"], records[1]["launches"] = counts["B1"], counts["B2"]
    print(f"checkpoint path (train, resume, test, serve, swap): launches {counts_text(counts)}")
    del trained
    torch.cuda.empty_cache()
    cli_runs(scratch("cli"))
    print(f"checkpoint phases done at {time.perf_counter() - t_start:.1f} s")

    # the bf16 slice's dense paths: mixed-precision training (its counts are
    # the bf16 B1/B2 records'), bf16 serving, bf16 checkpoints
    counts = bf16_training(device)
    bf16_records[0]["launches"], bf16_records[1]["launches"] = counts["B1"], counts["B2"]
    bf16_serve_dense(device)
    bf16_checkpoints(device, scratch("bf16_checkpoints"))
    torch.cuda.empty_cache()
    print(f"bf16 dense phases done at {time.perf_counter() - t_start:.1f} s")

    # the captured programs: graphed against eager at the dense flagship
    dense_ab(device)
    print(f"dense graphed/eager phases done at {time.perf_counter() - t_start:.1f} s")

    # the fleet slice: heterogeneous cities in shape classes, dense and tiled
    fleet_counts = fleet_phases(device)
    print(f"fleet phases done at {time.perf_counter() - t_start:.1f} s")
    fleet16_counts = fleet_bf16(device)  # phase 55
    release()
    print(f"bf16 fleet phase done at {time.perf_counter() - t_start:.1f} s")

    # this slice: training health, the divergence guard, fault plans,
    # SIGTERM, serving drift and fault drills (dense and fleet; bf16 health)
    res_fp32, res_bf16 = resilience_phases(device)
    print(f"resilience phases done at {time.perf_counter() - t_start:.1f} s")

    # this slice's main path: the default preset's bf16 model in the JAX
    # default LSTM form, served and trained (phase 42; the xla records' counts)
    counts = xla_default(device)
    xla_records[0]["launches"], xla_records[1]["launches"] = counts["B1 xla"], counts["B2 xla"]
    if not all(r["launches"] for r in xla_records):
        fail("the xla form was not launched on its main path: " + counts_text(counts))
    print(f"xla form phase done at {time.perf_counter() - t_start:.1f} s")

    ds, dense, plan = metro_host(device)
    dense_dev, plan_dev = torch.as_tensor(dense, device=device), plan.to(device)
    records += check_spmm_kernels(device, dense, dense_dev, plan)
    torch.cuda.empty_cache()
    metro_serve(device, ds, dense_dev, plan_dev)
    counts = metro_train(device, ds, dense_dev, plan_dev)
    if counts["B3"] == 0 or counts["B4"] == 0:
        fail("the tiled training path did not launch B3 and B4")
    # B3's launches on the shared signal are the gate conv's, the rest the graph conv's
    records[2]["launches"] = counts["B3"] - counts["B3 shared"]
    records[3]["launches"], records[5]["launches"] = counts["B4"], counts["B3 shared"]
    torch.cuda.empty_cache()
    records[4]["launches"], ktuples = metro_sparse(device, ds, dense, dense_dev, plan_dev)
    if records[4]["launches"] == 0:
        fail("the K-tuple route never launched B5")

    # the bf16 slice's metro paths: B3/B4/B5's bf16 forms, bf16 tiled
    # serving and training (the bf16 B3/B4 records' counts), bf16 K-tuples (B5)
    bf16_records += check_spmm_kernels_bf16(device, dense, dense_dev, plan)
    torch.cuda.empty_cache()
    counts = bf16_metro(device, ds, plan_dev, dense_dev)
    bf16_records[2]["launches"] = counts["B3"] - counts["B3 shared"]
    bf16_records[3]["launches"], bf16_records[5]["launches"] = counts["B4"], counts["B3 shared"]
    torch.cuda.empty_cache()
    bf16_records[4]["launches"] = bf16_sparse(device, ds, dense_dev, ktuples)
    metro_ab(device, ds, plan_dev)
    res_metro = metro_resilience(device, ds, plan_dev)
    if not res_metro["B3"] or not res_metro["B4"]:
        fail(f"the tiled health and guard path did not launch B3 and B4: "
             f"{counts_text(res_metro)}")
    print(f"metro phases done at {time.perf_counter() - t_start:.1f} s")
    metro_repeatability(device, ds, plan_dev)  # phase 43
    print(f"repeatability phase done at {time.perf_counter() - t_start:.1f} s")
    checks_phase(device, ds, plan_dev)  # phase 44
    print(f"sanitizer phase done at {time.perf_counter() - t_start:.1f} s")
    metro_place = placement_metro(device, ds, plan_dev)  # phase 53
    placement_auto(device, ds, plan_dev)  # phase 54
    print(f"metro placement phases done at {time.perf_counter() - t_start:.1f} s")
    tiled = tiled_shards(plan, plan_dev, device)  # phase 66's shards and reference
    del ds, dense, dense_dev, plan, plan_dev, ktuples
    torch.cuda.empty_cache()
    tracing_phase(device)  # phase 45
    print(f"tracing phase done at {time.perf_counter() - t_start:.1f} s")
    # this slice's main paths: the ring, the closed loop, the federation
    ring_phase(device)  # phase 46
    loop_counts = closed_loop_phase(device)  # phase 47
    fed_counts = federation_phase(device)  # phase 48
    print(f"closed-loop and federation phases done at {time.perf_counter() - t_start:.1f} s")
    # this slice's main path: the exported artifact on the card (its B1
    # launches are the export_launches of the B1 records), then serve-bench
    # and the profile in subprocesses, and the dense step's MFU
    export_counts = export_phase(device)  # phase 49
    records[0]["export_launches"] = export_counts["fp32"]
    xla_records[0]["export_launches"] = export_counts["xla"]
    bf16_records[0]["export_launches"] = 0  # an artifact runs the xla form, never this one
    if not export_counts["fp32"] or not export_counts["xla"]:
        fail(f"the exported programs did not launch B1: {export_counts}")
    torch.cuda.empty_cache()
    serve_bench_phase()  # phase 50
    profile_phase(scratch("profile"))  # phase 51
    print(f"export, serve-bench and profile phases done at {time.perf_counter() - t_start:.1f} s")
    # this slice's main path: training of the default preset over each data
    # placement at the dense city (52; the metro plan's, 53, ran above), then
    # the lint and the kernels' launch budgets
    dense_place = placement_dense(device)  # phase 52
    lint_and_budgets()  # phase 56
    print(f"placement and lint phases done at {time.perf_counter() - t_start:.1f} s")
    # this slice's main path: multicity at dp=8 and branchpar at dp=2 x branch=3
    # (fp32, then bf16), in rank processes sharing the card over gloo, and
    # the mesh's files and CLI (phases 57-60)
    mesh = mesh_phases(device, card)
    print(f"mesh phases done at {time.perf_counter() - t_start:.1f} s")
    # this slice's main path: scaled on its region=8 mesh, bf16 then fp32,
    # in rank processes sharing the card over gloo, and its files and CLI
    # (phases 61-63)
    # and (phases 64-66) scaled with block-CSR strips, bandedbranch's routes on
    # its region x branch mesh and the metro plan's shards, in the same job
    region = region_phases(device, card, tiled)
    print(f"region phases done at {time.perf_counter() - t_start:.1f} s")
    # the placement paths' launches: the dense city's fp32 runs and the metro
    # plan's (B3's gate-conv launches are the shared signal's); the xla form's
    # from the dense city's bf16 runs, and the bf16 fleet's
    for rec, k in zip(records, ("B1", "B2", "B3", "B4", "B5", "B3 shared")):
        rec["placement_launches"] = (dense_place["fp32"].get(k, 0) + metro_place[k]
                                     - (metro_place["B3 shared"] if k == "B3" else 0))
    for rec, k in zip(xla_records, ("B1 xla", "B2 xla")):
        rec["placement_launches"] = dense_place["bf16"][k]
        rec["fleet_bf16_launches"] = fleet16_counts[k]
    if not all(records[i]["placement_launches"] for i in (0, 1, 2, 3, 5)) or not all(
            r["placement_launches"] and r["fleet_bf16_launches"] for r in xla_records):
        fail("a kernel of the placement or bf16 fleet paths was not launched: "
             + ", ".join(f"{r['name']} {r.get('placement_launches')}"
                         for r in records + xla_records))
    if any(not r["launches"] for r in bf16_records):
        fail("a bf16 kernel form was not launched on its main path: " + ", ".join(
            f"{r['name']} {r['launches']}" for r in bf16_records))
    # the fp32 records' launches on the fleet paths (phases 26-29)
    fleet_counts["B3"] -= fleet_counts["B3 shared"]
    res_metro["B3"] -= res_metro["B3 shared"]
    for rec, k in zip(records, ("B1", "B2", "B3", "B4", "B5", "B3 shared")):
        rec["fleet_launches"] = fleet_counts[k]
        # this slice's paths: dense and fleet health/guard/drift, the metro plan's
        rec["resilience_launches"] = res_fp32[k] + res_metro[k]
        rec["continual_launches"], rec["federation_launches"] = loop_counts[k], fed_counts[k]
    for rec, k in zip(bf16_records, ("B1", "B2", "B3", "B4", "B5", "B3 shared")):
        rec["resilience_launches"] = res_bf16[k] - (res_bf16["B3 shared"] if k == "B3" else 0)
    # the mesh phases' launches, summed over the ranks: fp32 (57-58), xla (59)
    for rec in records + bf16_records + xla_records:
        rec["mesh_launches"] = 0
    records[0]["mesh_launches"], records[1]["mesh_launches"] = (mesh["fp32"]["B1"],
                                                                mesh["fp32"]["B2"])
    xla_records[0]["mesh_launches"], xla_records[1]["mesh_launches"] = (
        mesh["xla"]["B1 xla"], mesh["xla"]["B2 xla"])
    # the region phases' launches, summed over the ranks: fp32 (62), xla (61)
    for rec in records + bf16_records + xla_records:
        rec["region_launches"] = 0
    records[0]["region_launches"], records[1]["region_launches"] = (region["fp32"]["B1"],
                                                                    region["fp32"]["B2"])
    xla_records[0]["region_launches"], xla_records[1]["region_launches"] = (
        region["xla"]["B1 xla"], region["xla"]["B2 xla"])
    # the block-CSR strips, region x branch and sharded tiled phases' launches
    # (64-66, fp32), summed over the ranks: B3's gate-conv launches are the
    # shared signal's (phase 66's tiled launches go to the graph conv's record)
    sp = region["sparse"]
    for rec in records + bf16_records + xla_records:
        rec["sparse_mesh_launches"] = 0
    for rec, k in zip(records, ("B1", "B2", "B3", "B4")):
        rec["sparse_mesh_launches"] = sp[k] - (sp["B3 shared"] if k == "B3" else 0)
    records[5]["sparse_mesh_launches"] = sp["B3 shared"]
    if not all(records[i]["sparse_mesh_launches"] for i in (0, 1, 2, 3, 5)):
        fail("a kernel of the sparse mesh phases was not launched: " + ", ".join(
            f"{r['name']} {r['sparse_mesh_launches']}" for r in records))
    print(f"all phases done at {time.perf_counter() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": records + bf16_records + xla_records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
