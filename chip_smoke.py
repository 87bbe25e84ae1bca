#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``stmgcn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code on failure:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build every CUDA kernel of the serving path from ``stmgcn_tpu_torch/csrc``
   with ``nvcc`` (into ``build/kernels/``);
3. hold each kernel against its plain PyTorch version on the card at the
   serving path's shape (the 64-request rung of the flagship at a 16x16
   grid: M=3 branches x 64 x 256 nodes = 49,152 rows, a 12-step window,
   L=3, H=64), with residuals on and off, on a ragged row count, and at
   every hidden width and layer count the kernel's wrapper accepts; then
   time kernel, plain version and the cuDNN ``nn.LSTM`` yardstick with
   CUDA events;
4. serve the ``default``-width ST-MGCN (seeded random weights, synthetic
   16x16 city) through ``Forecaster`` and ``ServingEngine``: requests of
   1, 3, 16, 64 and 100 rows and four concurrent callers, every response
   finite and equal to ``Forecaster.predict`` on the same rows, one
   bucket-4 batch equal to the same model on the CPU, and the kernel's
   launch counter showing the path went through it, once per forward;
5. trace the smallest and largest rung with ``torch.profiler``: device
   busy time, idle share and the LSTM kernel's share per dispatch.

The last three lines are the card, one JSON object describing each kernel,
and ``{"ok": true, "device": {...}}``. There is no CPU mode: without a CUDA
device the script exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
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
#: engine vs forecaster vs CPU, raw demand units (normalizer range ~1e2):
#: float32 GEMMs at different batch shapes and devices sum in other orders
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-3
#: H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside the
#: tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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

    # cuDNN nn.LSTM on the same rows and weights (TF32 off): one call per
    # branch, each computing that branch's projection and recurrence
    cudnn = []
    for m in range(M):
        lstm = torch.nn.LSTM(1, H, L, batch_first=True).to(device)
        with torch.no_grad():
            for layer in range(L):
                w_in = wx0[m] if layer == 0 else wx[m, layer - 1]
                getattr(lstm, f"weight_ih_l{layer}").copy_(w_in.T)
                getattr(lstm, f"weight_hh_l{layer}").copy_(wh[m, layer].T)
                getattr(lstm, f"bias_ih_l{layer}").copy_(b0[m] if layer == 0 else b[m, layer - 1])
                getattr(lstm, f"bias_hh_l{layer}").zero_()
        cudnn.append(lstm)
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
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, n_bytes / PEAK_BYTES_PER_S * 1e3
    print(f"fused_lstm times (ms, CUDA events, mean): kernel {ms:.4f}, kernel with "
          f"residuals {ms_res:.4f}, plain {plain_ms:.4f}, cuDNN x{M} {library_ms:.4f}; "
          f"bound {max(t_ops, t_bytes):.4f} ({flops / 1e9:.2f} GFLOP, "
          f"{n_bytes / 1e6:.1f} MB)")
    return {
        "name": "fused_lstm_fwd",
        "route": "cuda",
        "source": "stmgcn_tpu_torch/csrc/fused_lstm_fwd.cu",
        "replaces": "stmgcn_tpu/ops/pallas_lstm.py:172",
        "launches": None,  # filled from the main path's run
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def trace_rungs(engine, windows, rungs, iters: int = 10) -> None:
    """Phase 5: where one dispatch's time goes, per rung, from a
    ``torch.profiler`` trace of ``iters`` direct dispatches: wall time per
    dispatch (profiler on), device busy time (CUDA kernels and copies),
    the idle share, and the LSTM kernel's share of busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for b in rungs:
        for _ in range(3):
            engine.predict_direct(windows[:b])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                engine.predict_direct(windows[:b])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
        device = {
            e.key: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        }
        busy = sum(device.values())
        if busy == 0.0:
            print(f"trace, rung {b}: no device time recorded (not measured)")
            continue
        lstm = sum(v for k, v in device.items() if "lstm_fwd_kernel" in k)
        top = sorted(device.items(), key=lambda kv: -kv[1])[:4]
        print(f"trace, rung {b}: wall {wall:.4f} ms/dispatch (profiler on), device "
              f"busy {busy:.4f} ms, idle share {1 - busy / wall:.3f}, LSTM kernel "
              f"{lstm:.4f} ms = {lstm / busy:.3f} of busy; top: "
              + "; ".join(f"{k[:48]} {v:.4f}" for k, v in top))


def serve(device, grid: int = GRID):
    """Phases 4 and 5: the serving path end to end, then its trace.
    Returns the engine's stats snapshot, the number of model forwards run
    on ``device`` and the LSTM kernel launches they made (read before the
    trace); raises SystemExit on any failed check."""
    import torch

    from stmgcn_tpu_torch import Forecaster, ServingConfig, preset
    from stmgcn_tpu_torch.experiment import build_dataset, build_model, build_supports
    from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm

    cfg = preset("default")
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
        # model forwards on the card: rung warm-ups, engine dispatches,
        # forecaster calls
        forwards = len(BUCKETS) + snapshot["totals"]["dispatches"] + fc_calls
        launches = fused_lstm.launches
        if device.type == "cuda":
            trace_rungs(engine, windows, (BUCKETS[0], BUCKETS[-1]))
        return snapshot, forwards, launches
    finally:
        engine.close()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the GPU "
              "and has no CPU mode", file=sys.stderr)
        return 1
    from stmgcn_tpu_torch.ops.fused_lstm import fused_lstm, kernel_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _, info = kernel_library()
    print(f"built {info.path.name} in {info.seconds:.1f} s "
          f"(nvcc; {time.perf_counter() - t0:.1f} s with load)")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    record = check_lstm_kernel(device)
    torch.cuda.empty_cache()

    fused_lstm.launches = 0
    snapshot, forwards, launches = serve(device)
    if launches == 0:
        fail("the serving path never launched the LSTM kernel")
    if launches != forwards:
        fail(f"{launches} LSTM kernel launches for {forwards} model forwards "
             "(expected one launch, all branches, per forward)")
    record["launches"] = launches
    print(f"LSTM kernel launches on the serving path: {launches} "
          f"(one per model forward; {forwards} forwards)")
    for b, s in snapshot["buckets"].items():
        print(f"bucket {b}: {s['dispatches']} dispatches, p50 latency "
              f"{s['latency_ms']['p50']} ms, p50 dispatch {s['device_ms']['p50']} ms")

    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
