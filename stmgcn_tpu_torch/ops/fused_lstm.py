"""Fused multi-layer LSTM recurrence: the hand-written CUDA kernel and its
plain PyTorch version.

Counterpart of ``stmgcn_tpu/ops/pallas_lstm.py`` (``fused_lstm``, forward
kernel ``_fwd_kernel``). The kernel (``csrc/fused_lstm_fwd.cu``) runs the
whole ``T x L`` recurrence for a block of rows with h and c kept on chip;
layer 0's input projection is hoisted outside it as one large matmul
(``ops/lstm.py``), and layers >= 1 contract ``[h_below, h_prev]`` against
one packed ``(2H, 4H)`` weight.

Every operand may carry a leading branch axis ``M`` (what ``vmap`` over the
model's branches gives the TPU kernel): all ``M`` branches then run in one
launch over ``M * R`` rows, each CTA reading its branch's weights.

:func:`fused_lstm` dispatches on where its tensors live: CUDA tensors
launch the kernel (or raise — no fallback), CPU tensors take
:func:`fused_lstm_reference`, the plain version the CPU tests and
``chip_smoke.py`` hold the kernel against. Storage is float32 only in this
slice; cell math is float32 either way.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from stmgcn_tpu_torch.ops._build import load_library

__all__ = ["fused_lstm", "fused_lstm_reference", "kernel_library", "pack_weights"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fused_lstm_fwd.cu"
#: hidden widths the kernel's thread mapping takes (H | 256, 32 | H)
KERNEL_HIDDEN = (32, 64, 128, 256)
KERNEL_MAX_LAYERS = 4

_COUNT_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def kernel_library():
    """The built, loaded kernel entry point and its build record
    (:class:`~stmgcn_tpu_torch.ops._build.BuildInfo`); built on first call."""
    lib, info = load_library([SOURCE], "fused_lstm_fwd")
    fn = lib.stmgcn_lstm_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, info


def pack_weights(wh_stack: torch.Tensor, wx_stack: torch.Tensor):
    """``(wh0, wxh)``: layer 0's recurrent weights alone, and layers >= 1's
    input weights stacked over their recurrent weights along the
    contraction axis (``(..., L-1, 2H, 4H)``; one unread slab when L == 1
    so the operand is never empty)."""
    L = wh_stack.shape[-3]
    if L > 1:
        wxh = torch.cat([wx_stack[..., : L - 1, :, :], wh_stack[..., 1:, :, :]], dim=-2)
    else:
        wxh = torch.cat([wx_stack, wx_stack], dim=-2)
    return wh_stack[..., 0, :, :], wxh


def _check_shapes(x_proj0, wh_stack, wx_stack, b_stack):
    if x_proj0.dim() not in (3, 4):
        raise ValueError(f"x_proj0 must be (R, T, 4H) or (M, R, T, 4H), got {tuple(x_proj0.shape)}")
    lead = tuple(x_proj0.shape[:-3])
    R, T, four_h = x_proj0.shape[-3:]
    if four_h % 4:
        raise ValueError(f"x_proj0's last axis must be 4H, got {four_h}")
    H = four_h // 4
    if wh_stack.dim() != len(lead) + 3:
        raise ValueError(f"wh_stack must be {lead} + (L, H, 4H), got {tuple(wh_stack.shape)}")
    L = wh_stack.shape[-3]
    want = {
        "wh_stack": (wh_stack, lead + (L, H, 4 * H)),
        "wx_stack": (wx_stack, lead + (max(L - 1, 1), H, 4 * H)),
        "b_stack": (b_stack, lead + (max(L - 1, 1), 4 * H)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return lead, R, T, L, H


def fused_lstm_reference(x_proj0, wh_stack, wx_stack, b_stack, *, with_residuals=False):
    """Plain PyTorch version of :func:`fused_lstm`: a Python loop over t and
    layers with ``torch.matmul``, same arguments, same outputs."""
    lead, R, T, L, H = _check_shapes(x_proj0, wh_stack, wx_stack, b_stack)
    f32 = torch.float32
    wh0, wxh = pack_weights(wh_stack, wx_stack)
    h = [x_proj0.new_zeros(lead + (R, H), dtype=f32) for _ in range(L)]
    c = [x_proj0.new_zeros(lead + (R, H), dtype=f32) for _ in range(L)]
    outs, hseq, cseq = [], [], []
    for t in range(T):
        for layer in range(L):
            if layer == 0:
                pre = x_proj0[..., t, :].to(f32) + h[0] @ wh0
            else:
                hcat = torch.cat([h[layer - 1], h[layer]], dim=-1)
                pre = hcat @ wxh[..., layer - 1, :, :] + b_stack[..., layer - 1 : layer, :]
            i, f, g, o = pre.chunk(4, dim=-1)
            c[layer] = torch.sigmoid(f) * c[layer] + torch.sigmoid(i) * torch.tanh(g)
            h[layer] = torch.sigmoid(o) * torch.tanh(c[layer])
        outs.append(h[L - 1])
        if with_residuals:
            hseq.append(torch.stack(h, dim=-3))
            cseq.append(torch.stack(c, dim=-3))
    result = (torch.stack(outs, dim=-2), torch.stack(h, dim=-3), torch.stack(c, dim=-3))
    if with_residuals:
        result += (torch.stack(hseq, dim=-4), torch.stack(cseq, dim=-4))
    return result


def fused_lstm(x_proj0, wh_stack, wx_stack, b_stack, *, with_residuals=False):
    """Run the fused recurrence from zero initial state.

    Args:
      x_proj0: ``([M,] R, T, 4H)`` — layer 0's hoisted ``x @ wx_0 + b_0``.
      wh_stack: ``([M,] L, H, 4H)`` recurrent weights, all layers.
      wx_stack: ``([M,] max(L-1, 1), H, 4H)`` input weights of layers >= 1
        (an unread slab when L == 1).
      b_stack: ``([M,] max(L-1, 1), 4H)`` biases of layers >= 1.
      with_residuals: also return the per-step states the backward pass
        reads, ``hseq``/``cseq`` ``([M,] T, L, R, H)``.

    Returns ``(hs_top ([M,] R, T, H), h_fin ([M,] L, R, H), c_fin ([M,] L,
    R, H))``, plus ``(hseq, cseq)`` with ``with_residuals``.

    On CPU tensors this is :func:`fused_lstm_reference`. On CUDA tensors it
    launches the kernel on the current stream (no synchronisation) and
    raises on anything the kernel does not take: another dtype than
    float32, non-contiguous or mixed-device operands, an ``H`` outside
    ``KERNEL_HIDDEN``, more than ``KERNEL_MAX_LAYERS`` layers.
    """
    operands = (x_proj0, wh_stack, wx_stack, b_stack)
    if all(t.device.type == "cpu" for t in operands):
        return fused_lstm_reference(*operands, with_residuals=with_residuals)
    device = x_proj0.device
    if device.type != "cuda" or any(t.device != device for t in operands):
        raise ValueError(
            "fused_lstm: operands must all be on one CUDA device (or all on "
            f"the CPU), got {[str(t.device) for t in operands]}"
        )
    if any(t.dtype != torch.float32 for t in operands):
        raise TypeError(
            "fused_lstm: the CUDA kernel takes float32 storage only, got "
            f"{[str(t.dtype) for t in operands]}"
        )
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("fused_lstm: the CUDA kernel needs contiguous operands")
    lead, R, T, L, H = _check_shapes(*operands)
    if H not in KERNEL_HIDDEN or not 1 <= L <= KERNEL_MAX_LAYERS:
        raise ValueError(
            f"fused_lstm: the CUDA kernel takes H in {KERNEL_HIDDEN} and "
            f"1 <= L <= {KERNEL_MAX_LAYERS}, got H={H}, L={L}"
        )
    if R == 0 or T == 0:
        raise ValueError(f"fused_lstm: empty recurrence (R={R}, T={T})")
    M = 1
    for n in lead:
        M *= n
    wh0, wxh = pack_weights(wh_stack, wx_stack)
    wh0, wxh = wh0.contiguous(), wxh.contiguous()
    out = torch.empty(lead + (R, T, H), device=device, dtype=torch.float32)
    h_fin = torch.empty(lead + (L, R, H), device=device, dtype=torch.float32)
    c_fin = torch.empty_like(h_fin)
    hseq = cseq = None
    if with_residuals:
        hseq = torch.empty(lead + (T, L, R, H), device=device, dtype=torch.float32)
        cseq = torch.empty_like(hseq)
    fn, _ = kernel_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            x_proj0.data_ptr(), wh0.data_ptr(), wxh.data_ptr(), b_stack.data_ptr(),
            out.data_ptr(), h_fin.data_ptr(), c_fin.data_ptr(),
            hseq.data_ptr() if hseq is not None else None,
            cseq.data_ptr() if cseq is not None else None,
            M, R, T, L, H, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_lstm: kernel launch failed with cudaError {err}")
    with _COUNT_LOCK:
        fused_lstm.launches += 1
    result = (out, h_fin, c_fin)
    return result + (hseq, cseq) if with_residuals else result


#: kernel launches since the last reset (set to 0 to start a count)
fused_lstm.launches = 0
