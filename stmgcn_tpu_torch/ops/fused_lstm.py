"""Fused multi-layer LSTM recurrence: the hand-written CUDA kernels and
their plain PyTorch versions.

Counterpart of ``stmgcn_tpu/ops/pallas_lstm.py`` (``fused_lstm`` with its
forward kernel ``_fwd_kernel`` and backward kernel ``_bwd_kernel``). The
forward kernel (``csrc/fused_lstm_fwd.cu``) runs the whole ``T x L``
recurrence for a block of rows with h and c kept on chip; layer 0's input
projection is hoisted outside it as one large matmul (``ops/lstm.py``), and
layers >= 1 contract ``[h_below, h_prev]`` against one packed ``(2H, 4H)``
weight. The backward kernel (``csrc/fused_lstm_bwd.cu``) runs the reverse
sweep from the forward's saved per-step h/c, recomputing the gates, then a
split-K weight-gradient pass, and returns the packed weight gradients;
:class:`FusedLSTM` ties the two into one ``torch.autograd.Function``.

Both kernels stream the packed weights through a ring of shared-memory
stages and do every matrix product on the tensor cores in 3xTF32 (each
fp32 operand split into two TF32 halves, three products, fp32
accumulation: ``csrc/lstm_mma.cuh``), which keeps fp32 accuracy where one
TF32 pass would not (``tests/test_torch_lstm_tf32.py``). The wrapper passes
the packed weights as they are: the kernels read ``W^T`` by transposing in
the fragment load, so no transposed copy is made.

Every operand may carry a leading branch axis ``M`` (what ``vmap`` over the
model's branches gives the TPU kernel): all ``M`` branches then run in one
launch over ``M * R`` rows, each CTA reading its branch's weights.

:func:`fused_lstm` launches the forward through one PyTorch operator,
``torch.ops.stmgcn.fused_lstm_fwd`` (registered here through
``torch.library``), whose implementation the dispatcher picks by where the tensors live: CUDA
tensors launch the kernel (or raise — no fallback), CPU tensors take
:func:`fused_lstm_reference`, the plain version the CPU tests and
``chip_smoke.py`` hold the kernel against. Being an operator, the launch
survives ``torch.export``: an exported program keeps it as one node and
picks the implementation where it runs (``stmgcn_tpu_torch/export.py``),
and the launch count lives in the CUDA implementation, which the program
calls. :func:`fused_lstm_bwd` and :func:`fused_lstm_bwd_reference` are the
backward's pair.

**Storage dtypes.** Every operand is float32 or every one bfloat16 (the
storage dtype of ``x_proj0`` and the weights, as the JAX kernel follows
``x_proj0.dtype``); mixed operands raise on either device. Cell math is
float32 either way. In bfloat16 the functions follow the JAX kernel's
rounding sites exactly: each product rounds its fp32 operand (h, dgates)
to bf16 and sums in fp32 (``_mm``); ``out``, ``hseq``, ``cseq`` and the
final states are stored in bf16; the backward reads the cotangents in
bf16, recomputes the gates from the bf16 residuals, stores ``dxp`` in bf16
and sums dW (bf16 x bf16 products) and db (the unrounded fp32 dgates) in
fp32, which :class:`FusedLSTM` rounds to the weights' dtype as
``_fused_bwd`` does. The CUDA kernels' bf16 forms run each product as one
``mma.sync`` m16n8k16 bf16 pass.

**On a mesh** (the counterpart of ``sharded_fused_lstm``,
``stmgcn_tpu/ops/pallas_lstm.py:456``, which ``shard_map``s the Pallas
kernel over the row axis): each rank is a process that holds its rows
only, so it calls these same functions on them and launches B1 and B2 on
``R_local = B/dp x N`` rows per branch over its ``M/branch`` branches. It
is not a kernel of its own. The weight gradients a launch returns are its
rows' sums; the step's one all-reduce over ``dp``
(``parallel/collectives.py`` ``GradSync``) sums them over the ranks, once,
so :class:`FusedLSTM`'s backward adds no collective of its own
(``tests/test_torch_parallel.py`` holds the per-split sums to the
whole-batch gradients).
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from stmgcn_tpu_torch.ops import counters
from stmgcn_tpu_torch.ops._build import load_library, on_cuda

__all__ = [
    "ATTRIBUTES",
    "FusedLSTM",
    "bwd_kernel_library",
    "fused_lstm",
    "fused_lstm_autograd",
    "fused_lstm_bwd",
    "fused_lstm_bwd_reference",
    "fused_lstm_reference",
    "kernel_attributes",
    "kernel_library",
    "kernel_resources",
    "kernel_width",
    "pack_weights",
    "unpack_weight_grads",
]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fused_lstm_fwd.cu"
BWD_SOURCE = SOURCE.with_name("fused_lstm_bwd.cu")
#: hidden widths the kernels' tilings take (csrc/lstm_mma.cuh ``Tile``)
KERNEL_HIDDEN = (32, 64, 128, 256)
KERNEL_MAX_LAYERS = 4
#: the kernels' forms by code (``_form``): each source builds one library
#: per form, so the six builds run in parallel
FORMS = ("fp32", "bf16", "xla")


def _library(source, name: str, form: int):
    """One form's library of ``source`` (``STMGCN_LSTM_FORMS`` selects the
    instances it compiles)."""
    return load_library([source], f"{name}_{FORMS[form]}",
                        (f"-DSTMGCN_LSTM_FORMS={1 << form}",))


@functools.lru_cache(maxsize=None)
def kernel_library(form: int = 0):
    """The built, loaded forward kernel entry point of ``form`` (0 fp32, 1
    bf16, 2 xla) and its build record
    (:class:`~stmgcn_tpu_torch.ops._build.BuildInfo`); built on first call."""
    lib, info = _library(SOURCE, "fused_lstm_fwd", form)
    fn = lib.stmgcn_lstm_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, info


@functools.lru_cache(maxsize=None)
def bwd_kernel_library(form: int = 0):
    """The backward kernel's entry point of ``form``, its workspace-size
    query and its build record; built on first call."""
    lib, info = _library(BWD_SOURCE, "fused_lstm_bwd", form)
    fn = lib.stmgcn_lstm_bwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    workspace = lib.stmgcn_lstm_bwd_workspace
    workspace.argtypes = [ctypes.c_int] * 6
    workspace.restype = ctypes.c_size_t
    return fn, workspace, info


def kernel_resources(L: int, H: int, dtype=torch.float32) -> dict:
    """Rows per CTA and dynamic shared memory (bytes) per CTA of each LSTM
    kernel at ``(L, H)`` and storage ``dtype`` (``"xla"`` for the xla
    form), as the built libraries report them (builds them on first
    call)."""
    form = 2 if dtype == "xla" else int(dtype == torch.bfloat16)
    fwd, bwd = _library(SOURCE, "fused_lstm_fwd", form)[0], _library(
        BWD_SOURCE, "fused_lstm_bwd", form)[0]
    for f in (fwd.stmgcn_lstm_fwd_smem, fwd.stmgcn_lstm_block_rows, bwd.stmgcn_lstm_bwd_smem):
        f.restype = ctypes.c_int
    return {
        "block_rows": fwd.stmgcn_lstm_block_rows(H),
        "lstm_fwd_kernel": fwd.stmgcn_lstm_fwd_smem(L, H, form),
        "lstm_bwd_sweep": bwd.stmgcn_lstm_bwd_smem(L, H, form),
        "lstm_bwd_wgrad": bwd.stmgcn_lstm_bwd_smem(0, H, form),
    }


#: what :func:`kernel_attributes` reports of each compiled kernel instance
ATTRIBUTES = ("registers", "local_bytes", "max_threads", "static_smem")


def kernel_attributes(L: int, H: int, dtype=torch.float32) -> dict:
    """``cudaFuncGetAttributes`` of each LSTM kernel instance a launch at
    ``(L, H)`` and storage ``dtype`` (``"xla"`` for the xla form) takes:
    ``{kernel: {registers, local_bytes (spilled, per thread), max_threads,
    static_smem}}`` for ``lstm_fwd_kernel``, ``lstm_bwd_sweep`` and
    ``lstm_bwd_wgrad`` (builds the libraries on first call; needs the
    card)."""
    form = 2 if dtype == "xla" else int(dtype == torch.bfloat16)
    fwd, bwd = _library(SOURCE, "fused_lstm_fwd", form)[0], _library(
        BWD_SOURCE, "fused_lstm_bwd", form)[0]
    out = {}
    for name, fn, layers in (("lstm_fwd_kernel", fwd.stmgcn_lstm_fwd_attrs, L),
                             ("lstm_bwd_sweep", bwd.stmgcn_lstm_bwd_attrs, L),
                             ("lstm_bwd_wgrad", bwd.stmgcn_lstm_bwd_attrs, 0)):
        fn.restype = ctypes.c_int
        info = (ctypes.c_int * len(ATTRIBUTES))()
        err = fn(layers, H, form, info)
        if err != 0:
            raise RuntimeError(f"{name} (L={layers}, H={H}, form {form}): "
                               f"cudaFuncGetAttributes failed with cudaError {err}")
        out[name] = dict(zip(ATTRIBUTES, info))
    return out


def _storage(name, operands, products=None) -> torch.dtype:
    """The one storage dtype of ``operands``: float32 or bfloat16, raising
    on mixed dtypes (which the JAX package never hands its kernel) on every
    device. The xla form (``products=torch.bfloat16``) stores in float32:
    every operand float32 but the weights (operands 1 and 2) and biases
    (operand 3), which may be the float32 masters or a bf16 shadow (the
    stochastically rounded parameters)."""
    if products is not None and products != operands[0].dtype:  # the xla form
        kinds = {torch.float32, torch.bfloat16}
        if (products != torch.bfloat16 or operands[0].dtype != torch.float32
                or any(t.dtype != torch.float32 for t in operands[4:])
                or not {t.dtype for t in operands[1:4]} <= kinds):
            raise TypeError(f"{name}: the xla form (products={products}) takes float32 "
                            "operands, the weights and biases float32 or bfloat16, got "
                            f"{[str(t.dtype) for t in operands]}")
        return torch.float32
    dtypes = {t.dtype for t in operands}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
        raise TypeError(f"{name}: operands must all be float32 or all bfloat16, got "
                        f"{[str(t.dtype) for t in operands]}")
    return dtypes.pop()


def _form(sd: torch.dtype, products) -> int:
    """The kernels' form code: 0 fp32, 1 bf16 storage, 2 the xla form."""
    if products == torch.bfloat16 and sd == torch.float32:
        return 2
    return int(sd == torch.bfloat16)


def _kernel_operands(name, operands, form):
    """Whether ``operands`` lie on a CUDA device (:func:`~stmgcn_tpu_torch.
    ops._build.on_cuda`'s rules), and on one, the operands as the kernel of
    ``form`` reads them (the xla form: weights in bf16, biases in
    float32)."""
    if form != 2:
        return operands, on_cuda(name, operands)
    x_proj0, wh, wx, b, *rest = operands
    if not on_cuda(name, (x_proj0, *rest)):  # the float32 operands
        return operands, False
    if any(t.device != x_proj0.device for t in (wh, wx, b)):
        raise ValueError(f"{name}: operands must all be on one CUDA device")
    bf16 = torch.bfloat16
    return (x_proj0, wh.to(bf16), wx.to(bf16), b.float().contiguous(), *rest), True


def _bf16r(t):
    """``t`` rounded to bf16 and read back as float32 (a JAX
    ``astype(bf16)`` seen from the float32 side)."""
    return t.to(torch.bfloat16).float()


def _mm(a, w):
    """The JAX kernel's ``_mm``: ``a`` rounded to ``w``'s storage dtype,
    the product summed in float32 (a product of two bf16 values is exact in
    float32). Float32 storage is the plain product."""
    if w.dtype == torch.float32:
        return a @ w
    return a.to(w.dtype).float() @ w.float()


def _check_aligned(name, copied, paired):
    """The kernels copy the weights and ``hseq`` 16 bytes at a time
    (cp.async) and read or write every other operand two floats at a time."""
    for tensors, nbytes in ((copied, 16), (paired, 8)):
        if any(t.data_ptr() % nbytes for t in tensors):
            raise ValueError(f"{name}: operands must start on a {nbytes}-byte boundary "
                             "(16 for the weights and hseq)")


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


def fused_lstm_reference(x_proj0, wh_stack, wx_stack, b_stack, *, with_residuals=False,
                         products=None):
    """Plain PyTorch version of :func:`fused_lstm`: a Python loop over t and
    layers with ``torch.matmul``, same arguments, same outputs, in every
    form (the module docstring's rounding sites; the xla form's from the
    JAX layered scan)."""
    lead, R, T, L, H = _check_shapes(x_proj0, wh_stack, wx_stack, b_stack)
    sd = _storage("fused_lstm", (x_proj0, wh_stack, wx_stack, b_stack), products)
    f32 = torch.float32
    xla = _form(sd, products) == 2
    if xla:
        wh_stack, wx_stack = wh_stack.to(products), wx_stack.to(products)
        b_stack = b_stack.float()
    wh0, wxh = pack_weights(wh_stack, wx_stack)
    h = [x_proj0.new_zeros(lead + (R, H), dtype=f32) for _ in range(L)]
    c = [x_proj0.new_zeros(lead + (R, H), dtype=f32) for _ in range(L)]
    outs, hseq, cseq = [], [], []
    for t in range(T):
        for layer in range(L):
            pre = _pre(x_proj0, wh0, wxh, b_stack, h[layer - 1] if layer else None,
                       h[layer], t, layer, xla)
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
    return tuple(r.to(sd) for r in result)


def _pre(x_proj0, wh0, wxh, b_stack, h_below, h_prev, t, layer, xla):
    """Step t's pre-activations of ``layer`` in float32: layer 0 adds its
    recurrent product to ``x_proj0``; a layer >= 1 contracts ``[h_below,
    h_prev]`` with its packed weight and adds its bias, in the xla form in
    the JAX scan's order ``(h_below @ wx + b) + h_prev @ wh``."""
    if layer == 0:
        return x_proj0[..., t, :].float() + _mm(h_prev, wh0)
    w, b = wxh[..., layer - 1, :, :], b_stack[..., layer - 1 : layer, :].float()
    if xla:
        H = h_prev.shape[-1]
        return (_mm(h_below, w[..., :H, :]) + b) + _mm(h_prev, w[..., H:, :])
    return _mm(torch.cat([h_below, h_prev], dim=-1), w) + b


def _kernel_shapes(name, operands):
    lead, R, T, L, H = _check_shapes(*operands[:4])
    if H not in KERNEL_HIDDEN or not 1 <= L <= KERNEL_MAX_LAYERS:
        raise ValueError(
            f"{name}: the CUDA kernel takes H in {KERNEL_HIDDEN} and "
            f"1 <= L <= {KERNEL_MAX_LAYERS}, got H={H}, L={L}"
        )
    if R == 0 or T == 0:
        raise ValueError(f"{name}: empty recurrence (R={R}, T={T})")
    return lead, math.prod(lead), R, T, L, H


#: B1 as one PyTorch operator, ``torch.ops.stmgcn.fused_lstm_fwd``: the
#: forward's operands, the form code (:func:`_form`) and whether the
#: per-step residuals are wanted (they come back empty, ``(0,)``, without)
_LIBRARY = torch.library.Library("stmgcn", "DEF")
_LIBRARY.define(
    "fused_lstm_fwd(Tensor x_proj0, Tensor wh_stack, Tensor wx_stack, Tensor b_stack, "
    "int form, bool with_residuals) -> (Tensor, Tensor, Tensor, Tensor, Tensor)")


def _fwd_cpu(x_proj0, wh_stack, wx_stack, b_stack, form, with_residuals):
    """The operator's CPU implementation: the plain version
    (:func:`fused_lstm_reference`). The dispatcher picks an implementation
    per device at run time, so a traced or exported program, which keeps
    the operator as one node, runs this on the CPU and launches the kernel
    (:func:`_fwd_cuda`) on the card."""
    result = fused_lstm_reference(x_proj0, wh_stack, wx_stack, b_stack,
                                  with_residuals=with_residuals,
                                  products=torch.bfloat16 if form == 2 else None)
    if with_residuals:
        return result
    empty = x_proj0.new_empty((0,), dtype=result[0].dtype)
    return result + (empty, empty.clone())


def _fwd_fake(x_proj0, wh_stack, wx_stack, b_stack, form, with_residuals):
    """The outputs' shapes and dtypes, for tracing (a symbolic row count
    carries through)."""
    lead, (R, T, four_h) = tuple(x_proj0.shape[:-3]), tuple(x_proj0.shape[-3:])
    H, L = four_h // 4, wh_stack.shape[-3]
    sd = torch.bfloat16 if form == 1 else torch.float32
    out = x_proj0.new_empty(lead + (R, T, H), dtype=sd)
    h_fin = x_proj0.new_empty(lead + (L, R, H), dtype=sd)
    shape = lead + (T, L, R, H) if with_residuals else (0,)
    return (out, h_fin, torch.empty_like(h_fin), x_proj0.new_empty(shape, dtype=sd),
            x_proj0.new_empty(shape, dtype=sd))


def _fwd_cuda(x_proj0, wh_stack, wx_stack, b_stack, form, with_residuals):
    """The CUDA implementation: one launch of ``csrc/fused_lstm_fwd.cu`` in
    ``form`` on the current stream (no synchronisation), counted in
    ``fused_lstm.launches`` (and ``launches_xla``); raises on anything the
    kernel does not take. There is no fallback to the plain version."""
    operands = (x_proj0, wh_stack, wx_stack, b_stack)
    (x_proj0, wh_stack, wx_stack, b_stack), cuda = _kernel_operands("fused_lstm", operands,
                                                                    form)
    if not cuda:
        raise ValueError("fused_lstm: operands must all be on one CUDA device")
    lead, M, R, T, L, H = _kernel_shapes("fused_lstm", operands)
    sd = torch.bfloat16 if form == 1 else torch.float32
    device = x_proj0.device
    wh0, wxh = pack_weights(wh_stack, wx_stack)
    wh0, wxh = wh0.contiguous(), wxh.contiguous()
    _check_aligned("fused_lstm", (wh0, wxh), (x_proj0, b_stack))
    out = torch.empty(lead + (R, T, H), device=device, dtype=sd)
    h_fin = torch.empty(lead + (L, R, H), device=device, dtype=sd)
    c_fin = torch.empty_like(h_fin)
    shape = lead + (T, L, R, H) if with_residuals else (0,)
    hseq = torch.empty(shape, device=device, dtype=sd)
    cseq = torch.empty_like(hseq)
    fn, _ = kernel_library(form)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            x_proj0.data_ptr(), wh0.data_ptr(), wxh.data_ptr(), b_stack.data_ptr(),
            out.data_ptr(), h_fin.data_ptr(), c_fin.data_ptr(),
            hseq.data_ptr() if with_residuals else None,
            cseq.data_ptr() if with_residuals else None,
            M, R, T, L, H, form, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_lstm: kernel launch failed with cudaError {err}")
    counters.bump(fused_lstm)
    if form == 2:
        counters.bump(fused_lstm, "launches_xla")
    return out, h_fin, c_fin, hseq, cseq


_LIBRARY.impl("fused_lstm_fwd", _fwd_cpu, "CPU")
_LIBRARY.impl("fused_lstm_fwd", _fwd_cuda, "CUDA")
torch.library.register_fake("stmgcn::fused_lstm_fwd", _fwd_fake, lib=_LIBRARY)


def _check_devices(name, operands) -> None:
    """Every operand on one device, the CPU or a CUDA device (the
    operator's dispatch picks the implementation from them)."""
    devices = {t.device for t in operands}
    if len(devices) != 1 or next(iter(devices)).type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: operands must all be on one CUDA device (or all on "
                         f"the CPU), got {[str(t.device) for t in operands]}")


def fused_lstm(x_proj0, wh_stack, wx_stack, b_stack, *, with_residuals=False,
               products=None):
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

    Outputs are in the operands' storage dtype (float32 or bfloat16).
    ``products=torch.bfloat16`` over float32 operands is the xla form (the
    module docstring): the weights are rounded to bf16, every output and
    residual stays float32.

    The launch is the operator ``torch.ops.stmgcn.fused_lstm_fwd``: on CPU
    tensors it
    runs :func:`fused_lstm_reference`; on CUDA tensors it launches the kernel
    of the storage dtype on the current stream (no synchronisation)
    and raises on anything the kernel does not take: mixed or other dtypes,
    non-contiguous or mixed-device operands, an ``H`` outside
    ``KERNEL_HIDDEN``, more than ``KERNEL_MAX_LAYERS`` layers.
    """
    operands = (x_proj0, wh_stack, wx_stack, b_stack)
    _check_shapes(*operands)
    sd = _storage("fused_lstm", operands, products)
    _check_devices("fused_lstm", operands)
    result = torch.ops.stmgcn.fused_lstm_fwd(*operands, _form(sd, products), with_residuals)
    return result if with_residuals else result[:3]


#: kernel launches since the last reset (set to 0 to start a count), and
#: those of them in the xla form
fused_lstm.launches = 0
fused_lstm.launches_xla = 0


def _cotangents(x_proj0, L, g_out, g_hfin, g_cfin):
    """The cotangents in the storage dtype, as ``_fused_bwd`` casts them.
    Autograd passes ``None`` for an output whose gradient is unused
    (``CGLSTM`` reads only the last step, so the final-state cotangents
    usually are): those become zeros."""
    lead, (R, T, four_h) = x_proj0.shape[:-3], x_proj0.shape[-3:]
    H = four_h // 4
    sd = x_proj0.dtype

    def cast(g, shape):
        if g is None:
            return torch.zeros(lead + shape, device=x_proj0.device, dtype=sd)
        return g.to(sd)

    return cast(g_out, (R, T, H)), cast(g_hfin, (L, R, H)), cast(g_cfin, (L, R, H))


def fused_lstm_bwd_reference(x_proj0, wh_stack, wx_stack, b_stack, hseq, cseq,
                             g_out, g_hfin, g_cfin, *, products=None, round_wx_steps=False):
    """Plain PyTorch version of :func:`fused_lstm_bwd`: the reverse sweep of
    ``_bwd_kernel`` as a Python loop over t and layers with ``torch.matmul``
    — recompute each step's pre-activations from the saved h/c, form the
    gate cotangents, carry dh/dc back — with the same arguments and the same
    packed outputs, in every form (the module docstring's rounding sites;
    the weight gradients are float32 sums, or bf16 sums in the xla form
    over bf16 weights)."""
    lead, R, T, L, H = _check_shapes(x_proj0, wh_stack, wx_stack, b_stack)
    sd = _storage("fused_lstm_bwd", (x_proj0, wh_stack, wx_stack, b_stack, hseq, cseq),
                  products)
    g_out, g_hfin, g_cfin = _cotangents(x_proj0, L, g_out, g_hfin, g_cfin)
    xla = _form(sd, products) == 2
    carry = xla and wh_stack.dtype == torch.bfloat16  # the scan's bf16 carries
    if xla:
        wh_stack, wx_stack = wh_stack.to(products), wx_stack.to(products)
        b_stack = b_stack.float()
    wh0, wxh = pack_weights(wh_stack, wx_stack)
    if sd != torch.float32:  # residuals, operands and cotangents read as fp32
        x_proj0, b_stack, hseq, cseq, g_out, g_hfin, g_cfin = (
            t.float() for t in (x_proj0, b_stack, hseq, cseq, g_out, g_hfin, g_cfin))
    dh = [g_hfin[..., layer, :, :] for layer in range(L)]
    dc = [g_cfin[..., layer, :, :] for layer in range(L)]
    zeros = x_proj0.new_zeros(lead + (R, H))
    dxp = [None] * T
    dwh0 = torch.zeros_like(wh0, dtype=torch.float32)
    dwxh = [torch.zeros_like(wxh[..., 0, :, :], dtype=torch.float32)
            for _ in range(wxh.shape[-3])]
    db = [torch.zeros_like(b_stack[..., 0, :]) for _ in range(b_stack.shape[-2])]
    for t in reversed(range(T)):
        dh[L - 1] = dh[L - 1] + g_out[..., t, :]
        for layer in reversed(range(L)):
            h_prev = hseq[..., t - 1, layer, :, :] if t > 0 else zeros
            c_prev = cseq[..., t - 1, layer, :, :] if t > 0 else zeros
            c_t = cseq[..., t, layer, :, :]
            h_below = hseq[..., t, layer - 1, :, :] if layer else None
            hin = h_prev if layer == 0 else torch.cat([h_below, h_prev], dim=-1)
            pre = _pre(x_proj0, wh0, wxh, b_stack, h_below, h_prev, t, layer, xla)
            i, f, g, o = (act(p) for act, p in zip(
                (torch.sigmoid, torch.sigmoid, torch.tanh, torch.sigmoid), pre.chunk(4, dim=-1)))
            tc = torch.tanh(c_t)
            d_o = dh[layer] * tc
            dct = dc[layer] + dh[layer] * o * (1.0 - tc * tc)
            dgates = torch.cat([
                dct * g * i * (1.0 - i),
                dct * c_prev * f * (1.0 - f),
                dct * i * (1.0 - g * g),
                d_o * o * (1.0 - o),
            ], dim=-1)
            dc[layer] = dct * f
            if xla:
                _xla_step_grads(dgates, hin, wh0, wxh, layer, H, round_wx_steps, carry,
                                dh, dwxh, db)
                if layer == 0:
                    dwh0 = _carry(dwh0 + _bf16r(_bf16r(hin).transpose(-1, -2) @ dgates),
                                  carry)
                    dxp[t] = dgates
                continue
            # dW: bf16(hin)^T bf16(dgates) in fp32 (hin is bf16 already)
            dg_w = dgates if sd == torch.float32 else dgates.to(sd).float()
            if layer == 0:
                dh[0] = _mm(dgates, wh0.transpose(-1, -2))
                dwh0 = dwh0 + hin.transpose(-1, -2) @ dg_w
                dxp[t] = dgates
            else:
                dcat = _mm(dgates, wxh[..., layer - 1, :, :].transpose(-1, -2))
                dh[layer - 1] = dh[layer - 1] + dcat[..., :H]
                dh[layer] = dcat[..., H:]
                dwxh[layer - 1] = dwxh[layer - 1] + hin.transpose(-1, -2) @ dg_w
                db[layer - 1] = db[layer - 1] + dgates.sum(dim=-2)
    return (torch.stack(dxp, dim=-2).to(sd), dwh0, torch.stack(dwxh, dim=-3),
            torch.stack(db, dim=-2))


def _carry(total, bf16: bool):
    """A running weight-gradient sum over steps: the JAX scan's carry, a
    float32 one over float32 masters, a bf16 one over a bf16 shadow."""
    return _bf16r(total) if bf16 else total


def _xla_step_grads(dgates, hin, wh0, wxh, layer, H, round_wx_steps, carry, dh, dwxh, db):
    """One (step, layer) of the xla form's backward, as ``jax.grad`` of the
    JAX scan rounds it: each product's h cotangent, a float32 product of
    the unrounded dgates, rounded to bf16 (the transpose of the operand's
    ``astype(bf16)``); a layer >= 1's recurrent weight partial rounded to
    bf16, its input-weight partial too with ``round_wx_steps``, its bias
    partial a float32 sum, rounded too when the fused scan's bias is a bf16
    shadow. ``carry``: the weights are a bf16 shadow, so the per-step
    rounded sums run in bf16 (:func:`_carry`). Updates ``dh``, ``dwxh`` and
    ``db`` in place (layer 0's dW and dxp are the caller's)."""
    if layer == 0:
        dh[0] = _bf16r(dgates @ wh0.float().transpose(-1, -2))
        return
    w = wxh[..., layer - 1, :, :].float()
    dh[layer - 1] = dh[layer - 1] + _bf16r(dgates @ w[..., :H, :].transpose(-1, -2))
    dh[layer] = _bf16r(dgates @ w[..., H:, :].transpose(-1, -2))
    hb = _bf16r(hin)
    d_wx = hb[..., :H].transpose(-1, -2) @ dgates
    d_wh = _bf16r(hb[..., H:].transpose(-1, -2) @ dgates)
    if round_wx_steps:
        d_wx = _carry(dwxh[layer - 1][..., :H, :] + _bf16r(d_wx), carry)
    else:
        d_wx = dwxh[layer - 1][..., :H, :] + d_wx
    d_wh = _carry(dwxh[layer - 1][..., H:, :] + d_wh, carry)
    dwxh[layer - 1] = torch.cat([d_wx, d_wh], dim=-2)
    d_b = dgates.sum(dim=-2)
    if round_wx_steps and carry:
        db[layer - 1] = _bf16r(db[layer - 1] + _bf16r(d_b))
    else:
        db[layer - 1] = db[layer - 1] + d_b


def fused_lstm_bwd(x_proj0, wh_stack, wx_stack, b_stack, hseq, cseq,
                   g_out=None, g_hfin=None, g_cfin=None, *, products=None,
                   round_wx_steps=False):
    """Backward of :func:`fused_lstm`: the reverse sweep over its saved
    per-step states.

    Args: the forward's four operands; its residuals ``hseq``/``cseq``
    ``([M,] T, L, R, H)``; the cotangents of its three outputs, ``g_out``
    ``([M,] R, T, H)`` and ``g_hfin``/``g_cfin`` ``([M,] L, R, H)``, each
    of which may be ``None`` (zeros).

    Returns the packed gradients of ``_fused_bwd``'s kernel: ``dxp ([M,]
    R, T, 4H)`` in the storage dtype, and in float32 ``dwh0 ([M,] H,
    4H)``, ``dwxh ([M,] max(L-1, 1), 2H, 4H)`` and ``db ([M,] max(L-1, 1),
    4H)`` (the last two zeros when L == 1); :func:`unpack_weight_grads`
    turns them into per-stack gradients. The cotangents are read in the
    storage dtype (cast as ``_fused_bwd`` casts them). ``products`` as
    :func:`fused_lstm`'s; ``round_wx_steps`` (xla form) rounds each step's
    input-weight partial to bf16, as the JAX fused scan does.

    On CPU tensors this is :func:`fused_lstm_bwd_reference`. On CUDA
    tensors it launches ``csrc/fused_lstm_bwd.cu`` on the current stream,
    with the scratch it needs, and raises on what the kernel does not take
    (the forward's rules). The result is deterministic: no atomics, a
    fixed summation order.
    """
    L = wh_stack.shape[-3]
    sd = _storage("fused_lstm_bwd", (x_proj0, wh_stack, wx_stack, b_stack, hseq, cseq),
                  products)
    g_out, g_hfin, g_cfin = _cotangents(x_proj0, L, g_out, g_hfin, g_cfin)
    operands = (x_proj0, wh_stack, wx_stack, b_stack, hseq, cseq, g_out, g_hfin, g_cfin)
    form = _form(sd, products)
    carry = form == 2 and wh_stack.dtype == torch.bfloat16
    kernel_ops, cuda = _kernel_operands("fused_lstm_bwd", operands, form)
    if not cuda:
        return fused_lstm_bwd_reference(*operands, products=products,
                                        round_wx_steps=round_wx_steps)
    operands = kernel_ops
    lead, M, R, T, L, H = _kernel_shapes("fused_lstm_bwd", operands)
    want = {"hseq": lead + (T, L, R, H), "cseq": lead + (T, L, R, H),
            "g_out": lead + (R, T, H), "g_hfin": lead + (L, R, H), "g_cfin": lead + (L, R, H)}
    for name, t in zip(want, operands[4:]):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"fused_lstm_bwd: {name} must be {want[name]}, got {tuple(t.shape)}")
    device = x_proj0.device
    x_proj0, wh_stack, wx_stack, b_stack = operands[:4]
    wh0, wxh = pack_weights(wh_stack, wx_stack)
    wh0, wxh = wh0.contiguous(), wxh.contiguous()
    _check_aligned("fused_lstm_bwd", (wh0, wxh, hseq), (x_proj0, b_stack) + operands[5:])
    fn, workspace_floats, _ = bwd_kernel_library(form)
    dxp = torch.empty_like(x_proj0)
    dwh0 = torch.empty_like(wh0, dtype=torch.float32)
    new = torch.empty if L > 1 else torch.zeros  # L == 1: unwritten placeholders
    dwxh = new(wxh.shape, device=device, dtype=torch.float32)
    db = new(b_stack.shape, device=device, dtype=torch.float32)
    work = torch.empty(workspace_floats(M, R, T, L, H, form), device=device,
                       dtype=torch.float32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *(t.data_ptr() for t in (x_proj0, wh0, wxh, b_stack, hseq, cseq,
                                     g_out, g_hfin, g_cfin, dxp, dwh0, dwxh, db, work)),
            M, R, T, L, H, form, int(bool(round_wx_steps)) | (2 * int(carry)), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_lstm_bwd: kernel launch failed with cudaError {err}")
    counters.bump(fused_lstm_bwd)
    if form == 2:
        counters.bump(fused_lstm_bwd, "launches_xla")
    return dxp, dwh0, dwxh, db


#: kernel launches since the last reset (set to 0 to start a count), and
#: those of them in the xla form
fused_lstm_bwd.launches = 0
fused_lstm_bwd.launches_xla = 0


def unpack_weight_grads(dwh0, dwxh, wh_stack, wx_stack):
    """``(dwh_stack, dwx_stack)`` from the packed ``(dwh0, dwxh)``, as
    ``_fused_bwd`` unpacks them: rows ``0:H`` of ``dwxh`` are layer l's
    input-weight gradient, rows ``H:2H`` its recurrent one; ``dwx`` is zeros
    when L == 1 (its slab is never read)."""
    L, H = wh_stack.shape[-3], wh_stack.shape[-2]
    if L == 1:
        return dwh0.unsqueeze(-3), torch.zeros_like(wx_stack, dtype=dwh0.dtype)
    dwh = torch.cat([dwh0.unsqueeze(-3), dwxh[..., H:, :]], dim=-3)
    return dwh, dwxh[..., :H, :]


class FusedLSTM(torch.autograd.Function):
    """:func:`fused_lstm` with :func:`fused_lstm_bwd` as its backward: the
    forward keeps the residuals the backward reads (``x_proj0``, the
    weights, ``hseq``, ``cseq``); the float32 weight gradients are rounded
    to the weights' dtype, as ``_fused_bwd`` rounds them (in the xla form
    the weights are the float32 masters, so they are not rounded). Use
    :func:`fused_lstm_autograd`, which takes this route only when a
    gradient is wanted."""

    @staticmethod
    def forward(ctx, x_proj0, wh_stack, wx_stack, b_stack, products=None,
                round_wx_steps=False):
        out, h_fin, c_fin, hseq, cseq = fused_lstm(
            x_proj0, wh_stack, wx_stack, b_stack, with_residuals=True, products=products)
        ctx.save_for_backward(x_proj0, wh_stack, wx_stack, b_stack, hseq, cseq)
        ctx.products, ctx.round_wx_steps = products, round_wx_steps
        return out, h_fin, c_fin

    @staticmethod
    def backward(ctx, g_out, g_hfin, g_cfin):
        x_proj0, wh_stack, wx_stack, b_stack, hseq, cseq = ctx.saved_tensors

        def dense(g):
            return None if g is None else g.contiguous()

        dxp, dwh0, dwxh, db = fused_lstm_bwd(
            x_proj0, wh_stack, wx_stack, b_stack, hseq, cseq,
            dense(g_out), dense(g_hfin), dense(g_cfin), products=ctx.products,
            round_wx_steps=ctx.round_wx_steps)
        dwh, dwx = unpack_weight_grads(dwh0, dwxh, wh_stack, wx_stack)
        return (dxp, dwh.to(wh_stack.dtype), dwx.to(wx_stack.dtype), db.to(b_stack.dtype),
                None, None)


def kernel_width(H: int) -> int:
    """The narrowest kernel width ``Hk >= H`` of ``KERNEL_HIDDEN``: the
    route pads H up to it. Raises past the widest; no preset of the JAX
    package comes near (``stmgcn_tpu/config.py``: H is 32 or 64 in every
    preset)."""
    for width in KERNEL_HIDDEN:
        if H <= width:
            return width
    raise ValueError(f"fused LSTM route: H={H} exceeds the kernels' widest hidden width "
                     f"{KERNEL_HIDDEN[-1]}")


def _pad_gates(t, H: int, Hk: int):
    """Zero-pad each of the four gate blocks of the last axis, 4H -> 4Hk."""
    return torch.nn.functional.pad(t.unflatten(-1, (4, H)), (0, Hk - H)).flatten(-2)


def _pad_weights(w, H: int, Hk: int):
    """``(..., H, 4H)`` -> ``(..., Hk, 4Hk)``: gate blocks and contraction
    rows zero-padded."""
    return torch.nn.functional.pad(_pad_gates(w, H, Hk), (0, 0, 0, Hk - H))


def _group_operands(xp, wh_stack, wx_stack, b_stack, g0: int, g1: int):
    """One launch's operands, for layers ``g0 .. g1-1``: layer ``g0``'s
    input weights are hoisted into ``xp`` by the caller, so the group's
    ``wx``/``b`` stacks hold layers ``g0+1 ..`` (an unread slab when the
    group has one layer)."""
    wh = wh_stack[..., g0:g1, :, :].contiguous()
    if g1 - g0 > 1:
        wx = wx_stack[..., g0:g1 - 1, :, :].contiguous()
        b = b_stack[..., g0:g1 - 1, :].contiguous()
    else:
        wx, b = torch.zeros_like(wh_stack[..., :1, :, :]), torch.zeros_like(b_stack[..., :1, :])
    return xp, wh, wx, b


def fused_lstm_autograd(x_proj0, wh_stack, wx_stack, b_stack, *, products=None,
                        round_wx_steps=False):
    """:func:`fused_lstm` for a model, at any ``H >= 1`` and ``L >= 1``:
    through :class:`FusedLSTM` (residuals kept, backward kernel on
    ``.backward()``) when grad is enabled and an operand requires it;
    otherwise the forward alone, without residuals, as serving calls it.
    Returns ``(hs_top, h_fin, c_fin)``.

    The kernels take ``H`` in ``KERNEL_HIDDEN`` and up to
    ``KERNEL_MAX_LAYERS`` layers; this route takes the rest, for CPU
    tensors (the plain versions) and CUDA tensors (the kernels) alike:

    - ``H`` is padded up to :func:`kernel_width`: each gate block of
      ``x_proj0``, the weights and the biases, and the weights' contraction
      rows (both halves of the ``[h_below, h_prev]`` product, since the
      stacks are padded before :func:`pack_weights` joins them). A padded
      unit's pre-activations are 0, so it holds ``c = h = 0`` at every
      step and its zero weights pass nothing into real units: the result
      is exact. Outputs are sliced back, and autograd slices the
      gradients back with them;
    - ``L`` is cut into groups of at most ``KERNEL_MAX_LAYERS`` layers, one
      launch each way per group: a group's top h sequence, projected
      through the next group's first input weights (a plain matmul, as
      layer 0's is), is that group's ``x_proj0``, and in the backward the
      group's ``dxp`` flows back through that product into the previous
      group's top-h cotangent. In bfloat16 that projection sums in float32
      and is rounded once to bf16, the chained group's storage: a rounding
      the JAX kernel, which runs all layers in one launch, does not make.
      In the xla form it is the JAX layered scan's own hoisted projection,
      bf16 operands and a float32 result (under ``round_wx_steps`` that
      layer's input-weight gradient is then rounded once, not per step).

    Padding is exact in bfloat16 too (zeros are exact). ``products`` and
    ``round_wx_steps`` as :func:`fused_lstm_bwd`'s.
    """
    operands = (x_proj0, wh_stack, wx_stack, b_stack)
    lead, R, T, L, H = _check_shapes(*operands)
    Hk = kernel_width(H)
    if Hk != H:
        x_proj0 = _pad_gates(x_proj0, H, Hk)
        wh_stack, wx_stack = _pad_weights(wh_stack, H, Hk), _pad_weights(wx_stack, H, Hk)
        b_stack = _pad_gates(b_stack, H, Hk)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in operands)
    if grad:
        def launch(*ops):
            return FusedLSTM.apply(*ops, products, round_wx_steps)
    else:
        def launch(*ops):
            return fused_lstm(*ops, products=products)
    xp, h_fins, c_fins = x_proj0.contiguous(), [], []
    for g0 in range(0, L, KERNEL_MAX_LAYERS):
        if g0:
            w, b = wx_stack[..., g0 - 1, :, :], b_stack[..., g0 - 1, :]
            if products is not None and products != hs_top.dtype:  # the xla form
                xp = (_bf16r(hs_top) @ _bf16r(w).unsqueeze(-3)
                      + b[..., None, None, :]).contiguous()
            elif hs_top.dtype == torch.float32:
                xp = (hs_top @ w.unsqueeze(-3) + b[..., None, None, :]).contiguous()
            else:  # fp32 sum of exact bf16 products, rounded once
                xp = (hs_top.float() @ w.float().unsqueeze(-3)
                      + b.float()[..., None, None, :]).to(hs_top.dtype).contiguous()
        g1 = min(g0 + KERNEL_MAX_LAYERS, L)
        hs_top, h_fin, c_fin = launch(*_group_operands(xp, wh_stack, wx_stack, b_stack, g0, g1))
        h_fins.append(h_fin)
        c_fins.append(c_fin)
    if len(h_fins) > 1:
        h_fin, c_fin = torch.cat(h_fins, dim=-3), torch.cat(c_fins, dim=-3)
    if Hk != H:
        hs_top, h_fin, c_fin = hs_top[..., :H], h_fin[..., :H], c_fin[..., :H]
    return hs_top, h_fin, c_fin
