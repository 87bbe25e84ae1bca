"""Analytic FLOPs model of the ST-MGCN training step, and the H100's peaks.

Counterpart of ``stmgcn_tpu/utils/flops.py``. MFU (model FLOPs
utilization) = analytic-model FLOPs / step time / device peak.

:func:`stmgcn_step_flops` is the JAX package's arithmetic, copied term by
term (``tests/test_torch_utils.py`` holds the two equal): the matmul work
of the gate's temporal graph conv and its two FC applications, the
globally shared L-layer LSTM over the ``B*N`` folded rows, the output
graph conv and the fusion head, twice the forward again for the backward.
Elementwise work is left out.

:func:`device_peak_flops` replaces the JAX package's TPU table with the
H100 SXM's dense peaks (NVIDIA data sheet, 700 W): bf16 on the tensor
cores 989.4 TFLOP/s, TF32 on them 494.7 TFLOP/s, and fp32 FMA outside
them 66.9 TFLOP/s. Which peak is the denominator is the caller's choice
(``precision``): the port's float32 LSTM kernels run their products as
3xTF32 on the tensor cores, its bf16 forms as bf16 products, and the
library's float32 GEMMs run on the fp32 units (TF32 off).
"""

from __future__ import annotations

from typing import Optional

__all__ = ["H100_PEAK_FLOPS", "device_peak_flops", "mfu", "stmgcn_step_flops"]


def stmgcn_step_flops(
    batch: int,
    seq_len: int,
    n_nodes: int,
    n_feats: int,
    m_graphs: int,
    n_supports: int,
    lstm_hidden_dim: int,
    lstm_num_layers: int,
    gcn_hidden_dim: int,
    horizon: int = 1,
    backward: bool = True,
) -> float:
    """Matmul FLOPs (2 * MACs) of one training (or forward) step."""
    B, T, N, C = batch, seq_len, n_nodes, n_feats
    K, H, G, L, M = n_supports, lstm_hidden_dim, gcn_hidden_dim, lstm_num_layers, m_graphs

    # Gate: K supports x (N,N)@(N,T) per sample, then (B,N,K*T)@(K*T,T),
    # then the FC pair (B,T)@(T,T) twice (shared or not, same FLOPs).
    gate_gconv = 2.0 * K * B * N * N * T + 2.0 * B * N * (K * T) * T
    gate_fc = 2 * (2.0 * B * T * T)
    # LSTM: per folded row (B*N) per step, 4 gates of input+recurrent matmul.
    lstm = (
        B * N * T * (8.0 * (C + H) * H + (L - 1) * 8.0 * (H + H) * H)
    )
    # Output graph conv on the (B, N, H) LSTM state.
    out_gconv = 2.0 * K * B * N * N * H + 2.0 * B * N * (K * H) * G
    branch = gate_gconv + gate_fc + lstm + out_gconv
    head = 2.0 * B * N * G * (horizon * C)
    fwd = M * branch + head
    return 3.0 * fwd if backward else fwd


#: dense peak FLOP/s by device-name substring (lower case), per precision
H100_PEAK_FLOPS = {"bf16": 989.4e12, "tf32": 494.7e12, "fp32": 66.9e12}
_PEAKS = (
    ("h100 80gb hbm3", H100_PEAK_FLOPS),  # the SXM card's name
    ("h100 sxm", H100_PEAK_FLOPS),
)


def device_peak_flops(device=None, precision: str = "bf16") -> Optional[float]:
    """Dense peak FLOP/s of a CUDA device at ``precision`` (``"bf16"``,
    ``"tf32"`` or ``"fp32"``); None on the CPU or an unknown card.
    ``device`` is a device (None: the current CUDA device) or a device name
    as ``torch.cuda.get_device_name`` gives it (no card needed)."""
    if precision not in H100_PEAK_FLOPS:
        raise ValueError(f"precision must be one of {sorted(H100_PEAK_FLOPS)}, got {precision!r}")
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        name = device
    else:
        import torch

        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(dev)
    name = name.lower()
    for needle, peaks in _PEAKS:
        if needle in name:
            return peaks[precision]
    return None


def mfu(model_flops: float, step_seconds: float, peak_flops: Optional[float]) -> Optional[float]:
    """Model FLOPs utilization in [0, 1]; None when the peak is unknown."""
    if peak_flops is None or step_seconds <= 0:
        return None
    return model_flops / step_seconds / peak_flops
