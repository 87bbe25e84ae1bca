"""``kernel-smem`` and ``kernel-shape``: the hand-written CUDA kernels'
launch budgets on sm_90, from config alone (the Hopper counterpart of the
JAX package's ``analysis/pallas_check.py`` VMEM model).

For every launch a config's shapes give each kernel, a Python mirror of
the launch plans in ``stmgcn_tpu_torch/csrc`` computes its dynamic shared
memory and threads per block:

- ``lstm_fwd_kernel`` (``FwdPlan``, ``fused_lstm_fwd.cu``): 8 warps; the
  two step parities' h tiles of every layer and a ``cp.async`` ring of 2-4
  weight stages;
- ``lstm_bwd_sweep`` (``BwdPlan``, ``fused_lstm_bwd.cu``): 16 warps; the
  h_below/h_prev tiles, the fp32 dgates tile, the cell-state cotangents
  where they fit, and the weight ring; ``lstm_bwd_wgrad`` (``kWSmem``):
  8 warps, three stages of 32-row slabs;
- the block-CSR SpMM kernels (``Plan``, ``spmm_stack.cu``): 8 warps, a
  ring of 64-column stages of a ``(tile, tile)`` block's columns and the
  gathered signal rows, per column tile 16/32/64/128 by the signal width.

Each is held to sm_90's limits (:data:`SM90`): 227 KB of dynamic shared
memory per block after opt-in, 1,024 threads per block, and registers: a
kernel launched one block per SM (``__launch_bounds__(threads, 1)``) may
take ``min(255, 65,536 // threads)`` registers a thread
(:func:`register_budget`), which ``chip_smoke.py`` holds the compiled
kernels' ``cudaFuncGetAttributes`` to, beside their spills. The mirror is
pinned to what the built kernels report (``stmgcn_lstm_*_smem``,
``stmgcn_spmm_plan``) on the card by ``chip_smoke.py``.

``kernel-shape`` flags what the wrappers refuse: an LSTM hidden width
above 256 (the widest kernel width; narrower widths pad up, and more than
four layers chain in groups of at most four) and a tiled plan whose
``tile_size`` the block-CSR kernels do not take. Pure arithmetic: no
torch model, no GPU, no build.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Tuple

from stmgcn_tpu_torch.analysis._configs import finding, preset_configs
from stmgcn_tpu_torch.analysis.report import Finding

__all__ = [
    "FORMS",
    "KERNEL_HIDDEN",
    "KERNEL_MAX_LAYERS",
    "KERNEL_TILES",
    "Launch",
    "SM90",
    "check_kernel_budgets",
    "config_launches",
    "lstm_block_rows",
    "lstm_bwd_smem",
    "lstm_fwd_smem",
    "register_budget",
    "spmm_plan",
]

#: the LSTM kernels' hidden widths and layers per launch
#: (``ops/fused_lstm.py`` ``KERNEL_HIDDEN``, ``KERNEL_MAX_LAYERS``)
KERNEL_HIDDEN = (32, 64, 128, 256)
KERNEL_MAX_LAYERS = 4
#: the block-CSR kernels' tiles (``ops/spmm.py`` ``KERNEL_TILES``) and the
#: block-sparse mode's tile (``ops/spmm.py`` ``TILE``)
KERNEL_TILES = (64, 128)
SPARSE_TILE = 128
#: the LSTM kernels' forms (one library each)
FORMS = ("fp32", "bf16", "xla")
#: an sm_90 (H100) block's and SM's limits
SM90 = {
    "smem_per_block": 232448,  # 227 KB of dynamic shared memory after opt-in
    "threads_per_block": 1024,
    "registers_per_thread": 255,
    "registers_per_sm": 65536,
}

#: the plans' own shared-memory ceiling (``lstm_mma.cuh`` ``kSmemLimit``),
#: which sizes their rings at compile time
K_SMEM_LIMIT = 232448
_WARPS_FWD, _WARPS_SWEEP, _THREADS = 8, 16, 256  # lstm_mma.cuh kThreads
_WGRAD = dict(k=64, c=128, n=32, stages=3, pad=8)  # fused_lstm_bwd.cu kW*
_KC_SPMM = 64  # spmm_stack.cu kKC


def register_budget(threads: int, blocks_per_sm: int = 1) -> int:
    """Registers a thread may take when ``blocks_per_sm`` blocks of
    ``threads`` share an SM's register file."""
    return min(SM90["registers_per_thread"],
               SM90["registers_per_sm"] // (threads * blocks_per_sm))


def _ring_stages(fixed: int, stage: int, cap: int = 4) -> int:
    """``lstm_mma.cuh`` ``ring_stages``: the deepest ring in [2, cap] that
    fits beside ``fixed`` bytes."""
    if cap >= 4 and fixed + 4 * stage <= K_SMEM_LIMIT:
        return 4
    if cap >= 3 and fixed + 3 * stage <= K_SMEM_LIMIT:
        return 3
    return 2


def _tile(H: int, warps: int, bf16: bool) -> dict:
    """``lstm_mma.cuh`` ``Tile``: rows per CTA and shared-memory strides."""
    if H not in KERNEL_HIDDEN:
        raise ValueError(f"H={H}: the LSTM kernels take H in {KERNEL_HIDDEN}")
    wn = 4 if H <= 64 else 8 if warps == 8 else H // 16
    wm = warps // wn
    ut = H // wn // 8
    mt = 32 // (warps * ut)
    return {"threads": 32 * warps, "BR": wm * 16 * mt, "MT": mt, "UT": ut,
            "KC": (16 if H <= 64 else 8) * (2 if bf16 else 1),
            "HS": H + (8 if bf16 else 4), "WS": 4 * H + 8}


def lstm_block_rows(H: int) -> int:
    """Rows per CTA of the LSTM kernels (``stmgcn_lstm_block_rows``)."""
    return _tile(H, _WARPS_FWD, False)["BR"]


def _check_layers(L: int) -> None:
    if not 1 <= L <= KERNEL_MAX_LAYERS:
        raise ValueError(f"L={L}: one launch takes 1..{KERNEL_MAX_LAYERS} layers")


def lstm_fwd_smem(L: int, H: int, form: str = "fp32") -> int:
    """``FwdPlan::smem_bytes`` (``stmgcn_lstm_fwd_smem``): the xla form's is
    the bf16 form's (bf16 products, h tiles and weights)."""
    _check_layers(L)
    bf16 = form != "fp32"
    c, e = _tile(H, _WARPS_FWD, bf16), 2 if bf16 else 4
    hbuf = 2 * L * c["BR"] * c["HS"]
    stage = c["KC"] * c["WS"]
    return e * (hbuf + _ring_stages(e * hbuf, e * stage) * stage)


def lstm_bwd_smem(L: int, H: int, form: str = "fp32") -> int:
    """``BwdPlan::smem_bytes`` of the sweep (``stmgcn_lstm_bwd_smem``), or
    the weight-gradient kernel's ``kWSmem`` at ``L = 0``. The xla form
    stores its h tiles in float32 beside bf16 weights."""
    if L == 0:
        w = _WGRAD
        return 4 * w["stages"] * w["n"] * (w["k"] + w["pad"] + w["c"] + w["pad"])
    _check_layers(L)
    bf16 = form != "fp32"
    c = _tile(H, _WARPS_SWEEP, bf16)
    e, sd = (2 if bf16 else 4), (2 if form == "bf16" else 4)
    hin = 2 * c["BR"] * c["HS"]
    dgt = c["BR"] * (4 * H + 4)
    cp = 16 // e
    stage = max(c["KC"] * c["WS"], H * (4 * c["KC"] + cp), 2 * H * (2 * c["KC"] + cp))
    dc_slots = L * c["MT"] * c["UT"] * 4
    fixed = sd * hin + 4 * dgt
    nt = 32 * _WARPS_SWEEP
    dc_shared = fixed + 4 * dc_slots * nt + 3 * e * stage <= K_SMEM_LIMIT
    dcs = dc_slots * nt if dc_shared else 0
    stages = _ring_stages(fixed + 4 * dcs, e * stage, H // c["KC"] + 1)
    return fixed + 4 * dcs + stages * e * stage


def _column_tile(F: int) -> int:
    return 16 if F <= 16 else 32 if F <= 32 else 64 if F <= 64 else 128


def spmm_plan(tile: int, F: int, bf16: bool = False) -> dict:
    """``Plan`` of the block-CSR instance a launch at ``(tile, F)`` takes
    (``stmgcn_spmm_plan``): column tile, ring stages, dynamic shared memory,
    rows and columns per warp."""
    if tile not in KERNEL_TILES:
        raise ValueError(f"tile={tile}: the block-CSR kernels take tiles {KERNEL_TILES}")
    ft, e = _column_tile(F), (2 if bf16 else 4)
    wm = min(tile // 16, _WARPS_FWD // (ft // 32 if ft >= 32 else 1))
    wn = _WARPS_FWD // wm
    stage = tile * (_KC_SPMM + (8 if bf16 else 4)) + _KC_SPMM * (ft + 8)
    stages = _ring_stages(0, e * stage)
    return {"column_tile": ft, "stages": stages, "smem_bytes": stages * stage * e,
            "warp_rows": tile // (16 * wm) * 16, "warp_cols": ft // (8 * wn) * 8}


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel instance a config launches, with its mirrored budget."""

    kernel: str
    form: str  # "fp32", "bf16" or "xla" (the SpMM's "fp32"/"bf16" storage)
    shape: tuple  # (L, H) for the LSTM kernels, (tile, column tile) for the SpMM
    threads: int
    smem_bytes: int


def _lstm_forms(cfg) -> set:
    """The LSTM forms a config runs: the model's dtype when serving, the
    training precision's when training (the xla or bf16 form by
    ``lstm_backend`` at a bf16 compute dtype)."""
    m = cfg.model
    low = "xla" if m.lstm_backend == "xla" else "bf16"
    forms = {low if m.dtype == "bfloat16" else "fp32"}
    if getattr(cfg.train, "precision", "fp32") == "bf16":
        forms.add(low)
    return forms


def _signal_widths(cfg) -> set:
    """The block-CSR signals' widths ``F`` (batch x features per node): the
    gate conv's ``B * seq_len * C`` and the graph conv's ``B * H`` at the
    training batch and every serving rung."""
    d, m = cfg.data, cfg.model
    seq_len = d.serial_len + d.daily_len + d.weekly_len
    batches = {cfg.train.batch_size, *getattr(cfg.serving, "buckets", ())}
    return {b * f for b in batches for f in (seq_len, m.lstm_hidden_dim)}


def config_launches(cfg) -> Tuple[List[Launch], List[str]]:
    """``(launches, shape problems)``: every kernel instance the config's
    shapes launch, and why a shape cannot launch at all."""
    m = cfg.model
    launches, problems = [], []
    H, L = m.lstm_hidden_dim, m.lstm_num_layers
    if H > KERNEL_HIDDEN[-1]:
        problems.append(f"model.lstm_hidden_dim={H} exceeds the LSTM kernels' widest "
                        f"hidden width {KERNEL_HIDDEN[-1]} — the fused route raises "
                        "(narrower widths pad up to the next kernel width)")
    elif H >= 1 and L >= 1:
        hk = next(w for w in KERNEL_HIDDEN if H <= w)
        groups = sorted({min(KERNEL_MAX_LAYERS, L - g0) for g0 in range(0, L, KERNEL_MAX_LAYERS)})
        for form in sorted(_lstm_forms(cfg)):
            for lg in groups:
                launches.append(Launch("lstm_fwd_kernel", form, (lg, hk), 32 * _WARPS_FWD,
                                       lstm_fwd_smem(lg, hk, form)))
                launches.append(Launch("lstm_bwd_sweep", form, (lg, hk), 32 * _WARPS_SWEEP,
                                       lstm_bwd_smem(lg, hk, form)))
            launches.append(Launch("lstm_bwd_wgrad", form, (0, hk), _THREADS,
                                   lstm_bwd_smem(0, hk, form)))
    tile = m.tile_size if m.tiled else SPARSE_TILE if m.sparse else None
    if tile is not None and tile not in KERNEL_TILES:
        problems.append(f"tile_size={tile}: the block-CSR kernels take tiles {KERNEL_TILES} "
                        "— the first tiled forward raises")
    elif tile is not None:
        bf16 = m.dtype == "bfloat16" or getattr(cfg.train, "precision", "fp32") == "bf16"
        storages = {"fp32" if m.dtype == "float32" else "bf16"} | ({"bf16"} if bf16 else set())
        for storage in sorted(storages):
            for ft in sorted({_column_tile(f) for f in _signal_widths(cfg)}):
                plan = spmm_plan(tile, ft, storage == "bf16")
                for kernel in ("spmm_stack_fwd_kernel", "spmm_stack_bwd_kernel"):
                    launches.append(Launch(kernel, storage, (tile, ft), _THREADS,
                                           plan["smem_bytes"]))
    return launches, problems


def check_kernel_budgets(configs: Optional[Iterable[Tuple[str, object]]] = None
                         ) -> List[Finding]:
    """Every config's kernel launches against :data:`SM90` (default:
    every preset)."""
    findings = []
    for name, cfg in configs if configs is not None else preset_configs():
        launches, problems = config_launches(cfg)
        findings += [finding("kernel-shape", "kernels", name, f"{name}: {p}") for p in problems]
        for k in launches:
            where = f"{name}: {k.kernel} ({k.form}, shape {k.shape})"
            if k.smem_bytes > SM90["smem_per_block"]:
                findings.append(finding(
                    "kernel-smem", "kernels", name,
                    f"{where} needs {k.smem_bytes:,} bytes of dynamic shared memory, past "
                    f"sm_90's {SM90['smem_per_block']:,} a block"))
            if k.threads > SM90["threads_per_block"]:
                findings.append(finding(
                    "kernel-smem", "kernels", name,
                    f"{where} launches {k.threads} threads a block, past sm_90's "
                    f"{SM90['threads_per_block']}"))
    return findings
