"""Train/eval steps, the masked loss, the window gather and the optimizer.

Counterpart of ``stmgcn_tpu/train/step.py``, on one device or as one rank
of a mesh. The JAX package jits pure functions over explicit state; here
the state is the model's parameters and an :class:`Optimizer`, and a step
runs eagerly:

- **Optimizer parity** (``make_optimizer``, ``step.py:135-209``): optax's
  chain of global-norm clipping, ``add_decayed_weights`` (L2 added to the
  gradient before the moments, which is how ``torch.optim.Adam``'s
  ``weight_decay`` couples it), Adam (b1 0.9, b2 0.999, eps 1e-8,
  eps_root 0) and ``-lr`` from optax's ``warmup_cosine_decay_schedule``,
  counted in optimizer steps. The clip divides by the norm only past
  ``max_norm``, as optax does (not ``clip_grad_norm_``'s ``norm + 1e-6``).
- **Loss parity** (``_elementwise_loss``/``loss_fn``): MSE, MAE and Huber
  (delta 1) over real elements only, with ``(B,)`` sample masks or
  ``(B, N)`` sample-by-node masks and the same denominator.
- **On a mesh** a rank's step takes its ``rows`` of the batch (and on a
  region mesh its ``nodes``) with the whole batch's mask (the loss over
  the global count, :func:`masked_loss`), and :attr:`Optimizer.sync` sums
  the gradients over the ``dp x region`` group once and gives the clip its
  global norm (``parallel/collectives.py``).
- **Window gather** (``gather_window_batch``): the microbatch is indexed
  out of the device-resident ``(T, N, C)`` series, bit-identical to the
  materialized windows.
- **Mixed precision** (``precision="bf16"``, ``step.py:364-458``): the
  parameters stay float32 masters, which the optimizer owns; the model
  computes in bf16 (the trainer sets its compute dtype, the JAX
  ``model.clone(dtype=bfloat16)``), casting each master at its use site,
  so autograd hands back float32 gradients, and the loss is taken on the
  float32 prediction. With an SR ``generator`` the whole parameter tree is
  cast at entry through ``compute_cast``'s stochastic rounding instead
  (one noise draw per leaf per step), with straight-through gradients.
  Adam, its moments and the loss stay float32.
- **Numeric health** (``_health_stats``, ``step.py:312-362``): with
  ``health`` (the groups of :func:`~stmgcn_tpu_torch.models.params.health_groups`)
  a step also returns one float32 row, :data:`HEALTH_COLUMNS` then one
  norm per group, read off values the step computes anyway: the raw
  gradients and the parameters before the update, and the update
  :meth:`Optimizer.apply` returns. It writes nothing the step reads, so the
  update is bit for bit the plain step's. The counts are exact in float32
  below 2^24 parameters.
- **Sanitizers** (``checks``, the JAX ``CHECK_SETS``, ``step.py:296-309``,
  ``:465-556``): the JAX package checkifies its jitted steps; a captured
  program cannot raise part-way through, so a :class:`Sanitizer` computes
  one int32 flag word per step inside the program, one bit per site of
  :data:`CHECK_SITES`, which the trainer reads back with the losses and
  raises on as :class:`CheckError` after the block, naming the check, the
  step and the site. ``"nan"`` flags a NaN in the LSTM output, either
  graph conv's output, the loss, the gradients or the updated parameters
  (each a reduction; as JAX's ``nan_checks``, an Inf alone is no NaN);
  ``"float"`` adds a zero loss denominator (JAX's ``float_checks``: nan
  and division by zero, not index); ``"index"`` clamps an out-of-range
  window index into range, as a JAX gather does, and flags it (a negative
  index would wrap silently in PyTorch, one past the end trip a device
  assert that kills the CUDA context); ``"all"`` is the three. The eval
  forwards take the same checks. The flags write nothing the step reads,
  so a clean checked step is bitwise the unchecked one, and with
  ``checks=None`` no sanitizer op exists.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from stmgcn_tpu_torch.config import CHECKS
from stmgcn_tpu_torch.models.params import compute_cast, from_optax_state, to_optax_state

__all__ = [
    "CHECK_SETS",
    "CHECK_SITES",
    "CheckError",
    "HEALTH_COLUMNS",
    "LOSSES",
    "Optimizer",
    "clip_by_global_norm_",
    "elementwise_loss",
    "eval_step",
    "gather_window_batch",
    "health_row",
    "lr_schedule",
    "make_optimizer",
    "masked_loss",
    "Sanitizer",
    "sr_shadow",
    "train_step",
]

LOSSES = ("mse", "mae", "huber")
#: the leading columns of a health row (:func:`health_row`); the group
#: norms follow in the groups' order
HEALTH_COLUMNS = ("loss", "grad_norm", "update_ratio", "nonfinite_grads", "nonfinite_loss")
#: the ``checks`` names (``stmgcn_tpu/train/step.py`` ``CHECK_SETS``)
CHECK_SETS = CHECKS[1:]
#: the sites a step's flag word names, bit i for site i, with its check
#: kind, in the order a step reaches them: an error names the lowest set
#: bit, the first site that went wrong
CHECK_SITES = (("window index", "index"), ("LSTM output", "nan"),
               ("graph conv output", "nan"), ("loss denominator", "div"), ("loss", "nan"),
               ("gradients", "nan"), ("updated parameters", "nan"))
_CHECK_KINDS = {"nan": ("nan",), "index": ("index",), "float": ("nan", "div"),
                "all": ("nan", "div", "index")}
_SITE_BIT = {site: bit for bit, (site, _) in enumerate(CHECK_SITES)}
_SITE_TEXT = {"nan": "a NaN in the {site}", "div": "a zero {site}",
              "index": "an out-of-range {site} (clamped)"}


class CheckError(RuntimeError):
    """A sanitizer's flag (``checks``): ``check`` (its name in
    :data:`CHECK_SETS` terms: "nan", "div" or "index"), ``site`` (of
    :data:`CHECK_SITES`) and ``where`` (the block and step)."""

    def __init__(self, check: str, site: str, where: str):
        self.check, self.site, self.where = check, site, where
        super().__init__(f"{check} check failed at {where}: "
                         + _SITE_TEXT[check].format(site=site))

    @classmethod
    def from_word(cls, word: int, where: str) -> "CheckError":
        """The error of a nonzero flag word: its lowest set bit's site."""
        bit = (word & -word).bit_length() - 1
        site, check = CHECK_SITES[bit]
        return cls(check, site, where)


class Sanitizer:
    """The in-program checks of one check set (``checks``, module
    docstring): between :meth:`begin` and :meth:`end` every flag joins the
    open step's int32 flag word on the device; outside them nothing is
    computed. :meth:`watch` hooks a model's LSTMs and graph convs."""

    def __init__(self, checks: str):
        if checks not in CHECK_SETS:
            raise ValueError(f"checks must be one of {CHECK_SETS}, got {checks!r}")
        self.checks = checks
        self.kinds = _CHECK_KINDS[checks]
        self.word: Optional[torch.Tensor] = None

    def begin(self, device) -> None:
        self.word = torch.zeros((), dtype=torch.int32, device=device)

    def end(self) -> torch.Tensor:
        word, self.word = self.word, None
        return word

    def flag(self, site: str, bad: torch.Tensor) -> None:
        """Set ``site``'s bit where the bool scalar ``bad`` holds (its kind
        in this check set, a step open)."""
        if self.word is None or CHECK_SITES[_SITE_BIT[site]][1] not in self.kinds:
            return
        self.word = torch.bitwise_or(self.word, bad.to(torch.int32) << _SITE_BIT[site])

    def nan(self, site: str, tensor: torch.Tensor) -> None:
        if self.word is not None and "nan" in self.kinds:
            self.flag(site, torch.isnan(tensor).any())

    def nan_all(self, site: str, tensors) -> None:
        """One multi-tensor norm: a NaN anywhere makes their sum NaN."""
        if self.word is not None and "nan" in self.kinds:
            self.flag(site, torch.isnan(torch.stack(torch._foreach_norm(list(tensors))).sum()))

    def watch(self, model) -> list:
        """Forward hooks on ``model``'s LSTMs (their output sequence) and
        graph convs (their output); returns the handles."""
        from stmgcn_tpu_torch.ops.chebconv import ChebGraphConv
        from stmgcn_tpu_torch.ops.lstm import StackedLSTM

        handles = []
        for module in model.modules():
            if isinstance(module, StackedLSTM):
                handles.append(module.register_forward_hook(
                    lambda mod, args, out: self.nan("LSTM output", out[0])))
            elif isinstance(module, ChebGraphConv):
                handles.append(module.register_forward_hook(
                    lambda mod, args, out: self.nan("graph conv output", out)))
        return handles


def lr_schedule(lr: float, schedule: str = "none", warmup_steps: int = 0,
                decay_steps: int = 0, min_lr_fraction: float = 0.0) -> Callable[[int], float]:
    """The learning rate at optimizer step ``k`` (0-based), with the JAX
    package's validation: ``"none"`` is constant; ``"cosine"`` is optax's
    ``warmup_cosine_decay_schedule`` (linear warmup from 0, or from ``lr``
    without warmup, then cosine decay to ``lr * min_lr_fraction`` at
    ``decay_steps``)."""
    if not 0.0 <= min_lr_fraction <= 1.0:
        raise ValueError(f"min_lr_fraction must be in [0, 1], got {min_lr_fraction}")
    if schedule == "none":
        if warmup_steps or min_lr_fraction:
            raise ValueError(
                "warmup_steps/min_lr_fraction only apply to schedule='cosine' "
                f"(got schedule='none' with warmup_steps={warmup_steps}, "
                f"min_lr_fraction={min_lr_fraction})"
            )
        return lambda step: lr
    if schedule != "cosine":
        raise ValueError(f"schedule must be none|cosine, got {schedule!r}")
    if decay_steps <= 0:
        raise ValueError("schedule='cosine' needs decay_steps > 0")
    if warmup_steps >= decay_steps:
        raise ValueError(
            f"warmup_steps ({warmup_steps}) must be shorter than the run "
            f"(decay_steps={decay_steps})"
        )
    init = 0.0 if warmup_steps else lr
    end = lr * min_lr_fraction
    alpha = 0.0 if lr == 0.0 else end / lr
    span = decay_steps - warmup_steps

    def at(step: int) -> float:
        if step < warmup_steps:  # optax linear_schedule(init, lr, warmup_steps)
            frac = 1.0 - min(step, warmup_steps) / warmup_steps
            return (init - lr) * frac + lr
        count = min(step - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / span))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return at


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float, sync=None) -> torch.Tensor:
    """optax ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place and without a host sync: unchanged while the global norm is below
    ``max_norm``, else every gradient becomes ``g / norm * max_norm``.
    Returns the norm (a device scalar). On a mesh, ``sync`` (a
    :class:`~stmgcn_tpu_torch.parallel.collectives.GradSync`) gives the
    norm over every rank's branch slices."""
    grads = [p.grad for p in params if p.grad is not None]
    if sync is not None:
        norm = torch.sqrt(sync.norm_sq(grads))
    else:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class Optimizer:
    """Adam with L2 regularization, clipping and a schedule, with optax's
    semantics (see the module docstring), over device tensors only, so a
    CUDA graph can capture its update (:meth:`apply`).

    The moments are allocated (zeros) here, and so is every parameter's
    ``.grad`` that is missing: the gradients stay allocated, :meth:`zero_grad`
    zeroes them in place, and autograd accumulates into them, so a captured
    step always reads and writes the same tensors. :attr:`count` (optax's
    ``count``, the schedule's input) is kept on the host, which fills each
    step's scalars (:meth:`scalars`): the scheduled rate over Adam's first
    bias correction, negated, and the square root of the second, computed
    in float64 as ``torch.optim.Adam`` computes them and rounded once to
    float32. The update follows ``torch.optim.Adam``'s single-tensor
    arithmetic op for op, so on the CPU it gives the same bits.

    ``parts`` names the optax chain this optimizer stands for, in chain
    order (``models/params.py`` ``OPTAX_PARTS``): checkpoints store the
    state per part, as the JAX package does (:meth:`state_tree`,
    :meth:`load_state_tree`).

    :attr:`lr_scale` multiplies the scheduled rate in :meth:`scalars` (the
    divergence guard's cumulative ``lr_cut``, which the JAX trainer applies
    by rebuilding its optimizer at ``lr * scale``): the scalars are filled
    on the host per step, so a cut needs no new program.

    On a mesh, :attr:`sync` (a
    :class:`~stmgcn_tpu_torch.parallel.collectives.GradSync`) sums the
    gradients over ``dp`` at the start of every update, once a step (the
    float32 master gradients at either precision), and gives the clip its
    global norm; the moments and the update are then each rank's own, as
    its parameters are (replicated, or its branch slice)."""

    BETAS, EPS = (0.9, 0.999), 1e-8

    def __init__(self, params, lr: float, weight_decay: float,
                 schedule: Callable[[int], float], grad_clip_norm: Optional[float],
                 parts: tuple):
        self.params = list(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.parts = tuple(parts)
        #: optimizer steps taken (optax's ``count``: the schedule's input)
        self.count = 0
        #: factor on the scheduled learning rate (1.0: none)
        self.lr_scale = 1.0
        #: the mesh's gradient sync (None: one device)
        self.sync = None
        self._synced = False  # sync_grads ran in the step under way
        with torch.no_grad():
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        torch._foreach_zero_([p.grad for p in self.params if p.grad is not None])
        self._synced = False

    def sync_grads(self) -> None:
        """Sum the gradients over the mesh's replicas (:attr:`sync`; a
        no-op on one device), once a step: :meth:`apply` does it unless the
        step did it already, to read the summed gradients (health,
        checks)."""
        if self.sync is not None and not self._synced:
            self.sync.reduce([p.grad for p in self.params])
            self._synced = True

    def scalars(self, count: int) -> tuple:
        """``(-lr / (1 - b1^t), sqrt(1 - b2^t))`` of the step that starts at
        ``count`` (``t = count + 1``), as ``torch.optim.Adam`` computes
        them."""
        b1, b2 = self.BETAS
        step = float(count + 1)  # stmgcn: ignore[host-sync-in-jit] a host int
        rate = self.lr_scale * self.schedule(count)
        return (-(rate / (1 - b1 ** step)), (1 - b2 ** step) ** 0.5)

    @torch.no_grad()
    def apply(self, scalars: torch.Tensor) -> list:
        """One update from the parameters' ``.grad`` and ``scalars``, a
        float32 device tensor ``(2,)`` holding :meth:`scalars`; leaves
        :attr:`count` to the caller. Launches kernels only (capturable).
        Returns the update added to each parameter (optax's ``updates``,
        after the clip, the L2 term and Adam)."""
        b1, b2 = self.BETAS
        for p in self.params:
            if p.grad is None:
                raise RuntimeError("Optimizer.apply: a parameter has no .grad")
        self.sync_grads()
        self._synced = False
        if self.grad_clip_norm is not None:
            clip_by_global_norm_(self.params, self.grad_clip_norm, self.sync)
        grads = [p.grad for p in self.params]
        if self.weight_decay:
            grads = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
        torch._foreach_lerp_(self.exp_avg, grads, 1 - b1)
        torch._foreach_mul_(self.exp_avg_sq, b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, value=1 - b2)
        denom = torch._foreach_sqrt(self.exp_avg_sq)
        torch._foreach_div_(denom, scalars[1])
        torch._foreach_add_(denom, self.EPS)
        update = torch._foreach_mul(self.exp_avg, scalars[0])
        torch._foreach_div_(update, denom)
        torch._foreach_add_(self.params, update)
        return update

    def step(self) -> list:
        """One eager update: a missing ``.grad`` steps on zeros, as under
        ``jax.grad`` (its L2 term still applies). Returns the update, as
        :meth:`apply`."""
        with torch.no_grad():
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        device = self.params[0].device if self.params else "cpu"
        update = self.apply(torch.tensor(self.scalars(self.count), dtype=torch.float32)
                            .to(device))
        self.count += 1
        return update

    def state_tree(self, names, m_graphs: int, layout: str = "vmapped",
                   gather=None) -> dict:
        """The optax chain state as the JAX package checkpoints it, with
        ``names`` the ``state_dict`` names of ``self.params`` in order:
        Adam's moments (zeros before the first step) become ``mu``/``nu``
        and :attr:`count` every ``count``. ``gather`` (a branch mesh's
        ``MeshPlacement.state_gather``) makes each moment dict the whole,
        mesh-free one first."""
        names = list(names)
        mu = dict(zip(names, self.exp_avg, strict=True))
        nu = dict(zip(names, self.exp_avg_sq, strict=True))
        if gather is not None:
            mu, nu = gather(mu, "moments"), gather(nu, "moments")
        return to_optax_state(self.parts, self.count, mu, nu, m_graphs, layout=layout)

    def load_state_tree(self, tree: dict, names, m_graphs: int,
                        branches: Optional[slice] = None) -> None:
        """Install a stored optax chain state (either branch layout): Adam's
        moments, written into the live moment tensors in place (a captured
        step keeps reading them), and :attr:`count`; ``branches``: a branch
        mesh rank's slice of the stacked moments. Raises when the stored
        chain, names or shapes differ from this optimizer's."""
        count, mu, nu = from_optax_state(tree, self.parts, m_graphs, branches)
        names = list(names)
        if set(mu) != set(names):
            raise ValueError(
                f"optimizer state: moments for {sorted(set(mu) ^ set(names))} do not "
                "match the parameters")
        for name, p in zip(names, self.params, strict=True):
            if tuple(mu[name].shape) != tuple(p.shape):
                raise ValueError(f"optimizer state: {name} is {tuple(mu[name].shape)}, the "
                                 f"parameter {tuple(p.shape)}")
        with torch.no_grad():
            for name, m, v in zip(names, self.exp_avg, self.exp_avg_sq):
                m.copy_(mu[name])
                v.copy_(nu[name])
        self.count = count


def make_optimizer(params, lr: float, weight_decay: float = 0.0, schedule: str = "none",
                   warmup_steps: int = 0, decay_steps: int = 0,
                   min_lr_fraction: float = 0.0,
                   grad_clip_norm: Optional[float] = None) -> Optimizer:
    """An :class:`Optimizer` over ``params``; arguments as the JAX
    package's ``make_optimizer``."""
    if grad_clip_norm is not None and grad_clip_norm <= 0:
        raise ValueError(f"grad_clip_norm must be > 0, got {grad_clip_norm}")
    sched = lr_schedule(lr, schedule, warmup_steps, decay_steps, min_lr_fraction)
    parts = (("clip",) if grad_clip_norm is not None else ()) + (
        ("l2",) if weight_decay else ()) + (
        "adam", "schedule" if schedule == "cosine" else "scale")
    return Optimizer(params, lr, weight_decay, sched, grad_clip_norm, parts)


def elementwise_loss(kind: str, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    if kind == "mse":
        return torch.square(pred - target)
    if kind == "mae":
        return torch.abs(pred - target)
    if kind == "huber":  # optax.losses.huber_loss, delta 1
        abs_err = torch.abs(pred - target)
        quadratic = torch.clamp(abs_err, max=1.0)
        return 0.5 * quadratic * quadratic + (abs_err - quadratic)
    raise ValueError(f"loss must be one of {LOSSES}, got {kind!r}")


def masked_loss(kind: str, pred: torch.Tensor, y: torch.Tensor,
                mask: torch.Tensor, sanitizer: Optional[Sanitizer] = None,
                rows: Optional[slice] = None, nodes: Optional[slice] = None) -> torch.Tensor:
    """Mean loss over real elements. ``y`` is ``(B, N, C)`` or ``(B, H, N,
    C)``; ``mask`` is ``(B,)`` (per sample) or ``(B, N)`` (sample x real
    node), 0/1. ``sanitizer`` flags a zero denominator and a NaN loss.

    On a ``dp`` mesh ``pred`` and ``y`` are a rank's ``rows`` of the
    global batch and ``mask`` the whole batch's: the value is the rank's
    error sum over the *global* count of real elements, so the ranks'
    values (and gradients) sum to the single-device mean, a padded tail
    batch included. On a region mesh ``nodes`` are the rank's node rows of
    ``pred`` and ``y`` and ``mask`` is the whole ``(B, N)`` one."""
    err = elementwise_loss(kind, pred.float(), y.float())
    local = mask if rows is None else mask[rows]
    if nodes is not None:
        if mask.dim() != 2:
            raise ValueError("a region mesh's loss takes the (B, N) sample x node mask")
        local = local[:, nodes]
    if mask.dim() == 1:
        w = local.reshape(local.shape + (1,) * (y.dim() - 1))
        denom = mask.sum() * math.prod(y.shape[1:])
    else:
        w = local[:, None, :, None] if y.dim() == 4 else local[:, :, None]
        per_node = y.shape[-1] * (y.shape[1] if y.dim() == 4 else 1)
        denom = mask.sum() * per_node
    if sanitizer is None:
        return (err * w).sum() / denom
    sanitizer.flag("loss denominator", denom == 0)
    value = (err * w).sum() / denom
    sanitizer.nan("loss", value)
    return value


def gather_window_batch(series, targets, offsets, idx, horizon: int = 1,
                        sanitizer: Optional[Sanitizer] = None):
    """A microbatch ``(x, y)`` from the resident series: ``x[b] =
    series[targets[idx[b]] + offsets]`` and ``y[b] = series[targets[idx[b]]
    (+ arange(horizon))]``. Pure index copies, so bit-identical to the
    materialized windows. Under an ``"index"`` sanitizer every index is
    clamped into range first, and one out of range is flagged."""
    if sanitizer is not None and "index" in sanitizer.kinds:
        return _checked_gather(series, targets, offsets, idx, horizon, sanitizer)
    tgt = targets.index_select(0, idx)
    x = series[tgt[:, None] + offsets[None, :]]
    if horizon == 1:
        return x, series[tgt]
    steps = torch.arange(horizon, device=tgt.device, dtype=tgt.dtype)
    return x, series[tgt[:, None] + steps[None, :]]


def _checked_gather(series, targets, offsets, idx, horizon, sanitizer):
    """:func:`gather_window_batch` with every index clamped, as a JAX gather
    clamps, and the window-index flag set when one was out of range."""
    n, T = targets.shape[0], series.shape[0]
    steps = offsets[None, :] if horizon == 1 else torch.cat(
        [offsets, torch.arange(horizon, device=offsets.device, dtype=offsets.dtype)])[None, :]
    bad = ((idx < 0) | (idx >= n)).any()
    tgt = targets.index_select(0, idx.clamp(0, n - 1))
    pos = tgt[:, None] + steps
    bad = bad | ((tgt < 0) | (tgt >= T)).any() | ((pos < 0) | (pos >= T)).any()
    sanitizer.flag("window index", bad)
    pos = pos.clamp(0, T - 1)
    x = series[pos[:, :offsets.shape[0]]]
    if horizon == 1:
        return x, series[tgt.clamp(0, T - 1)]
    return x, series[pos[:, offsets.shape[0]:]]


def _member_squares(tensors, groups, branches: Optional[slice] = None) -> torch.Tensor:
    """Each group member's float32 sum of squares over ``tensors``
    (indexed as :func:`~stmgcn_tpu_torch.models.params.health_groups`
    indexes them, a branch member being the slice ``[m]``), as one vector
    in the groups' order. ``branches``: a branch mesh rank's slice of the
    stacked branches, whose tensors hold only those: a member ``[m]`` of
    another rank's counts 0 here, a whole stacked tensor its local slice."""
    parts = []
    for _, group in groups:
        for i, m in group:
            t = tensors[i]
            if m is not None and branches is not None:
                t = t[m - branches.start] if branches.start <= m < branches.stop else t[:0]
            elif m is not None:
                t = t[m]
            parts.append(t.float())
    return torch.stack(torch._foreach_norm(parts)).square()


def _norms(squares: torch.Tensor, groups) -> list:
    """Each group's 2-norm from its members' squares
    (:func:`_member_squares`), and the global norm last."""
    norms, start = [], 0
    for _, group in groups:
        norms.append(torch.sqrt(squares[start:start + len(group)].sum()))
        start += len(group)
    norms.append(torch.sqrt(squares.sum()))
    return norms


def _nonfinite(tensors) -> torch.Tensor:
    if not tensors:
        return torch.zeros((), dtype=torch.int64)
    return (~torch.isfinite(torch.cat([t.reshape(-1) for t in tensors]))).sum()


def _branch_split(sync) -> Optional[slice]:
    """The rank's slice of the stacked branches when ``sync`` (a mesh's
    :class:`~stmgcn_tpu_torch.parallel.collectives.GradSync`) has branch
    slices among its parameters, else None."""
    return None if sync is None or not any(sync.sharded) else sync.branches


@torch.no_grad()
def _before_update(params, groups, sync=None) -> tuple:
    """What a health row reads before the update clips the gradients and
    writes the parameters in place: the raw gradients' member squares and
    non-finite count, and the parameters' member squares. On a branch mesh
    (``sync`` with branch slices) each is this rank's part, the non-finite
    count split ``(branch slices, replicated)``: :func:`health_row` sums
    them over ``branch``."""
    grads = [p.grad for p in params]
    branches = _branch_split(sync)
    if branches is None:
        nonfinite = _nonfinite(grads)
    else:
        nonfinite = torch.stack([
            _nonfinite([g for g, s in zip(grads, sync.sharded) if s]).to(grads[0].device),
            _nonfinite([g for g, s in zip(grads, sync.sharded) if not s]).to(grads[0].device)])
    return (_member_squares(grads, groups, branches), nonfinite,
            _member_squares(params, groups, branches))


@torch.no_grad()
def health_row(loss: torch.Tensor, before: tuple, update, groups, sync=None) -> torch.Tensor:
    """One step's health stats as a float32 row (:data:`HEALTH_COLUMNS`,
    then the group norms): the loss, the global norm of the raw gradients,
    ‖update‖ / max(‖parameters before the update‖, 1e-12), the
    non-finite entries of the raw gradients and of the loss, and each
    group's gradient norm; every norm in float32. ``before`` is what
    :func:`_before_update` read. On a mesh the gradients were summed
    before it read them; on a branch mesh (``sync`` with branch slices)
    the branch slices' squares and counts are summed over ``branch`` here,
    in one all-reduce, and the replicated parameters' counted once (as
    :meth:`~stmgcn_tpu_torch.parallel.collectives.GradSync.norm_sq`)."""
    grad_sq, nonfinite, param_sq = before
    branches = _branch_split(sync)
    update_sq = _member_squares(update, groups, branches)
    if branches is not None:
        sharded = torch.tensor([sync.sharded[i] for _, group in groups for i, _ in group],
                               device=grad_sq.device)
        n = sharded.numel()
        packed = torch.cat([grad_sq, param_sq, update_sq, nonfinite.float()])
        mask = torch.cat([sharded, sharded, sharded,
                          torch.tensor([True, False], device=grad_sq.device)])
        packed = sync.branch_sum(packed, mask)
        grad_sq, param_sq, update_sq = packed[:n], packed[n:2 * n], packed[2 * n:3 * n]
        nonfinite = packed[3 * n:].sum()
    *group_norms, grad_norm = _norms(grad_sq, groups)
    ratio = torch.sqrt(update_sq.sum()) / torch.clamp(torch.sqrt(param_sq.sum()), min=1e-12)
    loss = loss.detach().float()
    return torch.stack([loss, grad_norm, ratio, nonfinite.float(),
                        (~torch.isfinite(loss)).float(), *group_norms])


def sr_shadow(model, generator: torch.Generator) -> dict:
    """``model``'s parameters stochastically rounded to bf16 from
    ``generator`` (``compute_cast``, one noise draw per leaf); on a branch
    mesh (``model.placement``) each stacked leaf's noise drawn at the
    whole stack's shape and cut to the rank's branches, so the rank's
    shadow is one device's slice, bit for bit."""
    params = dict(model.named_parameters())
    placement = getattr(model, "placement", None)
    if placement is None or placement.branch == 1:
        return compute_cast(params, torch.bfloat16, generator)
    return compute_cast(params, torch.bfloat16, generator, m_graphs=model.m_graphs,
                        branches=placement.branches(model.m_graphs))


def train_step(model, optimizer: Optimizer, supports, x, y, mask,
               loss: str = "mse", sr_generator: Optional[torch.Generator] = None,
               n_real: Optional[torch.Tensor] = None,
               scalars: Optional[torch.Tensor] = None, health=None,
               sanitizer: Optional[Sanitizer] = None, rows: Optional[slice] = None,
               nodes: Optional[slice] = None, grad_check: Optional[Callable] = None):
    """One optimizer step; returns the (device, detached) loss, unsynced.
    With ``sr_generator`` the model runs on a stochastically rounded bf16
    shadow of its parameters (``compute_cast``), drawn from it. With
    ``scalars`` (the step's :meth:`Optimizer.scalars` on the device) the
    update is :meth:`Optimizer.apply` and launches kernels only, as a
    captured step must; without, :meth:`Optimizer.step`.

    A fleet city's step (``make_fleet_superstep_fns``' body,
    ``stmgcn_tpu/train/step.py:809-930``) passes its rung-padded
    ``supports``, a batch gathered from its class's series, a ``(B, N_c)``
    ``mask`` and ``n_real``, the int real-node count the gate pools over.

    With ``health`` (the parameters' groups, :func:`health_groups`) it
    returns ``(loss, health row)`` (:func:`health_row`) from the same
    update. ``sanitizer`` (a step open on it) adds the step's flags: the
    loss's, the gradients' and the updated parameters' here, the model's
    through its hooks. ``rows`` and ``nodes``: a mesh rank's rows of the
    batch and node rows (:func:`masked_loss`); the optimizer's ``sync``
    sums the gradients before the checks and the health stats read them,
    and on a branch mesh the stochastic rounding draws each stacked leaf's
    noise at the whole stack's shape (``compute_cast``'s ``branches``), so
    a rank rounds its slice as one device does. ``grad_check`` (the
    trainer's ``debug_nans`` on a mesh) is called with the summed
    gradients."""
    optimizer.zero_grad()
    if sr_generator is None:
        pred = model(supports, x, n_real)
    else:
        pred = torch.func.functional_call(model, sr_shadow(model, sr_generator),
                                          (supports, x, n_real))
    value = masked_loss(loss, pred, y, mask, sanitizer, rows, nodes)
    value.backward()
    optimizer.sync_grads()
    grads = [p.grad for p in optimizer.params]
    if grad_check is not None:
        grad_check(grads)
    if sanitizer is not None:
        sanitizer.nan_all("gradients", grads)
    before = None if health is None else _before_update(optimizer.params, health,
                                                        optimizer.sync)
    update = optimizer.step() if scalars is None else optimizer.apply(scalars)
    if sanitizer is not None:
        sanitizer.nan_all("updated parameters", optimizer.params)
    if health is not None:
        return value.detach(), health_row(value, before, update, health, optimizer.sync)
    return value.detach()


@torch.no_grad()
def eval_step(model, supports, x, y, mask, loss: str = "mse",
              n_real: Optional[torch.Tensor] = None, sanitizer: Optional[Sanitizer] = None,
              rows: Optional[slice] = None, nodes: Optional[slice] = None):
    """``(loss, prediction)`` without gradients (``n_real``, ``sanitizer``,
    ``rows`` and ``nodes`` as :func:`train_step`'s)."""
    pred = model(supports, x, n_real)
    return masked_loss(loss, pred, y, mask, sanitizer, rows, nodes), pred
