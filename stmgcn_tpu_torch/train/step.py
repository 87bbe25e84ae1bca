"""Train/eval steps, the masked loss, the window gather and the optimizer.

Counterpart of ``stmgcn_tpu/train/step.py`` on one device. The JAX package
jits pure functions over explicit state; here the state is the model's
parameters and an :class:`Optimizer`, and a step runs eagerly:

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
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from stmgcn_tpu_torch.models.params import compute_cast, from_optax_state, to_optax_state

__all__ = [
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
    "train_step",
]

LOSSES = ("mse", "mae", "huber")
#: the leading columns of a health row (:func:`health_row`); the group
#: norms follow in the groups' order
HEALTH_COLUMNS = ("loss", "grad_norm", "update_ratio", "nonfinite_grads", "nonfinite_loss")


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
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place and without a host sync: unchanged while the global norm is below
    ``max_norm``, else every gradient becomes ``g / norm * max_norm``.
    Returns the norm (a device scalar)."""
    grads = [p.grad for p in params if p.grad is not None]
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
    on the host per step, so a cut needs no new program."""

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
        with torch.no_grad():
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        torch._foreach_zero_([p.grad for p in self.params if p.grad is not None])

    def scalars(self, count: int) -> tuple:
        """``(-lr / (1 - b1^t), sqrt(1 - b2^t))`` of the step that starts at
        ``count`` (``t = count + 1``), as ``torch.optim.Adam`` computes
        them."""
        b1, b2 = self.BETAS
        step = float(count + 1)
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
        if self.grad_clip_norm is not None:
            clip_by_global_norm_(self.params, self.grad_clip_norm)
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

    def state_tree(self, names, m_graphs: int, layout: str = "vmapped") -> dict:
        """The optax chain state as the JAX package checkpoints it, with
        ``names`` the ``state_dict`` names of ``self.params`` in order:
        Adam's moments (zeros before the first step) become ``mu``/``nu``
        and :attr:`count` every ``count``."""
        names = list(names)
        mu = dict(zip(names, self.exp_avg, strict=True))
        nu = dict(zip(names, self.exp_avg_sq, strict=True))
        return to_optax_state(self.parts, self.count, mu, nu, m_graphs, layout=layout)

    def load_state_tree(self, tree: dict, names, m_graphs: int) -> None:
        """Install a stored optax chain state (either branch layout): Adam's
        moments, written into the live moment tensors in place (a captured
        step keeps reading them), and :attr:`count`. Raises when the stored
        chain, names or shapes differ from this optimizer's."""
        count, mu, nu = from_optax_state(tree, self.parts, m_graphs)
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
                mask: torch.Tensor) -> torch.Tensor:
    """Mean loss over real elements. ``y`` is ``(B, N, C)`` or ``(B, H, N,
    C)``; ``mask`` is ``(B,)`` (per sample) or ``(B, N)`` (sample x real
    node), 0/1."""
    err = elementwise_loss(kind, pred.float(), y.float())
    if mask.dim() == 1:
        w = mask.reshape(mask.shape + (1,) * (y.dim() - 1))
        denom = mask.sum() * math.prod(y.shape[1:])
    else:
        w = mask[:, None, :, None] if y.dim() == 4 else mask[:, :, None]
        per_node = y.shape[-1] * (y.shape[1] if y.dim() == 4 else 1)
        denom = mask.sum() * per_node
    return (err * w).sum() / denom


def gather_window_batch(series, targets, offsets, idx, horizon: int = 1):
    """A microbatch ``(x, y)`` from the resident series: ``x[b] =
    series[targets[idx[b]] + offsets]`` and ``y[b] = series[targets[idx[b]]
    (+ arange(horizon))]``. Pure index copies, so bit-identical to the
    materialized windows."""
    tgt = targets.index_select(0, idx)
    x = series[tgt[:, None] + offsets[None, :]]
    if horizon == 1:
        return x, series[tgt]
    steps = torch.arange(horizon, device=tgt.device, dtype=tgt.dtype)
    return x, series[tgt[:, None] + steps[None, :]]


def _member_norms(tensors, groups) -> list:
    """Each group's float32 2-norm over ``tensors`` (indexed as
    :func:`~stmgcn_tpu_torch.models.params.health_groups` indexes them, a
    branch member being the slice ``[m]``), and the global norm last."""
    members = [(i, m) for _, group in groups for i, m in group]
    parts = [tensors[i].float() if m is None else tensors[i][m].float() for i, m in members]
    squares = torch.stack(torch._foreach_norm(parts)).square()
    norms, start = [], 0
    for _, group in groups:
        norms.append(torch.sqrt(squares[start:start + len(group)].sum()))
        start += len(group)
    norms.append(torch.sqrt(squares.sum()))
    return norms


@torch.no_grad()
def _before_update(params, groups) -> tuple:
    """What a health row reads before the update clips the gradients and
    writes the parameters in place: the raw gradients' group norms and
    global norm, their non-finite count and the parameters' norm."""
    grads = [p.grad for p in params]
    nonfinite = (~torch.isfinite(torch.cat([g.reshape(-1) for g in grads]))).sum()
    return _member_norms(grads, groups), nonfinite, _member_norms(params, groups)[-1]


@torch.no_grad()
def health_row(loss: torch.Tensor, before: tuple, update, groups) -> torch.Tensor:
    """One step's health stats as a float32 row (:data:`HEALTH_COLUMNS`,
    then the group norms): the loss, the global norm of the raw gradients,
    ‖update‖ / max(‖parameters before the update‖, 1e-12), the
    non-finite entries of the raw gradients and of the loss, and each
    group's gradient norm; every norm in float32. ``before`` is what
    :func:`_before_update` read."""
    (*group_norms, grad_norm), nonfinite, param_norm = before
    ratio = _member_norms(update, groups)[-1] / torch.clamp(param_norm, min=1e-12)
    loss = loss.detach().float()
    return torch.stack([loss, grad_norm, ratio, nonfinite.float(),
                        (~torch.isfinite(loss)).float(), *group_norms])


def train_step(model, optimizer: Optimizer, supports, x, y, mask,
               loss: str = "mse", sr_generator: Optional[torch.Generator] = None,
               n_real: Optional[torch.Tensor] = None,
               scalars: Optional[torch.Tensor] = None, health=None):
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
    update."""
    optimizer.zero_grad()
    if sr_generator is None:
        pred = model(supports, x, n_real)
    else:
        shadow = compute_cast(dict(model.named_parameters()), torch.bfloat16, sr_generator)
        pred = torch.func.functional_call(model, shadow, (supports, x, n_real))
    value = masked_loss(loss, pred, y, mask)
    value.backward()
    before = None if health is None else _before_update(optimizer.params, health)
    update = optimizer.step() if scalars is None else optimizer.apply(scalars)
    if health is not None:
        return value.detach(), health_row(value, before, update, health)
    return value.detach()


@torch.no_grad()
def eval_step(model, supports, x, y, mask, loss: str = "mse",
              n_real: Optional[torch.Tensor] = None):
    """``(loss, prediction)`` without gradients (``n_real`` as
    :func:`train_step`'s)."""
    pred = model(supports, x, n_real)
    return masked_loss(loss, pred, y, mask), pred
