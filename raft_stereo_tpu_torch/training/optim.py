"""Optimizer and LR schedule (the port of ``raft_stereo_tpu.training.optim``).

AdamW (betas 0.9/0.999, eps 1e-8, decoupled weight decay on every
parameter) under a global-norm gradient clip of 1.0, with torch's
two-phase linear OneCycle schedule: ``pct_start=0.01`` warmup from
``peak/div_factor`` to ``peak``, then a linear anneal to
``peak/div_factor/final_div_factor``, over ``updates + 100`` steps.

The JAX package composes this from optax transforms; here it is
:class:`Optimizer`, which reproduces what those transforms compute:

* the clip is optax's ``clip_by_global_norm``: gradients pass unchanged
  when their global norm is below 1, else each is divided by the norm
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``);
* the LR is read at the optimizer's update count, which starts at 0 and
  advances only when an update is applied (optax ``scale_by_schedule``);
* ``grad_accum_steps = k > 1`` averages the gradients of k micro-steps
  (a running mean, as ``optax.MultiSteps`` keeps it) and applies one
  clipped update on the k-th.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from raft_stereo_tpu_torch.config import TrainConfig


def _linear_schedule(init: float, end: float,
                     steps: int) -> Callable[[int], float]:
    """optax's linear schedule, evaluated in fp32 as optax evaluates it."""
    if steps <= 0:
        return lambda count: init
    f32 = np.float32

    def schedule(count: int) -> float:
        frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
        return float(f32(init - end) * frac + f32(end))
    return schedule


def one_cycle_lr(peak_lr: float, total_steps: int, pct_start: float = 0.01,
                 div_factor: float = 25.0, final_div_factor: float = 1e4
                 ) -> Callable[[int], float]:
    """torch ``OneCycleLR(anneal_strategy='linear', cycle_momentum=False)``
    as a function of the update count (``initial_lr`` at count 0)."""
    initial_lr = peak_lr / div_factor
    min_lr = initial_lr / final_div_factor
    warmup_steps = max(int(round(pct_start * total_steps)) - 1, 1)
    warmup = _linear_schedule(initial_lr, peak_lr, warmup_steps)
    anneal = _linear_schedule(peak_lr, min_lr, total_steps - 1 - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return warmup(count)
        return anneal(count - warmup_steps)
    return schedule


def fetch_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The LR schedule :class:`Optimizer` applies. ``cfg.num_steps`` counts
    micro-steps; the schedule's horizon is the number of updates."""
    k = max(cfg.grad_accum_steps, 1)
    n_updates = -(-cfg.num_steps // k)
    return one_cycle_lr(cfg.lr, n_updates + 100)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """fp32 L2 norm of all ``grads`` together."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        max_norm: float = 1.0) -> List[torch.Tensor]:
    """optax's clip: unchanged when the global norm is below ``max_norm``,
    else every gradient times ``max_norm`` over the norm."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for g in grads]


class Optimizer:
    """Clip, AdamW at the OneCycle LR, and gradient accumulation, over a
    fixed list of parameters.

    ``step(grads)`` takes one micro-step's gradients, in the order of
    ``params``; it returns True when it applied an update.
    """

    def __init__(self, params: Sequence[torch.nn.Parameter],
                 cfg: TrainConfig):
        self.params = list(params)
        self.schedule = fetch_schedule(cfg)
        self.accum_steps = max(cfg.grad_accum_steps, 1)
        self.adamw = torch.optim.AdamW(
            self.params, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.wdecay)
        #: applied updates: the LR schedule's position
        self.count = 0
        #: micro-steps accumulated towards the next update
        self.mini_step = 0
        self._acc: List[torch.Tensor] = []

    @property
    def lr(self) -> float:
        """The LR the next applied update will use."""
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        grads = [g.float() for g in grads]
        if self.accum_steps > 1:
            if not self._acc:
                self._acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            self._acc = [a + (g - a) / (n + 1)
                         for a, g in zip(self._acc, grads)]
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                return False
            grads, self._acc = self._acc, []
        for p, g in zip(self.params, clip_by_global_norm(grads)):
            p.grad = g.to(p.dtype)
        for group in self.adamw.param_groups:
            group["lr"] = self.lr
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1
        return True


def fetch_optimizer(cfg: TrainConfig,
                    params: Sequence[torch.nn.Parameter]) -> Optimizer:
    """AdamW + OneCycle + global-norm clip over ``params`` (every
    parameter gets weight decay, as in the reference)."""
    return Optimizer(params, cfg)
