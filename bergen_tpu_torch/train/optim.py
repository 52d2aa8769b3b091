"""Ports of the optax pieces the JAX trainers use: the warmup-cosine
schedule and AdamW with decoupled decay, over a set of trainable leaves
(``multi_transform`` with ``set_to_zero`` for the rest: a frozen leaf has
no moments, no decay and no update).

The arithmetic follows optax 0.2's order and dtypes: the moments in each
leaf's dtype (``mu_dtype`` unset), the bias corrections ``1 - b**count``
in f32 cast to the moment's dtype, the decay added to the scaled update,
and the schedule's value (f32) cast to the leaf's dtype.  The schedule
counts from 0, so the first update uses ``schedule(0)``.
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Callable:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then cosine to ``end_value``
    at ``decay_steps``; count -> f32 value.  Raises as optax does when the
    cosine part has no steps."""
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got"
            f" decay_steps={cos_steps}.")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def linear(count):
        if warmup_steps <= 0:
            return f32(init_value)
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1) - c / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count):
        c = f32(min(count, cos_steps))
        cd = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(cos_steps)))
        decayed = f32(1 - alpha) * cd ** f32(exponent) + f32(alpha)
        return f32(peak_value) * decayed

    def schedule(count: int):
        return linear(count) if count < warmup_steps else cosine(
            count - warmup_steps)

    return schedule


class AdamW:
    """``optax.adamw(schedule, weight_decay)`` (b1 0.9, b2 0.999, eps 1e-8,
    decay on every trainable leaf) on ``params``, a list of tensors updated
    in place."""

    def __init__(self, params: List[torch.Tensor], schedule: Callable,
                 weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = params
        self.schedule = schedule
        self.wd, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        b1, b2 = self.b1, self.b2
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** self.count
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g.to(p.dtype)
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1.to(mu.dtype)) / (
                torch.sqrt(nu / bc2.to(nu.dtype)) + self.eps)
            u = u + self.wd * p
            p.add_(torch.tensor(-lr, dtype=p.dtype, device=p.device) * u)
