"""Optimizer interface: ``init(params) -> state``;
``update(grads, state, params) -> (updates, state)``.

Port of :mod:`repro.optim.base`. Parameters, gradients, updates and
states are flat dicts of tensors (the port's pytrees). The reference's
float32 round trips are kept: updates are added in float32 and the sum is
stored back in each parameter's dtype, so float64 parameters hold float32
values after every step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["Optimizer", "clip_by_global_norm", "apply_updates"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable          # params -> opt_state
    update: Callable        # (grads, opt_state, params) -> (updates, opt_state)


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale ``grads`` so their global float32 norm is at most
    ``max_norm``; returns ``(clipped, norm)``."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, norm


def apply_updates(params: dict, updates: dict) -> dict:
    """``params + updates``, added in float32, in each parameter's dtype."""
    return {k: (p.to(torch.float32) + updates[k].to(torch.float32)).to(p.dtype)
            for k, p in params.items()}
