"""SGD with optional momentum — the paper's local optimizer (E epochs/round).

Port of :mod:`repro.optim.sgd`: gradients are cast to float32 before the
step, as in the reference; the momentum buffer is float32.
"""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer

__all__ = ["sgd"]


def sgd(lr: float = 0.01, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": {k: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
                       for k, p in params.items()}}

    def update(grads, state, params=None):
        if momentum == 0.0:
            return {k: -lr * g.to(torch.float32)
                    for k, g in grads.items()}, state
        mu = {k: momentum * state["mu"][k] + g.to(torch.float32)
              for k, g in grads.items()}
        return {k: -lr * m for k, m in mu.items()}, {"mu": mu}

    return Optimizer(init=init, update=update)
