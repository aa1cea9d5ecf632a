"""Optimizers of the port: SGD (with or without momentum). Port of
:mod:`repro.optim`; ``adamw`` is not ported yet (ROADMAP.md, queue 1)."""
from repro_torch.optim.base import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.optim.sgd import sgd

__all__ = ["Optimizer", "apply_updates", "clip_by_global_norm", "sgd"]
