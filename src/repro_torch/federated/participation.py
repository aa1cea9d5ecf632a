"""Bernoulli participation (the paper's §III decision process).

Port of :mod:`repro.federated.participation`. Each node holds a fixed
probability p_i and flips an independent coin each round. The reference
draws the coins with ``jax.random.bernoulli(key, p)``, which is
``uniform(key, shape, dtype(p)) < p``; the port takes the uniforms as an
argument and writes the coin as ``uniforms < p``, so the caller owns the
random stream (a ``torch.Generator``, or uniforms handed across).
"""
from __future__ import annotations

import torch

__all__ = ["round_mask", "mask_schedule", "participant_count"]


def round_mask(uniforms: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(N,) bool participation mask for one round from (N,) uniforms in
    [0, 1) drawn in ``p``'s dtype; ``p`` is per node, ``(N,)``."""
    if p.dim() == 0:
        raise ValueError("pass a per-node probability vector, e.g. "
                         "torch.full((n_nodes,), p)")
    return uniforms < p


def mask_schedule(uniforms: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(n_rounds, N) masks from (n_rounds, N) uniforms, one row per round."""
    return uniforms < p


def participant_count(mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(mask.to(torch.int32), dim=-1)
