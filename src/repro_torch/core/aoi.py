"""Age-of-Information incentive (paper eq. 10).

Port of :func:`repro.core.aoi.expected_aoi` and :func:`repro.core.aoi.log_aoi`.
With per-round Bernoulli(p) participation the expected AoI is the renewal
ratio ``E[δ] = E[Y²] / (2 E[Y]) = 1/p − 1/2``; the paper rewards
participation with ``−γ · log E[δ]`` inside the utility.
"""
from __future__ import annotations

import torch

__all__ = ["expected_aoi", "log_aoi"]


def expected_aoi(p: torch.Tensor) -> torch.Tensor:
    """E[δ_i] = 1/p_i − 1/2 (eq. 10). Clipped away from p = 0 for finiteness."""
    p = torch.clamp(p, 1e-9, 1.0)
    return 1.0 / p - 0.5


def log_aoi(p: torch.Tensor) -> torch.Tensor:
    """log E[δ_i]; the incentive term of eq. (11)."""
    return torch.log(expected_aoi(p))
