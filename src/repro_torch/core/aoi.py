"""Age-of-Information incentive (paper eq. 10).

Port of :func:`repro.core.aoi.expected_aoi`, :func:`repro.core.aoi.log_aoi`
and :class:`repro.core.aoi.AoITracker`. With per-round Bernoulli(p)
participation the expected AoI is the renewal ratio
``E[δ] = E[Y²] / (2 E[Y]) = 1/p − 1/2``; the paper rewards
participation with ``−γ · log E[δ]`` inside the utility. The tracker is
the realized counterpart, one update per FL round.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

__all__ = ["expected_aoi", "log_aoi", "AoITracker"]


def expected_aoi(p: torch.Tensor) -> torch.Tensor:
    """E[δ_i] = 1/p_i − 1/2 (eq. 10). Clipped away from p = 0 for finiteness."""
    p = torch.clamp(p, 1e-9, 1.0)
    return 1.0 / p - 0.5


def log_aoi(p: torch.Tensor) -> torch.Tensor:
    """log E[δ_i]; the incentive term of eq. (11)."""
    return torch.log(expected_aoi(p))


@dataclasses.dataclass
class AoITracker:
    """Per-node realized AoI over a participation sample path.

    Port of :class:`repro.core.aoi.AoITracker`. The age is read mid-round
    (pre-update age + 1/2), so the long-run mean matches the renewal
    formula E[δ] = 1/p − 1/2. Fields are tensors; each may carry a leading
    batch axis B.

    Node churn: :meth:`update` takes an optional ``present`` mask — absent
    nodes are frozen (age and cumulative age untouched, their round not
    counted in ``tracked``), so a node that departs and re-arrives resumes
    the age it left with.

    Attributes:
        age: ``(N,)`` rounds since each node's last participation, float64.
        cum_age: ``(N,)`` sum of mid-round sampled ages, float64.
        rounds: total rounds this tracker has seen, int64.
        tracked: ``(N,)`` rounds each node was present for, int64.
    """

    age: torch.Tensor
    cum_age: torch.Tensor
    rounds: torch.Tensor
    tracked: torch.Tensor

    @staticmethod
    def create(n_nodes: int, *, batch: tuple[int, ...] = (),
               device: str | torch.device = "cuda") -> "AoITracker":
        dev = resolve_device(device)
        batch = tuple(batch)
        nodes = batch + (n_nodes,)
        return AoITracker(
            age=torch.zeros(nodes, dtype=torch.float64, device=dev),
            cum_age=torch.zeros(nodes, dtype=torch.float64, device=dev),
            rounds=torch.zeros(batch, dtype=torch.int64, device=dev),
            tracked=torch.zeros(nodes, dtype=torch.int64, device=dev),
        )

    def update(self, mask: torch.Tensor,
               present: torch.Tensor | None = None) -> "AoITracker":
        """Record one round: sample ages mid-round, reset participants.

        Args:
            mask: ``(..., N)`` bool/0-1 — whose update arrived this round.
            present: optional ``(..., N)`` bool — who was in the fleet.
                Absent nodes are frozen; ``None`` means everyone is present.
        """
        joined = mask.to(torch.bool)
        new_age = torch.where(joined, 0.0, self.age + 1.0)
        new_cum = self.cum_age + self.age + 0.5
        if present is None:
            return AoITracker(age=new_age, cum_age=new_cum,
                              rounds=self.rounds + 1,
                              tracked=self.tracked + 1)
        here = present.to(torch.bool)
        return AoITracker(
            age=torch.where(here, new_age, self.age),
            cum_age=torch.where(here, new_cum, self.cum_age),
            rounds=self.rounds + 1,
            tracked=self.tracked + here.to(self.tracked.dtype),
        )

    @property
    def per_node_aoi(self) -> torch.Tensor:
        """``(N,)`` (or ``(B, N)``) empirical mean age per node, over each
        node's tracked rounds."""
        return self.cum_age / torch.clamp(self.tracked, min=1)

    @property
    def mean_aoi(self) -> torch.Tensor:
        """Fleet-mean realized AoI (``(B,)`` for a batched tracker)."""
        return torch.mean(self.per_node_aoi, dim=-1)
