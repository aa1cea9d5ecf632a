"""FedAvg server: participation-masked merge + convergence tracking.

Port of :mod:`repro.federated.server`. The merge is McMahan et al.'s
FedAvg restricted to the round's participants (paper §III): equal shards
give the unweighted mean over the participating subset; if nobody
participates the global model is unchanged (cast through float32, as in
the reference). Both backends accumulate in float32:

* ``backend="kernel"`` (the default) — the flat merge of
  :func:`repro_torch.kernels.ops.fedavg_merge`, which on the card launches
  the hand-written ``fedavg_agg`` kernel (on the CPU its plain version);
* ``backend="ref"`` — the reference's per-leaf torch merge.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops

__all__ = ["fedavg_merge", "ConvergenceTracker"]


def fedavg_merge(global_params: dict, client_params: dict,
                 mask: torch.Tensor, weights: torch.Tensor | None = None, *,
                 backend: str | None = None) -> dict:
    """Masked (weighted) average of stacked client params.

    Args:
        global_params: dict of leaves ``(*batch, ...)`` — the fallback when
            k = 0. ``batch`` is empty, or ``(B,)`` for a batch of scenarios.
        client_params: the same leaves with a client axis after the batch,
            ``(*batch, N, ...)``.
        mask: ``(*batch, N)`` bool/0-1 participation.
        weights: optional ``(*batch, N)`` data-size weights (paper: equal
            shards).
        backend: ``"kernel"`` or ``"ref"``; ``None`` resolves through
            :func:`repro_torch.kernels.ops.resolve_backend` (default
            ``"kernel"``).
    """
    m = mask.to(torch.float32)
    if weights is not None:
        m = m * weights.to(torch.float32)
    if kernel_ops.resolve_backend(backend, site="server.fedavg_merge") \
            == "kernel":
        return kernel_ops.fedavg_merge(
            global_params, client_params,
            mask if weights is None else m, backend="kernel")
    nb = mask.dim() - 1
    total = torch.sum(m, dim=-1)
    safe = torch.clamp(total, min=1e-9)

    def merge(g, c):
        tail = (1,) * (g.dim() - nb)
        mexp = m.reshape(m.shape + tail)
        avg = torch.sum(c.to(torch.float32) * mexp, dim=nb) \
            / safe.reshape(safe.shape + tail)
        return torch.where((total > 0).reshape(total.shape + tail), avg,
                           g.to(torch.float32)).to(g.dtype)

    return {k: merge(g, client_params[k]) for k, g in global_params.items()}


@dataclasses.dataclass
class ConvergenceTracker:
    """Paper §IV: converged when val acc >= target for ``needed``
    consecutive rounds. ``target`` is float32 (as in the reference) and is
    compared with a float64 accuracy; the other fields are int32. Every
    field may carry a leading batch axis B."""

    target: torch.Tensor
    needed: torch.Tensor
    streak: torch.Tensor
    converged_at: torch.Tensor      # round index or -1

    @staticmethod
    def create(target: float = 0.73, needed: int = 3, *,
               batch: tuple[int, ...] = (),
               device: str | torch.device = "cuda") -> "ConvergenceTracker":
        dev = resolve_device(device)
        batch = tuple(batch)
        return ConvergenceTracker(
            target=torch.full(batch, target, dtype=torch.float32, device=dev),
            needed=torch.full(batch, needed, dtype=torch.int32, device=dev),
            streak=torch.zeros(batch, dtype=torch.int32, device=dev),
            converged_at=torch.full(batch, -1, dtype=torch.int32, device=dev),
        )

    def update(self, acc: torch.Tensor, round_idx) -> "ConvergenceTracker":
        hit = acc >= self.target.to(torch.float64)
        streak = torch.where(hit, self.streak + 1, 0).to(torch.int32)
        first = (self.converged_at < 0) & (streak >= self.needed)
        round_idx = torch.as_tensor(round_idx, dtype=torch.int32,
                                    device=self.converged_at.device)
        return ConvergenceTracker(
            target=self.target, needed=self.needed, streak=streak,
            converged_at=torch.where(first, round_idx, self.converged_at))

    def masked_update(self, acc: torch.Tensor, round_idx,
                      active: torch.Tensor) -> "ConvergenceTracker":
        """:meth:`update` where ``active``, else unchanged — for round loops
        in which post-convergence rounds are accounting no-ops."""
        return select(active, self.update(acc, round_idx), self)

    @property
    def converged(self) -> torch.Tensor:
        return self.converged_at >= 0


def select(cond: torch.Tensor, on_true, on_false):
    """Field-wise ``torch.where(cond, on_true, on_false)`` of two instances
    of one tensor dataclass; ``cond`` is ``(B,)`` against fields with a
    leading batch axis B (or a scalar)."""
    fields = {}
    for f in dataclasses.fields(on_true):
        t, e = getattr(on_true, f.name), getattr(on_false, f.name)
        c = cond.reshape(cond.shape + (1,) * (t.dim() - cond.dim()))
        fields[f.name] = torch.where(c, t, e)
    return type(on_true)(**fields)
