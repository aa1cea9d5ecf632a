"""ParticipationController — the paper's mechanism as a framework feature.

Port of the heterogeneous regime of :class:`repro.core.controller.
ParticipationController`: given ``(B, N)`` per-node cost/γ matrices,
:meth:`ParticipationController.solve_batched` returns ``(B, N)`` certified
asymmetric-NE / planner / uniform-γ* profiles, every scenario solved in
:mod:`repro_torch.core.asymmetric_batched`.

Not ported yet, and raising ``NotImplementedError`` that names the
``ROADMAP.md`` item: the symmetric regime (``(B,)`` inputs, which the
reference resolves through ``repro.mechanisms.batched``) and
``mode="coalition"``. ``EnergyParams`` and ``RooflineClock`` come with the
campaign slice.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch.core.asymmetric_batched import (P_MIN, planner_batched,
                                                 poa_report,
                                                 social_cost_batched,
                                                 solve_heterogeneous,
                                                 verify_equilibrium_batched)
from repro_torch.core.duration import DurationModel, paper_duration_model
from repro_torch.device import as_float64, resolve_device

__all__ = ["ParticipationController"]

_SYMMETRIC_TODO = ("the symmetric (B,) regime of solve_batched is not ported "
                   "yet (ROADMAP.md, queue 1: the symmetric solver, "
                   "mechanisms/batched.py and core/game.py); pass (B, N) "
                   "per-node matrices")
_COALITION_TODO = ("mode='coalition' is not ported yet (ROADMAP.md, queue 1: "
                   "coalitions, core/coalition.py)")


@dataclasses.dataclass
class ParticipationController:
    """Chooses the per-node participation probabilities of a fleet.

    Modes (per scenario of a ``(B, N)`` batch):
        "ne"          — best-cost certified asymmetric NE (multistart).
        "ne_worst"    — worst-cost certified NE (the PoA numerator).
        "centralized" — heterogeneity-aware planner optimum.
        "fixed"       — ``fixed_p`` everywhere.
        "mechanism"   — NE induced by the smallest uniform AoI reward γ* on
                        a grid whose heterogeneous PoA meets ``target_poa``.
        "coalition"   — not ported yet.

    ``device`` (default ``"cuda"``) is resolved at construction, so a
    controller asked for the card on a machine without one raises.
    """

    n_nodes: int
    gamma: float = 0.0
    cost: float = 0.0
    mode: Literal["ne", "ne_worst", "centralized", "fixed",
                  "mechanism", "coalition"] = "ne"
    fixed_p: float = 0.5
    duration_model: Optional[DurationModel] = None
    target_poa: float = 1.05
    device: str | torch.device = "cuda"

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.duration_model is None:
            self.duration_model = paper_duration_model()
        if self.duration_model.n_nodes != self.n_nodes:
            raise ValueError(
                f"duration model is for N={self.duration_model.n_nodes}, "
                f"controller has N={self.n_nodes}")

    def solve_batched(
        self,
        gammas=None,
        costs=None,
        mode: str | None = None,
        *,
        gamma_max: float = 5.0,
        coarse: int | None = None,
        **solver_kwargs,
    ) -> torch.Tensor:
        """Participation probabilities for a whole scenario batch.

        Either input must be a ``(B, N)`` matrix of per-node values
        (``N == n_nodes``); the call goes to
        :meth:`solve_batched_heterogeneous` and returns ``(B, N)``.
        ``coarse`` is the mechanism-mode γ-grid size (default 16);
        ``solver_kwargs`` reach the asymmetric engine (``damping``,
        ``max_iters``, ``tol``, ``cert_tol``).
        """
        if (mode or self.mode) == "coalition":
            raise NotImplementedError(_COALITION_TODO)
        if np.ndim(gammas) != 2 and np.ndim(costs) != 2:
            raise NotImplementedError(_SYMMETRIC_TODO)
        if coarse is not None:
            solver_kwargs["coarse"] = coarse
        return self.solve_batched_heterogeneous(
            gammas, costs, mode, gamma_max=gamma_max, **solver_kwargs)

    def solve_batched_heterogeneous(
        self,
        gammas=None,
        costs=None,
        mode: str | None = None,
        *,
        gamma_max: float = 5.0,
        coarse: int = 16,
        cert_tol: float = 1e-3,
        **solver_kwargs,
    ) -> torch.Tensor:
        """Per-node participation matrices for heterogeneous scenario sweeps.

        * ``"ne"`` / ``"ne_worst"`` — damped Gauss-Seidel from three
          starting profiles (0.5, ``P_MIN``, 1.0), every fixed point
          certified on the deviation grid; per scenario the certified NE
          with the lowest / highest social cost wins (fallback: the
          default-start fixed point when nothing certifies within
          ``cert_tol``).
        * ``"centralized"`` — the planner, descending from the
          default-start NE.
        * ``"mechanism"`` — the smallest uniform γ* on a ``coarse``-point
          grid in ``[0, gamma_max]`` whose induced NE has heterogeneous
          PoA ≤ ``target_poa`` (else the best PoA seen); its NE profile.
        * ``"fixed"`` — ``fixed_p`` everywhere.

        Args:
            gammas / costs: per-node values broadcastable to ``(B, N)``
                (``None`` takes this controller's γ / c).
            cert_tol: max profitable deviation for a fixed point to count
                as a certified NE.
            solver_kwargs: forwarded to the asymmetric engine (``damping``,
                ``max_iters``, ``tol``).

        Returns:
            ``(B, N)`` float64 probabilities on ``self.device``.
        """
        mode = mode or self.mode
        dev = self.device
        n = self.n_nodes
        g = torch.atleast_2d(as_float64(
            self.gamma if gammas is None else gammas, dev))
        c = torch.atleast_2d(as_float64(
            self.cost if costs is None else costs, dev))
        g, c = torch.broadcast_tensors(g, c)
        if g.shape[-1] != n:
            raise ValueError(f"per-node arrays have N={g.shape[-1]}, "
                             f"controller has n_nodes={n}")
        b = g.shape[0]
        dur = self.duration_model
        rows = torch.arange(b, device=dev)

        if mode == "fixed":
            return torch.full((b, n), self.fixed_p, dtype=torch.float64,
                              device=dev)

        if mode == "coalition":
            raise NotImplementedError(_COALITION_TODO)

        if mode == "mechanism":
            grid = torch.linspace(0.0, gamma_max, coarse, dtype=torch.float64,
                                  device=dev)
            g_all = (g[:, None, :] + grid[None, :, None]).reshape(-1, n)
            c_all = torch.repeat_interleave(c, coarse, dim=0)
            rep = poa_report(c_all, g_all, dur, device=dev, **solver_kwargs)
            poa = torch.where(rep.solution.converged, rep.poa,
                              float("inf")).reshape(b, coarse)
            ok = poa <= self.target_poa + 1e-9
            first_ok = torch.argmax(ok.to(torch.int8), dim=1)
            best = torch.argmin(poa, dim=1)
            idx = torch.where(ok.any(dim=1), first_ok, best)
            return rep.solution.p.reshape(b, coarse, n)[rows, idx]

        if mode in ("ne", "ne_worst"):
            starts = torch.tensor([0.5, P_MIN, 1.0], dtype=torch.float64,
                                  device=dev)
            s = starts.shape[0]
            c_all = c.repeat(s, 1)
            g_all = g.repeat(s, 1)
            p0 = (torch.repeat_interleave(starts, b)[:, None]
                  * torch.ones((1, n), dtype=torch.float64, device=dev))
            sol = solve_heterogeneous(c_all, g_all, dur, p0=p0, device=dev,
                                      **solver_kwargs)
            deviation = verify_equilibrium_batched(c_all, g_all, dur, sol.p,
                                                   device=dev)
            cost = social_cost_batched(c_all, dur, sol.p, device=dev)
            valid = (sol.converged & (deviation <= cert_tol)).reshape(s, b)
            cost = cost.reshape(s, b)
            if mode == "ne_worst":
                pick = torch.argmax(
                    torch.where(valid, cost, -float("inf")), dim=0)
            else:
                pick = torch.argmin(
                    torch.where(valid, cost, float("inf")), dim=0)
            pick = torch.where(valid.any(dim=0), pick, 0)
            return sol.p.reshape(s, b, n)[pick, rows]

        if mode == "centralized":
            sol = solve_heterogeneous(c, g, dur, device=dev, **solver_kwargs)
            return planner_batched(c, dur, sol.p, device=dev)

        raise ValueError(f"unknown mode {mode!r}")
