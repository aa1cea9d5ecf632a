"""Energy accounting for participatory FL (paper eqs. 1-7).

Port of :mod:`repro.core.energy`, in ``torch.float64``. Per round t and
node i:

    participant:      E_i^t = P_hw * T_train + P_tx * T_tx + P_idle * (T_round - T_train)   (1,2,3,4)
    non-participant:  E_j^t = P_idle * T_round                                              (5)
    round total:      E^t   = sum over all nodes                                            (6)
    task total:       E     = sum_t E^t                                                     (7)

Power constants follow Table I (P_idle = 96.85 W); ``P_hw`` and ``T_train``
are calibrated against Table II (:func:`calibrate_from_table`); ``E_tx``
comes from the 802.11ax airtime model. :class:`EnergyLedger` is a plain
dataclass of tensors whose leaves may carry a leading scenario axis B.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.comm80211ax import (CommParams, PAPER_COMM,
                                          airtime_model,
                                          airtime_model_batched)
from repro_torch.core.duration import PAPER_N_CLIENTS, PAPER_TABLE_II
from repro_torch.device import as_float64, resolve_device

__all__ = [
    "EnergyParams",
    "EnergyLedger",
    "round_energy",
    "expected_round_energy",
    "task_energy",
    "expected_task_energy",
    "calibrate_from_table",
    "per_node_energy_rates",
    "channel_energy_rates",
    "PAPER_MODEL_BYTES",
    "J_PER_WH",
]

PAPER_MODEL_BYTES = 44.73e6  # S_w: ResNet-18 fp32 update, Table I

J_PER_WH = 3600.0


@dataclasses.dataclass(frozen=True)
class EnergyParams:
    """Power/time constants of the energy model (Table I + calibration)."""

    p_idle_w: float = 96.85       # P_idle (Table I)
    p_hw_w: float = 250.0         # P_hw: CPU+GPU+DRAM while training (eq. 1)
    t_round_s: float = 10.0       # T_round (Table I)
    t_train_s: float = 4.0        # T_train (calibrated; <= t_round)
    model_bytes: float = PAPER_MODEL_BYTES
    comm: CommParams = PAPER_COMM

    @property
    def e_tx_j(self) -> float:
        """E_tx = P_tx * T_tx (eq. 2) — constant across rounds/nodes."""
        a = airtime_model(self.model_bytes, self.comm)
        return a["tx_power_w"] * a["t_tx_s"]

    @property
    def e_participant_j(self) -> float:
        """Per-round energy of a participating node (eq. 4)."""
        return (self.p_hw_w * self.t_train_s
                + self.e_tx_j
                + self.p_idle_w * (self.t_round_s - self.t_train_s))

    @property
    def e_idle_j(self) -> float:
        """Per-round energy of a non-participant (eq. 5)."""
        return self.p_idle_w * self.t_round_s


def round_energy(mask: torch.Tensor, params: EnergyParams) -> torch.Tensor:
    """Eq. (6): total energy of one round given the ``(N,)`` participation
    mask, in Joules (a float64 scalar on the mask's device)."""
    mask = mask.to(torch.float64)
    return torch.sum(mask * params.e_participant_j
                     + (1.0 - mask) * params.e_idle_j)


def expected_round_energy(p: torch.Tensor,
                          params: EnergyParams) -> torch.Tensor:
    """E over participation draws of eq. (6); linear in p."""
    p = p.to(torch.float64)
    return torch.sum(p * params.e_participant_j
                     + (1.0 - p) * params.e_idle_j)


def task_energy(round_energies: torch.Tensor) -> torch.Tensor:
    """Eq. (7): sum over rounds."""
    return torch.sum(round_energies)


def expected_task_energy(p: torch.Tensor, expected_rounds,
                         params: EnergyParams) -> torch.Tensor:
    """E[task energy] = E[D] * E[round energy], in Joules (exact when
    participation is iid across rounds, the paper's Fig. 1 linearity)."""
    return expected_rounds * expected_round_energy(p, params)


def per_node_energy_rates(
    params: "EnergyParams | list[EnergyParams] | tuple[EnergyParams, ...]",
    n_nodes: int | None = None,
    *,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flatten per-node :class:`EnergyParams` into raw joule-rate vectors.

    Args:
        params: one shared :class:`EnergyParams` (requires ``n_nodes``) or a
            length-N sequence, one per node (hardware tiers).
        n_nodes: fleet size when ``params`` is a single instance.

    Returns:
        ``(e_participant_j, e_idle_j)`` — two ``(N,)`` float64 tensors on
        ``device``, Joules per round (eq. 4 / eq. 5 per node).
    """
    if isinstance(params, EnergyParams):
        if n_nodes is None:
            raise ValueError("n_nodes required for a single EnergyParams")
        params = [params] * n_nodes
    dev = resolve_device(device)
    e_part = as_float64([e.e_participant_j for e in params], dev)
    e_idle = as_float64([e.e_idle_j for e in params], dev)
    return e_part, e_idle


def channel_energy_rates(
    bits_per_symbol_per_sc,
    params: EnergyParams = EnergyParams(),
    payload_bytes=None,
    *,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Channel-aware per-node joule rates from a per-node MCS vector.

        e_part[i] = P_hw*T_train + E_tx(MCS_i, S_i) + P_idle*(T_round - T_train)
        e_idle[i] = P_idle*T_round

    ``payload_bytes`` (per node or scalar) defaults to
    ``params.model_bytes``. Returns two ``(N,)`` float64 tensors on
    ``device``; at a uniform MCS equal to
    ``params.comm.bits_per_symbol_per_sc`` they equal the scalar
    ``params.e_participant_j`` / ``params.e_idle_j``.
    """
    if payload_bytes is None:
        payload_bytes = params.model_bytes
    a = airtime_model_batched(payload_bytes, bits_per_symbol_per_sc,
                              params.comm, device=device)
    e_tx_j = a["tx_power_w"] * a["t_tx_s"]
    e_part = (params.p_hw_w * params.t_train_s
              + e_tx_j
              + params.p_idle_w * (params.t_round_s - params.t_train_s))
    e_idle = torch.full_like(e_part, params.p_idle_w * params.t_round_s)
    return e_part, e_idle


def calibrate_from_table(
    p_idle_w: float = 96.85,
    t_round_s: float = 10.0,
    n_nodes: int = PAPER_N_CLIENTS,
) -> EnergyParams:
    """Back out (P_hw, T_train) so E(p, d) reproduces Table II(b).

    Per-round extra joules per participant
        x = P_hw*T_train - P_idle*T_train + E_tx
    is the single unknown of E_wh(p, d) = d * [N*P_idle*T_round + N*p*x]
    / 3600; least squares over the table rows gives x, split with
    T_train = 4 s to report P_hw. Host arithmetic in float64 (numpy).
    """
    tab = PAPER_TABLE_II
    p_col, d_col, e_col = tab[:, 0], tab[:, 1], tab[:, 3]
    floor_j = n_nodes * p_idle_w * t_round_s
    y = e_col * J_PER_WH / d_col - floor_j
    a = n_nodes * p_col
    x = float(np.dot(a, y) / np.dot(a, a))
    t_train = 4.0
    e_tx = EnergyParams(p_idle_w=p_idle_w).e_tx_j
    p_hw = (x - e_tx) / t_train + p_idle_w
    return EnergyParams(p_idle_w=p_idle_w, p_hw_w=float(p_hw),
                        t_round_s=t_round_s, t_train_s=t_train)


@dataclasses.dataclass
class EnergyLedger:
    """Running energy account (Joules).

    Attributes (tensors; every leaf may carry a leading batch axis B):
        per_node_j: ``(N,)`` cumulative per-node energy, float64.
        rounds: number of rounds accounted, int64.
        participation_counts: ``(N,)`` how often each node joined, int64.
    """

    per_node_j: torch.Tensor
    rounds: torch.Tensor
    participation_counts: torch.Tensor

    @staticmethod
    def create(n_nodes: int, *, batch: tuple[int, ...] = (),
               device: str | torch.device = "cuda") -> "EnergyLedger":
        dev = resolve_device(device)
        batch = tuple(batch)
        return EnergyLedger(
            per_node_j=torch.zeros(batch + (n_nodes,), dtype=torch.float64,
                                   device=dev),
            rounds=torch.zeros(batch, dtype=torch.int64, device=dev),
            participation_counts=torch.zeros(batch + (n_nodes,),
                                             dtype=torch.int64, device=dev),
        )

    def record_round(self, mask: torch.Tensor,
                     params: EnergyParams) -> "EnergyLedger":
        return self.record_round_j(mask, params.e_participant_j,
                                   params.e_idle_j)

    def record_round_j(self, mask: torch.Tensor, e_participant_j,
                       e_idle_j) -> "EnergyLedger":
        """Record one round from raw per-round joule rates.

        Args:
            mask: ``(..., N)`` bool/0-1 — who participated. Nodes with
                ``mask[i] == False`` (churned-out nodes too) accrue
                ``e_idle_j`` only.
            e_participant_j / e_idle_j: Joules per round, broadcastable
                against ``mask`` (a scalar, ``(N,)`` per node, or
                ``(B, 1)`` / ``(B, N)`` for a batched ledger).
        """
        maskf = mask.to(torch.float64)
        node_j = maskf * e_participant_j + (1.0 - maskf) * e_idle_j
        return EnergyLedger(
            per_node_j=self.per_node_j + node_j,
            rounds=self.rounds + 1,
            participation_counts=self.participation_counts
            + mask.to(torch.int64),
        )

    @property
    def total_j(self) -> torch.Tensor:
        """Task energy in Joules (``(B,)`` for a batched ledger)."""
        return torch.sum(self.per_node_j, dim=-1)

    @property
    def total_wh(self) -> torch.Tensor:
        """Task energy in Watt-hours (``(B,)`` when batched)."""
        return self.total_j / J_PER_WH

    @property
    def per_node_wh(self) -> torch.Tensor:
        """``(N,)`` (or ``(B, N)``) cumulative per-node energy in Wh."""
        return self.per_node_j / J_PER_WH

    def summary(self) -> dict[str, Any]:
        return {
            "total_wh": float(self.total_wh),
            "rounds": int(self.rounds),
            "mean_node_wh": float(torch.mean(self.per_node_j) / J_PER_WH),
            "mean_participation": float(torch.mean(
                self.participation_counts.to(torch.float64)
                / torch.clamp(self.rounds, min=1))),
        }
