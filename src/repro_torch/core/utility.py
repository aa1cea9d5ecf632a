"""Player utility (paper eq. 11) and the social objective used for PoA.

Port of :mod:`repro.core.utility`::

    u_i = -E[D] - γ · log(E[δ_i]) - c · p_i

The social cost per node is ``E[D] + c·p``: the AoI incentive is a
transfer paid by the sink and nets out of the welfare comparison.

Probabilities may be tensors or Python floats; floats are taken as
``torch.float64``. The duration table follows the probabilities' device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.aoi import log_aoi
from repro_torch.core.duration import DurationModel
from repro_torch.core.poibin import poibin_pmf

__all__ = [
    "UtilityParams",
    "player_utility",
    "symmetric_player_utility",
    "social_utility",
    "social_cost",
]


@dataclasses.dataclass(frozen=True)
class UtilityParams:
    """Weights of eq. (11)."""

    gamma: float = 0.0   # AoI incentive weight
    cost: float = 0.0    # participation cost factor c
    n_nodes: int = 50


def _f64(x) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor)
            else torch.as_tensor(x, dtype=torch.float64))


def player_utility(p_i, p_others, params: UtilityParams,
                   dur: DurationModel) -> torch.Tensor:
    """u_i of eq. (11) with opponents fixed at ``p_others`` (shape (N-1,))."""
    p_i, p_others = _f64(p_i), _f64(p_others)
    p_vec = torch.cat([p_i.reshape(1), p_others])
    e_d = torch.sum(poibin_pmf(p_vec) * dur.table().to(p_vec.device))
    return -e_d - params.gamma * log_aoi(p_i) - params.cost * p_i


def symmetric_player_utility(p_i, p_sym, params: UtilityParams,
                             dur: DurationModel) -> torch.Tensor:
    """u_i when the other N-1 nodes all play ``p_sym``.

    Uses ``m = X_i + m_-i`` with ``m_-i ~ Binomial(N-1, p_sym)``:
    ``E[D] = p_i·E[d(m_-i + 1)] + (1 - p_i)·E[d(m_-i)]``.
    """
    p_i, p_sym = _f64(p_i), _f64(p_sym)
    n = params.n_nodes
    pmf_others = poibin_pmf(p_sym.expand(n - 1))               # over 0..N-1
    d_tab = dur.table().to(pmf_others.device)                  # (N+1,)
    e_d_without = torch.sum(pmf_others * d_tab[:-1])
    e_d_with = torch.sum(pmf_others * d_tab[1:])
    e_d = p_i * e_d_with + (1.0 - p_i) * e_d_without
    return -e_d - params.gamma * log_aoi(p_i) - params.cost * p_i


def social_utility(p_sym, params: UtilityParams, dur: DurationModel,
                   include_incentive: bool = False) -> torch.Tensor:
    """Per-node utility when everyone plays ``p_sym`` (symmetric profile)."""
    p_sym = _f64(p_sym)
    pmf = poibin_pmf(p_sym.expand(params.n_nodes))
    e_d = torch.sum(pmf * dur.table().to(pmf.device))
    u = -e_d - params.cost * p_sym
    if include_incentive:
        u = u - params.gamma * log_aoi(p_sym)
    return u


def social_cost(p_sym, params: UtilityParams,
                dur: DurationModel) -> torch.Tensor:
    """Per-node social cost E[D] + c·p used in the PoA (eq. 13)."""
    return -social_utility(p_sym, params, dur, include_incentive=False)
