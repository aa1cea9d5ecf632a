"""End-to-end participatory-FL simulation with energy metering (paper §IV).

Port of :mod:`repro.federated.simulation`. One round = (participation
masks) → (local training of every client) → (masked FedAvg merge) →
(validation) → (energy ledger) → (convergence check).

* :func:`run_simulation` — the B = 1 case of the campaign engine
  (:func:`repro_torch.federated.campaign.run_campaigns`).
* :func:`run_simulation_reference` and :func:`run_heterogeneous_reference`
  — the port's own oracles: one scenario, a Python loop over rounds and
  over clients (each client trained alone with
  :func:`~repro_torch.federated.client.local_train`), eager early stop.
  They take their random inputs from the same draw source as the engine
  (:func:`~repro_torch.federated.campaign.generator_draws` of
  ``fl.seed`` by default), so masks, ledgers and AoI agree with the
  engine's scenario of that seed.

A ``controller`` argument asks for the symmetric game's probability,
which is not ported yet (ROADMAP.md, queue 1 item 3) and raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core.aoi import AoITracker
from repro_torch.core.energy import EnergyLedger, EnergyParams
from repro_torch.device import as_float64, as_tensor, resolve_device
from repro_torch.federated.campaign import (CampaignDraws, generator_draws,
                                            run_campaigns)
from repro_torch.federated.client import local_train
from repro_torch.federated.participation import round_mask
from repro_torch.federated.server import ConvergenceTracker, fedavg_merge
from repro_torch.optim.base import Optimizer

__all__ = ["FLConfig", "FLResult", "HeterogeneousReference",
           "run_simulation", "run_simulation_reference",
           "run_heterogeneous_reference"]

_CONTROLLER_TODO = ("controller= needs the symmetric game's probability, "
                    "which is not ported yet (ROADMAP.md, queue 1 item 3: "
                    "the symmetric solver); pass p and energy instead")


@dataclasses.dataclass(frozen=True)
class FLConfig:
    n_clients: int = 50
    local_steps: int = 5            # E local epochs (1 minibatch/epoch here)
    batch_per_client: int = 32
    max_rounds: int = 200
    target_acc: float = 0.73
    consecutive: int = 3
    seed: int = 0


@dataclasses.dataclass
class FLResult:
    rounds: int
    converged: bool
    energy_wh: float
    acc_history: list
    participation_rate: float
    wall_s: float
    ledger_summary: dict
    mean_aoi: float = float("nan")  # realized fleet AoI (campaign engine only)


def _symmetric_p(p, controller, n: int, dev: torch.device) -> torch.Tensor:
    """The reference's ``_resolve``: ``p`` as a float32 ``(N,)`` vector."""
    if controller is not None:
        raise NotImplementedError(_CONTROLLER_TODO)
    return as_tensor(p, dev).to(torch.float32).expand(n)


def run_simulation(
    fl: FLConfig,
    init_params: Callable,
    loss_fn: Callable,
    eval_fn: Callable,
    client_data: Callable,
    val_batch: dict,
    opt: Optimizer,
    p,
    energy: EnergyParams | None = None,
    controller=None,
    engine=None,
    *,
    draws: CampaignDraws | None = None,
    device: str | torch.device = "cuda",
) -> FLResult:
    """Run FedAvg with Bernoulli(p) participation until convergence: the
    B = 1 campaign of seed ``fl.seed``. ``p`` is a scalar or ``(N,)`` and
    is used in float32, as the reference does."""
    dev = resolve_device(device)
    p_vec = _symmetric_p(p, controller, fl.n_clients, dev)
    t0 = time.time()
    res = run_campaigns(fl, init_params, loss_fn, eval_fn, client_data,
                        val_batch, opt, p_vec[None, :], energy=energy,
                        seeds=[fl.seed], engine=engine, draws=draws,
                        device=dev)
    wall = time.time() - t0
    rounds = int(res.rounds[0])
    return FLResult(
        rounds=rounds,
        converged=bool(res.converged[0]),
        energy_wh=float(res.energy_wh[0]),
        acc_history=[float(a) for a in res.acc_history[0][:rounds]],
        participation_rate=float(res.participation_rate[0]),
        wall_s=wall,
        ledger_summary=res.scenario_ledger(0).summary(),
        mean_aoi=float(res.mean_aoi[0]),
    )


def _one_draws(fl, init_params, draws, dtype, churn, deadline, dev):
    if draws is None:
        draws = generator_draws(fl, init_params, [fl.seed], dtype=dtype,
                                churn=churn, deadline=deadline, device=dev)
    return draws.scenario(0)


def _train_clients(fl, loss_fn, client_data, opt, params, r, dev) -> dict:
    """Every client trained alone from ``params``; leaves ``(N, ...)``."""
    n = fl.n_clients
    batches = {k: v.to(dev) for k, v in client_data(
        range(n), r, fl.batch_per_client, fl.local_steps).items()}
    trained = [local_train(loss_fn, params,
                           {k: v[c] for k, v in batches.items()}, opt)[0]
               for c in range(n)]
    return {k: torch.stack([t[k] for t in trained]) for k in params}


def run_simulation_reference(
    fl: FLConfig,
    init_params: Callable,
    loss_fn: Callable,
    eval_fn: Callable,
    client_data: Callable,
    val_batch: dict,
    opt: Optimizer,
    p,
    energy: EnergyParams | None = None,
    controller=None,
    *,
    draws: CampaignDraws | None = None,
    device: str | torch.device = "cuda",
) -> FLResult:
    """The plain round loop for one symmetric scenario (float32 ``p``, one
    shared :class:`EnergyParams`): the engine's oracle."""
    dev = resolve_device(device)
    n = fl.n_clients
    p_vec = _symmetric_p(p, controller, n, dev)
    energy = energy or EnergyParams()
    d = _one_draws(fl, init_params, draws, p_vec.dtype, False, False, dev)
    params = {k: v[0] for k, v in d.params.items()}
    val = {k: v.to(dev) for k, v in val_batch.items()}

    ledger = EnergyLedger.create(n, device=dev)
    tracker = ConvergenceTracker.create(fl.target_acc, fl.consecutive,
                                        device=dev)
    accs = []
    t0 = time.time()
    rounds_done = fl.max_rounds
    for r in range(fl.max_rounds):
        mask = round_mask(d.mask[0, r], p_vec)
        clients = _train_clients(fl, loss_fn, client_data, opt, params, r,
                                 dev)
        params = fedavg_merge(params, clients, mask)
        acc = eval_fn(params, val)
        ledger = ledger.record_round(mask, energy)
        tracker = tracker.update(acc, r)
        accs.append(float(acc))
        if bool(tracker.converged):
            rounds_done = r + 1
            break
    wall = time.time() - t0
    return FLResult(
        rounds=rounds_done,
        converged=bool(tracker.converged),
        energy_wh=float(ledger.total_wh),
        acc_history=accs,
        participation_rate=float(torch.mean(
            ledger.participation_counts.to(torch.float64)
            / torch.clamp(ledger.rounds, min=1))),
        wall_s=wall,
        ledger_summary=ledger.summary(),
    )


@dataclasses.dataclass
class HeterogeneousReference:
    """Outcome of :func:`run_heterogeneous_reference` (one scenario).

    Attributes:
        rounds: realized rounds (eager early stop).
        converged: whether the accuracy target was hit.
        acc_history: per-round validation accuracies (length ``rounds``).
        ledger: the :class:`~repro_torch.core.energy.EnergyLedger` (J).
        aoi: the :class:`~repro_torch.core.aoi.AoITracker`.
        present_counts: ``(N,)`` rounds each node was in the fleet.
        present_final: ``(N,)`` bool presence after the last round.
        straggler_counts: ``(N,)`` attempts that missed the deadline.
        params: the final merged parameters.
        wall_s: wall-clock seconds of the round loop.
    """

    rounds: int
    converged: bool
    acc_history: list
    ledger: EnergyLedger
    aoi: AoITracker
    present_counts: torch.Tensor
    present_final: torch.Tensor
    straggler_counts: torch.Tensor
    params: dict
    wall_s: float


def run_heterogeneous_reference(
    fl: FLConfig,
    init_params: Callable,
    loss_fn: Callable,
    eval_fn: Callable,
    client_data: Callable,
    val_batch: dict,
    opt: Optimizer,
    p,
    *,
    energy_rates_j: tuple | None = None,
    energy: EnergyParams | None = None,
    churn=None,
    deadline=None,
    draws: CampaignDraws | None = None,
    device: str | torch.device = "cuda",
) -> HeterogeneousReference:
    """Per-node round loop for one scenario — the engine's oracle.

    Args:
        p: scalar or ``(N,)`` per-node probabilities (dtype kept: mask
            uniforms are drawn in it).
        energy_rates_j: ``(e_participant_j, e_idle_j)`` Joules per round,
            scalars or ``(N,)``; overrides ``energy``.
        energy: shared :class:`EnergyParams` (default paper Table I).
        churn: optional :class:`~repro_torch.federated.campaign.ChurnConfig`.
        deadline: optional
            :class:`~repro_torch.federated.campaign.DeadlineConfig`.
        draws: the scenario's random inputs, with a batch axis of one
            (default: :func:`generator_draws` of ``fl.seed``).
    """
    dev = resolve_device(device)
    n = fl.n_clients
    p_vec = as_tensor(p, dev)
    if p_vec.dim() == 0:
        p_vec = p_vec.expand(n)
    if energy_rates_j is not None:
        e_part = as_float64(energy_rates_j[0], dev)
        e_idle = as_float64(energy_rates_j[1], dev)
    else:
        ep = energy or EnergyParams()
        e_part = as_float64(ep.e_participant_j, dev)
        e_idle = as_float64(ep.e_idle_j, dev)
    d = _one_draws(fl, init_params, draws, p_vec.dtype, churn is not None,
                   deadline is not None, dev)
    params = {k: v[0] for k, v in d.params.items()}
    val = {k: v.to(dev) for k, v in val_batch.items()}

    if churn is not None:
        arrival, departure, present0 = (a[0] for a in
                                        churn.as_arrays(1, n, device=dev))
        present = present0.clone()
    else:
        present = torch.ones(n, dtype=torch.bool, device=dev)
    miss = deadline.as_arrays(1, n, device=dev)[0] if deadline else None

    ledger = EnergyLedger.create(n, device=dev)
    aoi = AoITracker.create(n, device=dev)
    tracker = ConvergenceTracker.create(fl.target_acc, fl.consecutive,
                                        device=dev)
    present_counts = torch.zeros(n, dtype=torch.int64, device=dev)
    straggler_counts = torch.zeros(n, dtype=torch.int64, device=dev)
    no_late = torch.zeros(n, dtype=torch.bool, device=dev)
    accs: list[float] = []
    t0 = time.time()
    rounds_done = fl.max_rounds
    for r in range(fl.max_rounds):
        if churn is not None:
            arrive = d.arrive[0, r] < arrival
            depart = d.depart[0, r] < departure
            present = torch.where(present, ~depart, arrive)
            present_counts = present_counts + present.to(torch.int64)
        late = d.late[0, r] < miss if deadline is not None else no_late
        mask = round_mask(d.mask[0, r], p_vec) & present
        delivered = mask & ~late
        clients = _train_clients(fl, loss_fn, client_data, opt, params, r,
                                 dev)
        params = fedavg_merge(params, clients, delivered)
        acc = eval_fn(params, val)
        # attempts are charged; only delivered updates reset AoI
        ledger = ledger.record_round_j(mask, e_part, e_idle)
        aoi = aoi.update(delivered, present if churn is not None else None)
        straggler_counts = straggler_counts + (mask & late).to(torch.int64)
        tracker = tracker.update(acc, r)
        accs.append(float(acc))
        if bool(tracker.converged):
            rounds_done = r + 1
            break
    if churn is None:
        present_counts = torch.full((n,), rounds_done, dtype=torch.int64,
                                    device=dev)
    return HeterogeneousReference(
        rounds=rounds_done,
        converged=bool(tracker.converged),
        acc_history=accs,
        ledger=ledger,
        aoi=aoi,
        present_counts=present_counts,
        present_final=present,
        straggler_counts=straggler_counts,
        params=params,
        wall_s=time.time() - t0,
    )
