"""Multi-scenario FL campaign engine (heterogeneous fleets), batched over B.

Port of :mod:`repro.federated.campaign`. The reference runs a campaign as
one ``lax.scan`` over rounds, ``vmap``-ed over scenarios. Here the rounds
are an eager Python loop and the scenarios a batch dimension written out:

* one **round** = (optional churn: arrival/departure update the presence
  mask) → participation masks ``uniforms < p`` (``& present``) → (optional
  deadline: stragglers drop out of the merge) → local training of every
  (scenario, client) replica (:func:`~repro_torch.federated.client.
  make_local_train`) → masked FedAvg merge (on the card, the hand-written
  ``fedavg_agg`` kernel, one launch for all B scenarios) → validation →
  :class:`EnergyLedger`, :class:`ConvergenceTracker` and
  :class:`AoITracker` updates;
* a scenario that has converged stays frozen: its parameters, ledger, AoI,
  presence and straggler counts no longer change, its ``acc_history``
  repeats the last accuracy and its ``k_history`` reads 0 — what the
  reference's fixed-length scan does with masked rounds. The loop stops
  once every scenario has converged and fills the rest of the histories
  the same way.

Accounting: the ledger charges *attempts* (the mask after churn); AoI
resets only on *delivered* updates (attempts that met the deadline);
absent nodes are frozen in AoI and accrue idle energy only.

The client parameters live in one flat ``(B, N, P)`` slab whose leaves are
views, so local training writes into it in place and the merge reads it as
it lies, with no flatten-and-concatenate copy per round.

Randomness. The reference draws every random variable from keyed streams
of ``PRNGKey(seed)``: masks from ``fold_in(key, 10_000 + r)``, churn from
``split(fold_in(key, 20_000 + r))``, deadlines from
``fold_in(key, 30_000 + r)``, initial parameters from ``fold_in(key, 1)``.
The port takes them from a :class:`CampaignDraws` — every uniform and the
initial parameters, as tensors. By default :func:`generator_draws` makes
them with ``torch.Generator``s on the run's device keyed by (seed,
stream), once per distinct seed, so scenarios with equal seeds see equal
draws (as in the reference, where ``seeds=None`` gives every scenario
``fl.seed``). Mask uniforms are drawn in ``p``'s dtype and churn and
deadline uniforms in float64, as ``jax.random.bernoulli`` draws them. A
caller may build a :class:`CampaignDraws` from arrays instead — the
reference's own uniforms, say — and the client batches come from the
task's ``client_data``, so both can be replayed.

Not ported: ``obs=`` (observability, ROADMAP.md queue 1 item 8) and
``mesh=``/``batch_axis=`` (sharding, queue 1 item 9) raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core.aoi import AoITracker
from repro_torch.core.energy import J_PER_WH, EnergyLedger, EnergyParams
from repro_torch.device import as_float64, as_tensor, resolve_device
from repro_torch.federated.client import make_local_train
from repro_torch.federated.participation import round_mask
from repro_torch.federated.server import (ConvergenceTracker, fedavg_merge,
                                          select)
from repro_torch.optim.base import Optimizer
from repro_torch.rng import generator

__all__ = ["CampaignDraws", "CampaignResult", "ChurnConfig",
           "DeadlineConfig", "build_campaign", "generator_draws",
           "run_campaigns", "MASK_STREAM", "CHURN_STREAM", "DEADLINE_STREAM",
           "PARAMS_STREAM"]

# Stream offsets, as the reference folds them into PRNGKey(seed).
PARAMS_STREAM = 1         # initial parameters
MASK_STREAM = 10_000      # participation uniforms
CHURN_STREAM = 20_000     # arrival/departure uniforms
DEADLINE_STREAM = 30_000  # straggler (deadline-miss) uniforms

_OBS_TODO = ("obs= is not ported yet (ROADMAP.md, queue 1 item 8: "
             "observability)")
_MESH_TODO = ("mesh=/batch_axis= are not ported yet (ROADMAP.md, queue 1 "
              "item 9: devices and distribution)")


def _unported(obs, mesh, batch_axis) -> None:
    if obs is not None:
        raise NotImplementedError(_OBS_TODO)
    if mesh is not None or batch_axis is not None:
        raise NotImplementedError(_MESH_TODO)


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Per-round fleet churn: a 2-state Markov chain per node.

    At the start of every round each present node departs with probability
    ``departure`` and each absent node (re-)arrives with probability
    ``arrival``; the presence mask then gates participation
    (``mask = Bernoulli(p) & present``). ``arrival``/``departure`` are
    scalars, ``(N,)``, ``(B, 1)`` or ``(B, N)``; ``present0`` (bool, same
    shapes) is the initial presence. ``ChurnConfig()`` is the no-churn
    identity.
    """

    arrival: Any = 0.0
    departure: Any = 0.0
    present0: Any = True

    def as_arrays(self, batch: int, n: int, *,
                  device: str | torch.device = "cuda"
                  ) -> tuple[torch.Tensor, ...]:
        """Broadcast to the engine's ``(B, N)`` inputs on ``device``."""
        dev = resolve_device(device)
        arr = torch.atleast_2d(as_float64(self.arrival, dev))
        dep = torch.atleast_2d(as_float64(self.departure, dev))
        pres = torch.atleast_2d(as_tensor(self.present0, dev).to(torch.bool))
        return (arr.expand(batch, n), dep.expand(batch, n),
                pres.expand(batch, n))


@dataclasses.dataclass(frozen=True)
class DeadlineConfig:
    """Per-round straggler model: a node wins the participation lottery but
    misses the round deadline with probability ``miss`` (scalar, ``(N,)``,
    ``(B, 1)`` or ``(B, N)``). A straggler is charged the full participant
    energy, but its update is dropped from the merge and its AoI is not
    reset."""

    miss: Any = 0.0

    def as_arrays(self, batch: int, n: int, *,
                  device: str | torch.device = "cuda") -> torch.Tensor:
        """Broadcast to the engine's ``(B, N)`` miss probabilities."""
        dev = resolve_device(device)
        return torch.atleast_2d(as_float64(self.miss, dev)).expand(batch, n)


@dataclasses.dataclass
class CampaignDraws:
    """Every random input of B campaigns over R rounds and N nodes.

    Attributes:
        mask: ``(B, R, N)`` participation uniforms in ``p``'s dtype: node
            i joins round r iff ``mask[b, r, i] < p[b, i]``.
        params: initial parameters, leaves ``(B, ...)`` in the task's dtype
            (float64 for the MLP task, the config's for a model: the flat
            client slab then holds that dtype, which ``fedavg_agg`` reads).
        arrive / depart: ``(B, R, N)`` float64 churn uniforms (churn only).
        late: ``(B, R, N)`` float64 deadline uniforms (deadlines only).
    """

    mask: torch.Tensor
    params: dict
    arrive: torch.Tensor | None = None
    depart: torch.Tensor | None = None
    late: torch.Tensor | None = None

    @staticmethod
    def from_arrays(mask, params: dict, arrive=None, depart=None, late=None,
                    *, device: str | torch.device = "cuda"
                    ) -> "CampaignDraws":
        """Draws handed in as arrays (numpy or tensors), dtypes kept."""
        dev = resolve_device(device)

        def put(x):
            return None if x is None else as_tensor(x, dev)

        return CampaignDraws(mask=put(mask),
                             params={k: put(v) for k, v in params.items()},
                             arrive=put(arrive), depart=put(depart),
                             late=put(late))

    def scenario(self, b: int) -> "CampaignDraws":
        """Scenario ``b``'s draws, with a batch axis of one."""
        def row(x):
            return None if x is None else x[b:b + 1]
        return CampaignDraws(mask=row(self.mask),
                             params={k: row(v) for k, v in self.params.items()},
                             arrive=row(self.arrive), depart=row(self.depart),
                             late=row(self.late))


def generator_draws(fl, init_params: Callable, seeds: Sequence[int], *,
                    dtype: torch.dtype, churn: bool, deadline: bool,
                    device: str | torch.device = "cuda") -> CampaignDraws:
    """The default draws: ``torch.Generator``s on ``device`` keyed by
    (seed, stream). Each stream's whole ``(R, N)`` schedule is drawn in one
    call per *distinct* seed and shared by the scenarios holding it."""
    dev = resolve_device(device)
    seeds = [int(s) for s in seeds]
    uniq = sorted(set(seeds))
    index = torch.tensor([uniq.index(s) for s in seeds], device=dev)
    shape = (fl.max_rounds, fl.n_clients)

    def schedule(stream: int, dt: torch.dtype, lead: tuple = ()):
        table = torch.stack([
            torch.rand(lead + shape, generator=generator(dev, s, stream),
                       dtype=dt, device=dev) for s in uniq])
        return table[index]

    inits = [init_params(generator(dev, s, PARAMS_STREAM)) for s in uniq]
    params = {k: torch.stack([p[k] for p in inits])[index] for k in inits[0]}
    arrive = depart = late = None
    if churn:
        both = schedule(CHURN_STREAM, torch.float64, (2,))   # (B, 2, R, N)
        arrive, depart = both[:, 0], both[:, 1]
    if deadline:
        late = schedule(DEADLINE_STREAM, torch.float64)
    return CampaignDraws(mask=schedule(MASK_STREAM, dtype), params=params,
                         arrive=arrive, depart=depart, late=late)


def _check_draws(draws: CampaignDraws, batch: int, fl, dtype: torch.dtype,
                 churn: bool, deadline: bool) -> None:
    shape = (batch, fl.max_rounds, fl.n_clients)
    wanted = [("mask", dtype, True), ("arrive", torch.float64, churn),
              ("depart", torch.float64, churn),
              ("late", torch.float64, deadline)]
    for name, dt, needed in wanted:
        x = getattr(draws, name)
        if not needed:
            continue
        if x is None or tuple(x.shape) != shape or x.dtype != dt:
            got = None if x is None else (tuple(x.shape), x.dtype)
            raise ValueError(f"draws.{name}: expected {shape} {dt}, got {got}")
    for k, v in draws.params.items():
        if v.shape[0] != batch:
            raise ValueError(f"draws.params[{k!r}] has {v.shape[0]} "
                             f"scenarios, expected {batch}")


class _Layout:
    """Leaf names, shapes and offsets of a batched parameter dict (leaves
    ``(B, ...)``) in its flat ``(B, P)`` form; :meth:`views` gives the
    leaves as views of a flat ``(..., P)`` tensor."""

    def __init__(self, params: dict):
        self.names = list(params)
        self.shapes = [tuple(params[k].shape[1:]) for k in self.names]
        self.sizes = [int(np.prod(s)) for s in self.shapes]
        self.size = sum(self.sizes)

    def flatten(self, params: dict) -> torch.Tensor:
        return torch.cat([params[k].flatten(1) for k in self.names], dim=-1)

    def views(self, flat: torch.Tensor) -> dict:
        lead = tuple(flat.shape[:-1])
        out, off = {}, 0
        for k, shape, size in zip(self.names, self.shapes, self.sizes):
            out[k] = flat[..., off:off + size].view(*lead, *shape)
            off += size
        return out


@dataclasses.dataclass
class CampaignResult:
    """Outcome of B campaigns (leading axis B on every tensor).

    ``acc_history``/``k_history`` are ``(B, max_rounds)``; entries after a
    scenario converged repeat its last accuracy and report 0 participants.
    Slice ``[:rounds[i]]`` for scenario ``i``'s realized trajectory.
    """

    p: torch.Tensor                 # (B, N) per-node participation probability
    seeds: torch.Tensor             # (B,)
    converged_at: torch.Tensor      # (B,) round index or -1
    converged: torch.Tensor         # (B,) bool
    rounds: torch.Tensor            # (B,) realized rounds (early stop honoured)
    energy_wh: torch.Tensor         # (B,) realized task energy [Wh]
    acc_history: torch.Tensor       # (B, R) float64
    k_history: torch.Tensor         # (B, R) delivered updates per round, int32
    participation_rate: torch.Tensor  # (B,) mean realized participation
    per_node_aoi: torch.Tensor      # (B, N) realized mean age per node [rounds]
    mean_aoi: torch.Tensor          # (B,) fleet-mean realized AoI [rounds]
    ledger: EnergyLedger            # leaves carry the leading B axis
    aoi: AoITracker                 # leaves carry the leading B axis
    present_counts: torch.Tensor    # (B, N) rounds each node was in the fleet
    present_final: torch.Tensor     # (B, N) bool presence after the last round
    straggler_counts: torch.Tensor  # (B, N) attempts that missed the deadline
    #: final merged parameters, leaves ``(B, ...)``
    params: Any = None

    @property
    def batch(self) -> int:
        return int(self.rounds.shape[0])

    @property
    def per_node_energy_wh(self) -> torch.Tensor:
        """``(B, N)`` realized per-node energy in Watt-hours."""
        return self.ledger.per_node_wh

    def scenario_ledger(self, i: int) -> EnergyLedger:
        """The i-th scenario's ledger as an unbatched :class:`EnergyLedger`."""
        return EnergyLedger(**{f.name: getattr(self.ledger, f.name)[i]
                               for f in dataclasses.fields(EnergyLedger)})

    def summary(self, i: int) -> dict[str, Any]:
        s = self.scenario_ledger(i).summary()
        s.update(converged=bool(self.converged[i]),
                 rounds=int(self.rounds[i]),
                 mean_aoi=float(self.mean_aoi[i]))
        return s


def build_campaign(
    fl,
    init_params: Callable,
    loss_fn: Callable,
    eval_fn: Callable,
    client_data: Callable,
    val_batch: dict,
    opt: Optimizer,
    *,
    churn: bool = False,
    deadline: bool = False,
    backend: str | None = None,
    obs=None,
    mesh=None,
    batch_axis=None,
):
    """The campaign engine for one task definition.

    Returns ``engine(p, seeds, e_participant_j, e_idle_j, [miss,]
    [arrival, departure, present0,] draws=None)`` — the reference's
    positional signature, which grows with the ``deadline`` and ``churn``
    flags: ``p`` is ``(B, N)``, ``seeds`` ``(B,)``, the joule rates
    ``(B,)`` or ``(B, N)``, the flag inputs ``(B, N)``, all on one device,
    where the engine runs. ``draws`` (default: :func:`generator_draws` of
    ``seeds``) supplies every random input. The engine returns the raw
    final state: a dict of ``params``, ``ledger``, ``tracker``, ``aoi``,
    ``accs``, ``ks``, plus ``straggler_counts`` with deadlines and
    ``present``/``present_counts`` with churn. ``backend`` picks the merge
    (see :func:`repro_torch.federated.server.fedavg_merge`).
    """
    _unported(obs, mesh, batch_axis)
    n = fl.n_clients
    rounds = fl.max_rounds
    train = make_local_train(loss_fn, opt)
    evaluate = vmap(eval_fn, in_dims=(0, None))
    extra = (["miss"] if deadline else []) + (
        ["arrival", "departure", "present0"] if churn else [])

    def engine(p, seeds, e_participant_j, e_idle_j, *flag_args, draws=None):
        if len(flag_args) != len(extra):
            raise TypeError(f"engine takes {extra} after the rates, got "
                            f"{len(flag_args)} arguments")
        kw = dict(zip(extra, flag_args))
        dev = p.device
        batch = p.shape[0]
        if draws is None:
            draws = generator_draws(fl, init_params, seeds.tolist(),
                                    dtype=p.dtype, churn=churn,
                                    deadline=deadline, device=dev)
        _check_draws(draws, batch, fl, p.dtype, churn, deadline)
        e_part = e_participant_j if e_participant_j.dim() == 2 \
            else e_participant_j[:, None]
        e_idle = e_idle_j if e_idle_j.dim() == 2 else e_idle_j[:, None]
        val = {k: v.to(dev) for k, v in val_batch.items()}

        layout = _Layout(draws.params)
        theta = layout.flatten(draws.params).to(dev)            # (B, P)
        slab = torch.empty((batch, n, layout.size), dtype=theta.dtype,
                           device=dev)                          # (B, N, P)
        clients = layout.views(slab)
        ledger = EnergyLedger.create(n, batch=(batch,), device=dev)
        tracker = ConvergenceTracker.create(fl.target_acc, fl.consecutive,
                                            batch=(batch,), device=dev)
        aoi = AoITracker.create(n, batch=(batch,), device=dev)
        last_acc = torch.zeros(batch, dtype=torch.float64, device=dev)
        accs = torch.zeros((batch, rounds), dtype=torch.float64, device=dev)
        ks = torch.zeros((batch, rounds), dtype=torch.int32, device=dev)
        if deadline:
            scount = torch.zeros((batch, n), dtype=torch.int64, device=dev)
        if churn:
            present = kw["present0"].to(torch.bool).clone()
            pcount = torch.zeros((batch, n), dtype=torch.int64, device=dev)

        for r in range(rounds):
            active = ~tracker.converged
            if not bool(active.any()):       # the one host sync of a round
                accs[:, r:] = last_acc[:, None]
                break
            col = active[:, None]
            here = None
            if churn:
                arrive = draws.arrive[:, r] < kw["arrival"]
                depart = draws.depart[:, r] < kw["departure"]
                here = torch.where(present, ~depart, arrive)
            mask = round_mask(draws.mask[:, r], p)
            if churn:
                mask = mask & here               # absentees cannot join
            if deadline:
                late = draws.late[:, r] < kw["miss"]
                delivered = mask & ~late
            else:
                delivered = mask

            batches = {k: v.to(dev) for k, v in client_data(
                range(n), r, fl.batch_per_client, fl.local_steps).items()}
            slab.copy_(theta[:, None, :].expand_as(slab))
            train(clients, batches)
            merged = fedavg_merge({"theta": theta}, {"theta": slab},
                                  delivered, backend=backend)["theta"]
            acc = evaluate(layout.views(merged), val)

            ledger = select(active, ledger.record_round_j(mask, e_part,
                                                          e_idle), ledger)
            tracker = tracker.masked_update(acc, r, active)
            aoi = select(active, aoi.update(delivered, here), aoi)
            theta = torch.where(col, merged, theta)
            last_acc = torch.where(active, acc, last_acc)
            if deadline:
                scount += ((mask & late) & col).to(torch.int64)
            if churn:
                present = torch.where(col, here, present)
                pcount += (here & col).to(torch.int64)
            accs[:, r] = last_acc
            ks[:, r] = torch.where(active, delivered.to(torch.int32).sum(-1),
                                   0)

        out = {"params": layout.views(theta), "ledger": ledger,
               "tracker": tracker, "aoi": aoi, "accs": accs, "ks": ks}
        if deadline:
            out["straggler_counts"] = scount
        if churn:
            out.update(present=present, present_counts=pcount)
        return out

    return engine


def _energy_rates(energy, batch: int, dev: torch.device):
    """Per-scenario ``(B,)`` joule rates from :class:`EnergyParams` input."""
    if energy is None:
        energy = EnergyParams()
    if isinstance(energy, EnergyParams):
        energy = [energy] * batch
    if len(energy) != batch:
        raise ValueError(f"{len(energy)} EnergyParams for {batch} scenarios")
    return (as_float64([e.e_participant_j for e in energy], dev),
            as_float64([e.e_idle_j for e in energy], dev))


def _raw_rate(rate, batch: int, n: int, name: str,
              dev: torch.device) -> torch.Tensor:
    """Normalize one raw joule-rate input to ``(B,)`` or ``(B, N)``.

    1-D inputs are *per-scenario* rates (length B); anything per-node must
    be 2-D (``(1, N)`` or ``(B, N)``). When B == N a 1-D vector is
    ambiguous — e.g. the ``(N,)`` output of
    :func:`~repro_torch.core.energy.per_node_energy_rates` passed without
    the ``[None, :]`` — and is rejected rather than silently metering
    scenario i at node i's rate.
    """
    r = as_float64(rate, dev)
    if r.dim() == 0:
        return r.expand(batch)
    if r.dim() == 1:
        if batch == n:
            raise ValueError(
                f"{name}: B == N == {batch}, so a 1-D rate vector is "
                f"ambiguous; pass rates[:, None] for per-scenario or "
                f"rates[None, :] for per-node")
        if r.shape[0] != batch:
            raise ValueError(
                f"{name}: 1-D rates are per-scenario and must have length "
                f"B={batch}, got {tuple(r.shape)}; pass (1, N) or (B, N) for "
                f"per-node rates")
        return r
    if r.dim() == 2:
        return r.expand(batch, n)
    raise ValueError(f"{name}: rank-{r.dim()} rates unsupported")


def run_campaigns(
    fl,
    init_params: Callable,
    loss_fn: Callable,
    eval_fn: Callable,
    client_data: Callable,
    val_batch: dict,
    opt: Optimizer,
    p,
    *,
    energy: EnergyParams | Sequence[EnergyParams] | None = None,
    energy_rates_j: tuple | None = None,
    churn: ChurnConfig | None = None,
    deadline: DeadlineConfig | None = None,
    seeds: Sequence[int] | None = None,
    engine: Callable | None = None,
    backend: str | None = None,
    draws: CampaignDraws | None = None,
    obs=None,
    mesh=None,
    batch_axis=None,
    device: str | torch.device = "cuda",
) -> CampaignResult:
    """Run B FedAvg campaigns on ``device`` (default ``"cuda"``).

    Args:
        p: scalar, ``(B,)`` symmetric probabilities, or a ``(B, N)``
            per-node matrix (e.g. the certified equilibria of
            :meth:`repro_torch.core.controller.ParticipationController.
            solve_batched`). Its dtype is kept: mask uniforms are drawn in it.
        energy: one shared :class:`EnergyParams` or one per scenario.
        energy_rates_j: raw per-round joule rates ``(e_participant_j,
            e_idle_j)`` overriding ``energy``: scalars, ``(B,)``
            per-scenario, or ``(1, N)`` / ``(B, N)`` per-node.
        churn: optional :class:`ChurnConfig` (fleet churn).
        deadline: optional :class:`DeadlineConfig` (stragglers).
        seeds: per-scenario seeds (default ``fl.seed`` for all: the
            scenarios then share initial parameters and masks and differ
            only in ``p``).
        engine: a prebuilt :func:`build_campaign` engine, built with the
            same ``churn``/``deadline`` flags.
        backend: FedAvg-merge implementation, ``"kernel"`` (default) or
            ``"ref"``.
        draws: every random input (default :func:`generator_draws`).
        obs, mesh, batch_axis: not ported; raise ``NotImplementedError``.
    """
    _unported(obs, mesh, batch_axis)
    dev = resolve_device(device)
    n = fl.n_clients
    p_arr = torch.atleast_1d(as_tensor(p, dev))
    if p_arr.dim() == 1:
        p_arr = p_arr[:, None].expand(p_arr.shape[0], n)
    if p_arr.shape[1] != n:
        raise ValueError(f"p {tuple(p_arr.shape)} for n_clients={n}")
    batch = p_arr.shape[0]
    seeds_t = torch.as_tensor([fl.seed] * batch if seeds is None
                              else np.asarray(seeds), dtype=torch.int64)
    if tuple(seeds_t.shape) != (batch,):
        raise ValueError(f"seeds {tuple(seeds_t.shape)} for {batch} "
                         f"scenarios")
    if energy_rates_j is not None:
        e_part = _raw_rate(energy_rates_j[0], batch, n, "e_participant_j", dev)
        e_idle = _raw_rate(energy_rates_j[1], batch, n, "e_idle_j", dev)
    else:
        e_part, e_idle = _energy_rates(energy, batch, dev)

    fn = engine if engine is not None else build_campaign(
        fl, init_params, loss_fn, eval_fn, client_data, val_batch, opt,
        churn=churn is not None, deadline=deadline is not None,
        backend=backend)
    call_args = [p_arr, seeds_t, e_part, e_idle]
    if deadline is not None:
        call_args.append(deadline.as_arrays(batch, n, device=dev))
    if churn is not None:
        call_args.extend(churn.as_arrays(batch, n, device=dev))
    out = fn(*call_args, draws=draws)

    tracker, ledger, aoi = out["tracker"], out["ledger"], out["aoi"]
    converged = tracker.converged_at >= 0
    rounds = torch.where(converged, tracker.converged_at.to(torch.int64) + 1,
                         fl.max_rounds)
    if churn is not None:
        present_counts = out["present_counts"]
        present_final = out["present"]
    else:
        present_counts = rounds[:, None].expand(batch, n)
        present_final = torch.ones((batch, n), dtype=torch.bool, device=dev)
    return CampaignResult(
        p=p_arr,
        seeds=seeds_t,
        converged_at=tracker.converged_at,
        converged=converged,
        rounds=rounds,
        energy_wh=torch.sum(ledger.per_node_j, dim=-1) / J_PER_WH,
        acc_history=out["accs"],
        k_history=out["ks"],
        participation_rate=torch.mean(
            ledger.participation_counts.to(torch.float64)
            / torch.clamp(ledger.rounds, min=1)[:, None], dim=-1),
        per_node_aoi=aoi.per_node_aoi,
        mean_aoi=aoi.mean_aoi,
        ledger=ledger,
        aoi=aoi,
        present_counts=present_counts,
        present_final=present_final,
        straggler_counts=out.get(
            "straggler_counts",
            torch.zeros((batch, n), dtype=torch.int64, device=dev)),
        params=out["params"],
    )
