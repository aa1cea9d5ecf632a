"""Batched heterogeneous-equilibrium engine: NE solve, certifier, planner, PoA.

Port of :mod:`repro.core.asymmetric_batched` (without ``mesh=``). The
reference writes each surface for one scenario and lifts it with ``vmap``;
here the scenario batch is the leading axis of every tensor:

* **Damped Gauss-Seidel.** One round-robin sweep walks the nodes in order:
  node i's opponents' pmf comes from the O(N) leave-one-out deconvolution
  (:func:`repro_torch.core.poibin.poibin_pmf_loo`), its closed-form best
  response is taken, and the updated factor is convolved back in, so node
  i's update feeds node i+1 within the sweep. The pmf is rebuilt with the
  O(N²) recursion once per sweep. The reference's vmapped
  ``lax.while_loop`` becomes one batched loop with an ``active`` mask: a
  converged lane freezes (profile, delta and sweep count) while the others
  keep sweeping, and the loop stops when no lane is active — one host
  sync per sweep.
* **Certification** (:func:`verify_equilibrium_batched`): all N
  leave-one-out pmfs, then a (B, N, grid) deviation-utility table.
* **Planner** (:func:`planner_batched`): the social cost is linear in each
  ``p_i``, so each coordinate update jumps to a corner.
* **PoA** (:func:`poa_report`).

Both programs of the reference are kept. ``backend="ref"`` is its default
program: the f64 recursive pmf and deconvolution. ``backend="kernel"`` is
its kernel path: the whole batch's pmfs and leave-one-out pmfs from the
fused fp32 ``poibin_dft`` program. Here the kernel path is the call-site
default of :func:`verify_equilibrium_batched`, :func:`social_cost_batched`
and :func:`poa_report`. The Gauss-Seidel solve and the planner always run
the f64 recursion: their sweeps are sequential per node.

Every entry point takes ``device=`` (default ``"cuda"``; see
:mod:`repro_torch.device`) and works in ``torch.float64``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.aoi import log_aoi
from repro_torch.core.duration import DurationModel
from repro_torch.core.poibin import (poibin_convolve, poibin_pmf_loo,
                                     poibin_pmf_recursive)
from repro_torch.device import as_float64, resolve_device
from repro_torch.kernels import ops

__all__ = [
    "P_MIN",
    "HeterogeneousSolution",
    "HeterogeneousPoA",
    "best_response_given_slope",
    "solve_heterogeneous",
    "verify_equilibrium_batched",
    "planner_batched",
    "social_cost_batched",
    "poa_report",
]

P_MIN = 1e-3  # matches repro.core.game / repro.core.asymmetric

_F64 = torch.float64


def best_response_given_slope(slope: torch.Tensor, cost: torch.Tensor,
                              gamma: torch.Tensor) -> torch.Tensor:
    """Exact best response from the (utility-side) duration slope.

    With opponents fixed, ``u_i(p) = const + a·p - γ·log(1/p - 1/2)`` where
    ``a = slope - cost``:

    * γ = 0: bang-bang on sign(a); a = 0 exactly resolves to ``P_MIN``.
    * γ > 0, a ≥ 0: utility strictly increasing ⇒ p = 1.
    * γ > 0, a < 0: ``p* = 1 - sqrt(1 + 2γ/a)``, clipped to [P_MIN, 1].

    The a ≥ 0 branch is masked out by the outer ``where``, so its divisor
    is replaced by a benign -1 (a two-sided guard: no inf/NaN at a = 0).
    """
    a = slope - cost
    if_zero = torch.where(a > 0.0, torch.ones_like(a),
                          torch.full_like(a, P_MIN))
    denom = torch.where(a < 0.0, a, -1.0)
    prod = -2.0 * gamma / denom          # p(2-p) at the stationary point
    disc = torch.clamp(1.0 - prod, 0.0, 1.0)
    interior = torch.clamp(1.0 - torch.sqrt(disc), P_MIN, 1.0)
    return torch.where(gamma <= 0.0, if_zero,
                       torch.where(a >= 0.0, 1.0, interior))


# ---------------------------------------------------------------------------
# Batched round-robin sweeps with per-lane freezing
# ---------------------------------------------------------------------------

def _node_sweep(p: torch.Tensor, dd: torch.Tensor,
                update: Callable[[int, torch.Tensor, torch.Tensor],
                                 torch.Tensor]):
    """One Gauss-Seidel sweep over the nodes of every lane.

    ``update(i, p_i, slope_i)`` returns node i's new probability from its
    old one and ``∂E[D]/∂p_i`` (others fixed). Returns the new profile and
    each lane's largest per-node change.
    """
    f = poibin_pmf_recursive(p)  # fresh O(N²) pmf once per sweep
    p = p.clone()
    delta = torch.zeros_like(p[:, 0])
    for i in range(p.shape[1]):
        p_i = p[:, i].clone()
        loo = poibin_pmf_loo(f, p_i)                    # (B, S), last 0
        slope = torch.linalg.vecdot(loo[:, :-1], dd)
        new = update(i, p_i, slope)
        f = poibin_convolve(loo, new)
        p[:, i] = new
        delta = torch.maximum(delta, torch.abs(new - p_i))
    return p, delta


def _masked_loop(p0: torch.Tensor, sweep, keep_going):
    """The reference's vmapped ``lax.while_loop`` over sweeps.

    Each lane sweeps while ``keep_going(delta, iters)`` holds and is frozen
    after; returns ``(p, delta, iters)`` per lane.
    """
    p = p0
    delta = torch.full(p0.shape[:1], float("inf"), dtype=p0.dtype,
                       device=p0.device)
    iters = torch.zeros(p0.shape[:1], dtype=torch.int64, device=p0.device)
    while True:
        active = keep_going(delta, iters)
        if not bool(active.any()):          # the one host sync per sweep
            return p, delta, iters
        p_new, delta_new = sweep(p)
        p = torch.where(active[:, None], p_new, p)
        delta = torch.where(active, delta_new, delta)
        iters = iters + active


def _gs_fixed_point(costs, gammas, d_tab, p0, *, damping, max_iters, tol):
    dd = d_tab[:, 1:] - d_tab[:, :-1]

    def update(i, p_i, slope):
        br = best_response_given_slope(-slope, costs[:, i], gammas[:, i])
        return (1.0 - damping) * p_i + damping * br

    p, delta, iters = _masked_loop(
        p0, lambda p: _node_sweep(p, dd, update),
        lambda delta, it: (delta >= tol) & (it < max_iters))
    return p, delta < tol, iters


@dataclasses.dataclass(frozen=True)
class HeterogeneousSolution:
    """A batch of asymmetric-NE solves."""

    costs: torch.Tensor       # (B, N)
    gammas: torch.Tensor      # (B, N)
    p: torch.Tensor           # (B, N) fixed-point profiles
    converged: torch.Tensor   # (B,) bool
    iters: torch.Tensor       # (B,) Gauss-Seidel sweeps run

    @property
    def batch(self) -> int:
        return int(self.p.shape[0])

    def single(self) -> tuple[torch.Tensor, bool, int]:
        """The (profile, converged, iters) triple of a B = 1 solve."""
        if self.batch != 1:
            raise ValueError(
                f"single() called on a batch of {self.batch} scenarios")
        return self.p[0], bool(self.converged[0]), int(self.iters[0])


def _prepare_batch(costs, gammas, dur, p0, device):
    """Resolve the device and bring every input to float64 ``(B, N)``
    (duration tables ``(B, N+1)``) on it."""
    dev = resolve_device(device)
    d_tab = dur.table() if isinstance(dur, DurationModel) else dur
    d_tab = as_float64(d_tab, dev)
    costs = torch.atleast_2d(as_float64(costs, dev))
    gammas = torch.atleast_2d(as_float64(gammas, dev))
    try:
        shape = torch.broadcast_shapes(costs.shape, gammas.shape)
    except RuntimeError as e:
        raise ValueError(f"costs {tuple(costs.shape)} vs gammas "
                         f"{tuple(gammas.shape)}: {e}") from None
    costs = costs.expand(shape).contiguous()
    gammas = gammas.expand(shape).contiguous()
    b, n = shape
    if d_tab.dim() == 1:
        d_tab = d_tab.expand((b,) + d_tab.shape)
    if tuple(d_tab.shape) != (b, n + 1):
        raise ValueError(f"duration table {tuple(d_tab.shape)}, "
                         f"want {(b, n + 1)}")
    if p0 is None:
        p0 = torch.full((b, n), 0.5, dtype=_F64, device=dev)
    else:
        p0 = torch.atleast_2d(as_float64(p0, dev)).expand(b, n).contiguous()
    return costs, gammas, d_tab, p0


def solve_heterogeneous(
    costs,
    gammas,
    dur: DurationModel | torch.Tensor,
    *,
    p0=None,
    damping: float = 0.5,
    max_iters: int = 200,
    tol: float = 1e-5,
    device: str | torch.device = "cuda",
) -> HeterogeneousSolution:
    """Solve a batch of heterogeneous games by damped Gauss-Seidel.

    Args:
        costs / gammas: ``(N,)`` for a single game or ``(B, N)`` for a
            batch; the two broadcast against each other.
        dur: a shared :class:`DurationModel`, a shared ``(N+1,)`` duration
            table, or a per-scenario ``(B, N+1)`` stack of tables.
        p0: initial profile(s); defaults to the all-0.5 profile.
        damping / max_iters / tol: Gauss-Seidel controls (``iters`` counts
            round-robin sweeps; a lane converges when its largest per-node
            update in a sweep is below ``tol``).
        device: where to run (default the card).
    """
    costs, gammas, d_tab, p0 = _prepare_batch(costs, gammas, dur, p0, device)
    p, conv, iters = _gs_fixed_point(costs, gammas, d_tab, p0,
                                     damping=float(damping),
                                     max_iters=int(max_iters),
                                     tol=float(tol))
    return HeterogeneousSolution(costs=costs, gammas=gammas, p=p,
                                 converged=conv, iters=iters)


# ---------------------------------------------------------------------------
# Certification: vectorized unilateral-deviation grid
# ---------------------------------------------------------------------------

def verify_equilibrium_batched(
    costs,
    gammas,
    dur: DurationModel | torch.Tensor,
    p,
    *,
    grid: int = 64,
    backend: str | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Max profitable unilateral deviation per scenario (0 at an exact NE).

    All N leave-one-out pmfs, then a (B, N, grid) deviation-utility table.
    Accepts the shapes of :func:`solve_heterogeneous`; returns ``(B,)``.
    ``backend="kernel"`` (the default) takes the leave-one-out block from
    the fused fp32 ``poibin_dft`` program; ``"ref"`` from the f64
    recursion and deconvolution.
    """
    costs, gammas, d_tab, p = _prepare_batch(costs, gammas, dur, p, device)
    if ops.resolve_backend(backend, default="kernel",
                           site="ne.verify_equilibrium_batched") == "kernel":
        _, loo = ops.poibin(p, backend="kernel")   # (B, N, S)
    else:
        loo = poibin_pmf_loo(poibin_pmf_recursive(p)[:, None, :], p)
    dd = d_tab[:, 1:] - d_tab[:, :-1]
    base = torch.einsum("bns,bs->bn", loo[:, :, :-1], d_tab[:, :-1])
    slope = torch.einsum("bns,bs->bn", loo[:, :, :-1], dd)
    gridv = torch.linspace(P_MIN, 1.0, grid, dtype=_F64, device=p.device)
    aoi_dev = log_aoi(gridv)
    u_dev = (-(base[..., None] + gridv * slope[..., None])
             - gammas[..., None] * aoi_dev
             - costs[..., None] * gridv)                     # (B, N, G)
    u_eq = -(base + p * slope) - gammas * log_aoi(p) - costs * p   # (B, N)
    return torch.clamp(torch.amax(u_dev - u_eq[..., None], dim=(1, 2)),
                       min=0.0)


# ---------------------------------------------------------------------------
# Planner + social cost + PoA report
# ---------------------------------------------------------------------------

def social_cost_batched(costs, dur: DurationModel | torch.Tensor, p, *,
                        backend: str | None = None,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """``Σ_i (E[D] + c_i p_i) = N·E[D] + Σ c_i p_i`` per scenario, ``(B,)``.

    ``backend="kernel"`` (the default) evaluates the pmfs in the DFT
    kernel's pmf-only variant; ``"ref"`` with the f64 recursion.
    """
    costs, _, d_tab, p = _prepare_batch(costs, 0.0, dur, p, device)
    if ops.resolve_backend(backend, default="kernel",
                           site="ne.social_cost_batched") == "kernel":
        f = ops.poibin_pmf(p, backend="kernel")           # (B, S)
    else:
        f = poibin_pmf_recursive(p)
    n = costs.shape[1]
    return (n * torch.linalg.vecdot(f, d_tab)
            + torch.linalg.vecdot(costs, p))


def planner_batched(
    costs,
    dur: DurationModel | torch.Tensor,
    p0,
    *,
    rounds: int = 20,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Heterogeneity-aware planner: round-robin coordinate descent.

    Each coordinate update is exact (the social cost is linear in one
    ``p_i``, so the minimum is the corner picked by the sign of
    ``N·∂E[D]/∂p_i + c_i``). A lane stops after a sweep that changes
    nothing, or after ``rounds`` sweeps. Started from an NE profile its
    cost lower-bounds the NE cost — the PoA denominator. Returns ``(B, N)``.
    """
    costs, _, d_tab, p0 = _prepare_batch(costs, 0.0, dur, p0, device)
    n = costs.shape[1]
    dd = d_tab[:, 1:] - d_tab[:, :-1]

    def update(i, p_i, slope):
        return torch.where(n * slope + costs[:, i] >= 0.0,
                           torch.full_like(p_i, P_MIN), torch.ones_like(p_i))

    p, _, _ = _masked_loop(
        p0, lambda p: _node_sweep(p, dd, update),
        lambda delta, it: (delta > 0.0) & (it < rounds))
    return p


@dataclasses.dataclass(frozen=True)
class HeterogeneousPoA:
    """NE + certification + planner benchmark for a scenario batch."""

    solution: HeterogeneousSolution
    deviation: torch.Tensor   # (B,) max profitable unilateral deviation at NE
    ne_cost: torch.Tensor     # (B,) social cost of the reached profile
    opt_p: torch.Tensor       # (B, N) planner profile (descent from the NE)
    opt_cost: torch.Tensor    # (B,)
    poa: torch.Tensor         # (B,) heterogeneous PoA ≥ 1

    @property
    def batch(self) -> int:
        return self.solution.batch


def poa_report(
    costs,
    gammas,
    dur: DurationModel | torch.Tensor,
    *,
    verify_grid: int = 64,
    planner_rounds: int = 20,
    backend: str | None = None,
    device: str | torch.device = "cuda",
    **solver_kwargs,
) -> HeterogeneousPoA:
    """Solve, certify, and benchmark a batch of heterogeneous scenarios.

    ``backend`` routes the certification and social-cost evaluations (the
    kernel path by default); the NE solve and the planner always run the
    f64 recursion. ``solver_kwargs`` go to :func:`solve_heterogeneous`.
    """
    sol = solve_heterogeneous(costs, gammas, dur, device=device,
                              **solver_kwargs)
    dev = verify_equilibrium_batched(sol.costs, sol.gammas, dur, sol.p,
                                     grid=verify_grid, backend=backend,
                                     device=device)
    ne_cost = social_cost_batched(sol.costs, dur, sol.p, backend=backend,
                                  device=device)
    opt_p = planner_batched(sol.costs, dur, sol.p, rounds=planner_rounds,
                            device=device)
    opt_cost = social_cost_batched(sol.costs, dur, opt_p, backend=backend,
                                   device=device)
    poa = ne_cost / torch.clamp(opt_cost, min=1e-12)
    return HeterogeneousPoA(solution=sol, deviation=dev, ne_cost=ne_cost,
                            opt_p=opt_p, opt_cost=opt_cost, poa=poa)
