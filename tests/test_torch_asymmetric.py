"""Port parity: ``repro_torch.core.asymmetric_batched`` against the JAX
heterogeneous-equilibrium engine.

``backend="ref"`` is the reference's default program (f64 recursion): the
Gauss-Seidel profiles agree to 1e-10 with equal sweep counts and
convergence flags, and the certifier, social cost, planner and PoA to
1e-10. The kernel path (the port's default) runs the kernel's fp32 plain
version on the CPU and is held against the reference's kernel path — the
Pallas program in interpret mode, under ``backend_scope("pallas")`` — at
1e-5 on deviations and costs.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on JAX x64)
from repro.core import asymmetric_batched as ja
from repro.core.duration import theoretical_duration as jax_theoretical
from repro.kernels import ops as jops
from repro_torch.convert import DURATION_FIELDS, duration_model_from_numpy
from repro_torch.core import asymmetric_batched as ta

B, N = 5, 6
SOLVER = dict(damping=0.6, max_iters=300, tol=1e-5)
F64_TOL = 1e-10
KERNEL_TOL = 1e-5
CPU = dict(device="cpu")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0.0, atol=tol)


@pytest.fixture(scope="module")
def game():
    rng = np.random.default_rng(0)
    costs = rng.uniform(0.5, 12.0, (B, N))
    gammas = rng.uniform(0.2, 1.0, (B, N))
    jdur = jax_theoretical(N)
    tdur = duration_model_from_numpy(
        {f: np.asarray(getattr(jdur, f)) for f in DURATION_FIELDS})
    jsol = ja.solve_heterogeneous(costs, gammas, jdur, **SOLVER)
    tsol = ta.solve_heterogeneous(costs, gammas, tdur, **SOLVER, **CPU)
    return dict(costs=costs, gammas=gammas, jdur=jdur, tdur=tdur,
                jsol=jsol, tsol=tsol, p=np.asarray(jsol.p))


def test_best_response_matches_including_a_zero():
    slope = np.array([-3.0, 0.0, 2.0, 2.0, 1.0, -1e-300, 5.0])
    cost = np.array([1.0, 0.0, 2.0, 1.0, 3.0, 0.0, 5.0])
    gamma = np.array([0.5, 0.5, 0.5, 0.0, 0.0, 0.3, 0.0])
    got = ta.best_response_given_slope(
        torch.tensor(slope), torch.tensor(cost), torch.tensor(gamma))
    want = ja.best_response_given_slope(jnp.asarray(slope), jnp.asarray(cost),
                                        jnp.asarray(gamma))
    assert bool(torch.isfinite(got).all())
    _close(got, want, 1e-15)


def test_solve_matches_reference(game):
    jsol, tsol = game["jsol"], game["tsol"]
    _close(tsol.p, jsol.p, F64_TOL)
    np.testing.assert_array_equal(_np(tsol.iters), np.asarray(jsol.iters))
    np.testing.assert_array_equal(_np(tsol.converged),
                                  np.asarray(jsol.converged))
    assert tsol.p.dtype == torch.float64 and tsol.batch == B


@pytest.mark.parametrize("max_iters", [0, 4])
def test_lanes_freeze_like_the_vmapped_while_loop(game, max_iters):
    """With few sweeps some lanes stop converged and the rest at the cap;
    frozen lanes keep their profile and sweep count."""
    kw = dict(SOLVER, max_iters=max_iters, tol=1e-2)
    jsol = ja.solve_heterogeneous(game["costs"], game["gammas"],
                                  game["jdur"], **kw)
    tsol = ta.solve_heterogeneous(game["costs"], game["gammas"],
                                  game["tdur"], **kw, **CPU)
    _close(tsol.p, jsol.p, F64_TOL)
    np.testing.assert_array_equal(_np(tsol.iters), np.asarray(jsol.iters))
    np.testing.assert_array_equal(_np(tsol.converged),
                                  np.asarray(jsol.converged))


def test_broadcasting_p0_and_table_stack(game):
    """(N,) costs against (B, N) gammas, an explicit p0 and a (B, N+1)
    stack of tables give the same program as the plain call."""
    costs0 = game["costs"][0]
    table = _np(game["tdur"].table())
    base = ta.solve_heterogeneous(np.tile(costs0, (B, 1)), game["gammas"],
                                  game["tdur"], **SOLVER, **CPU)
    sol = ta.solve_heterogeneous(costs0, game["gammas"],
                                 np.tile(table, (B, 1)),
                                 p0=np.full(N, 0.5), **SOLVER, **CPU)
    _close(sol.p, base.p, 0.0)
    one = ta.solve_heterogeneous(costs0, game["gammas"][:1], game["tdur"],
                                 **SOLVER, **CPU)
    p1, conv1, it1 = one.single()
    _close(p1, base.p[0], 0.0)
    assert (conv1, it1) == (bool(base.converged[0]), int(base.iters[0]))
    with pytest.raises(ValueError):
        base.single()
    with pytest.raises(ValueError):
        ta.solve_heterogeneous(game["costs"], game["gammas"][:, :3],
                               game["tdur"], **CPU)


def test_verify_ref_matches_reference(game):
    want = ja.verify_equilibrium_batched(game["costs"], game["gammas"],
                                         game["jdur"], game["p"])
    got = ta.verify_equilibrium_batched(game["costs"], game["gammas"],
                                        game["tdur"], game["p"],
                                        backend="ref", **CPU)
    _close(got, want, F64_TOL)
    # an off-equilibrium profile has a profitable deviation
    off = ta.verify_equilibrium_batched(game["costs"], game["gammas"],
                                        game["tdur"], np.full((B, N), 0.9),
                                        backend="ref", **CPU)
    assert bool((off > 1e-3).all())


def test_social_cost_ref_matches_reference(game):
    want = ja.social_cost_batched(game["costs"], game["jdur"], game["p"])
    got = ta.social_cost_batched(game["costs"], game["tdur"], game["p"],
                                 backend="ref", **CPU)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=F64_TOL)


def test_planner_matches_reference(game):
    want = ja.planner_batched(game["costs"], game["jdur"], game["p"])
    got = ta.planner_batched(game["costs"], game["tdur"], game["p"], **CPU)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_poa_report_ref_matches_reference(game):
    want = ja.poa_report(game["costs"], game["gammas"], game["jdur"],
                         **SOLVER)
    got = ta.poa_report(game["costs"], game["gammas"], game["tdur"],
                        backend="ref", **SOLVER, **CPU)
    for field in ("deviation", "opt_p", "poa"):
        _close(getattr(got, field), getattr(want, field), F64_TOL)
    for field in ("ne_cost", "opt_cost"):
        np.testing.assert_allclose(_np(getattr(got, field)),
                                   np.asarray(getattr(want, field)),
                                   rtol=F64_TOL)
    _close(got.solution.p, want.solution.p, F64_TOL)
    assert got.batch == B


def test_kernel_path_matches_reference_kernel_path(game):
    """Default (kernel) backend on the CPU vs the Pallas program."""
    with jops.backend_scope("pallas"):
        want_dev = ja.verify_equilibrium_batched(
            game["costs"], game["gammas"], game["jdur"], game["p"])
        want_cost = ja.social_cost_batched(game["costs"], game["jdur"],
                                           game["p"])
    got_dev = ta.verify_equilibrium_batched(game["costs"], game["gammas"],
                                            game["tdur"], game["p"], **CPU)
    got_cost = ta.social_cost_batched(game["costs"], game["tdur"], game["p"],
                                      **CPU)
    _close(got_dev, want_dev, KERNEL_TOL)
    np.testing.assert_allclose(_np(got_cost), np.asarray(want_cost),
                               rtol=KERNEL_TOL)


def test_kernel_path_poa_report_matches(game):
    with jops.backend_scope("pallas"):
        want = ja.poa_report(game["costs"], game["gammas"], game["jdur"],
                             **SOLVER)
    got = ta.poa_report(game["costs"], game["gammas"], game["tdur"],
                        **SOLVER, **CPU)
    _close(got.deviation, want.deviation, KERNEL_TOL)
    _close(got.poa, want.poa, KERNEL_TOL)
    _close(got.opt_p, want.opt_p, 0.0)


def test_entry_points_default_to_cuda(game, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = (game["costs"], game["gammas"], game["tdur"])
    for call in (lambda: ta.solve_heterogeneous(*args),
                 lambda: ta.verify_equilibrium_batched(*args, game["p"]),
                 lambda: ta.social_cost_batched(game["costs"], game["tdur"],
                                                game["p"]),
                 lambda: ta.planner_batched(game["costs"], game["tdur"],
                                            game["p"]),
                 lambda: ta.poa_report(*args)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
