"""Port parity: ``repro_torch.core.{duration, aoi, utility}`` and the
``repro_torch.convert`` carry-across against the JAX reference.

A model carried across (its fields handed over as numpy) gives the same
table up to the rounding of the polynomial's own sum: the degree-9 paper
fit has coefficients up to ~8e7 that cancel to d ≈ 40, so a different
summation order alone moves d(k) by up to ``terms·eps·Σ_j |c_j| x^j``
(measured 1.7e-9 against that bound); every other quantity is held to
1e-12. A model refitted by the port goes through its own SVD: the paper
fit is ill-conditioned (coefficients differ by ~2e-2), so its table — the
only thing the game reads — is held to a relative 1e-9 (measured 1.5e-10);
the degree-6 surrogate is well-conditioned and held to 1e-12.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on JAX x64)
from repro.core import aoi as ja
from repro.core import duration as jd
from repro.core import utility as ju
from repro_torch.convert import DURATION_FIELDS, duration_model_from_numpy
from repro_torch.core import aoi as ta
from repro_torch.core import duration as td
from repro_torch.core import utility as tu

F64_TOL = 1e-12
REFIT_RTOL = 1e-9

N_SMALL = 6
_MODELS = {
    "paper": (jd.paper_duration_model, td.paper_duration_model),
    "theoretical": (lambda: jd.theoretical_duration(N_SMALL),
                    lambda: td.theoretical_duration(N_SMALL)),
}
_JAX_MODELS: dict = {}


def _jax_model(name):
    if name not in _JAX_MODELS:
        _JAX_MODELS[name] = _MODELS[name][0]()
    return _JAX_MODELS[name]


def _carried(jax_model) -> td.DurationModel:
    return duration_model_from_numpy(
        {f: np.asarray(getattr(jax_model, f)) for f in DURATION_FIELDS})


def _poly_rounding_bound(jax_model) -> np.ndarray:
    """Per-entry rounding bound of evaluating the table's polynomial in any
    summation order: ``terms · eps · Σ_j |c_j| x^j`` on k = 0..N."""
    c = np.abs(np.asarray(jax_model.coeffs))
    x = np.clip(np.arange(jax_model.n_nodes + 1) / jax_model.n_nodes, 0.0,
                1.0)
    mag = np.stack([x ** j for j in range(c.size)], axis=-1) @ c
    return c.size * np.finfo(np.float64).eps * mag


def _close(got, want, tol=F64_TOL, rtol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    if np.ndim(tol):                      # a per-entry bound
        gap = np.abs(got - want)
        assert (gap <= tol).all(), f"gap {gap.max()} vs bound {tol.max()}"
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=tol)


def test_table_ii_copy_is_verbatim():
    np.testing.assert_array_equal(td.PAPER_TABLE_II, jd.PAPER_TABLE_II)
    assert td.PAPER_N_CLIENTS == jd.PAPER_N_CLIENTS


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_carried_model_table_matches(name):
    jm = _jax_model(name)
    tm = _carried(jm)
    assert tm.coeffs.dtype == torch.float64
    np.testing.assert_array_equal(tm.coeffs.numpy(), np.asarray(jm.coeffs))
    _close(tm.table(), jm.table(),
           tol=np.maximum(F64_TOL, _poly_rounding_bound(jm)))
    k = np.array([0.0, 0.4, 1.5, jm.n_nodes * 0.75, float(jm.n_nodes)])
    _close(tm.eval_continuous(torch.tensor(k)), jm.eval_continuous(k),
           tol=max(F64_TOL, float(_poly_rounding_bound(jm).max())))


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_refitted_model_table_matches(name):
    jm, tm = _jax_model(name), _MODELS[name][1]()
    for f in DURATION_FIELDS[1:]:
        assert getattr(tm, f) == getattr(jm, f), f
    tol = F64_TOL if name == "theoretical" else 0.0
    _close(tm.table(), jm.table(), tol=tol, rtol=REFIT_RTOL)


def test_fit_polynomial_duration_well_conditioned():
    rng = np.random.default_rng(1)
    k = np.linspace(0.0, 1.0, 12)
    d = 40.0 + 3.0 * k - 2.0 * k ** 2 + rng.normal(0.0, 0.1, k.shape)
    w = rng.uniform(0.5, 2.0, k.shape)
    _close(td.fit_polynomial_duration(k, d, degree=3, weights=w),
           jd.fit_polynomial_duration(jnp.asarray(k), jnp.asarray(d),
                                      degree=3, weights=jnp.asarray(w)),
           tol=1e-10)


P_GRID = np.array([0.0, 1e-12, 1e-3, 0.2, 0.5, 0.9, 1.0])


@pytest.mark.parametrize("fn", ["expected_aoi", "log_aoi"])
def test_aoi(fn):
    _close(getattr(ta, fn)(torch.tensor(P_GRID)),
           jax.jit(getattr(ja, fn))(jnp.asarray(P_GRID)))


@pytest.fixture(scope="module")
def models():
    jm = _jax_model("theoretical")
    return jm, _carried(jm)


@pytest.mark.parametrize("gamma,cost", [(0.0, 0.0), (0.7, 3.0)])
def test_player_utilities(models, gamma, cost):
    jm, tm = models
    jparams = ju.UtilityParams(gamma=gamma, cost=cost, n_nodes=N_SMALL)
    tparams = tu.UtilityParams(gamma=gamma, cost=cost, n_nodes=N_SMALL)
    others = np.random.default_rng(2).uniform(0.0, 1.0, N_SMALL - 1)
    for p_i in (0.1, 0.5, 1.0):
        _close(tu.player_utility(p_i, torch.tensor(others), tparams, tm),
               ju.player_utility(jnp.asarray(p_i), jnp.asarray(others),
                                 jparams, jm))
        _close(tu.symmetric_player_utility(p_i, 0.4, tparams, tm),
               ju.symmetric_player_utility(jnp.asarray(p_i),
                                           jnp.asarray(0.4), jparams, jm))


@pytest.mark.parametrize("incentive", [False, True])
def test_social_utility_and_cost(models, incentive):
    jm, tm = models
    jparams = ju.UtilityParams(gamma=0.5, cost=2.0, n_nodes=N_SMALL)
    tparams = tu.UtilityParams(gamma=0.5, cost=2.0, n_nodes=N_SMALL)
    for p in (0.05, 0.3, 0.61, 1.0):
        _close(tu.social_utility(p, tparams, tm, include_incentive=incentive),
               ju.social_utility(jnp.asarray(p), jparams, jm,
                                 include_incentive=incentive))
        _close(tu.social_cost(p, tparams, tm),
               ju.social_cost(jnp.asarray(p), jparams, jm))


def test_duration_model_from_numpy_requires_every_field():
    fields = {f: np.asarray(getattr(_jax_model("theoretical"), f))
              for f in DURATION_FIELDS if f != "rise"}
    with pytest.raises(KeyError, match="rise"):
        duration_model_from_numpy(fields)
