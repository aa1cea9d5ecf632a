"""Port parity: ``repro_torch.core.poibin`` and the ``poibin_dft`` kernel's
plain version against the JAX reference, plus the port's dispatch layer.

Inputs are made with numpy from a seed and handed to both sides. The f64
game-layer functions agree to 1e-12 (same formulas; only the summation
order of a few reductions differs). The kernel's plain version is held at
2e-6, the reference's own kernel tolerance (``tests/test_kernels.py``):
its fp32 DFT differs from the Pallas program's fp32 matmuls by rounding.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on JAX x64, as the game layer does)
from repro.core import poibin as jp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.poibin_dft import poibin_dft as pallas_poibin_dft
from repro_torch.core import poibin as tp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import poibin_dft as tk
from repro_torch.kernels import ref as tref

F64_TOL = 1e-12
KERNEL_TOL = 2e-6


def _jit(fn, **kw):
    """The reference function under ``jax.jit``: one compile per shape is
    far cheaper on the CPU than op-by-op eager dispatch."""
    return jax.jit(fn, **kw)


J = {name: _jit(getattr(jp, name)) for name in (
    "poibin_pmf", "poibin_pmf_recursive", "poibin_mean", "poibin_cdf",
    "poibin_convolve", "poibin_pmf_loo", "poibin_pmf_batched",
    "poibin_pmf_loo_all", "expected_duration")}
J["symmetric_pmf"] = _jit(jp.symmetric_pmf, static_argnums=1)
J_DFT_REF = _jit(jref.poibin_dft_ref, static_argnames="with_loo")


def _profiles():
    # Two lengths only (N = 6 and N = 1): every new shape costs the JAX side
    # a compile per primitive.
    rng = np.random.default_rng(7)
    return {
        "random": rng.uniform(0.0, 1.0, 6),
        "corners": np.array([0.0, 0.5, 1.0, 0.25, 0.75, 0.0]),
        "half": np.full(6, 0.5),
        "n1": np.array([0.3]),
        "n1_zero": np.array([0.0]),
        "n1_one": np.array([1.0]),
    }


PROFILES = _profiles()


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=0.0, atol=tol)


@pytest.mark.parametrize("name", sorted(PROFILES))
@pytest.mark.parametrize("fn", ["poibin_pmf", "poibin_pmf_recursive",
                                "poibin_mean", "poibin_cdf"])
def test_profile_functions_match_reference(fn, name):
    p = PROFILES[name]
    _close(getattr(tp, fn)(torch.tensor(p)), J[fn](jnp.asarray(p)),
           F64_TOL)


@pytest.mark.parametrize("p_i", [0.0, 0.2, 0.5, 0.8, 1.0])
def test_convolve_and_loo_match_reference(p_i):
    p = PROFILES["random"]
    f_j = J["poibin_pmf_recursive"](jnp.asarray(p))
    f_t = torch.tensor(np.asarray(f_j))
    _close(tp.poibin_pmf_loo(f_t, torch.tensor(p_i, dtype=torch.float64)),
           J["poibin_pmf_loo"](f_j, p_i), F64_TOL)
    padded = np.append(np.asarray(f_j)[:-1], 0.0)
    _close(tp.poibin_convolve(torch.tensor(padded),
                            torch.tensor(p_i, dtype=torch.float64)),
           J["poibin_convolve"](jnp.asarray(padded), p_i), F64_TOL)


def test_loo_corners_invert_convolution():
    """p_i ∈ {0, 1/2, 1}: deconvolving a node folded in gives back the rest."""
    rest = tp.poibin_pmf_recursive(torch.tensor(PROFILES["random"][:-1]))
    rest = torch.nn.functional.pad(rest, (0, 1))
    for p_i in (0.0, 0.5, 1.0):
        p_i = torch.tensor(p_i, dtype=torch.float64)
        full = tp.poibin_convolve(rest, p_i)
        _close(tp.poibin_pmf_loo(full, p_i), rest.numpy(), F64_TOL)


def test_batched_loo_lanes_match_reference():
    """One call over (B, N) lanes, each lane its own fwd/bwd branch."""
    rng = np.random.default_rng(3)
    p = rng.uniform(0.0, 1.0, (3, 6))
    p[0, :3] = [0.0, 0.5, 1.0]
    pmf_t, loo_t = tp.poibin_pmf_loo_all(torch.tensor(p))
    pmf_j, loo_j = J["poibin_pmf_loo_all"](jnp.asarray(p))
    _close(pmf_t, pmf_j, F64_TOL)
    _close(loo_t, loo_j, F64_TOL)
    _close(tp.poibin_pmf_batched(torch.tensor(p)),
           J["poibin_pmf_batched"](jnp.asarray(p)), F64_TOL)


@pytest.mark.parametrize("p_scalar", [0.0, 0.37, 0.5, 1.0])
def test_symmetric_pmf_and_expected_duration(p_scalar):
    _close(tp.symmetric_pmf(p_scalar, 5), J["symmetric_pmf"](p_scalar, 5),
           F64_TOL)
    d = np.linspace(80.0, 40.0, 7)
    p = PROFILES["corners"]
    _close(tp.expected_duration(torch.tensor(p), torch.tensor(d)),
           J["expected_duration"](jnp.asarray(p), jnp.asarray(d)),
           F64_TOL)


# ---------------------------------------------------------------------------
# The kernel's plain version
# ---------------------------------------------------------------------------

def _kernel_inputs(b: int, n: int) -> np.ndarray:
    p = np.random.default_rng(b * 100 + n).uniform(0.0, 1.0, (b, n))
    p[0, 0] = 0.0
    if n > 1:
        p[0, 1] = 1.0
    return p


KERNEL_SHAPES = [(1, 1), (13, 7), (3, 16)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_plain_version_matches_reference_oracle(shape, dtype):
    """``poibin_dft_ref`` restates ``repro.kernels.ref.poibin_dft_ref``."""
    p = _kernel_inputs(*shape).astype(dtype)
    tol = F64_TOL if dtype == np.float64 else KERNEL_TOL
    pmf_t, loo_t = tref.poibin_dft_ref(torch.tensor(p))
    pmf_j, loo_j = J_DFT_REF(jnp.asarray(p))
    assert pmf_t.dtype == torch.tensor(p).dtype
    _close(pmf_t, pmf_j, tol)
    _close(loo_t, loo_j, tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_wrapper_on_cpu_matches_pallas_interpret(shape, dtype):
    """The wrapper on a CPU tensor (the plain version, fp32 arithmetic)
    against the Pallas kernel in interpret mode, both variants."""
    p = _kernel_inputs(*shape).astype(dtype)
    before = (tk.counts.launches, tk.counts.plain)
    pmf_t, loo_t = tk.poibin_dft(torch.tensor(p))
    pmf_only = tk.poibin_dft(torch.tensor(p), with_loo=False)
    assert (tk.counts.launches, tk.counts.plain) == (before[0], before[1] + 2)
    pmf_j, loo_j = pallas_poibin_dft(jnp.asarray(p), block_b=4,
                                     interpret=True)
    assert pmf_t.dtype == loo_t.dtype == torch.tensor(p).dtype
    assert tuple(loo_t.shape) == (shape[0], shape[1], shape[1] + 1)
    _close(pmf_t, pmf_j, KERNEL_TOL)
    _close(loo_t, loo_j, KERNEL_TOL)
    _close(pmf_only, pmf_j, KERNEL_TOL)


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        tk.poibin_dft(torch.zeros(3))
    with pytest.raises(TypeError):
        tk.poibin_dft(torch.zeros((2, 3), dtype=torch.int64))


def test_dft_tables_match_reference_construction():
    cos, sin = tk.dft_tables(7, torch.device("cpu"))
    idx = jnp.arange(8)
    ang = 2.0 * jnp.pi * jnp.outer(idx, idx) / 8
    np.testing.assert_array_equal(cos.numpy(),
                                  np.asarray(jnp.cos(ang).astype(jnp.float32)))
    np.testing.assert_array_equal(sin.numpy(),
                                  np.asarray(jnp.sin(ang).astype(jnp.float32)))


# ---------------------------------------------------------------------------
# Dispatch: precedence, env var, counters
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_dispatch(monkeypatch):
    monkeypatch.delenv(tops.ENV_VAR, raising=False)
    prev = tops.set_backend(None)
    tops.reset_dispatch_stats()
    yield
    tops.set_backend(prev)


def test_env_var_has_its_own_name():
    assert tops.ENV_VAR == "REPRO_TORCH_KERNEL_BACKEND"
    assert tops.ENV_VAR != jops.ENV_VAR


def test_resolution_precedence(clean_dispatch, monkeypatch):
    assert tops.resolve_backend(default="ref") == "ref"
    assert tops.resolve_backend(default="kernel") == "kernel"
    monkeypatch.setenv(jops.ENV_VAR, "ref")          # the reference's var
    assert tops.resolve_backend(default="kernel") == "kernel"
    monkeypatch.setenv(tops.ENV_VAR, "ref")          # env beats default
    assert tops.resolve_backend(default="kernel") == "ref"
    with tops.backend_scope("kernel"):               # scope beats env
        assert tops.resolve_backend(default="ref") == "kernel"
        assert tops.resolve_backend("ref") == "ref"  # argument beats all
    assert tops.resolve_backend(default="kernel") == "ref"
    with pytest.raises(ValueError):
        tops.resolve_backend("pallas")


def test_bogus_env_value_is_ignored(clean_dispatch, monkeypatch, capsys):
    monkeypatch.setenv(tops.ENV_VAR, "triton-please")
    monkeypatch.setattr(tops, "_env_warned", False)
    assert tops.resolve_backend(default="kernel") == "kernel"
    assert "ignoring" in capsys.readouterr().err


def test_dispatch_stats_count_sites(clean_dispatch):
    p = torch.tensor(_kernel_inputs(2, 4))
    tops.poibin(p)
    tops.poibin_pmf(p, backend="ref")
    tp.poibin_pmf_loo_all(p)
    assert tops.dispatch_stats() == {
        "ops.poibin": {"kernel": 1}, "ops.poibin_pmf": {"ref": 1},
        "poibin.pmf_loo_all": {"ref": 1}}
    tops.reset_dispatch_stats()
    assert tops.dispatch_stats() == {}


def test_ops_backends_agree(clean_dispatch):
    p = torch.tensor(_kernel_inputs(3, 6))
    pmf_k, loo_k = tops.poibin(p)
    pmf_r, loo_r = tops.poibin(p, backend="ref")
    _close(pmf_k, pmf_r.numpy(), KERNEL_TOL)
    _close(loo_k, loo_r.numpy(), KERNEL_TOL)
    _close(tops.poibin_pmf(p), pmf_r.numpy(), KERNEL_TOL)
