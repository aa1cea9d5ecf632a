"""Port parity for the slice as a whole: ``ParticipationController.
solve_batched`` on (B, N) fleets against the JAX controller, in every
ported mode; the port's device default; and the rule that the port
imports neither JAX nor the JAX package.

Under ``backend_scope("ref")`` the port runs the reference's default
program and its profiles agree to 1e-10. On its default kernel path (the
kernel's fp32 plain version on the CPU) it is held against the reference's
kernel path (Pallas in interpret mode). There the fp32 social costs only
choose among the fixed points of the same f64 solve, and two starts that
reach one equilibrium stop up to the solver's tolerance apart (3e-5 in
scenarios 0 and 1 here; scenario 2 has two distinct equilibria), so those
profiles are held at ten times the Gauss-Seidel ``tol`` of 1e-5.
"""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on JAX x64)
from repro.core.controller import ParticipationController as JaxController
from repro.core.duration import theoretical_duration as jax_theoretical
from repro.kernels import ops as jops
from repro_torch.convert import (CONTROLLER_FIELDS, DURATION_FIELDS,
                                 controller_from_numpy)
from repro_torch.core.controller import ParticipationController
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parents[1]
B, N = 3, 6
F64_TOL = 1e-10
PICK_TOL = 1e-4      # 10 × the Gauss-Seidel tol
MODES = ["ne", "ne_worst", "centralized", "fixed", "mechanism"]
MECHANISM = dict(coarse=3, gamma_max=2.0)


@pytest.fixture(scope="module")
def fleet():
    rng = np.random.default_rng(5)
    costs = rng.uniform(0.5, 12.0, (B, N))
    gammas = rng.uniform(0.2, 1.0, (B, N))
    jax_ctrl = JaxController(n_nodes=N, duration_model=jax_theoretical(N),
                             fixed_p=0.3, target_poa=1.1)
    fields = {f: getattr(jax_ctrl, f) for f in CONTROLLER_FIELDS}
    dur_fields = {f: np.asarray(getattr(jax_ctrl.duration_model, f))
                  for f in DURATION_FIELDS}
    ctrl = controller_from_numpy(fields, dur_fields, device="cpu")
    return dict(costs=costs, gammas=gammas, jax=jax_ctrl, port=ctrl)


def _kwargs(mode):
    return MECHANISM if mode == "mechanism" else {}


def _close(got: torch.Tensor, want, tol: float) -> None:
    assert got.dtype == torch.float64 and tuple(got.shape) == (B, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.0,
                               atol=tol)


@pytest.mark.parametrize("mode", MODES)
def test_ref_program_matches_reference(fleet, mode):
    want = fleet["jax"].solve_batched(fleet["gammas"], fleet["costs"],
                                      mode=mode, **_kwargs(mode))
    with tops.backend_scope("ref"):
        got = fleet["port"].solve_batched(fleet["gammas"], fleet["costs"],
                                          mode=mode, **_kwargs(mode))
    _close(got, want, F64_TOL)


@pytest.mark.parametrize("mode", ["ne", "ne_worst", "mechanism"])
def test_kernel_path_matches_reference_kernel_path(fleet, mode):
    with jops.backend_scope("pallas"):
        want = fleet["jax"].solve_batched(fleet["gammas"], fleet["costs"],
                                          mode=mode, **_kwargs(mode))
    tops.reset_dispatch_stats()
    got = fleet["port"].solve_batched(fleet["gammas"], fleet["costs"],
                                      mode=mode, **_kwargs(mode))
    assert set(tops.dispatch_stats()["ops.poibin"]) == {"kernel"}
    _close(got, want, PICK_TOL)


def test_controller_fields_carried(fleet):
    port, jax_ctrl = fleet["port"], fleet["jax"]
    for f in CONTROLLER_FIELDS:
        assert getattr(port, f) == getattr(jax_ctrl, f), f
    assert port.device == torch.device("cpu")


def test_unported_regimes_raise(fleet):
    port = fleet["port"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.solve_batched(np.full(B, 0.5), np.full(B, 2.0))     # (B,)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.solve_batched()                                    # scalars
    with pytest.raises(NotImplementedError, match="coalition"):
        port.solve_batched(fleet["gammas"], fleet["costs"], mode="coalition")
    with pytest.raises(ValueError, match="unknown mode"):
        port.solve_batched(fleet["gammas"], fleet["costs"], mode="nash")
    with pytest.raises(ValueError, match="n_nodes"):
        port.solve_batched(fleet["gammas"][:, :4], fleet["costs"][:, :4])


def test_device_defaults_to_cuda_and_raises_without_it(fleet, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dur = fleet["port"].duration_model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParticipationController(n_nodes=N, duration_model=dur)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParticipationController(n_nodes=N, duration_model=dur,
                                device="cuda")
    ctrl = ParticipationController(n_nodes=N, duration_model=dur,
                                   device="cpu")
    assert ctrl.device == torch.device("cpu")


def test_duration_model_size_must_match(fleet):
    with pytest.raises(ValueError, match="N=6"):
        ParticipationController(n_nodes=N + 1,
                                duration_model=fleet["port"].duration_model,
                                device="cpu")


def _port_files() -> list[Path]:
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


#: Every module of the port, slice by slice: the import check below must
#: reach each of them.
PORT_MODULES = (
    "__init__", "convert", "device", "rng",
    "core/__init__", "core/poibin", "core/duration", "core/aoi",
    "core/utility", "core/asymmetric_batched", "core/controller",
    "core/comm80211ax", "core/energy",
    "kernels/__init__", "kernels/build", "kernels/ops", "kernels/ref",
    "kernels/poibin_dft", "kernels/fedavg_agg",
    "optim/__init__", "optim/base", "optim/sgd",
    "data/__init__", "data/synthetic",
    "federated/__init__", "federated/participation", "federated/client",
    "federated/server", "federated/tasks", "federated/simulation",
    "federated/campaign",
    "configs/__init__", "configs/base", "configs/stablelm_3b",
    "configs/phi4_mini_3_8b", "configs/gemma_2b", "configs/rwkv6_3b",
    "configs/hymba_1_5b", "configs/olmoe_1b_7b", "configs/internvl2_26b",
    "configs/minicpm3_4b", "configs/deepseek_v2_236b", "configs/whisper_tiny",
    "configs/resnet18_cifar",
    "models/__init__", "models/runtime", "models/layers",
    "models/transformer", "models/registry",
    "kernels/flash_attention", "kernels/fused_ce",
)


def test_import_check_reaches_every_port_module():
    checked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for module in PORT_MODULES:
        assert f"src/repro_torch/{module}.py" in checked, module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name} imports {name}"
