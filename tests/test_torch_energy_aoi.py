"""Port parity: ``repro_torch.core.{comm80211ax, energy, aoi}`` and the
controller's energy hooks against the JAX reference.

Inputs are made with numpy from a seed and handed to both sides. The
float64 functions agree to 1e-12 (relative for the airtime model, whose
values span microseconds to seconds); the scalar oracles are one source
and agree exactly.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on JAX x64)
from repro.core import aoi as jaoi
from repro.core import comm80211ax as jcomm
from repro.core import energy as jenergy
from repro.core.controller import ParticipationController as JaxController
from repro.core.controller import RooflineClock as JaxClock
from repro.core.duration import theoretical_duration as jax_theoretical
from repro_torch.convert import (COMM_FIELDS, CONTROLLER_FIELDS,
                                 DURATION_FIELDS, ENERGY_FIELDS,
                                 controller_from_numpy,
                                 energy_params_from_numpy)
from repro_torch.core import aoi as taoi
from repro_torch.core import comm80211ax as tcomm
from repro_torch.core import energy as tenergy
from repro_torch.core.controller import ParticipationController, RooflineClock

TOL = 1e-12
CPU = "cpu"
N = 6
AIRTIME_KEYS = ("t_tx_s", "t_data_s", "t_overhead_s", "n_ampdu",
                "goodput_mbps", "e_tx_wh")


def _close(got: torch.Tensor, want, rtol: float = 0.0,
           atol: float = TOL) -> None:
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def grid():
    """An MCS × payload grid: payload 0, sub-A-MPDU sizes, an exact A-MPDU
    multiple, the paper's 44.73 MB update."""
    mpdu = jcomm.PAPER_COMM.a_mpdu_max_bits / 8
    payload = np.array([0.0, 1.0, 1_000.0, 13_032.0, mpdu, 3 * mpdu,
                        2.5 * mpdu, 44.73e6])
    mcs = np.array([0.5, 1.0, 2.0, 4.0, 6.0, 8.33, 10.0])
    return payload[:, None], mcs[None, :]


def test_scalar_airtime_is_the_reference_oracle(grid):
    for payload in grid[0][:, 0]:
        for bps in grid[1][0]:
            cp = jcomm.CommParams(bits_per_symbol_per_sc=float(bps))
            tp = tcomm.CommParams(bits_per_symbol_per_sc=float(bps))
            assert tcomm.airtime_model(float(payload), tp) == \
                jcomm.airtime_model(float(payload), cp)


def test_airtime_batched_matches_reference_over_grid(grid):
    payload, mcs = grid
    want = jax.jit(jcomm.airtime_model_batched)(payload, mcs)
    got = tcomm.airtime_model_batched(payload, mcs, device=CPU)
    assert got["tx_power_w"] == want["tx_power_w"]
    for key in AIRTIME_KEYS:
        assert tuple(got[key].shape) == payload.shape[:1] + mcs.shape[1:]
        _close(got[key], want[key], rtol=TOL, atol=0.0)
    zero = got["goodput_mbps"][0]
    assert bool(torch.all(zero == 0.0)) and bool(torch.isfinite(
        got["goodput_mbps"]).all())


def test_airtime_batched_equals_scalar_oracle(grid):
    payload, mcs = grid
    got = tcomm.airtime_model_batched(payload, mcs, device=CPU)
    for i, s in enumerate(payload[:, 0]):
        for j, bps in enumerate(mcs[0]):
            want = tcomm.airtime_model(
                float(s), tcomm.CommParams(bits_per_symbol_per_sc=float(bps)))
            for key in AIRTIME_KEYS:
                assert float(got[key][i, j]) == pytest.approx(
                    want[key], rel=TOL, abs=0.0)


def test_energy_params_and_scalar_functions():
    jp, tp = jenergy.EnergyParams(p_hw_w=150.0), tenergy.EnergyParams(
        p_hw_w=150.0)
    for name in ("e_tx_j", "e_participant_j", "e_idle_j"):
        assert getattr(tp, name) == getattr(jp, name)
    assert tenergy.PAPER_MODEL_BYTES == jenergy.PAPER_MODEL_BYTES
    assert tenergy.J_PER_WH == jenergy.J_PER_WH
    rng = np.random.default_rng(1)
    mask = rng.uniform(size=N) < 0.5
    p = rng.uniform(size=N)
    _close(tenergy.round_energy(torch.tensor(mask), tp),
           jenergy.round_energy(mask, jp))
    _close(tenergy.expected_round_energy(torch.tensor(p), tp),
           jenergy.expected_round_energy(p, jp))
    _close(tenergy.expected_task_energy(torch.tensor(p), 42.5, tp),
           jenergy.expected_task_energy(p, 42.5, jp), rtol=TOL)
    rounds = rng.uniform(100, 200, 7)
    _close(tenergy.task_energy(torch.tensor(rounds)),
           jenergy.task_energy(rounds), rtol=TOL)


def test_calibration_matches_reference():
    want, got = jenergy.calibrate_from_table(), tenergy.calibrate_from_table()
    for name in ENERGY_FIELDS:
        assert getattr(got, name) == pytest.approx(getattr(want, name),
                                                   rel=TOL)


def test_per_node_and_channel_rates_match_reference():
    tiers_j = [jenergy.EnergyParams(p_hw_w=150.0, t_train_s=6.0)
               if i < N // 2 else jenergy.EnergyParams() for i in range(N)]
    tiers_t = [tenergy.EnergyParams(p_hw_w=150.0, t_train_s=6.0)
               if i < N // 2 else tenergy.EnergyParams() for i in range(N)]
    for got, want in zip(tenergy.per_node_energy_rates(tiers_t, device=CPU),
                         jenergy.per_node_energy_rates(tiers_j)):
        _close(got, want)
    single = tenergy.per_node_energy_rates(tenergy.EnergyParams(), N,
                                           device=CPU)
    assert all(tuple(x.shape) == (N,) for x in single)
    with pytest.raises(ValueError, match="n_nodes"):
        tenergy.per_node_energy_rates(tenergy.EnergyParams(), device=CPU)

    mcs = np.linspace(1.0, 10.0, N)
    payload = np.linspace(1e5, 5e7, N)
    for kw in ({}, {"payload_bytes": payload}):
        got = tenergy.channel_energy_rates(mcs, tiers_t[0], device=CPU, **kw)
        want = jenergy.channel_energy_rates(mcs, tiers_j[0], **kw)
        for g, w in zip(got, want):
            _close(g, w, rtol=TOL, atol=0.0)


def test_channel_rates_at_uniform_mcs_equal_scalar_rates():
    ep = tenergy.EnergyParams()
    e_part, e_idle = tenergy.channel_energy_rates(
        np.full(N, ep.comm.bits_per_symbol_per_sc), ep, device=CPU)
    assert bool(torch.all(e_part == ep.e_participant_j))
    assert bool(torch.all(e_idle == ep.e_idle_j))


@pytest.mark.parametrize("per_node", [False, True], ids=["scalar", "per_node"])
def test_record_round_j_matches_reference(per_node):
    rng = np.random.default_rng(2)
    masks = rng.uniform(size=(9, N)) < 0.4
    if per_node:
        e_part, e_idle = rng.uniform(900, 1500, N), rng.uniform(500, 900, N)
    else:
        e_part, e_idle = 1234.5, 968.5
    jl = jenergy.EnergyLedger.create(N)
    tl = tenergy.EnergyLedger.create(N, device=CPU)
    tp = torch.tensor(e_part) if per_node else e_part
    ti = torch.tensor(e_idle) if per_node else e_idle
    for m in masks:
        jl = jl.record_round_j(m, e_part, e_idle)
        tl = tl.record_round_j(torch.tensor(m), tp, ti)
    _close(tl.per_node_j, jl.per_node_j)
    np.testing.assert_array_equal(tl.participation_counts.numpy(),
                                  np.asarray(jl.participation_counts))
    assert int(tl.rounds) == int(jl.rounds) == len(masks)
    assert tl.participation_counts.dtype == torch.int64
    for key, value in tl.summary().items():
        assert value == pytest.approx(jl.summary()[key], rel=TOL)
    _close(tl.per_node_wh, jl.per_node_wh)


def test_batched_ledger_equals_per_scenario_ledgers():
    rng = np.random.default_rng(3)
    masks = torch.tensor(rng.uniform(size=(5, 3, N)) < 0.5)
    rates = torch.tensor(rng.uniform(900, 1500, (3, 1)))
    batched = tenergy.EnergyLedger.create(N, batch=(3,), device=CPU)
    for m in masks:
        batched = batched.record_round_j(m, rates, 900.0)
    for b in range(3):
        one = tenergy.EnergyLedger.create(N, device=CPU)
        for m in masks:
            one = one.record_round_j(m[b], rates[b], 900.0)
        assert torch.equal(one.per_node_j, batched.per_node_j[b])
    assert tuple(batched.total_wh.shape) == (3,)


@pytest.mark.parametrize("churn", [False, True], ids=["all_present",
                                                      "present_mask"])
def test_aoi_tracker_matches_reference(churn):
    rng = np.random.default_rng(4)
    masks = rng.uniform(size=(15, N)) < 0.35
    present = rng.uniform(size=(15, N)) < 0.7
    jt = jaoi.AoITracker.create(N)
    tt = taoi.AoITracker.create(N, device=CPU)
    for m, h in zip(masks, present):
        jt = jt.update(m, h if churn else None)
        tt = tt.update(torch.tensor(m), torch.tensor(h) if churn else None)
    for name in ("age", "cum_age", "per_node_aoi"):
        _close(getattr(tt, name), getattr(jt, name))
    np.testing.assert_array_equal(tt.tracked.numpy(), np.asarray(jt.tracked))
    assert int(tt.rounds) == int(jt.rounds)
    _close(tt.mean_aoi, jt.mean_aoi)


def test_controller_energy_hooks_match_reference():
    jax_ctrl = JaxController(n_nodes=N, duration_model=jax_theoretical(N),
                             energy_params=jenergy.EnergyParams(p_hw_w=180.0))
    ctrl = controller_from_numpy(
        {f: getattr(jax_ctrl, f) for f in CONTROLLER_FIELDS},
        {f: np.asarray(getattr(jax_ctrl.duration_model, f))
         for f in DURATION_FIELDS},
        energy_fields={f: getattr(jax_ctrl.energy_params, f)
                       for f in ENERGY_FIELDS},
        comm_fields={f: getattr(jax_ctrl.energy_params.comm, f)
                     for f in COMM_FIELDS},
        device=CPU)
    assert ctrl.energy_params == energy_params_from_numpy(
        dataclasses.asdict(jax_ctrl.energy_params))
    assert ctrl.energy_params.e_participant_j == \
        jax_ctrl.energy_params.e_participant_j
    ledger = ctrl.new_ledger()
    assert tuple(ledger.per_node_j.shape) == (N,)
    assert ledger.per_node_j.device == torch.device(CPU)

    clock = dict(flops_per_step=3.1e12, hbm_bytes_per_step=2.2e9,
                 steps_per_round=5, chips=2, peak_flops=67e12,
                 hbm_bw=3.35e12, chip_power_w=700.0)
    jclock, tclock = JaxClock(**clock), RooflineClock(**clock)
    assert tclock.t_train_s == jclock.t_train_s
    assert tclock.p_hw_w == jclock.p_hw_w
    assert ctrl.with_roofline(tclock).energy_params == energy_params_from_numpy(
        dataclasses.asdict(jax_ctrl.with_roofline(jclock).energy_params))
    with pytest.raises(TypeError):
        RooflineClock(flops_per_step=1e12, hbm_bytes_per_step=1e9)
