"""Port parity for the campaign slice: ``repro_torch.federated`` (masks,
local training, the campaign engine, the oracles) against the JAX
reference, on shared draws.

The port does not reproduce threefry, so the parity runs replay JAX's own
random inputs into the port: :func:`_replay` computes, with
``jax.random``, every uniform the reference's ``bernoulli`` calls draw
(masks in ``p``'s dtype, churn and deadline in float64), the initial
parameters and the client batches, after checking that ``uniform < p``
gives ``jax.random.bernoulli``'s coins on those keys. Tolerances:

* masks, ``k_history``, ``rounds``, ``converged_at``, straggler and
  presence counts: equal;
* ledgers, AoI and the float64 means over them (energy, participation
  rate): 1e-12 (the same float64 arithmetic, reduced in other orders);
* final parameters: 1e-6 — both sides keep the float32 round trips
  (SGD step, update, merge), so parameters are float32 values whose last
  bit can differ where the two sum the fp32 merge in another order;
* accuracies: equal (k/128 of the same validation batch).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on JAX x64)
from repro.core.energy import EnergyParams as JaxEnergy
from repro.core.energy import per_node_energy_rates as jax_rates
from repro.federated import campaign as jcamp
from repro.federated.client import local_train as jax_local_train
from repro.federated.simulation import FLConfig as JaxFL
from repro.federated.simulation import \
    run_heterogeneous_reference as jax_hetero_reference
from repro.federated.tasks import synthetic_mlp_task as jax_task
from repro.optim import sgd as jax_sgd
from repro_torch.convert import (FL_CONFIG_FIELDS, fl_config_from_numpy,
                                 params_from_numpy)
from repro_torch.core.energy import EnergyLedger, EnergyParams
from repro_torch.core.energy import per_node_energy_rates
from repro_torch.federated import campaign as tcamp
from repro_torch.federated.client import local_train, make_local_train
from repro_torch.federated.participation import (mask_schedule,
                                                 participant_count,
                                                 round_mask)
from repro_torch.federated.simulation import (FLConfig,
                                              run_heterogeneous_reference,
                                              run_simulation,
                                              run_simulation_reference)
from repro_torch.federated.tasks import synthetic_mlp_task
from repro_torch.optim import sgd

CPU = "cpu"
B, N, R = 4, 6, 12
SEEDS = [5, 6, 7, 5]
LR = 0.15
CHURN = dict(arrival=0.3, departure=0.1)
MISS = 0.1
F64_TOL = 1e-12
PARAM_TOL = 1e-6


def _fl(**kw) -> JaxFL:
    base = dict(n_clients=N, local_steps=1, batch_per_client=8,
                max_rounds=R, target_acc=0.73, seed=SEEDS[0])
    base.update(kw)
    return JaxFL(**base)


def _replay(jtask, fl: JaxFL, seeds, p: np.ndarray, arrival: float,
            departure: float, miss: float) -> dict:
    """The reference's draws for ``seeds`` as numpy arrays; checks on the
    way that ``uniform < p`` reproduces ``jax.random.bernoulli``."""
    n, rounds = fl.n_clients, fl.max_rounds
    f64 = jnp.float64

    @jax.jit
    def one(seed, p_row):
        key = jax.random.PRNGKey(seed)
        rs = jnp.arange(rounds)

        def per_round(r):
            km = jax.random.fold_in(key, jcamp.MASK_STREAM + r)
            ka, kd = jax.random.split(
                jax.random.fold_in(key, jcamp.CHURN_STREAM + r))
            kl = jax.random.fold_in(key, jcamp.DEADLINE_STREAM + r)
            u = (jax.random.uniform(km, (n,), p_row.dtype),
                 jax.random.uniform(ka, (n,), f64),
                 jax.random.uniform(kd, (n,), f64),
                 jax.random.uniform(kl, (n,), f64))
            coins = (jax.random.bernoulli(km, p_row, (n,)),
                     jax.random.bernoulli(ka, jnp.full(n, arrival), (n,)),
                     jax.random.bernoulli(kd, jnp.full(n, departure), (n,)),
                     jax.random.bernoulli(kl, jnp.full(n, miss), (n,)))
            return u, coins

        u, coins = jax.vmap(per_round)(rs)
        return u, coins, jtask.init_params(jax.random.fold_in(key, 1))

    out = {"mask": [], "arrive": [], "depart": [], "late": [], "params": []}
    for seed, p_row in zip(seeds, p):
        u, coins, params = one(jnp.uint32(seed), jnp.asarray(p_row))
        probs = (p_row, arrival, departure, miss)
        for ui, ci, pr in zip(u, coins, probs):
            np.testing.assert_array_equal(np.asarray(ui) < pr,
                                          np.asarray(ci))
        for name, ui in zip(("mask", "arrive", "depart", "late"), u):
            out[name].append(np.asarray(ui))
        out["params"].append({k: np.asarray(v) for k, v in params.items()})
    draws = {k: np.stack(out[k]) for k in ("mask", "arrive", "depart",
                                           "late")}
    draws["params"] = {k: np.stack([p[k] for p in out["params"]])
                       for k in out["params"][0]}
    batches = jax.jit(lambda: jax.vmap(lambda r: jax.vmap(
        lambda c: jtask.client_data(c, r, fl.batch_per_client,
                                    fl.local_steps))(jnp.arange(n)))(
        jnp.arange(rounds)))()
    draws["batches"] = {k: np.asarray(v) for k, v in batches.items()}
    draws["val"] = {k: np.asarray(v) for k, v in jtask.val_batch.items()}
    return draws


def _port_task(replayed: dict):
    """The port's task with the reference's client batches and validation
    batch handed across."""
    task = synthetic_mlp_task(noise=2.5, device=CPU)
    batches = {k: torch.from_numpy(np.array(v))
               for k, v in replayed["batches"].items()}

    def client_data(cids, rnd, n, steps):
        return {k: v[rnd][list(cids)] for k, v in batches.items()}

    return dataclasses.replace(
        task, client_data=client_data,
        val_batch={k: torch.from_numpy(np.array(v))
                   for k, v in replayed["val"].items()})


def _port_draws(replayed: dict, rows=slice(None)) -> tcamp.CampaignDraws:
    return tcamp.CampaignDraws.from_arrays(
        replayed["mask"][rows],
        {k: v[rows] for k, v in replayed["params"].items()},
        replayed["arrive"][rows], replayed["depart"][rows],
        replayed["late"][rows], device=CPU)


def _tiers(cls):
    return [cls(p_hw_w=150.0, t_train_s=6.0) if i < N // 2 else cls()
            for i in range(N)]


@pytest.fixture(scope="module")
def case():
    """One campaign batch run by the reference and replayed into the port:
    per-node p, two hardware tiers, churn and deadlines."""
    p = np.random.default_rng(0).uniform(0.3, 1.0, (B, N))
    fl = _fl()
    jtask = jax_task(noise=2.5)
    e_part, e_idle = jax_rates(_tiers(JaxEnergy))
    want = jcamp.run_campaigns(
        fl, *jtask.campaign_args(), jax_sgd(LR), jnp.asarray(p),
        energy_rates_j=(e_part[None], e_idle[None]),
        churn=jcamp.ChurnConfig(**CHURN),
        deadline=jcamp.DeadlineConfig(miss=MISS), seeds=SEEDS, backend="ref")
    replayed = _replay(jtask, fl, SEEDS, p, miss=MISS, **CHURN)
    port_fl = fl_config_from_numpy(dataclasses.asdict(fl))
    return dict(p=p, fl=fl, port_fl=port_fl, jtask=jtask, want=want,
                replayed=replayed, task=_port_task(replayed))


def _run_port(case, **kw) -> tcamp.CampaignResult:
    e_part, e_idle = per_node_energy_rates(_tiers(EnergyParams), device=CPU)
    return tcamp.run_campaigns(
        case["port_fl"], *case["task"].campaign_args(), sgd(LR), case["p"],
        energy_rates_j=(e_part[None], e_idle[None]),
        churn=tcamp.ChurnConfig(**CHURN),
        deadline=tcamp.DeadlineConfig(miss=MISS), seeds=SEEDS,
        draws=_port_draws(case["replayed"]), device=CPU, **kw)


def _equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.0,
                               atol=tol)


def test_fl_config_and_params_carried(case):
    fl, port_fl = case["fl"], case["port_fl"]
    assert all(getattr(port_fl, f) == getattr(fl, f)
               for f in FL_CONFIG_FIELDS)
    params = params_from_numpy(
        {k: v[0] for k, v in case["replayed"]["params"].items()}, device=CPU)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "w1": (192, 16), "b1": (16,), "w2": (16, 10), "b2": (10,)}
    assert all(v.dtype == torch.float64 for v in params.values())
    assert sum(v.numel() for v in params.values()) == 3258


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_campaigns_match_reference_on_shared_draws(case, backend):
    want = case["want"]
    got = _run_port(case, backend=backend)
    assert got.acc_history.dtype == torch.float64
    for name in ("rounds", "converged_at", "converged", "k_history",
                 "straggler_counts", "present_counts", "present_final",
                 "acc_history"):
        _equal(getattr(got, name), getattr(want, name))
    _equal(got.ledger.participation_counts, want.ledger.participation_counts)
    _equal(got.aoi.tracked, want.aoi.tracked)
    for g, w in ((got.ledger.per_node_j, want.ledger.per_node_j),
                 (got.aoi.cum_age, want.aoi.cum_age),
                 (got.aoi.age, want.aoi.age),
                 (got.per_node_aoi, want.per_node_aoi),
                 (got.energy_wh, want.energy_wh),
                 (got.participation_rate, want.participation_rate)):
        _close(g, w, F64_TOL)
    for k, v in got.params.items():
        _close(v, want.params[k], PARAM_TOL)
    # the batch holds converged and unconverged scenarios
    assert 0 < int(got.converged.sum()) < B


def test_heterogeneous_oracle_matches_reference(case):
    b = 2
    fl = _fl(seed=SEEDS[b])
    e_part, e_idle = jax_rates(_tiers(JaxEnergy))
    want = jax_hetero_reference(
        fl, *case["jtask"].campaign_args(), jax_sgd(LR),
        jnp.asarray(case["p"][b]), energy_rates_j=(e_part, e_idle),
        churn=jcamp.ChurnConfig(**CHURN),
        deadline=jcamp.DeadlineConfig(miss=MISS))
    t_part, t_idle = per_node_energy_rates(_tiers(EnergyParams), device=CPU)
    got = run_heterogeneous_reference(
        fl_config_from_numpy(dataclasses.asdict(fl)),
        *case["task"].campaign_args(), sgd(LR), case["p"][b],
        energy_rates_j=(t_part, t_idle), churn=tcamp.ChurnConfig(**CHURN),
        deadline=tcamp.DeadlineConfig(miss=MISS),
        draws=_port_draws(case["replayed"], slice(b, b + 1)), device=CPU)
    assert (got.rounds, got.converged) == (want.rounds, want.converged)
    assert got.acc_history == [float(a) for a in want.acc_history]
    for name in ("present_counts", "present_final", "straggler_counts"):
        _equal(getattr(got, name), getattr(want, name))
    _equal(got.ledger.participation_counts, want.ledger.participation_counts)
    _close(got.ledger.per_node_j, want.ledger.per_node_j, F64_TOL)
    _close(got.aoi.cum_age, want.aoi.cum_age, F64_TOL)
    _equal(got.aoi.tracked, want.aoi.tracked)


def test_campaigns_match_port_oracle_on_generator_draws():
    """Default draws (``torch.Generator`` on the CPU): every scenario of
    the engine equals the oracle run with that scenario's seed."""
    task = synthetic_mlp_task(noise=2.5, device=CPU)
    fl = FLConfig(n_clients=N, local_steps=2, batch_per_client=8,
                  max_rounds=10, target_acc=0.6, seed=0)
    p = np.random.default_rng(1).uniform(0.3, 1.0, (3, N))
    seeds = [11, 12, 11]
    e_part, e_idle = per_node_energy_rates(_tiers(EnergyParams), device=CPU)
    kw = dict(churn=tcamp.ChurnConfig(**CHURN),
              deadline=tcamp.DeadlineConfig(miss=MISS))
    res = tcamp.run_campaigns(fl, *task.campaign_args(), sgd(LR, 0.5), p,
                              energy_rates_j=(e_part[None], e_idle[None]),
                              seeds=seeds, device=CPU, **kw)
    for b, seed in enumerate(seeds):
        ref = run_heterogeneous_reference(
            dataclasses.replace(fl, seed=seed), *task.campaign_args(),
            sgd(LR, 0.5), p[b], energy_rates_j=(e_part, e_idle), device=CPU,
            **kw)
        assert ref.rounds == int(res.rounds[b])
        assert ref.acc_history == res.acc_history[b, :ref.rounds].tolist()
        assert torch.equal(ref.ledger.per_node_j, res.ledger.per_node_j[b])
        assert torch.equal(ref.aoi.cum_age, res.aoi.cum_age[b])
        assert torch.equal(ref.straggler_counts, res.straggler_counts[b])
        assert torch.equal(ref.present_counts, res.present_counts[b])
        for k, v in ref.params.items():
            _close(res.params[k][b], v.numpy(), PARAM_TOL)


def test_run_simulation_matches_its_reference():
    task = synthetic_mlp_task(noise=2.5, device=CPU)
    fl = FLConfig(n_clients=N, local_steps=1, batch_per_client=8,
                  max_rounds=8, target_acc=0.5, seed=2)
    got = run_simulation(fl, *task.campaign_args(), sgd(LR), 0.6,
                         device=CPU)
    want = run_simulation_reference(fl, *task.campaign_args(), sgd(LR), 0.6,
                                    device=CPU)
    assert (got.rounds, got.converged) == (want.rounds, want.converged)
    assert got.acc_history == want.acc_history
    assert got.energy_wh == want.energy_wh
    assert got.ledger_summary == want.ledger_summary
    assert np.isfinite(got.mean_aoi)


def test_equal_seeds_share_draws_and_masks():
    task = synthetic_mlp_task(noise=2.5, device=CPU)
    fl = FLConfig(n_clients=N, local_steps=1, batch_per_client=4,
                  max_rounds=5, target_acc=0.99, seed=3)
    draws = tcamp.generator_draws(fl, task.init_params, [3, 4, 3],
                                  dtype=torch.float64, churn=True,
                                  deadline=True, device=CPU)
    for name in ("mask", "arrive", "depart", "late"):
        x = getattr(draws, name)
        assert tuple(x.shape) == (3, 5, N) and x.dtype == torch.float64
        assert torch.equal(x[0], x[2]) and not torch.equal(x[0], x[1])
    assert torch.equal(draws.params["w1"][0], draws.params["w1"][2])
    # seeds=None: every scenario holds fl.seed; rows 0 and 2 share p
    p = np.array([[0.5] * N, [0.8] * N, [0.5] * N])
    res = tcamp.run_campaigns(fl, *task.campaign_args(), sgd(LR), p,
                              device=CPU)
    assert res.seeds.tolist() == [3, 3, 3]
    assert torch.equal(res.k_history[0], res.k_history[2])
    assert torch.equal(res.ledger.per_node_j[0], res.ledger.per_node_j[2])
    assert not torch.equal(res.k_history[0], res.k_history[1])
    f32 = tcamp.generator_draws(fl, task.init_params, [3], dtype=torch.float32,
                                churn=False, deadline=False, device=CPU)
    assert f32.mask.dtype == torch.float32 and f32.arrive is None


def test_flag_defaults_reduce_bitwise_to_the_flag_free_engine():
    task = synthetic_mlp_task(noise=2.5, device=CPU)
    fl = FLConfig(n_clients=N, local_steps=1, batch_per_client=8,
                  max_rounds=6, target_acc=0.5, seed=4)
    p = np.random.default_rng(2).uniform(0.3, 1.0, (2, N))
    args = (fl, *task.campaign_args(), sgd(LR), p)
    base = tcamp.run_campaigns(*args, device=CPU)
    for kw in ({"churn": tcamp.ChurnConfig()},
               {"deadline": tcamp.DeadlineConfig(miss=0.0)},
               {"churn": tcamp.ChurnConfig(),
                "deadline": tcamp.DeadlineConfig()}):
        other = tcamp.run_campaigns(*args, device=CPU, **kw)
        for name in ("rounds", "acc_history", "k_history", "present_counts",
                     "present_final", "straggler_counts"):
            assert torch.equal(getattr(base, name), getattr(other, name))
        for name in ("per_node_j", "participation_counts", "rounds"):
            assert torch.equal(getattr(base.ledger, name),
                               getattr(other.ledger, name))
        for name in ("age", "cum_age", "tracked"):
            assert torch.equal(getattr(base.aoi, name),
                               getattr(other.aoi, name))
        for k in base.params:
            assert torch.equal(base.params[k], other.params[k])


def test_run_campaigns_validates_its_inputs():
    task = synthetic_mlp_task(noise=2.5, device=CPU)
    fl = FLConfig(n_clients=N, local_steps=1, batch_per_client=4,
                  max_rounds=2, seed=0)
    args = (fl, *task.campaign_args(), sgd(LR))
    p = np.full((N, N), 0.5)                       # B == N
    rates = per_node_energy_rates(EnergyParams(), N, device=CPU)
    with pytest.raises(ValueError, match="ambiguous"):
        tcamp.run_campaigns(*args, p, energy_rates_j=rates, device=CPU)
    with pytest.raises(ValueError, match="per-scenario"):
        tcamp.run_campaigns(*args, p[:2], energy_rates_j=(rates[0][:3], 1.0),
                            device=CPU)
    with pytest.raises(ValueError, match="n_clients"):
        tcamp.run_campaigns(*args, p[:, :4], device=CPU)
    with pytest.raises(ValueError, match="seeds"):
        tcamp.run_campaigns(*args, p[:2], seeds=[1, 2, 3], device=CPU)
    draws = tcamp.generator_draws(fl, task.init_params, [0, 0],
                                  dtype=torch.float64, churn=False,
                                  deadline=False, device=CPU)
    with pytest.raises(ValueError, match="draws.arrive"):
        tcamp.run_campaigns(*args, p[:2], churn=tcamp.ChurnConfig(),
                            draws=draws, device=CPU)
    with pytest.raises(ValueError, match="draws.mask"):
        tcamp.run_campaigns(*args, p[:2].astype(np.float32), draws=draws,
                            device=CPU)


def test_unported_options_raise():
    task = synthetic_mlp_task(device=CPU)
    fl = FLConfig(n_clients=N, max_rounds=2)
    args = (fl, *task.campaign_args(), sgd(LR))
    for kw, item in (({"obs": object()}, "item 8"),
                     ({"mesh": object()}, "item 9"),
                     ({"batch_axis": "data"}, "item 9")):
        with pytest.raises(NotImplementedError, match=item):
            tcamp.run_campaigns(*args, 0.5, device=CPU, **kw)
        with pytest.raises(NotImplementedError, match=item):
            tcamp.build_campaign(*args, **kw)
    for fn in (run_simulation, run_simulation_reference):
        with pytest.raises(NotImplementedError, match="item 3"):
            fn(*args, 0.5, controller=object(), device=CPU)


def test_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic_mlp_task()
    task = synthetic_mlp_task(device=CPU)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcamp.run_campaigns(FLConfig(n_clients=N, max_rounds=2),
                            *task.campaign_args(), sgd(LR), 0.5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EnergyLedger.create(N)


def test_local_train_matches_reference(case):
    """Three local steps per client (the replayed batches of rounds 0-2).
    Step 0's loss is the same float64 function of the same parameters;
    later steps start from float32 parameters whose last bit may differ."""
    jtask = case["jtask"]
    jparams = {k: jnp.asarray(v[1])
               for k, v in case["replayed"]["params"].items()}
    steps = {k: np.ascontiguousarray(np.swapaxes(v[:3, :2, 0], 0, 1))
             for k, v in case["replayed"]["batches"].items()}  # (2, 3, ...)
    batches = {k: jnp.asarray(v) for k, v in steps.items()}
    task = case["task"]
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                               device=CPU)
    tb = {k: torch.from_numpy(v) for k, v in steps.items()}
    for momentum in (0.9,):          # momentum 0 runs in every campaign
        train = jax.jit(jax.vmap(
            lambda b: jax_local_train(jtask.loss_fn, jparams, b,
                                      jax_sgd(LR, momentum))))
        wparams, wlosses = train(batches)
        got = [local_train(task.loss_fn, params,
                           {k: v[c] for k, v in tb.items()},
                           sgd(LR, momentum)) for c in range(2)]
        for c, (gp, gl) in enumerate(got):
            _close(gl[:1], wlosses[c, :1], F64_TOL)
            _close(gl, wlosses[c], PARAM_TOL)
            for k in gp:
                assert gp[k].dtype == torch.float64
                _close(gp[k], wparams[k][c], PARAM_TOL)
        # the batched form over (B, N) replicas writes into its inputs
        reps = {k: v[None, None].expand(2, 2, *v.shape).clone()
                for k, v in params.items()}
        out, losses = make_local_train(task.loss_fn, sgd(LR, momentum))(
            dict(reps), tb)
        assert tuple(losses.shape) == (2, 2, 3)
        for k in params:
            assert out[k].data_ptr() == reps[k].data_ptr()
            for b in range(2):
                for c in range(2):
                    _close(out[k][b, c], got[c][0][k].numpy(), PARAM_TOL)


def test_participation_masks_and_counts():
    u = torch.tensor([[0.1, 0.6, 0.3], [0.9, 0.2, 0.5]], dtype=torch.float64)
    p = torch.tensor([0.5, 0.5, 0.3], dtype=torch.float64)
    assert round_mask(u[0], p).tolist() == [True, False, False]
    assert mask_schedule(u, p).tolist() == [[True, False, False],
                                            [False, True, False]]
    assert participant_count(mask_schedule(u, p)).tolist() == [1, 1]
    with pytest.raises(ValueError, match="per-node"):
        round_mask(u[0], torch.tensor(0.5))


def test_synthetic_data_is_deterministic_per_client_and_round():
    task = synthetic_mlp_task(device=CPU)
    a = task.client_data(range(3), 2, 8, 2)
    b = task.client_data([1, 2], 2, 8, 2)
    c = task.client_data(range(3), 3, 8, 2)
    assert tuple(a["images"].shape) == (3, 2, 8, 8, 8, 3)
    assert a["images"].dtype == torch.float64
    assert a["labels"].dtype == torch.int64
    assert torch.equal(a["images"][1:], b["images"])
    assert not torch.equal(a["images"], c["images"])
    again = synthetic_mlp_task(device=CPU)
    assert torch.equal(again.val_batch["images"], task.val_batch["images"])
    assert tuple(task.val_batch["labels"].shape) == (128,)
