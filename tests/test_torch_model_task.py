"""Port parity for the real-model client path: ``SyntheticLM``,
``model_task``, one ``local_train`` round and ``run_campaigns`` on a tiny
dense transformer, against the JAX reference.

The port does not reproduce threefry, so the reference's draws are handed
across: its initial parameters (:func:`repro_torch.convert.
model_params_from_numpy`), its mask uniforms (checked on the way to give
``jax.random.bernoulli``'s coins), its client batches and its validation
batch. The reference runs ``backend="ref"`` (its Pallas kernels would run
in interpret mode); the port runs its kernel backend (the kernels' plain
versions on CPU tensors) and its ``"ref"`` backend. Tolerances: token
streams, masks, ``k_history``, rounds and accuracies equal; ledgers and AoI
1e-12 (float64, other reduction orders); parameters and losses 1e-5
(float32 products summed in other orders, through SGD steps).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on JAX x64, as the campaign does)
from repro.configs import ARCHITECTURES
from repro.data.synthetic import SyntheticLM as JaxLM
from repro.federated import campaign as jcamp
from repro.federated.client import local_train as jax_local_train
from repro.federated.simulation import FLConfig as JaxFL
from repro.federated.tasks import model_task as jax_model_task
from repro.optim import sgd as jax_sgd
from repro_torch.configs import get_config
from repro_torch.convert import (fl_config_from_numpy,
                                 model_config_from_numpy,
                                 model_params_from_numpy)
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.federated import campaign as tcamp
from repro_torch.federated.client import local_train
from repro_torch.federated.tasks import model_task
from repro_torch.kernels import fedavg_agg as fk
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_ce as fc
from repro_torch.optim import sgd

CPU = "cpu"
SEQ = 8
LR = 0.5
B, N, R = 2, 3, 2
SEEDS = [4, 9]
F64_TOL = 1e-12
PARAM_TOL = 1e-5


def _cfg():
    return dataclasses.replace(
        ARCHITECTURES["stablelm-3b"].reduced(), n_layers=1, d_model=32,
        n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, vocab=64)


def _port_cfg():
    return model_config_from_numpy(dataclasses.asdict(_cfg()))


def _flat(tree) -> dict:
    return model_params_from_numpy(jax.tree.map(np.asarray, tree),
                                   device=CPU)


def _long(arrays: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64))
            for k, v in arrays.items()}


def test_synthetic_lm_chain_matches_reference():
    """The port's Markov chain, fed the reference's own random inputs,
    gives the reference's token stream."""
    lm = JaxLM(vocab=64, seed=3)

    @jax.jit
    def reference(key):
        k1, k2 = jax.random.split(key)
        inputs = (jax.random.randint(k1, (4, 1), 0, 64)[:, 0],
                  jax.random.uniform(k2, (4, 10)) > lm.order_weight,
                  jax.random.randint(jax.random.fold_in(k2, 1), (4, 10), 0,
                                     64))
        succ = jax.random.permutation(jax.random.PRNGKey(3), 64)
        return lm.batch(key, 4, 10), inputs, succ

    want, (start, noisy, rand), succ = reference(jax.random.PRNGKey(11))
    port = SyntheticLM(vocab=64, seed=3, device=CPU)
    port.__dict__["succ"] = torch.from_numpy(np.array(succ, np.int64))
    got = port.chain(torch.from_numpy(np.array(start, np.int64)),
                     torch.from_numpy(np.array(noisy)),
                     torch.from_numpy(np.array(rand, np.int64)))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_synthetic_lm_streams():
    lm = SyntheticLM(vocab=50, seed=2, device=CPU)
    assert torch.equal(torch.sort(lm.succ).values, torch.arange(50))
    a = lm.client_batch(1, 3, 6, 40, steps=2)
    assert a["tokens"].shape == (2, 6, 40) and a["tokens"].dtype == torch.int64
    assert torch.equal(a["tokens"], lm.client_batch(1, 3, 6, 40,
                                                    steps=2)["tokens"])
    assert not torch.equal(a["tokens"], lm.client_batch(1, 4, 6, 40,
                                                        steps=2)["tokens"])
    assert torch.equal(a["tokens"][..., 1:], a["labels"][..., :-1])
    follows = (lm.succ[a["tokens"]] == a["labels"]).double().mean()
    assert 0.6 < float(follows) < 0.85      # order_weight 0.7, plus chance


def test_model_task_shapes_and_determinism():
    cfg = _port_cfg()
    task = model_task(cfg, SEQ, backend="kernel", optimizer="sgd",
                      val_size=5, device=CPU)
    assert task.cfg is cfg and task.opt == "sgd"
    batch = task.client_data([0, 2], 1, 3, 2)
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        "tokens": ((2, 2, 3, SEQ), torch.int64),
        "labels": ((2, 2, 3, SEQ), torch.int64)}
    again = task.client_data([2], 1, 3, 2)
    assert torch.equal(batch["tokens"][1], again["tokens"][0])
    assert not torch.equal(batch["tokens"],
                           task.client_data([0, 2], 2, 3, 2)["tokens"])
    assert task.val_batch["tokens"].shape == (5, SEQ)
    gen = torch.Generator(device=CPU)
    gen.manual_seed(0)
    params = task.init_params(gen)
    assert params["layers.body.attn.wq"].shape == (1, 32, 2, 16)
    assert all(v.dtype == torch.float32 for v in params.values())
    assert task.loss_fn(params, {k: v[0, 0] for k, v in batch.items()}) \
        .dim() == 0


def test_model_task_unported_options_raise():
    cfg = _port_cfg()
    with pytest.raises(NotImplementedError, match="item 4"):
        model_task(cfg, partition="dirichlet", device=CPU)
    with pytest.raises(NotImplementedError, match="item 7.4"):
        model_task(cfg, remat=True, device=CPU)
    with pytest.raises(NotImplementedError, match="item 7.3"):
        model_task(get_config("resnet18-cifar").reduced(), device=CPU)
    with pytest.raises(ValueError):
        model_task(cfg, partition="shards", device=CPU)


@pytest.fixture(scope="module")
def reference():
    """One reference campaign batch on the tiny model and its draws."""
    cfg = _cfg()
    jtask = jax_model_task(cfg, SEQ, backend="ref", val_size=6)
    fl = JaxFL(n_clients=N, local_steps=1, batch_per_client=2, max_rounds=R,
               target_acc=0.99, seed=SEEDS[0])
    p = np.random.default_rng(0).uniform(0.3, 1.0, (B, N))
    want = jcamp.run_campaigns(fl, *jtask.campaign_args(), jax_sgd(LR),
                               jnp.asarray(p), seeds=SEEDS, backend="ref")

    @jax.jit
    def draws(seed, p_row):
        key = jax.random.PRNGKey(seed)

        def per_round(r):
            km = jax.random.fold_in(key, jcamp.MASK_STREAM + r)
            return (jax.random.uniform(km, (N,), p_row.dtype),
                    jax.random.bernoulli(km, p_row, (N,)))

        u, coins = jax.vmap(per_round)(jnp.arange(R))
        return u, coins, jtask.init_params(jax.random.fold_in(key, 1))

    masks, inits = [], []
    for seed, p_row in zip(SEEDS, p):
        u, coins, params = draws(jnp.uint32(seed), jnp.asarray(p_row))
        np.testing.assert_array_equal(np.asarray(u) < p_row,
                                      np.asarray(coins))
        masks.append(np.asarray(u))
        inits.append(_flat(params))
    batches = jax.jit(lambda: jax.vmap(lambda r: jax.vmap(
        lambda c: jtask.client_data(c, r, fl.batch_per_client,
                                    fl.local_steps))(jnp.arange(N)))(
        jnp.arange(R)))()
    return dict(cfg=cfg, jtask=jtask, fl=fl, p=p, want=want,
                mask=np.stack(masks),
                params={k: torch.stack([q[k] for q in inits])
                        for k in inits[0]},
                batches=_long(batches), val=_long(jtask.val_batch))


def _port_task(ref: dict, backend: str):
    batches = ref["batches"]
    return dataclasses.replace(
        model_task(_port_cfg(), SEQ, backend=backend, device=CPU),
        client_data=lambda cids, rnd, n, steps: {
            k: v[rnd][list(cids)] for k, v in batches.items()},
        val_batch=ref["val"])


def test_local_train_round_matches_reference(reference):
    jtask = reference["jtask"]
    key = jax.random.PRNGKey(5)
    jparams = jax.jit(jtask.init_params)(key)
    jbatches = jax.jit(lambda: jtask.client_data(1, 0, 2, 2))()
    want_p, want_l = jax.jit(lambda p, b: jax_local_train(
        jtask.loss_fn, p, b, jax_sgd(LR)))(jparams, jbatches)
    want_p = _flat(want_p)
    for backend in ("kernel", "ref"):
        task = model_task(_port_cfg(), SEQ, backend=backend, device=CPU)
        got_p, got_l = local_train(task.loss_fn, _flat(jparams),
                                   _long(jbatches), sgd(LR))
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                                   rtol=0.0, atol=PARAM_TOL)
        for k, v in want_p.items():
            np.testing.assert_allclose(got_p[k].numpy(), v.numpy(),
                                       rtol=0.0, atol=PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_run_campaigns_matches_reference_on_shared_draws(reference, backend):
    want = reference["want"]
    task = _port_task(reference, backend)
    draws = tcamp.CampaignDraws.from_arrays(reference["mask"],
                                            reference["params"], device=CPU)
    fl = fl_config_from_numpy(dataclasses.asdict(reference["fl"]))
    for m in (fa, fc, fk):
        m.reset_counts()
    got = tcamp.run_campaigns(fl, *task.campaign_args(), sgd(LR),
                              reference["p"], seeds=SEEDS, draws=draws,
                              device=CPU)
    launches = (fa.counts.plain, fc.counts.plain, fk.counts.plain)
    assert launches == ((R, R, R) if backend == "kernel" else (0, 0, R))
    for name in ("rounds", "converged_at", "k_history", "acc_history"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.ledger.participation_counts.numpy(),
                                  np.asarray(want.ledger.participation_counts))
    for g, w in ((got.ledger.per_node_j, want.ledger.per_node_j),
                 (got.aoi.cum_age, want.aoi.cum_age),
                 (got.mean_aoi, want.mean_aoi),
                 (got.energy_wh, want.energy_wh)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0.0,
                                   atol=F64_TOL)
    want_params = {k: torch.stack([_flat(jax.tree.map(lambda x: x[b],
                                                      want.params))[k]
                                   for b in range(B)])
                   for k in got.params}
    for k, v in want_params.items():
        assert got.params[k].dtype == torch.float32
        np.testing.assert_allclose(got.params[k].numpy(), v.numpy(),
                                   rtol=0.0, atol=PARAM_TOL, err_msg=k)
