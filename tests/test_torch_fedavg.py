"""Port parity: the ``fedavg_agg`` kernel's plain version, its dispatch and
the FedAvg server against the JAX reference; the port's optimizers.

The plain version (what the kernel wrapper runs for a CPU tensor) is held
against ``repro.kernels.ref.fedavg_agg_ref`` and against the Pallas kernel
in interpret mode, run as ``tests/test_kernels.py`` runs it, at the
reference's own tolerances: 2e-5 for fp32 (and bf16 outputs compared in
fp32) and 2e-6 for float64 slabs, which round-trip through fp32. The
all-zero mask returns the previous global cast through fp32, bitwise.
``server.fedavg_merge`` (backend ``ref`` on both sides) agrees to one
fp32 ulp: both sum fp32 products over the client axis, in orders that may
differ.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on JAX x64)
from repro.federated.server import ConvergenceTracker as JaxTracker
from repro.federated.server import fedavg_merge as jax_merge
from repro.kernels import ref as jref
from repro.kernels.fedavg_agg import fedavg_agg as pallas_fedavg_agg
from repro.optim import apply_updates as jax_apply
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import sgd as jax_sgd
from repro_torch.federated.server import ConvergenceTracker, fedavg_merge
from repro_torch.kernels import fedavg_agg as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.optim import apply_updates, clip_by_global_norm, sgd

TOL = {np.float32: 2e-5, np.float64: 2e-6}
DT = {np.float32: torch.float32, np.float64: torch.float64}
CPU = "cpu"


def _case(n: int, p: int, dtype, seed: int, mask: str):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(p).astype(dtype)
    c = rng.standard_normal((n, p)).astype(dtype)
    if mask == "bool":
        m = rng.uniform(size=n) < 0.5
        m[0] = True
    elif mask == "zero":
        m = np.zeros(n, bool)
    else:                                    # participation × data weights
        m = ((rng.uniform(size=n) < 0.7) * rng.uniform(0.5, 3.0, n)
             ).astype(np.float32)
    return g, c, m


CASES = [(4, 1000, 256), (7, 999, 512), (1, 777, 256), (50, 4096, 2048),
         (3, 100, 2048)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n,p,bp", CASES,
                         ids=[f"n{n}_p{p}" for n, p, _ in CASES])
def test_plain_version_matches_oracle_and_pallas(n, p, bp, dtype):
    g, c, m = _case(n, p, dtype, seed=n * 7 + p, mask="bool")
    want = np.asarray(jref.fedavg_agg_ref(g, c, m))
    pallas = np.asarray(pallas_fedavg_agg(g, c, m, block_p=bp,
                                          interpret=True))
    got = tref.fedavg_agg_ref(torch.from_numpy(g), torch.from_numpy(c),
                              torch.from_numpy(m))
    assert got.dtype == DT[dtype] and tuple(got.shape) == (p,)
    for other in (want, pallas):
        np.testing.assert_allclose(got.numpy(), other, rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("n", [1, 5])
def test_all_zero_mask_returns_global_through_fp32_bitwise(n):
    g, c, m = _case(n, 300, np.float64, seed=n, mask="zero")
    want = g.astype(np.float32).astype(np.float64)
    pallas = np.asarray(pallas_fedavg_agg(g, c, m, block_p=128,
                                          interpret=True))
    got = tk.fedavg_agg(torch.from_numpy(g), torch.from_numpy(c),
                        torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pallas, want)


def test_weighted_mask_matches_oracle_and_pallas():
    g, c, m = _case(9, 1500, np.float64, seed=3, mask="weights")
    want = np.asarray(jref.fedavg_agg_ref(g, c, m))
    pallas = np.asarray(pallas_fedavg_agg(g, c, m, block_p=512,
                                          interpret=True))
    got = tref.fedavg_agg_ref(torch.from_numpy(g), torch.from_numpy(c),
                              torch.from_numpy(m)).numpy()
    for other in (want, pallas):
        np.testing.assert_allclose(got, other, rtol=2e-6, atol=2e-6)


def test_bf16_plain_version_matches_oracle():
    g, c, m = _case(6, 700, np.float32, seed=11, mask="bool")
    jg, jc = jnp.asarray(g, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16)
    want = np.asarray(jref.fedavg_agg_ref(jg, jc, m), np.float32)
    got = tref.fedavg_agg_ref(torch.from_numpy(g).bfloat16(),
                              torch.from_numpy(c).bfloat16(),
                              torch.from_numpy(m))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-5,
                               atol=2e-5)


def test_batched_call_equals_per_scenario_calls():
    rng = np.random.default_rng(12)
    g = torch.from_numpy(rng.standard_normal((5, 333)))
    c = torch.from_numpy(rng.standard_normal((5, 4, 333)))
    m = torch.from_numpy(rng.uniform(size=(5, 4)) < 0.5)
    m[2] = False                              # an empty round inside a batch
    tk.reset_counts()
    out = tk.fedavg_agg(g, c, m)
    assert (tk.counts.plain, tk.counts.launches) == (1, 0)
    for b in range(5):
        assert torch.equal(out[b], tref.fedavg_agg_ref(g[b], c[b], m[b]))
    assert torch.equal(out[2], g[2].float().double())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    g = torch.zeros(2, 10, dtype=torch.float64)
    c = torch.zeros(2, 3, 10, dtype=torch.float64)
    m = torch.ones(2, 3, dtype=torch.bool)
    with pytest.raises(TypeError, match="share"):
        tk.fedavg_agg(g, c.float(), m)
    with pytest.raises(TypeError, match="share"):
        tk.fedavg_agg(g.half(), c.half(), m)
    with pytest.raises(ValueError, match="mask"):
        tk.fedavg_agg(g, c, m[:, :2])
    with pytest.raises(ValueError, match="clients"):
        tk.fedavg_agg(g, c[:, :, :9], m)
    with pytest.raises(ValueError, match="clients"):
        tk.fedavg_agg(g, c[:, :0], m[:, :0])
    with pytest.raises(ValueError, match="global"):
        tk.fedavg_agg(g[None], c[None], m[None])


def _tree(seed: int, n: int, batch: tuple = ()):
    rng = np.random.default_rng(seed)
    shapes = {"w": (13, 7), "b": (5,), "s": ()}
    g = {k: rng.standard_normal(batch + s) for k, s in shapes.items()}
    c = {k: rng.standard_normal(batch + (n,) + s) for k, s in shapes.items()}
    return g, c


def test_server_merge_matches_reference_to_one_fp32_ulp():
    g, c = _tree(6, 4)
    mask = np.asarray([1, 0, 1, 1], bool)
    weights = np.asarray([2.0, 1.0, 0.5, 3.0])
    for w in (None, weights):
        want = jax_merge(g, c, mask, None if w is None else jnp.asarray(w),
                         backend="ref")
        got = fedavg_merge({k: torch.from_numpy(v) for k, v in g.items()},
                           {k: torch.from_numpy(v) for k, v in c.items()},
                           torch.from_numpy(mask),
                           None if w is None else torch.from_numpy(w),
                           backend="ref")
        for k in g:
            w32 = np.asarray(want[k], np.float32)
            assert got[k].dtype == torch.float64
            ulp = np.spacing(np.abs(w32)).astype(np.float64)
            assert np.all(np.abs(got[k].numpy() - np.asarray(want[k])) <= ulp)


def test_server_kernel_backend_matches_ref_backend_batched():
    g, c = _tree(7, 5, batch=(3,))
    g = {k: torch.from_numpy(v) for k, v in g.items()}
    c = {k: torch.from_numpy(v) for k, v in c.items()}
    mask = torch.from_numpy(np.random.default_rng(8).uniform(size=(3, 5))
                            < 0.5)
    mask[1] = False
    tops.reset_dispatch_stats()
    got = fedavg_merge(g, c, mask)                     # default: kernel
    want = fedavg_merge(g, c, mask, backend="ref")
    stats = tops.dispatch_stats()
    assert stats["server.fedavg_merge"] == {"kernel": 1, "ref": 1}
    assert stats["ops.fedavg_merge"] == {"kernel": 1}
    for k in g:
        assert got[k].shape == g[k].shape
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-6, atol=2e-6)
        assert torch.equal(got[k][1], g[k][1].float().double())


def test_mixed_dtype_leaves_merge_in_fp32_and_keep_their_dtypes():
    g, c = _tree(9, 4)
    g = {k: torch.from_numpy(v) for k, v in g.items()}
    c = {k: torch.from_numpy(v) for k, v in c.items()}
    g["b"], c["b"] = g["b"].bfloat16(), c["b"].bfloat16()
    mask = torch.tensor([True, False, True, True])
    got = fedavg_merge(g, c, mask, backend="kernel")
    want = fedavg_merge(g, c, mask, backend="ref")
    for k in g:
        assert got[k].dtype == g[k].dtype and got[k].shape == g[k].shape
        np.testing.assert_allclose(got[k].double().numpy(),
                                   want[k].double().numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_single_leaf_merge_reads_the_slab_as_it_lies(monkeypatch):
    """The campaign hands its flat (B, N, P) slab over as one leaf: the
    kernel must receive that very buffer, not a copy."""
    slab = torch.randn(2, 3, 11, dtype=torch.float64)
    theta = torch.randn(2, 11, dtype=torch.float64)
    seen = {}

    def spy(global_flat, client_flat, mask):
        seen["ptrs"] = (global_flat.data_ptr(), client_flat.data_ptr())
        return tref.fedavg_agg_ref(global_flat, client_flat, mask)

    monkeypatch.setattr(tops, "fedavg_agg", spy)
    fedavg_merge({"theta": theta}, {"theta": slab},
                 torch.ones(2, 3, dtype=torch.bool), backend="kernel")
    assert seen["ptrs"] == (theta.data_ptr(), slab.data_ptr())


def test_convergence_tracker_matches_reference():
    """The float32 target is 0.7300000190734863: a float64 accuracy of
    0.73 misses it, one a hair above it hits."""
    accs = [0.5, 0.7300000190734864, 0.75, 0.73, 0.8, 0.9, 0.95, 0.2]
    jt, tt = JaxTracker.create(0.73, 3), ConvergenceTracker.create(
        0.73, 3, device=CPU)
    assert tt.target.dtype == torch.float32
    for r, a in enumerate(accs):
        jt = jt.update(jnp.asarray(a, jnp.float64), jnp.asarray(r, jnp.int32))
        tt = tt.update(torch.tensor(a, dtype=torch.float64), r)
        assert int(tt.converged_at) == int(jt.converged_at)
        assert int(tt.streak) == int(jt.streak)
    assert bool(tt.converged) and int(tt.converged_at) == 6
    frozen = tt.masked_update(torch.tensor(0.1, dtype=torch.float64), 9,
                              torch.tensor(False))
    assert int(frozen.streak) == int(tt.streak)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_and_apply_updates_match_reference(momentum):
    rng = np.random.default_rng(9)
    params = {"a": rng.standard_normal((4, 3)), "b": rng.standard_normal(5)}
    jopt, topt = jax_sgd(0.15, momentum), sgd(0.15, momentum)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        grads = {k: rng.standard_normal(v.shape) for k, v in params.items()}
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                             js, jp)
        tu, ts = topt.update({k: torch.from_numpy(v)
                              for k, v in grads.items()}, ts, tp)
        jp, tp = jax_apply(jp, ju), apply_updates(tp, tu)
        for k in params:
            assert tu[k].dtype == torch.float32
            assert tp[k].dtype == torch.float64
            np.testing.assert_array_equal(tu[k].numpy(), np.asarray(ju[k]))
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(10)
    grads = {"a": rng.standard_normal((6, 2)) * 3, "b": rng.standard_normal(4)}
    jc, jn = jax_clip({k: jnp.asarray(v) for k, v in grads.items()}, 1.5)
    tc, tn = clip_by_global_norm({k: torch.from_numpy(v)
                                  for k, v in grads.items()}, 1.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in grads:
        assert tc[k].dtype == torch.float64
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6, atol=1e-7)
