"""Port parity for the model kernels: ``flash_attention`` and ``fused_ce``
(their plain versions, the CPU side of their wrappers, and the
``torch.autograd.Function`` dispatch of :mod:`repro_torch.kernels.ops`)
against the JAX reference.

Inputs are made with numpy from a seed. Tolerances: the plain versions
against :mod:`repro.kernels.ref` and the interpret-mode Pallas kernels at
the reference's fp32 2e-5 (``tests/test_kernels.py:14``): the same fp32
arithmetic summed in other orders. The autograd dispatch against the
oracle and its VJP, and ``vmap(vmap(grad))`` against a Python loop, on the
CPU: 1e-6 (the same torch functions, batched or not).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value, vmap

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.fused_ce import fused_ce as jax_fused_ce
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_ce as fc
from repro_torch.kernels import ops, ref

TOL = dict(atol=2e-5, rtol=2e-5)


def _arrays(seed: int, *shapes) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _qkv(b, s, h, kv, d, seed=0):
    return _arrays(seed, (b, s, h, d), (b, s, kv, d), (b, s, kv, d))


def _ce(t, d, v, seed=1, lead=()):
    h, w = _arrays(seed, (*lead, t, d), (*lead, d, v))
    labels = np.random.default_rng(seed + 1).integers(0, v, (*lead, t))
    return h, w * d ** -0.5, labels


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("b,s,h,kv,d,causal,window", [
    (2, 40, 4, 2, 16, True, 0),     # GQA
    (1, 33, 3, 1, 8, True, 7),      # MQA, ragged, sliding window
    (2, 24, 2, 2, 16, False, 0),    # MHA, non-causal
])
def test_flash_attention_ref_matches_reference(b, s, h, kv, d, causal,
                                               window):
    q, k, v = _qkv(b, s, h, kv, d)
    want = jax.jit(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=causal, window=window))(q, k, v)
    got = ref.flash_attention_ref(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_ce_ref_matches_reference():
    h, w, labels = _ce(37, 24, 101)
    want = jax.jit(jref.fused_ce_ref)(h, w, labels)
    got = ref.fused_ce_ref(*_t(h, w, labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_plain_matches_pallas_interpret():
    q, k, v = _qkv(1, 40, 4, 2, 16, seed=3)
    want = jax.jit(lambda q, k, v: jax_flash(
        q, k, v, causal=True, window=9, block_q=16, block_k=16,
        interpret=True))(q, k, v)
    got = fa.flash_attention(*_t(q, k, v), causal=True, window=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_ce_plain_matches_pallas_interpret():
    h, w, labels = _ce(40, 16, 70, seed=4)
    want = jax.jit(lambda h, w, lab: jax_fused_ce(
        h, w, lab, block_t=16, block_v=32, interpret=True))(
        h, w, labels.astype(np.int32))
    got = fc.fused_ce(*_t(h, w, labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    fa.reset_counts()
    fc.reset_counts()
    q, k, v = (x.bfloat16() for x in _t(*_qkv(1, 12, 2, 1, 8)))
    out = fa.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    want = ref.flash_attention_ref(q.float(), k.float(), v.float())
    assert torch.equal(out, want.bfloat16())
    h, w, labels = _t(*_ce(9, 8, 30, lead=(3,)))
    got = fc.fused_ce(h.bfloat16(), w.bfloat16(), labels)
    assert got.shape == (3, 9) and got.dtype == torch.float32
    assert torch.equal(got, ref.fused_ce_ref(h.bfloat16(), w.bfloat16(),
                                             labels))
    assert (fa.counts.plain, fa.counts.launches) == (1, 0)
    assert (fc.counts.plain, fc.counts.launches) == (1, 0)


@pytest.mark.parametrize("bad", ["shape", "groups", "dtype"])
def test_flash_attention_rejects(bad):
    q, k, v = _t(*_qkv(1, 8, 4, 2, 8))
    if bad == "shape":
        k = k[:, :4]
    elif bad == "groups":
        k, v = k[:, :, :1].expand(1, 8, 3, 8), v[:, :, :1].expand(1, 8, 3, 8)
    else:
        q = q.double()
    with pytest.raises((ValueError, TypeError)):
        fa.flash_attention(q, k, v)


@pytest.mark.parametrize("bad", ["labels", "vocab", "dtype"])
def test_fused_ce_rejects(bad):
    h, w, labels = _t(*_ce(6, 4, 10))
    if bad == "labels":
        labels = labels.float()
    elif bad == "vocab":
        w = w[:3]
    else:
        h = h.double()
    with pytest.raises((ValueError, TypeError)):
        fc.fused_ce(h, w, labels)


def test_attention_function_forward_and_vjp_match_the_oracle():
    q, k, v = _t(*_qkv(2, 20, 4, 2, 8, seed=5))
    cot = torch.from_numpy(_arrays(6, (2, 20, 4, 8))[0])

    def oracle(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=True, window=5)

    def kernel(q, k, v):
        return ops.attention(q, k, v, window=5, backend="kernel")

    out_k, vjp_k = torch.func.vjp(kernel, q, k, v)
    out_r, vjp_r = torch.func.vjp(oracle, q, k, v)
    assert torch.equal(out_k, out_r)
    for gk, gr in zip(vjp_k(cot), vjp_r(cot)):
        np.testing.assert_allclose(gk.numpy(), gr.numpy(), atol=1e-6)


def test_cross_entropy_function_forward_and_vjp_match_the_oracle():
    h, w, labels = _t(*_ce(16, 8, 40, seed=7))
    out_k, vjp_k = torch.func.vjp(
        lambda h, w: ops.cross_entropy(h, w, labels, backend="kernel"), h, w)
    out_r, vjp_r = torch.func.vjp(
        lambda h, w: ref.fused_ce_ref(h, w, labels), h, w)
    assert torch.equal(out_k, out_r)
    cot = torch.linspace(0.5, 1.5, 16)
    for gk, gr in zip(vjp_k(cot), vjp_r(cot)):
        np.testing.assert_allclose(gk.numpy(), gr.numpy(), atol=1e-6)


def _loss(q, k, v, w, labels, backend):
    """A toy loss through both model kernels, as a client step runs them:
    attention, then the cross-entropy of its flattened output."""
    out = ops.attention(q, k, v, window=6, backend=backend)
    hidden = out.reshape(-1, out.shape[-2] * out.shape[-1])
    return torch.mean(ops.cross_entropy(hidden, w, labels, backend=backend))


@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_vmap_vmap_grad_matches_a_loop_with_one_call_each(backend):
    """The campaign's ``vmap(vmap(grad_and_value(loss)))`` over (scenario,
    client) replicas, labels shared by the scenarios: one kernel call per
    dispatch, gradients equal to a Python loop over the replicas."""
    nb, nc, b, s, h, kv, d, vocab = 2, 3, 2, 10, 4, 2, 4, 11
    rng = np.random.default_rng(8)
    q, k, v = _t(*[rng.standard_normal((nb, nc, b, s, n, d))
                   .astype(np.float32) for n in (h, kv, kv)])
    w = torch.from_numpy(rng.standard_normal((nb, nc, h * d, vocab))
                         .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, vocab, (nc, b * s)))
    per_client = vmap(grad_and_value(_loss, argnums=(0, 1, 2, 3)),
                      in_dims=(0, 0, 0, 0, 0, None))
    per_replica = vmap(per_client, in_dims=(0, 0, 0, 0, None, None))
    fa.reset_counts()
    fc.reset_counts()
    grads, values = per_replica(q, k, v, w, labels, backend)
    calls = (fa.counts.plain, fc.counts.plain)
    assert calls == ((1, 1) if backend == "kernel" else (0, 0))
    for i in range(nb):
        for j in range(nc):
            want = grad(_loss, argnums=(0, 1, 2, 3))(
                q[i, j], k[i, j], v[i, j], w[i, j], labels[j], backend)
            np.testing.assert_allclose(
                float(values[i, j]),
                float(_loss(q[i, j], k[i, j], v[i, j], w[i, j], labels[j],
                            backend)), atol=1e-6)
            for g, wg in zip(grads, want):
                np.testing.assert_allclose(g[i, j].numpy(), wg.numpy(),
                                           atol=1e-6)


def test_dispatch_sites_are_counted():
    ops.reset_dispatch_stats()
    q, k, v = _t(*_qkv(1, 6, 2, 2, 4))
    h, w, labels = _t(*_ce(5, 4, 9))
    ops.attention(q, k, v)
    ops.attention(q, k, v, backend="ref")
    ops.cross_entropy(h, w, labels)
    stats = ops.dispatch_stats()
    assert stats["ops.attention"] == {"kernel": 1, "ref": 1}
    assert stats["ops.cross_entropy"] == {"kernel": 1}

