"""Port parity for the dense transformer family: ``repro_torch.models``
(layers, transformer, registry) and ``repro_torch.configs`` against the JAX
reference, on the reference's own parameters carried across with
:func:`repro_torch.convert.model_params_from_numpy`.

Tiny configs as in ``tests/test_task_factory.py:46-48`` (1–2 layers,
d_model 32–64, vocab 64–512): stablelm (layernorm, SwiGLU, MHA), a
phi4-mini GQA case (rmsnorm, 4 query heads on 1 kv head) and gemma (GeGLU,
tied embeddings, the embedding scale); parameters made with numpy in the
reference's tree. Tolerances: float32 forward, loss
and logits 1e-5 (the same fp32 arithmetic summed in other orders; JAX
calls are jitted). bfloat16: the reference's bf16 kernel tolerance, 3e-2
(``tests/test_kernels.py:15``), on the loss, and on the logits and hidden
states relative to the tensor's largest magnitude: both frameworks round
every product to bf16, at places that differ, so an error of a few bf16
ulps of the largest activations (measured 0.040 at |x| ≤ 3, 1.4%) reaches
the small entries too.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES
from repro.models import runtime as jruntime
from repro.models import transformer as jtransformer
from repro.models.layers import apply_rope as jax_rope
from repro.models.registry import param_count as jax_param_count
from repro_torch.configs import ARCHITECTURES as PORT_ARCHITECTURES
from repro_torch.configs import get_config
from repro_torch.convert import (model_config_from_numpy,
                                 model_params_from_numpy)
from repro_torch.models import layers, runtime, transformer
from repro_torch.models.registry import get_model, param_count

CPU = "cpu"
F32_TOL = 1e-5
BF16_TOL = 3e-2


def _tiny(name: str, **over):
    return dataclasses.replace(ARCHITECTURES[name].reduced(), **over)


CONFIGS = {
    "stablelm": lambda: _tiny("stablelm-3b", n_layers=2, d_model=32,
                              n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
                              vocab=64),
    "phi4-gqa": lambda: _tiny("phi4-mini-3.8b", d_model=64, head_dim=16,
                              d_ff=128, vocab=128),
}


def _gemma():
    return _tiny("gemma-2b", n_layers=1, d_model=32, head_dim=16, d_ff=64,
                 vocab=96)


def _port_cfg(cfg):
    return model_config_from_numpy(dataclasses.asdict(cfg))


def _jax_outputs(cfg):
    """The reference's logits, hidden states and losses (plain and through
    the ``"ref"`` kernel oracles), in one jitted call."""
    def fn(p, tokens, labels):
        batch = {"tokens": tokens, "labels": labels}
        out = {"logits": jtransformer.forward(cfg, p, tokens)[0],
               "hidden": jtransformer.forward(cfg, p, tokens,
                                              return_hidden=True)[0],
               "loss": jtransformer.lm_loss(cfg, p, batch)}
        with jruntime.kernel_scope("ref"):
            out["loss_ref"] = jtransformer.lm_loss(cfg, p, batch)
        return out
    return jax.jit(fn)


def _numpy_params(cfg, rng: np.random.Generator) -> dict:
    """Parameters in the reference's tree, made with numpy: weights at the
    reference init's scale, norm scales near 1 and biases near 0."""
    shapes = jax.eval_shape(lambda: jtransformer.init_lm(
        cfg, jax.random.PRNGKey(0))[0])

    def leaf(path, sds):
        name = str(getattr(path[-1], "key", path[-1]))
        x = rng.standard_normal(sds.shape).astype(np.float32)
        if name == "scale":
            x = 1.0 + 0.1 * x
        elif name == "bias":
            x = 0.1 * x
        else:
            x = x * (cfg.d_ff if name == "w_down" else cfg.d_model) ** -0.5
        return jnp.asarray(x, sds.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _make(cfg, seed: int, seq: int) -> dict:
    rng = np.random.default_rng(seed)
    jparams = _numpy_params(cfg, rng)
    tokens = rng.integers(0, cfg.vocab, (2, seq))
    labels = rng.integers(0, cfg.vocab, (2, seq))
    want = _jax_outputs(cfg)(jparams, tokens, labels)
    return dict(cfg=cfg, port_cfg=_port_cfg(cfg), jparams=jparams,
                params=model_params_from_numpy(
                    jax.tree.map(np.asarray, jparams), device=CPU),
                tokens=tokens, labels=labels,
                want={k: np.asarray(v, np.float32) for k, v in want.items()})


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    return _make(CONFIGS[request.param](), 3, 12)


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0.0,
                               atol=tol)


def test_configs_are_the_references():
    assert set(PORT_ARCHITECTURES) == set(ARCHITECTURES)
    for name, cfg in ARCHITECTURES.items():
        port = get_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
        assert dataclasses.asdict(port.reduced()) == \
            dataclasses.asdict(cfg.reduced())
        assert port.resolved_head_dim == cfg.resolved_head_dim
        assert _port_cfg(cfg) == port


def test_params_carried_with_flat_names_and_shapes(model):
    params, jparams = model["params"], model["jparams"]
    flat = {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in flat.items()}
    assert "layers.body.attn.wq" in params
    assert param_count(params) == jax_param_count(jparams)


def test_init_lm_shapes_dtypes_and_truncation(model):
    gen = torch.Generator(device=CPU)
    gen.manual_seed(0)
    params = get_model(model["port_cfg"]).init(gen)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in model["params"].items()}
    cfg = model["port_cfg"]
    embed = params["embed"]
    assert embed.dtype == layers._dtype(cfg.param_dtype)
    assert float(embed.abs().max()) <= 2 * cfg.d_model ** -0.5
    wq = params["layers.body.attn.wq"]
    assert float(wq.abs().max()) <= 2 * cfg.d_model ** -0.5
    assert float(wq.std()) == pytest.approx(
        0.88 * cfg.d_model ** -0.5, rel=0.1)   # N(0, 1) cut at ±2σ


def test_apply_rope_matches_reference():
    x = np.random.default_rng(5).standard_normal((2, 7, 3, 8)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7))
    want = jax_rope(x, pos, 10000.0)
    got = layers.apply_rope(torch.from_numpy(x),
                            torch.from_numpy(np.array(pos)), 10000.0)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("backend", [None, "ref", "kernel"])
def test_forward_logits_and_hidden_match_reference(model, backend):
    pcfg, want = model["port_cfg"], model["want"]
    tokens = torch.from_numpy(model["tokens"])
    with runtime.kernel_scope(backend):
        got, aux = transformer.forward(pcfg, model["params"], tokens)
        got_h, _ = transformer.forward(pcfg, model["params"], tokens,
                                       return_hidden=True)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want["logits"], F32_TOL)
    _close(got_h, want["hidden"], F32_TOL)
    logits = get_model(pcfg).logits(model["params"], {"tokens": tokens})
    _close(logits, want["logits"], F32_TOL)


def _port_loss(m: dict, backend: str | None) -> torch.Tensor:
    batch = {"tokens": torch.from_numpy(m["tokens"]),
             "labels": torch.from_numpy(m["labels"])}
    with runtime.kernel_scope(backend):
        return get_model(m["port_cfg"]).loss(m["params"], batch)


@pytest.mark.parametrize("backend", [None, "ref", "kernel"])
def test_lm_loss_matches_reference(model, backend):
    got = _port_loss(model, backend)
    assert got.dtype == torch.float32 and got.dim() == 0
    want = model["want"]["loss" if backend is None else "loss_ref"]
    _close(got, want, F32_TOL)


def test_gemma_tied_embeddings_scale_and_geglu_match_reference():
    cfg = _gemma()
    assert cfg.tie_embeddings and cfg.act == "geglu"
    rng = np.random.default_rng(9)
    jparams = _numpy_params(cfg, rng)
    tokens = rng.integers(0, cfg.vocab, (2, 12))
    want = jax.jit(lambda p, t: jtransformer.forward(cfg, p, t)[0])(
        jparams, tokens)
    params = model_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device=CPU)
    assert "lm_head" not in params
    got, _ = transformer.forward(_port_cfg(cfg), params,
                                 torch.from_numpy(tokens))
    _close(got, want, F32_TOL)


def test_bf16_loss_logits_and_hidden_match_reference():
    cfg = dataclasses.replace(CONFIGS["stablelm"](), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    m = _make(cfg, 6, 16)
    assert all(v.dtype == torch.bfloat16 for v in m["params"].values())
    tokens = torch.from_numpy(m["tokens"])
    for name, hidden in (("logits", False), ("hidden", True)):
        want = m["want"][name]
        got, _ = transformer.forward(m["port_cfg"], m["params"], tokens,
                                     return_hidden=hidden)
        assert got.dtype == (torch.bfloat16 if hidden else torch.float32)
        _close(got, want, BF16_TOL * np.abs(want).max())
    for backend in (None, "ref", "kernel"):
        want = m["want"]["loss" if backend is None else "loss_ref"]
        _close(_port_loss(m, backend), want, BF16_TOL)


@pytest.mark.parametrize("name,item", [
    ("rwkv6-3b", "7.1"), ("hymba-1.5b", "7.2"), ("olmoe-1b-7b", "7.3"),
    ("internvl2-26b", "7.3"), ("whisper-tiny", "7.3"),
    ("resnet18-cifar", "7.3")])
def test_other_families_raise_naming_their_item(name, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        get_model(get_config(name))


def test_unported_paths_raise():
    cfg = _port_cfg(CONFIGS["stablelm"]())
    with pytest.raises(NotImplementedError, match="item 7.4"):
        transformer.forward(cfg, {}, torch.zeros((1, 2), dtype=torch.long),
                            remat=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        layers.attention_apply(cfg, {}, torch.zeros(1, 2, 32),
                               torch.zeros(1, 2), cache={})
    with pytest.raises(NotImplementedError, match="item 7.3"):
        transformer.init_lm(get_config("minicpm3-4b").reduced(),
                            torch.Generator())
    with pytest.raises(ValueError):
        with runtime.kernel_scope("pallas"):
            pass
