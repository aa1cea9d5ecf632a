"""rwkv6-3b (Finch) — attention-free RNN with data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,                # attention-free
    n_kv_heads=0,
    d_ff=8960,
    vocab=65536,
    source="arXiv:2404.05892 (Finch, data-dependent decay)",
    attn="none",
    act="swiglu",             # rwkv channel-mix uses squared relu; see models/rwkv.py
    norm="layernorm",
    ssm=SSMConfig(head_dim=64, state_dim=64),   # wkv head size 64 -> 40 heads
)
