"""hymba-1.5b — hybrid: parallel attention + mamba heads [arXiv:2411.13676]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,             # GQA kv=5
    d_ff=5504,
    vocab=32001,
    source="arXiv:2411.13676 (parallel attn+mamba heads)",
    attn="gqa",
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    ssm=SSMConfig(state_dim=16, expand=1, conv_width=4),
    sliding_window=1024,      # Hymba uses SWA in most layers; native long ctx
)
