"""phi4-mini-3.8b — dense decoder LM, RoPE+SwiGLU+GQA [arXiv:2412.08905]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,             # GQA kv=8
    d_ff=8192,
    vocab=200064,
    source="arXiv:2412.08905 (RoPE SwiGLU GQA)",
    attn="gqa",
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    sliding_window=4096,      # long_500k via sliding-window variant
)
