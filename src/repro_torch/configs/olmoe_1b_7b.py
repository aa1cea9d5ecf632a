"""olmoe-1b-7b — MoE decoder LM, 64 experts top-8 [arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,                # per-expert FF width
    vocab=50304,
    source="arXiv:2409.02060 (64 experts top-8)",
    attn="gqa",
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=64, top_k=8, n_shared=0,
                  capacity_factor=1.25, router_aux_weight=0.01),
    sliding_window=4096,      # long_500k via sliding-window variant
)
