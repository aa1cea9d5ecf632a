"""deepseek-v2-236b — MoE + MLA [arXiv:2405.04434].

MLA kv_lora=512; 2 shared + 160 routed experts, top-6; first layer dense.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,                # per-expert FF width
    vocab=102400,
    source="arXiv:2405.04434 (MLA kv_lora=512, 2 shared + 160 routed top-6)",
    attn="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2,
                  capacity_factor=1.25, router_aux_weight=0.003,
                  first_dense_layers=1, dense_ff=12288),
    sliding_window=4096,      # long_500k via sliding-window variant
)
