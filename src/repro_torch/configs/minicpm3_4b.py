"""minicpm3-4b — dense decoder LM with MLA [hf:openbmb/MiniCPM3-4B]."""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,            # MLA: kv heads = q heads over the latent cache
    d_ff=6400,
    vocab=73448,
    source="hf:openbmb/MiniCPM3-4B (MLA)",
    attn="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    sliding_window=4096,      # long_500k via sliding-window variant
)
