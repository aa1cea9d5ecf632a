"""stablelm-3b — dense decoder LM [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,            # GQA kv=32 (full MHA)
    d_ff=6912,
    vocab=50304,
    source="hf:stabilityai/stablelm-2-1_6b",
    attn="gqa",
    act="swiglu",
    norm="layernorm",
    rope_theta=10000.0,
    sliding_window=4096,      # long_500k via sliding-window variant (DESIGN §4)
)
