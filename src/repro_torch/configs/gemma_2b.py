"""gemma-2b — dense decoder LM, GeGLU, MQA, head_dim=256 [arXiv:2403.08295]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,             # MQA
    d_ff=16384,
    vocab=256000,
    source="arXiv:2403.08295 (GeGLU, head_dim=256, MQA)",
    attn="gqa",
    head_dim=256,
    act="geglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    sliding_window=4096,      # long_500k via sliding-window variant
)
