"""internvl2-26b — VLM: InternViT (stub) + InternLM2 backbone [arXiv:2404.16821].

The vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (InternViT-6B output dim 3200); the framework
implements the projector MLP + the 48-layer InternLM2 language backbone.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,             # GQA kv=8
    d_ff=16384,
    vocab=92553,
    source="arXiv:2404.16821 (InternViT + InternLM2)",
    attn="gqa",
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    sliding_window=4096,      # long_500k via sliding-window variant
    n_patches=256,            # one 448px tile -> 256 visual tokens
    d_frontend=3200,          # InternViT-6B hidden size
)
