"""whisper-tiny — audio encoder-decoder [arXiv:2212.04356].

Mel-spectrogram + conv feature extractor are STUBS per the assignment:
``input_specs()`` provides precomputed frame embeddings (n_frames, d_model)
for the encoder; the framework implements the 4+4 layer transformer.
long_500k is SKIPPED (DESIGN.md §4): a bounded-audio-context ASR decoder has
no meaningful 512k-token autoregressive decode.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,               # decoder layers
    encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    source="arXiv:2212.04356 (enc-dec, conv frontend stubbed)",
    attn="gqa",
    act="gelu",
    norm="layernorm",
    n_frames=1500,            # 30 s of audio at 50 Hz after conv frontend
)
