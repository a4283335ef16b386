"""seamless-m4t-large-v2 — enc-dec, multimodal [arXiv:2308.11596; hf].

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206 (padded to 256256
for the 16-way vocab shard). Encoder-decoder: 24 encoder + 24 decoder
layers (HF checkpoint convention). The speech frontend is a STUB: input
specs provide precomputed audio-frame embeddings.
AccMPEG-applicable: audio-frame embeddings are the lossy sensor stream.
"""
from repro_torch.configs.base import ArchConfig, ATTN, MLP

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    block_pattern=((ATTN, MLP),),
    enc_dec=True,
    n_frontend_tokens=0,  # encoder length comes from the shape cell
    norm="layernorm",
    act="gelu",
    rope_theta=0.0,  # learned positions in seamless; we use sinusoidal
    grad_accum=2,
    accmpeg_applicable=True,
)

REDUCED = ArchConfig(
    name="seamless-reduced",
    family="audio",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    block_pattern=((ATTN, MLP),),
    enc_dec=True,
    norm="layernorm",
    act="gelu",
    rope_theta=0.0,
    accmpeg_applicable=True,
)
