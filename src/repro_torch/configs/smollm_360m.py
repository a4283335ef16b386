"""smollm-360m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152. head_dim=64.
15 heads / 5 kv heads do not divide the 16-way model axis -> sequence
parallel attention fallback (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, ATTN, MLP

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49_152,
    head_dim=64,
    block_pattern=((ATTN, MLP),),
    tie_embeddings=True,
    rope_theta=10_000.0,
    grad_accum=2,
)

REDUCED = ArchConfig(
    name="smollm-reduced",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=3,
    n_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    head_dim=32,
    block_pattern=((ATTN, MLP),),
    tie_embeddings=True,
)
