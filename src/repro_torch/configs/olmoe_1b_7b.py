"""olmoe-1b-7b — 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) d_ff=1024 (per expert) vocab=50304, MoE 64e top-8.
"""
from repro_torch.configs.base import ArchConfig, ATTN, MOE

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50_304,
    block_pattern=((ATTN, MOE),),
    n_experts=64,
    top_k=8,
    rope_theta=10_000.0,
    grad_accum=2,
)

REDUCED = ArchConfig(
    name="olmoe-reduced",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab_size=512,
    block_pattern=((ATTN, MOE),),
    n_experts=8,
    top_k=2,
)
