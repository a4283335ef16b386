"""moonshot-v1-16b-a3b — kimi/moonlight, 64e top-6 [hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (GQA kv=16) d_ff=1408 (per expert) vocab=163840, MoE 64e top-6.
"""
from repro_torch.configs.base import ArchConfig, ATTN, MOE

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    block_pattern=((ATTN, MOE),),
    n_experts=64,
    top_k=6,
    rope_theta=50_000.0,
    fsdp=True,
    grad_accum=4,
    kv_cache_dtype="int8",
)

REDUCED = ArchConfig(
    name="moonshot-reduced",
    family="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=512,
    block_pattern=((ATTN, MOE),),
    n_experts=8,
    top_k=3,
)
