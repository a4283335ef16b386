"""stablelm-3b [hf:stabilityai/stablelm-2-1_6b; unverified].

32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304. LayerNorm + qkv bias
per the StableLM-2 family.
"""
from repro_torch.configs.base import ArchConfig, ATTN, MLP

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50_304,
    block_pattern=((ATTN, MLP),),
    norm="layernorm",
    qkv_bias=True,
    rope_theta=10_000.0,
    grad_accum=4,
    kv_cache_dtype="int8",  # 32 kv heads: cache dominates decode (§Perf)
)

REDUCED = ArchConfig(
    name="stablelm-reduced",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    block_pattern=((ATTN, MLP),),
    norm="layernorm",
    qkv_bias=True,
)
