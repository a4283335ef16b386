"""rwkv6-1.6b — Finch, data-dependent decay [arXiv:2404.05892; unverified].

24L d_model=2048 (attn-free) d_ff=7168 vocab=65536. head_size=64 -> 32 heads.
Channel-mix hidden = 7168 (3.5x). Sub-quadratic: runs long_500k.
"""
from repro_torch.configs.base import ArchConfig, RWKV, NOFF

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # derived: d_model / head_size
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65_536,
    block_pattern=((RWKV, NOFF),),
    rwkv_head_size=64,
    norm="layernorm",    # RWKV uses LayerNorm
    act="gelu",
    rope_theta=0.0,      # no rotary
    remat="full",
    grad_accum=4,
)

REDUCED = ArchConfig(
    name="rwkv6-reduced",
    family="ssm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    block_pattern=((RWKV, NOFF),),
    rwkv_head_size=32,
    rwkv_decay_lora=16,
    rwkv_gate_lora=16,
    norm="layernorm",
    act="gelu",
    rope_theta=0.0,
)
