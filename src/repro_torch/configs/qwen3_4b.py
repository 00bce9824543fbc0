"""Qwen3-4B: 36L d=2560 32H(kv8) d_ff=9728 vocab 151936, qk_norm, tied
embeddings. [hf:Qwen/Qwen3-*]"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151_936, rope_theta=1_000_000.0, qk_norm=True,
    tie_embeddings=True, act="swiglu", norm="rmsnorm",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=256, loss_chunk=32,
)
