"""Qwen2.5-32B: 64L d=5120 40H(kv8) d_ff=27648 vocab 152064, QKV bias.
[hf:Qwen/Qwen2.5-*]"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=27_648, vocab_size=152_064, rope_theta=1_000_000.0, qkv_bias=True,
    act="swiglu", norm="rmsnorm",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=256, loss_chunk=32,
)
