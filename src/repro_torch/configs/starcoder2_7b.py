"""StarCoder2-7B: 32L d=4608 36H(kv4) d_ff=18432 vocab 49152; LayerNorm,
GELU MLP, biases, RoPE, 4k sliding window. [arXiv:2402.19173]"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
    d_ff=18_432, vocab_size=49_152, rope_theta=100_000.0, qkv_bias=True,
    mlp_bias=True, sliding_window=4096, act="gelu", norm="layernorm",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=256, sliding_window=16, loss_chunk=32,
)
