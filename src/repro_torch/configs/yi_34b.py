"""Yi-34B: 60L d=7168 56H(kv8) d_ff=20480 vocab 64000 (llama-arch GQA).
[arXiv:2403.04652]"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20_480, vocab_size=64_000, rope_theta=5_000_000.0,
    act="swiglu", norm="rmsnorm",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=256, loss_chunk=32,
)
