"""LLaVA-NeXT (Mistral-7B backbone): 32L d=4096 32H(kv8) d_ff=14336
vocab 32000; anyres vision tiling is a STUB frontend — input_specs provides
precomputed patch embeddings at d_model (576 base-res patches).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Assumption (DESIGN.md): Mistral 4096-token sliding window retained (v0.1
lineage) — this is what qualifies the arch for the 500k decode cell.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab_size=32_000, rope_theta=10_000.0,
    sliding_window=4096, act="swiglu", norm="rmsnorm",
    frontend="vision_patches", n_patches=576,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=256, sliding_window=16, n_patches=8, loss_chunk=32,
)
