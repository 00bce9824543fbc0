"""Qwen3-30B-A3B: 48L d=2048 32H(kv4) MoE 128e top-8, d_ff_expert=768,
vocab 151936. [hf:Qwen/Qwen3-30B-A3B]"""
import dataclasses
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151_936, rope_theta=1_000_000.0, qk_norm=True,
    act="swiglu", norm="rmsnorm",
    moe=MoEConfig(n_experts=128, top_k=8, n_shared_experts=0,
                  d_ff_expert=768, norm_topk_prob=True),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256, loss_chunk=32,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, dispatch_chunk=64,
                  capacity_factor=4.0),
)
