"""RecurrentGemma-2B (Griffin): 26L d=2560, RG-LRU + local attention 1:2
pattern (rec,rec,attn), 10H MQA(kv1) head_dim 256, window 2048, GeGLU
d_ff=7680, vocab 256000, tied embeddings, final logit softcap 30.
[arXiv:2402.19427]"""
import dataclasses
from .base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256_000, rope_theta=10_000.0,
    sliding_window=2048, act="geglu", norm="rmsnorm", tie_embeddings=True,
    final_logit_softcap=30.0,
    rglru=RGLRUConfig(lru_width=2560, d_conv=4, c_exponent=8.0,
                      pattern=("rec", "rec", "attn"), scan_chunk=256),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=192, vocab_size=256, sliding_window=16, loss_chunk=32,
    rglru=RGLRUConfig(lru_width=64, d_conv=4, pattern=("rec", "rec", "attn"),
                      scan_chunk=16),
)
