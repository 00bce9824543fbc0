"""Falcon-Mamba-7B: 64 pure Mamba-1 layers, d=4096, ssm_state=16, d_conv=4,
expand=2 (d_inner 8192), dt_rank 256, vocab 65024; extra RMSNorms on dt/B/C.
[arXiv:2410.05355; unverified]"""
import dataclasses
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=65_024, act="swiglu", norm="rmsnorm",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256,
                  extra_norms=True, scan_chunk=128),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, vocab_size=256, loss_chunk=32,
    ssm=SSMConfig(d_state=4, d_conv=4, expand=2, dt_rank=8,
                  extra_norms=True, scan_chunk=16),
)
