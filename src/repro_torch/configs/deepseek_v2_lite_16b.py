"""DeepSeek-V2-Lite 16B: 27L d=2048, MLA (kv_lora 512, rope 64), MoE 64
routed top-6 + 2 shared (d_ff 1408), first layer dense (d_ff 10944),
vocab 102400. [arXiv:2405.04434]

NB: the assignment line says "2 shared+160 routed"; 160 routed is the
DeepSeek-V2-236B figure — V2-Lite has 64 routed experts (paper Table 1 /
HF config). We follow the primary "MoE 64e top-6" spec; see DESIGN.md.
"""
import dataclasses
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10_944, vocab_size=102_400, rope_theta=10_000.0,
    act="swiglu", norm="rmsnorm",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
                  first_k_dense=1, d_ff_dense=10_944, norm_topk_prob=False),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, loss_chunk=32,
    mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16),
    moe=MoEConfig(n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=48,
                  first_k_dense=1, d_ff_dense=128, dispatch_chunk=64,
                  norm_topk_prob=False, capacity_factor=4.0),
)
