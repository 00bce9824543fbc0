"""MusicGen-medium: 48L d=1536 24H(kv24, MHA) d_ff=6144 vocab 2048 (EnCodec
codebooks); decoder-only over audio tokens, sinusoidal positions, LayerNorm
+ GELU. The EnCodec frontend is a STUB — input_specs provides precomputed
frame embeddings; 4 codebook output heads. [arXiv:2306.05284]"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048, pos_emb="sinusoidal", act="gelu",
    norm="layernorm", mlp_bias=True, qkv_bias=False,
    frontend="audio_frames", n_codebooks=4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=64, n_codebooks=2, loss_chunk=32,
)
