"""Model configuration schema for all assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention dims."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: Optional[int] = None     # V2-Lite projects q directly


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64                   # routed experts
    top_k: int = 6
    n_shared_experts: int = 0
    d_ff_expert: int = 1408
    first_k_dense: int = 0                # leading layers with dense FFN
    d_ff_dense: int = 0                   # dense d_ff for those layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    norm_topk_prob: bool = True
    dispatch_chunk: int = 4096            # tokens per dispatch-einsum chunk
    impl: str = "einsum"                  # einsum (GShard one-hot baseline)
    #                                       | gather (scatter/gather, §Perf)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 block dims."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 256
    extra_norms: bool = True              # falcon-mamba's RMSNorm on dt/B/C
    scan_chunk: int = 128


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma (Griffin) recurrent block dims."""
    lru_width: int = 2560
    d_conv: int = 4
    c_exponent: float = 8.0
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    scan_chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                           # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # attention
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    pos_emb: str = "rope"                 # rope | sinusoidal
    attn_impl: str = "flash"              # flash (custom-vjp) | naive
    attn_q_chunk: int = 512
    attn_k_chunk: int = 1024
    sp_attn: bool = False                 # sequence-parallel attention (§Perf):
    #   replicate attn weights, shard activations on sequence over "model" —
    #   the fix for head counts not divisible by the model axis
    # ffn / norms
    act: str = "swiglu"                   # swiglu | gelu | geglu
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    mlp_bias: bool = False
    tie_embeddings: bool = False
    final_logit_softcap: Optional[float] = None
    # sub-configs
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # modality frontends (stubs per assignment)
    frontend: Optional[str] = None        # vision_patches | audio_frames
    n_patches: int = 576
    n_codebooks: int = 4
    # the paper's technique as a first-class feature
    quant: Optional[str] = None           # pim_w4 | pim_w8
    quant_mode: str = "shift_add"         # shift_add (paper) | dequant (opt)
    # numerics / training
    dtype: str = "bfloat16"
    remat: bool = True
    loss_chunk: int = 512                 # sequence chunk for CE loss

    @property
    def attn_type(self) -> str:
        if self.mla is not None:
            return "mla"
        if self.family == "ssm":
            return "none"
        return "gqa"

    @property
    def quant_bits(self) -> int:
        return {"pim_w4": 4, "pim_w8": 8, None: 0}[self.quant]

    def _head_params(self) -> int:
        D, V = self.d_model, self.vocab_size
        if self.frontend == "audio_frames":      # n_codebooks output heads
            return V * D * (1 + self.n_codebooks)
        return V * D * (1 if self.tie_embeddings else 2)

    def n_params(self) -> int:
        """Total parameter count (analytic, for roofline MODEL_FLOPS)."""
        return self._head_params() + self._params_per_layer_all()

    def n_active_params(self) -> int:
        """Active params per token (MoE counts top_k + shared experts)."""
        return self._head_params() \
            + self._params_per_layer_all(active_only=True)

    # -- internals ----------------------------------------------------------
    def _attn_params(self) -> int:
        D, dh = self.d_model, self.head_dim
        if self.mla is not None:
            m = self.mla
            p = D * (m.kv_lora_rank + m.qk_rope_head_dim)          # kv down
            p += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim
                                                  + m.v_head_dim)  # kv up
            p += D * self.n_heads * (m.qk_nope_head_dim
                                     + m.qk_rope_head_dim)         # q
            p += self.n_heads * m.v_head_dim * D                   # out
            return p
        return (D * self.n_heads * dh + 2 * D * self.n_kv_heads * dh
                + self.n_heads * dh * D)

    def _ffn_params(self, d_ff: int) -> int:
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        return mult * self.d_model * d_ff

    def _params_per_layer_all(self, active_only: bool = False) -> int:
        D, L = self.d_model, self.n_layers
        if self.family == "ssm":
            s = self.ssm
            di = s.expand * D
            per = (D * 2 * di + s.d_conv * di + di * (s.dt_rank + 2 * s.d_state)
                   + s.dt_rank * di + di * D + 2 * di * s.d_state)
            return L * per
        if self.rglru is not None:
            r = self.rglru
            w = r.lru_width
            rec = 2 * D * w + r.d_conv * w + 3 * w + w * D + 2 * w * w
            attn = self._attn_params()
            mlp = self._ffn_params(self.d_ff)
            n_attn = sum(1 for i in range(L)
                         if r.pattern[i % len(r.pattern)] == "attn")
            n_rec = L - n_attn
            return n_rec * (rec + mlp) + n_attn * (attn + mlp)
        attn = self._attn_params()
        if self.moe is not None:
            m = self.moe
            n_moe = L - m.first_k_dense
            k_eff = (m.top_k + m.n_shared_experts) if active_only \
                else (m.n_experts + m.n_shared_experts)
            moe_ffn = k_eff * self._ffn_params(m.d_ff_expert) \
                + self.d_model * m.n_experts                      # router
            dense_ffn = self._ffn_params(m.d_ff_dense or self.d_ff)
            return (m.first_k_dense * (attn + dense_ffn)
                    + n_moe * (attn + moe_ffn))
        return L * (attn + self._ffn_params(self.d_ff))
