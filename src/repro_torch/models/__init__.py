"""Model zoo of the port: the attention families (dense, MoE, MLA, the
vision-patch and audio-frame frontends), SSM and the RG-LRU hybrid,
prefill and decode."""
from .transformer import LM, decode_step, init_caches, init_params, prefill

__all__ = ["LM", "decode_step", "init_caches", "init_params", "prefill"]
