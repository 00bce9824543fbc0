"""Model zoo of the port: the dense decoder family (prefill and decode)."""
from .transformer import LM, decode_step, init_caches, init_params, prefill

__all__ = ["LM", "decode_step", "init_caches", "init_params", "prefill"]
