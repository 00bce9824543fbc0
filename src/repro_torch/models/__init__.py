"""Model zoo of the port: the attention families (dense, MoE, MLA, the
vision-patch and audio-frame frontends), SSM and the RG-LRU hybrid,
prefill and decode, and training's losses and trainable parameters."""
from .transformer import (LM, decode_step, init_caches, init_params,
                          loss_fn, param_tree, prefill, refresh_heads,
                          trainable)

__all__ = ["LM", "decode_step", "init_caches", "init_params", "loss_fn",
           "param_tree", "prefill", "refresh_heads", "trainable"]
