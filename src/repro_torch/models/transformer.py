"""Decoder assembly for the dense family: embeds → layers → logits, prefill
and single-token decode.

Port of the dense-family part of ``repro.models.transformer``. Where the
reference stacks every layer's weights along a leading axis and scans, the
port keeps one ``TFLayer`` module per layer in a ``ModuleList`` and loops.
The decode caches keep the reference's stacked layout,
``caches["stack"] = {"k": (L, B, Sc, KV, dh), "v": ..., "kpos": (L, B, Sc)}``;
``decode_step`` updates them in place and returns them.

The tied (or untied) output head is cast to float32 once, when the model is
built (the ``head_f32`` buffer), since the logits are a float32 product as in
the reference (at Qwen3-4B's width that copy is 1.56 GB, which a cast per
call would allocate again every step).

MoE, MLA, SSM and RG-LRU configurations, frontends and sinusoidal position
embeddings wait (ROADMAP A10): ``init_params`` raises for them.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from .._device import resolve_device, same_device
from . import attention as attn
from . import ffn as ffn_mod
from .common import (Norm, apply_norm, dtype_of, embed_init, frozen,
                     make_norm_params)


def check_supported(cfg) -> None:
    """Raise for the configurations this slice of the port does not run."""
    why = []
    if cfg.family != "dense":
        why.append(f"family {cfg.family!r}")
    for sub in ("mla", "moe", "ssm", "rglru"):
        if getattr(cfg, sub) is not None:
            why.append(sub.upper())
    if cfg.frontend is not None:
        why.append(f"frontend {cfg.frontend!r}")
    if cfg.pos_emb != "rope":
        why.append(f"pos_emb {cfg.pos_emb!r}")
    if why:
        raise NotImplementedError(
            f"{cfg.arch_id}: {', '.join(why)} is not ported yet (ROADMAP "
            "A10); the port runs the dense family with RoPE and no frontend")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class TFLayer(nn.Module):
    """One transformer layer: ``ln1``, ``attn``, ``ln2``, ``ffn``."""

    def __init__(self, ln1: Norm, attn_p: attn.GQA, ln2: Norm,
                 ffn: ffn_mod.DenseFFN):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.ffn = ln1, attn_p, ln2, ffn


class LM(nn.Module):
    """A dense decoder: ``embed`` (V, D), ``layers``, ``final_norm``, and
    ``lm_head`` (D, V) unless the embeddings are tied. ``generate_graphs``
    keeps ``serve.engine``'s CUDA graphs of this model, which moving or
    casting it drops."""

    def __init__(self, cfg, embed: torch.Tensor, layers, final_norm: Norm,
                 lm_head: torch.Tensor | None = None):
        super().__init__()
        check_supported(cfg)
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError(f"{cfg.arch_id}: lm_head must be given iff the "
                             "embeddings are untied")
        self.cfg = cfg
        self.embed = frozen(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = frozen(lm_head)
        head = embed if lm_head is None else lm_head.T
        self.register_buffer("head_f32", head.to(torch.float32).contiguous(),
                             persistent=False)            # (V, D)
        # serve.engine's CUDA graphs of greedy_generate, by call signature:
        # a plain attribute, so they die with the model
        self.generate_graphs = OrderedDict()

    def _apply(self, fn, *args, **kwargs):
        # the graphs hold the weights' addresses, which to(), cuda(), cpu()
        # and casts may change: drop them
        self.generate_graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_tf_layer(gen, cfg) -> TFLayer:
    return TFLayer(make_norm_params(cfg, cfg.d_model, gen.device),
                   attn.init_gqa(gen, cfg),
                   make_norm_params(cfg, cfg.d_model, gen.device),
                   ffn_mod.init_dense_ffn(gen, cfg, cfg.d_ff))


def init_params(cfg, seed: int = 0, *, device=None) -> LM:
    """A model with random weights drawn by a ``torch.Generator`` seeded
    with ``seed``, on the card unless ``device="cpu"``. The reference's
    ``jax.random`` weights differ; ``convert.lm_params_from_numpy`` carries
    those across."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dt = dtype_of(cfg)
    embed = embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
    lm_head = (None if cfg.tie_embeddings
               else embed_init(gen, cfg.vocab_size, cfg.d_model, dt).T
               .contiguous())
    layers = [init_tf_layer(gen, cfg) for _ in range(cfg.n_layers)]
    return LM(cfg, embed, layers, make_norm_params(cfg, cfg.d_model, device),
              lm_head)


def check_model_device(model: LM, device=None) -> torch.device:
    """The device to run on (the card unless ``device="cpu"``), which must
    be the model's."""
    device = resolve_device(device)
    if not same_device(model.device, device):
        raise ValueError(f"the model is on {model.device}, not on {device}; "
                         "pass the model's device")
    return model.device


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def tf_layer_train(cfg, p: TFLayer, x, positions):
    """Full-sequence layer; returns (x, (k, v))."""
    a, kv = attn.gqa_train(cfg, p.attn, apply_norm(cfg, p.ln1, x), positions,
                           window=cfg.sliding_window)
    x = x + a
    h = apply_norm(cfg, p.ln2, x)
    return x + ffn_mod.dense_ffn(cfg, p.ffn, h), kv


def tf_layer_decode(cfg, p: TFLayer, x, pos: int, cache):
    a, cache = attn.gqa_decode(cfg, p.attn, apply_norm(cfg, p.ln1, x), pos,
                               cache, window=cfg.sliding_window)
    x = x + a
    h = apply_norm(cfg, p.ln2, x)
    return x + ffn_mod.dense_ffn(cfg, p.ffn, h), cache


def _tokens(batch, device) -> torch.Tensor:
    """``batch["tokens"]`` (a tensor or an array) as indices on ``device``."""
    t = batch["tokens"]
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.array(t))
    return t.to(device=device, dtype=torch.long)


def embed_inputs(cfg, model: LM, batch):
    """Returns (x, positions); text only, so no prefix."""
    x = model.embed[_tokens(batch, model.device)]
    return x, torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


def backbone_train(cfg, model: LM, x, positions):
    """Run all layers; returns (hidden, per-layer (k, v))."""
    kvs = []
    for layer in model.layers:
        x, kv = tf_layer_train(cfg, layer, x, positions)
        kvs.append(kv)
    return apply_norm(cfg, model.final_norm, x), kvs


def _logits_chunk(cfg, model: LM, h):
    logits = h.to(torch.float32) @ model.head_f32.T
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# Serving: caches, prefill, single-token decode
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, max_len: int, device):
    """Empty decode caches (kpos −1) for every layer, stacked."""
    one = attn.gqa_init_cache(cfg, batch, max_len, device)
    return {"stack": {k: v[None].repeat(cfg.n_layers, *([1] * v.dim()))
                      for k, v in one.items()}}


def _attn_cache_from_prefill(cfg, kv, max_len: int):
    """Build one layer's decode cache from prefill-produced k/v."""
    k, v = kv
    B, S = k.shape[:2]
    cache = attn.gqa_init_cache(cfg, B, max_len, k.device)
    Sc = cache["k"].shape[1]
    if S >= Sc:                      # keep the last window at ring slots
        pos = torch.arange(S - Sc, S, dtype=torch.int32, device=k.device)
        slots = (pos % Sc).long()
        cache["k"][:, slots] = k[:, -Sc:]
        cache["v"][:, slots] = v[:, -Sc:]
        kpos = torch.zeros((B, Sc), dtype=torch.int32, device=k.device)
        kpos[:, slots] = pos.expand(B, Sc)
        cache["kpos"] = kpos
        return cache
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    cache["kpos"][:, :S] = torch.arange(S, dtype=torch.int32,
                                        device=k.device)
    return cache


@torch.no_grad()
def prefill(cfg, model: LM, batch, max_cache_len: int, *, device=None):
    """Process a prompt batch; returns (last-position logits (B, 1, V)
    float32, decode caches). Runs on the card unless ``device="cpu"``, which
    must be where the model is."""
    check_model_device(model, device)
    x, positions = embed_inputs(cfg, model, batch)
    h, kvs = backbone_train(cfg, model, x, positions)
    per_layer = [_attn_cache_from_prefill(cfg, kv, max_cache_len)
                 for kv in kvs]
    caches = {"stack": {k: torch.stack([c[k] for c in per_layer])
                        for k in ("k", "v", "kpos")}}
    return _logits_chunk(cfg, model, h[:, -1:, :]), caches


@torch.no_grad()
def decode_step(cfg, model: LM, token_inputs, pos: int, caches, *,
                device=None):
    """One decode step at absolute position ``pos``.

    token_inputs: {"tokens": (B, 1)}. Returns (logits (B, 1, V) float32,
    caches), the caches updated in place."""
    check_model_device(model, device)
    x = model.embed[_tokens(token_inputs, model.device)]
    stack = caches["stack"]
    for i, layer in enumerate(model.layers):
        cache = {k: stack[k][i] for k in ("k", "v", "kpos")}
        x, _ = tf_layer_decode(cfg, layer, x, pos, cache)
    x = apply_norm(cfg, model.final_norm, x)
    return _logits_chunk(cfg, model, x), caches
