"""Decoder assembly for the attention families: embeds → layers → logits,
prefill and single-token decode.

Port of ``repro.models.transformer`` for the dense, MoE (with
``first_k_dense`` dense head layers), MLA, vision-patch and audio-frame
configurations. Where the reference stacks every layer's weights along a
leading axis and scans, the port keeps one ``TFLayer`` module per layer in
an ``nn.ModuleList`` per stack (``dense_head_layers``, then ``layers``)
and loops. The decode caches keep the reference's stacked layout per
stack: ``caches["stack"] = {"k": (L, B, Sc, KV, dh), "v": ..., "kpos":
(L, B, Sc)}`` for GQA, ``{"ckv": (L, B, Sc, rank), "krope": ..., "kpos":
...}`` for MLA, and ``caches["dense_head"]`` alike for the dense head
layers; ``decode_step`` updates them in place and returns them.

The tied (or untied) output head is cast to float32 once, when the model is
built (the ``head_f32`` buffer; the audio frontend's per-codebook
``heads_f32``), since the logits are a float32 product as in the reference
(at Qwen3-4B's width that copy is 1.56 GB, which a cast per call would
allocate again every step).

The recurrent families, SSM (falcon-mamba) and RG-LRU (recurrentgemma),
wait (ROADMAP A7): ``init_params`` raises for them.
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
                     make_norm_params, sinusoidal_pos_emb)


def check_supported(cfg) -> None:
    """Raise for the configurations this slice of the port does not run."""
    why = [sub.upper() for sub in ("ssm", "rglru")
           if getattr(cfg, sub) is not None]
    if why:
        raise NotImplementedError(
            f"{cfg.arch_id}: {', '.join(why)} is not ported yet (ROADMAP "
            "A7, the recurrent families); the port runs the attention "
            "families: dense, MoE, MLA, the vision and audio frontends")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class TFLayer(nn.Module):
    """One transformer layer: ``ln1``, ``attn`` (GQA or MLA), ``ln2``,
    ``ffn`` (dense or MoE)."""

    def __init__(self, ln1: Norm, attn_p: nn.Module, ln2: Norm,
                 ffn: nn.Module):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.ffn = ln1, attn_p, ln2, ffn


class LM(nn.Module):
    """A decoder: ``embed`` (V, D), ``dense_head_layers`` (an MoE config's
    ``first_k_dense`` dense layers), ``layers``, ``final_norm``, and
    ``lm_head`` (D, V) unless the embeddings are tied, or for the audio
    frontend ``heads`` (n_codebooks, D, V). ``generate_graphs`` keeps
    ``serve.engine``'s CUDA graphs of this model, which moving or casting
    it drops."""

    def __init__(self, cfg, embed: torch.Tensor, layers, final_norm: Norm,
                 lm_head: torch.Tensor | None = None, *,
                 dense_head_layers=(), heads: torch.Tensor | None = None):
        super().__init__()
        check_supported(cfg)
        audio = cfg.frontend == "audio_frames"
        if audio and (heads is None or lm_head is not None):
            raise ValueError(f"{cfg.arch_id}: the audio frontend takes "
                             "heads (n_codebooks, D, V) and no lm_head")
        if not audio and (heads is not None
                          or (lm_head is None) != cfg.tie_embeddings):
            raise ValueError(f"{cfg.arch_id}: lm_head must be given iff the "
                             "embeddings are untied")
        n_head = cfg.moe.first_k_dense if cfg.moe is not None else 0
        if len(dense_head_layers) != n_head \
                or len(layers) != cfg.n_layers - n_head:
            raise ValueError(f"{cfg.arch_id}: {len(dense_head_layers)} dense "
                             f"head layers and {len(layers)} layers, "
                             f"expected {n_head} and {cfg.n_layers - n_head}")
        self.cfg = cfg
        self.embed = frozen(embed)
        self.dense_head_layers = nn.ModuleList(dense_head_layers)
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = frozen(lm_head)
        self.heads = frozen(heads)
        if audio:
            self.register_buffer("heads_f32", heads.to(torch.float32),
                                 persistent=False)        # (C, D, V)
        else:
            head = embed if lm_head is None else lm_head.T
            self.register_buffer("head_f32",
                                 head.to(torch.float32).contiguous(),
                                 persistent=False)        # (V, D)
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

    def stacks(self):
        """(cache name, layers) of each non-empty stack, in order."""
        return [(name, layers) for name, layers in
                (("dense_head", self.dense_head_layers),
                 ("stack", self.layers)) if len(layers)]


def _init_attn(gen, cfg):
    return attn.init_mla(gen, cfg) if cfg.attn_type == "mla" \
        else attn.init_gqa(gen, cfg)


def init_tf_layer(gen, cfg, moe: bool = False) -> TFLayer:
    d_ff = cfg.d_ff
    if cfg.moe is not None and not moe and cfg.moe.d_ff_dense:
        d_ff = cfg.moe.d_ff_dense
    return TFLayer(make_norm_params(cfg, cfg.d_model, gen.device),
                   _init_attn(gen, cfg),
                   make_norm_params(cfg, cfg.d_model, gen.device),
                   ffn_mod.init_moe(gen, cfg) if moe
                   else ffn_mod.init_dense_ffn(gen, cfg, d_ff))


def init_params(cfg, seed: int = 0, *, device=None) -> LM:
    """A model with random weights drawn by a ``torch.Generator`` seeded
    with ``seed``, one tensor at a time, on the card unless
    ``device="cpu"``. The reference's ``jax.random`` weights differ;
    ``convert.lm_params_from_numpy`` carries those across."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dt = dtype_of(cfg)
    embed = embed_init(gen, cfg.vocab_size, cfg.d_model, dt)
    lm_head = heads = None
    if not cfg.tie_embeddings:
        if cfg.frontend == "audio_frames":
            heads = torch.stack([
                embed_init(gen, cfg.vocab_size, cfg.d_model, dt).T
                for _ in range(cfg.n_codebooks)])          # (C, D, V)
        else:
            lm_head = embed_init(gen, cfg.vocab_size, cfg.d_model, dt).T \
                .contiguous()
    n_head = cfg.moe.first_k_dense if cfg.moe is not None else 0
    dense_head = [init_tf_layer(gen, cfg) for _ in range(n_head)]
    layers = [init_tf_layer(gen, cfg, moe=cfg.moe is not None)
              for _ in range(cfg.n_layers - n_head)]
    return LM(cfg, embed, layers, make_norm_params(cfg, cfg.d_model, device),
              lm_head, dense_head_layers=dense_head, heads=heads)


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

def _attn_train(cfg, p, x, positions):
    if cfg.attn_type == "mla":
        return attn.mla_train(cfg, p, x, positions)
    return attn.gqa_train(cfg, p, x, positions, window=cfg.sliding_window)


def _attn_decode(cfg, p, x, pos: int, cache):
    if cfg.attn_type == "mla":
        return attn.mla_decode(cfg, p, x, pos, cache)
    return attn.gqa_decode(cfg, p, x, pos, cache, window=cfg.sliding_window)


def _attn_init_cache(cfg, batch: int, max_len: int, device):
    if cfg.attn_type == "mla":
        return attn.mla_init_cache(cfg, batch, max_len, device)
    return attn.gqa_init_cache(cfg, batch, max_len, device)


def _ffn(cfg, p: TFLayer, h):
    """(y, aux): the MoE's load-balance term, 0 for a dense FFN."""
    if isinstance(p.ffn, ffn_mod.MoEFFN):
        return ffn_mod.moe_ffn(cfg, p.ffn, h)
    return ffn_mod.dense_ffn(cfg, p.ffn, h), 0.0


def tf_layer_train(cfg, p: TFLayer, x, positions):
    """Full-sequence layer; returns (x, aux, attention entries for the
    cache: (k, v) or MLA's (c_kv, k_rope))."""
    a, kv = _attn_train(cfg, p.attn, apply_norm(cfg, p.ln1, x), positions)
    x = x + a
    f, aux = _ffn(cfg, p, apply_norm(cfg, p.ln2, x))
    return x + f, aux, kv


def tf_layer_decode(cfg, p: TFLayer, x, pos: int, cache):
    a, cache = _attn_decode(cfg, p.attn, apply_norm(cfg, p.ln1, x), pos,
                            cache)
    x = x + a
    f, _ = _ffn(cfg, p, apply_norm(cfg, p.ln2, x))
    return x + f, cache


def _tokens(batch, device) -> torch.Tensor:
    """``batch["tokens"]`` (a tensor or an array) as indices on ``device``."""
    t = batch["tokens"]
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.array(t))
    return t.to(device=device, dtype=torch.long)


def _embeds(batch, key: str, cfg, device) -> torch.Tensor:
    """``batch[key]`` (frame or patch embeddings: a tensor, or an array
    taken as float32 as the reference's ``jnp`` arrays are) in the model's
    dtype on ``device``."""
    e = batch[key]
    if not isinstance(e, torch.Tensor):
        e = torch.from_numpy(np.array(e, np.float32))
    return e.to(device=device, dtype=dtype_of(cfg))


def _add_sinusoidal(cfg, x, positions):
    return x + sinusoidal_pos_emb(positions, cfg.d_model).to(x.dtype)


def embed_inputs(cfg, model: LM, batch):
    """Returns (x, positions, n_prefix): n_prefix is the non-text prefix's
    length (the vision patches)."""
    dev = model.device
    if cfg.frontend == "audio_frames":
        x = _embeds(batch, "frame_embeds", cfg, dev)
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=dev)
        return _add_sinusoidal(cfg, x, pos), pos, 0
    x = model.embed[_tokens(batch, dev)]
    n_prefix = 0
    if cfg.frontend == "vision_patches":
        patches = _embeds(batch, "patch_embeds", cfg, dev)
        x = torch.cat([patches, x], dim=1)
        n_prefix = patches.shape[1]
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=dev)
    if cfg.pos_emb == "sinusoidal":
        x = _add_sinusoidal(cfg, x, pos)
    return x, pos, n_prefix


def backbone_train(cfg, model: LM, x, positions):
    """Run every stack; returns (hidden, aux, {stack name: per-layer
    attention entries})."""
    entries, aux = {}, 0.0
    for name, layers in model.stacks():
        entries[name] = []
        for layer in layers:
            x, aux_i, kv = tf_layer_train(cfg, layer, x, positions)
            aux = aux + aux_i
            entries[name].append(kv)
    return apply_norm(cfg, model.final_norm, x), aux, entries


def _logits_chunk(cfg, model: LM, h):
    """float32 logits (B, S, V), or (B, S, n_codebooks, V) for the audio
    frontend's heads."""
    if cfg.frontend == "audio_frames":
        return torch.einsum("bsd,cdv->bscv", h.to(torch.float32),
                            model.heads_f32)
    logits = h.to(torch.float32) @ model.head_f32.T
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# Serving: caches, prefill, single-token decode
# ---------------------------------------------------------------------------

def _stacked(per_layer: list) -> dict:
    return {k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]}


def init_caches(cfg, batch: int, max_len: int, device):
    """Empty decode caches (kpos −1) for every layer, stacked per stack."""
    check_supported(cfg)
    n_head = cfg.moe.first_k_dense if cfg.moe is not None else 0
    one = _attn_init_cache(cfg, batch, max_len, device)
    caches = {}
    for name, n in (("dense_head", n_head), ("stack", cfg.n_layers - n_head)):
        if n:
            caches[name] = {k: v[None].repeat(n, *([1] * v.dim()))
                            for k, v in one.items()}
    return caches


def _attn_cache_from_prefill(cfg, kv, max_len: int):
    """Build one layer's decode cache from prefill-produced entries."""
    if cfg.attn_type == "mla":
        c_kv, k_rope = kv
        B, S = c_kv.shape[:2]
        cache = attn.mla_init_cache(cfg, B, max_len, c_kv.device)
        cache["ckv"][:, :S] = c_kv
        cache["krope"][:, :S] = k_rope
        cache["kpos"][:, :S] = torch.arange(S, dtype=torch.int32,
                                            device=c_kv.device)
        return cache
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
    """Process a prompt batch; returns (last-position logits float32, (B, 1,
    V) or the audio frontend's (B, 1, n_codebooks, V), decode caches). Runs
    on the card unless ``device="cpu"``, which must be where the model is."""
    check_model_device(model, device)
    x, positions, _ = embed_inputs(cfg, model, batch)
    h, _, entries = backbone_train(cfg, model, x, positions)
    caches = {name: _stacked([_attn_cache_from_prefill(cfg, kv,
                                                       max_cache_len)
                              for kv in kvs])
              for name, kvs in entries.items()}
    return _logits_chunk(cfg, model, h[:, -1:, :]), caches


@torch.no_grad()
def decode_step(cfg, model: LM, token_inputs, pos: int, caches, *,
                device=None):
    """One decode step at absolute position ``pos``.

    token_inputs: {"tokens": (B, 1)}, or {"frame_embeds": (B, 1, D)} for
    the audio frontend. Returns (logits float32, (B, 1, V) or (B, 1,
    n_codebooks, V), caches), the caches updated in place."""
    check_model_device(model, device)
    dev = model.device
    at = torch.full((1,), int(pos), dtype=torch.int32, device=dev)
    if cfg.frontend == "audio_frames":
        x = _add_sinusoidal(cfg, _embeds(token_inputs, "frame_embeds", cfg,
                                         dev), at)
    else:
        x = model.embed[_tokens(token_inputs, dev)]
        if cfg.pos_emb == "sinusoidal":
            x = _add_sinusoidal(cfg, x, at)
    for name, layers in model.stacks():
        stack = caches[name]
        for i, layer in enumerate(layers):
            x, _ = tf_layer_decode(cfg, layer, x, pos,
                                   {k: v[i] for k, v in stack.items()})
    x = apply_norm(cfg, model.final_norm, x)
    return _logits_chunk(cfg, model, x), caches
