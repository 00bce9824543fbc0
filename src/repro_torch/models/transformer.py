"""Decoder assembly: embeds → layers → logits, prefill and single-token
decode.

Port of ``repro.models.transformer`` for every family: dense, MoE (with
``first_k_dense`` dense head layers), MLA, the vision-patch and
audio-frame frontends, SSM (falcon-mamba) and the RG-LRU hybrid
(recurrentgemma). Where the reference stacks every layer's weights along a
leading axis and scans, the port keeps one module per layer in an
``nn.ModuleList`` per stack and loops:

- ``dense_head_layers`` and ``layers`` (the reference's ``stack``):
  ``TFLayer``s, or for SSM ``MambaLayer``s;
- ``blocks``: the hybrid's super-blocks, one ``nn.ModuleList`` of
  ``HybridSub``s per block, in the order of ``rglru.pattern`` (``rec``:
  RG-LRU, ``attn``: GQA, each followed by a dense FFN), then ``tail``,
  the ``HybridSub``s of the leftover layers, the leading ``rec`` prefix of
  the pattern (``_hybrid_layout``).

The decode caches keep the reference's stacked layout and key names, each
layer's entries along a leading axis: ``caches["stack"] = {"k": (L, B, Sc,
KV, dh), "v": ..., "kpos": (L, B, Sc)}`` for GQA, ``{"ckv": (L, B, Sc,
rank), "krope": ..., "kpos": ...}`` for MLA, ``{"h": (L, B, I, N)
float32, "conv": (L, B, d_conv - 1, I)}`` for SSM, and
``caches["dense_head"]`` alike for the dense head layers; for the hybrid,
``caches["blocks"]["sub{i}"]`` holds RG-LRU state ``{"h": (n_blocks, B,
W) float32, "conv": ...}`` or a GQA (ring) cache, and ``caches["tail"]``
RG-LRU state. ``decode_step`` writes every entry, attention or recurrent,
in place and returns the caches.

The tied (or untied) output head is cast to float32 once, when the model is
built (the ``head_f32`` buffer; the audio frontend's per-codebook
``heads_f32``), since the logits are a float32 product as in the reference
(at Qwen3-4B's width that copy is 1.56 GB, which a cast per call would
allocate again every step). Training reads the trainable head itself, cast
per loss chunk as the reference does, and ``refresh_heads`` copies it into
those buffers in place after an optimizer step.

Training: ``loss_fn`` (``lm_loss``, ``musicgen_loss`` and the MoE aux
loss) over ``backbone_loss``, which checkpoints each layer when
``cfg.remat`` (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``); ``param_tree`` lays the parameters out as the
reference's pytree and ``trainable`` turns the gradient on for its
floating leaves.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device, same_device
from . import attention as attn
from . import ffn as ffn_mod
from . import rglru as rg
from . import ssm as ssm_mod
from .common import (Norm, apply_norm, constrain, dtype_of, embed_init,
                     frozen, hold, hold_batch, is_dtensor, make_norm_params,
                     sinusoidal_pos_emb)


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


class MambaLayer(nn.Module):
    """One SSM layer: ``ln``, ``mix`` (a ``Mamba`` block)."""

    def __init__(self, ln: Norm, mix: ssm_mod.Mamba):
        super().__init__()
        self.ln, self.mix = ln, mix


class HybridSub(nn.Module):
    """One sub-layer of a Griffin block: ``ln1``, ``mix`` (``RGLRU`` or
    ``GQA``), ``ln2``, ``mlp`` (a ``DenseFFN``)."""

    def __init__(self, ln1: Norm, mix: nn.Module, ln2: Norm,
                 mlp: ffn_mod.DenseFFN):
        super().__init__()
        self.ln1, self.mix, self.ln2, self.mlp = ln1, mix, ln2, mlp


def _hybrid_layout(cfg) -> tuple[int, int]:
    """(blocks, tail layers) of a hybrid config: ``n_layers // len(pattern)``
    blocks, the rest the leading (``rec``) prefix of the pattern."""
    pat = cfg.rglru.pattern
    n_blocks, tail = divmod(cfg.n_layers, len(pat))
    if any(k != "rec" for k in pat[:tail]):
        raise ValueError(f"{cfg.arch_id}: the {tail} tail layers must be "
                         f"the leading (rec) prefix of the pattern {pat}")
    return n_blocks, tail


def _layout(cfg) -> dict:
    """Layers per ModuleList: dense head, layers, blocks, tail."""
    n_head = cfg.moe.first_k_dense if cfg.moe is not None else 0
    if cfg.rglru is not None:
        n_blocks, tail = _hybrid_layout(cfg)
        return dict(dense_head=0, layers=0, blocks=n_blocks, tail=tail)
    return dict(dense_head=n_head, layers=cfg.n_layers - n_head, blocks=0,
                tail=0)


class LM(nn.Module):
    """A decoder: ``embed`` (V, D), ``dense_head_layers`` (an MoE config's
    ``first_k_dense`` dense layers), ``layers``, ``blocks`` and ``tail``
    (the hybrid's), ``final_norm``, and ``lm_head`` (D, V) unless the
    embeddings are tied, or for the audio frontend ``heads``
    (n_codebooks, D, V). ``generate_graphs`` keeps ``serve.engine``'s CUDA
    graphs of this model, which moving or casting it drops."""

    def __init__(self, cfg, embed: torch.Tensor, layers, final_norm: Norm,
                 lm_head: torch.Tensor | None = None, *,
                 dense_head_layers=(), heads: torch.Tensor | None = None,
                 blocks=(), tail=()):
        super().__init__()
        audio = cfg.frontend == "audio_frames"
        if audio and (heads is None or lm_head is not None):
            raise ValueError(f"{cfg.arch_id}: the audio frontend takes "
                             "heads (n_codebooks, D, V) and no lm_head")
        if not audio and (heads is not None
                          or (lm_head is None) != cfg.tie_embeddings):
            raise ValueError(f"{cfg.arch_id}: lm_head must be given iff the "
                             "embeddings are untied")
        got = dict(dense_head=len(dense_head_layers), layers=len(layers),
                   blocks=len(blocks), tail=len(tail))
        if got != _layout(cfg):
            raise ValueError(f"{cfg.arch_id}: layers per stack {got}, "
                             f"expected {_layout(cfg)}")
        pat = cfg.rglru.pattern if cfg.rglru is not None else ()
        if any(len(b) != len(pat) for b in blocks):
            raise ValueError(f"{cfg.arch_id}: a block holds "
                             f"{len(pat)} sub-layers {pat}")
        self.cfg = cfg
        self.embed = frozen(embed)
        self.dense_head_layers = nn.ModuleList(dense_head_layers)
        self.layers = nn.ModuleList(layers)
        self.blocks = nn.ModuleList(nn.ModuleList(b) for b in blocks)
        self.tail = nn.ModuleList(tail)
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

    def walk(self):
        """(cache name, sub-layer name or None, index in its stack, layer)
        of every layer, in the order they run: ``caches[name][i]`` (for a
        block, ``caches["blocks"][sub][i]``) is its entry."""
        for name, layers in (("dense_head", self.dense_head_layers),
                             ("stack", self.layers)):
            for i, layer in enumerate(layers):
                yield name, None, i, layer
        for i, block in enumerate(self.blocks):
            for j, sub in enumerate(block):
                yield "blocks", f"sub{j}", i, sub
        for i, layer in enumerate(self.tail):
            yield "tail", None, i, layer


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


def init_mamba_layer(gen, cfg) -> MambaLayer:
    return MambaLayer(make_norm_params(cfg, cfg.d_model, gen.device),
                      ssm_mod.init_mamba(gen, cfg))


def init_hybrid_sub(gen, cfg, kind: str) -> HybridSub:
    mix = rg.init_rglru(gen, cfg) if kind == "rec" else _init_attn(gen, cfg)
    return HybridSub(make_norm_params(cfg, cfg.d_model, gen.device), mix,
                     make_norm_params(cfg, cfg.d_model, gen.device),
                     ffn_mod.init_dense_ffn(gen, cfg, cfg.d_ff))


def init_params(cfg, seed: int = 0, *, device=None) -> LM:
    """A model with random weights drawn by a ``torch.Generator`` seeded
    with ``seed``, one tensor at a time, on the card unless
    ``device="cpu"``. The reference's ``jax.random`` weights differ;
    ``convert.lm_params_from_numpy`` carries those across."""
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
    n = _layout(cfg)
    dense_head = [init_tf_layer(gen, cfg) for _ in range(n["dense_head"])]
    if cfg.family == "ssm":
        layers = [init_mamba_layer(gen, cfg) for _ in range(n["layers"])]
    else:
        layers = [init_tf_layer(gen, cfg, moe=cfg.moe is not None)
                  for _ in range(n["layers"])]
    pat = cfg.rglru.pattern if cfg.rglru is not None else ()
    blocks = [[init_hybrid_sub(gen, cfg, kind) for kind in pat]
              for _ in range(n["blocks"])]
    tail = [init_hybrid_sub(gen, cfg, "rec") for _ in range(n["tail"])]
    return LM(cfg, embed, layers, make_norm_params(cfg, cfg.d_model, device),
              lm_head, dense_head_layers=dense_head, heads=heads,
              blocks=blocks, tail=tail)


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


def _sp_constraint(cfg, x):
    if cfg.sp_attn and x.dim() == 3 and x.shape[1] > 1:
        return constrain(x, (None, "model", None))
    return x


def tf_layer_train(cfg, p: TFLayer, x, positions):
    """Full-sequence layer; returns (x, aux, attention entries for the
    cache: (k, v) or MLA's (c_kv, k_rope))."""
    x = _sp_constraint(cfg, x)
    a, kv = _attn_train(cfg, p.attn, hold(apply_norm(cfg, p.ln1, x), "ln1"),
                        positions)
    x = x + hold(a, "attn out")
    f, aux = _ffn(cfg, p, hold(apply_norm(cfg, p.ln2, x), "ln2"))
    return x + hold(f, "ffn out"), aux, kv


def tf_layer_decode(cfg, p: TFLayer, x, pos: int, cache):
    a, cache = _attn_decode(cfg, p.attn, hold(apply_norm(cfg, p.ln1, x),
                                              "ln1"), pos, cache)
    x = x + hold(a, "attn out")
    f, _ = _ffn(cfg, p, hold(apply_norm(cfg, p.ln2, x), "ln2"))
    return x + hold(f, "ffn out"), cache


def mamba_layer_train(cfg, p: MambaLayer, x):
    """Returns (x, the layer's recurrent state)."""
    y, state = ssm_mod.mamba_train(cfg, p.mix,
                                   hold(apply_norm(cfg, p.ln, x), "ln"))
    return x + hold(y, "mix out"), state


def mamba_layer_decode(cfg, p: MambaLayer, x, state):
    y, state = ssm_mod.mamba_decode(cfg, p.mix,
                                    hold(apply_norm(cfg, p.ln, x), "ln"),
                                    state)
    return x + hold(y, "mix out"), state


def hybrid_sub_train(cfg, p: HybridSub, x, positions):
    """Returns (x, RG-LRU state or the attention's (k, v))."""
    h = hold(apply_norm(cfg, p.ln1, x), "ln1")
    if isinstance(p.mix, rg.RGLRU):
        y, entry = rg.rglru_train(cfg, p.mix, h)
    else:
        y, entry = _attn_train(cfg, p.mix, h, positions)
    x = x + hold(y, "mix out")
    f = ffn_mod.dense_ffn(cfg, p.mlp, hold(apply_norm(cfg, p.ln2, x), "ln2"))
    return x + hold(f, "mlp out"), entry


def hybrid_sub_decode(cfg, p: HybridSub, x, pos: int, cache):
    h = hold(apply_norm(cfg, p.ln1, x), "ln1")
    if isinstance(p.mix, rg.RGLRU):
        y, cache = rg.rglru_decode(cfg, p.mix, h, cache)
    else:
        y, cache = _attn_decode(cfg, p.mix, h, pos, cache)
    x = x + hold(y, "mix out")
    f = ffn_mod.dense_ffn(cfg, p.mlp, hold(apply_norm(cfg, p.ln2, x), "ln2"))
    return x + hold(f, "mlp out"), cache


def layer_train(cfg, layer, x, positions):
    """Any layer over the full sequence: (x, aux, its cache entry)."""
    if isinstance(layer, TFLayer):
        return tf_layer_train(cfg, layer, x, positions)
    if isinstance(layer, MambaLayer):
        x, state = mamba_layer_train(cfg, layer, x)
    else:
        x, state = hybrid_sub_train(cfg, layer, x, positions)
    return x, 0.0, state


def layer_decode(cfg, layer, x, pos: int, cache):
    """Any layer at one position, its cache entry updated in place."""
    if isinstance(layer, TFLayer):
        return tf_layer_decode(cfg, layer, x, pos, cache)[0]
    if isinstance(layer, MambaLayer):
        return mamba_layer_decode(cfg, layer, x, cache)[0]
    return hybrid_sub_decode(cfg, layer, x, pos, cache)[0]


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


def _lookup(model: LM, tokens):
    """The token embeddings: ``F.embedding``, whose vocab-parallel rule (and
    backward) DTensor has on the sharded path, its masked partial sums
    reduced at once (``hold``, a no-op on plain tensors)."""
    return hold(torch.nn.functional.embedding(tokens, model.embed), "embed")


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
    x = _lookup(model, _tokens(batch, dev))
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
    """Run every layer; returns (hidden, aux, {(cache name, sub-layer name
    or None): the per-layer cache entries, in stack order})."""
    entries, aux = {}, 0.0
    for name, sub, _, layer in model.walk():
        x, aux_i, entry = layer_train(cfg, layer,
                                      hold_batch(x, "layer input"), positions)
        aux = aux + aux_i
        entries.setdefault((name, sub), []).append(entry)
    return apply_norm(cfg, model.final_norm, x), aux, entries


def _logits_chunk(cfg, model: LM, h):
    """float32 logits (B, S, V), or (B, S, n_codebooks, V) for the audio
    frontend's heads."""
    if cfg.frontend == "audio_frames":
        if is_dtensor(h):
            # one product per codebook (DTensor cannot merge the codebook
            # dim with the vocab-sharded dim in a batched product)
            return torch.stack([h.to(torch.float32) @ w
                                for w in model.heads_f32.unbind(0)], dim=2)
        return torch.einsum("bsd,cdv->bscv", h.to(torch.float32),
                            model.heads_f32)
    logits = h.to(torch.float32) @ model.head_f32.T
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ---------------------------------------------------------------------------
# Training: the reference's parameter tree, losses
# ---------------------------------------------------------------------------

def _module_tree(m: nn.Module) -> dict:
    """A module's parameters, persistent buffers and sub-modules by
    attribute name: the reference's keys."""
    out = {k: p for k, p in m._parameters.items() if p is not None}
    out.update({k: b for k, b in m._buffers.items()
                if b is not None and k not in m._non_persistent_buffers_set})
    out.update({k: _module_tree(c) for k, c in m._modules.items()
                if c is not None})
    return out


def _stacked_tree(trees: list) -> dict:
    """Per-layer trees as one tree whose leaves list the layers' tensors
    (the reference stacks them along a leading axis)."""
    return {k: _stacked_tree([t[k] for t in trees])
            if isinstance(trees[0][k], dict) else [t[k] for t in trees]
            for k in trees[0]}


def param_tree(model: LM) -> dict:
    """The model's parameters (and int8 codes) in the reference's
    ``init_params`` layout: ``embed``, ``final_norm``, ``lm_head`` or
    ``heads``, and ``stack`` / ``dense_head_layers`` / ``blocks``
    (``sub{i}``) / ``tail``, whose leaves are lists of per-layer
    tensors."""
    tree = {"embed": model.embed,
            "final_norm": _module_tree(model.final_norm)}
    if model.lm_head is not None:
        tree["lm_head"] = model.lm_head
    if model.heads is not None:
        tree["heads"] = model.heads
    for key, stack in (("dense_head_layers", model.dense_head_layers),
                       ("stack", model.layers), ("tail", model.tail)):
        if len(stack):
            tree[key] = _stacked_tree([_module_tree(m) for m in stack])
    if len(model.blocks):
        tree["blocks"] = {
            f"sub{j}": _stacked_tree([_module_tree(b[j])
                                      for b in model.blocks])
            for j in range(len(model.blocks[0]))}
    return tree


def tree_leaves(tree: dict, prefix: str = ""):
    """(path, leaf) in the order of ``jax.tree.leaves`` (dict keys
    sorted); a path joins the keys with "/"."""
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}{k}"
        if isinstance(v, dict):
            yield from tree_leaves(v, path + "/")
        else:
            yield path, v


def trainable(model: LM) -> list:
    """Turn the gradient on for the leaves the reference's
    ``adamw.partition`` trains (every floating one: weights, norms,
    biases, the quantized linears' scales; the int8 codes stay frozen)
    and return them as ``[(path, [tensor per layer])]`` in the reference's
    tree order."""
    out = []
    for path, leaf in tree_leaves(param_tree(model)):
        ts = leaf if isinstance(leaf, list) else [leaf]
        if ts[0].is_floating_point():
            for t in ts:
                t.requires_grad_(True)
            out.append((path, ts))
    return out


@torch.no_grad()
def refresh_heads(model: LM) -> None:
    """Copy the trained head into the float32 serving buffers in place
    (their addresses, which ``generate_graphs`` hold, stay)."""
    if model.heads is not None:
        model.heads_f32.copy_(model.heads)
    else:
        model.head_f32.copy_(model.embed if model.lm_head is None
                             else model.lm_head.T)


def backbone_loss(cfg, model: LM, x, positions):
    """Every layer over the full sequence for the loss: (hidden after the
    final norm, aux). With ``cfg.remat`` each layer is checkpointed
    (``use_reentrant=False``): its activations are recomputed in the
    backward, the counterpart of the reference's ``jax.checkpoint``."""
    aux = 0.0
    for _, _, _, layer in model.walk():
        def run(h, layer=layer):
            return layer_train(cfg, layer, h, positions)[:2]
        x = hold_batch(x, "layer input")
        x, aux_i = (checkpoint(run, x, use_reentrant=False) if cfg.remat
                    else run(x))
        aux = aux + aux_i
    return apply_norm(cfg, model.final_norm, x), aux


def _train_head(cfg, model: LM, h, w):
    """float32 logits of ``h`` against the trainable head ``w`` (D, V),
    both cast per chunk as the reference's ``_logits_chunk``."""
    logits = h.to(torch.float32) @ w.to(torch.float32)
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _nll(logits, labels):
    """(lse − gold) per position, float32. On the sharded path (DTensor
    logits, the vocab dim sharded) the gold logit is a masked sum over the
    vocab, which stays sharded and is exact (one term, the rest zeros):
    what XLA's partitioner makes of a gather over a sharded dim, and what
    DTensor's own gather rule fails at."""
    if is_dtensor(logits):
        vocab = torch.arange(logits.shape[-1], device=labels.device)
        gold = torch.where(labels[..., None] == vocab, logits,
                           torch.zeros((), dtype=logits.dtype)).sum(-1)
    else:
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def _on(model: LM, batch, key: str, dtype, default_shape=None):
    """``batch[key]`` (a tensor or an array) as ``dtype`` on the model's
    device; ones of ``default_shape`` when absent."""
    v = batch.get(key)
    if v is None:
        return torch.ones(default_shape, dtype=dtype, device=model.device)
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v))
    return v.to(device=model.device, dtype=dtype)


def lm_loss(cfg, model: LM, h, labels, mask):
    """h (B, S, D); labels (B, S) int; mask (B, S) float32. Cross entropy
    over chunks of ``cfg.loss_chunk`` positions (halved until it divides
    S), summed in chunk order, over max(Σ mask, 1)."""
    S = h.shape[1]
    chunk = min(cfg.loss_chunk, S)
    while S % chunk:
        chunk //= 2
    w = model.embed.T if cfg.tie_embeddings else model.lm_head
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        mc = mask[:, c0:c0 + chunk]
        nll = _nll(_train_head(cfg, model, h[:, c0:c0 + chunk], w),
                   labels[:, c0:c0 + chunk])
        tot = tot + torch.sum(nll * mc)
        cnt = cnt + torch.sum(mc)
    return tot / torch.clamp(cnt, min=1.0)


def musicgen_loss(cfg, model: LM, h, labels, mask):
    """labels (B, S, n_codebooks): the mean over codebooks of each head's
    masked cross entropy."""
    losses = []
    for c in range(cfg.n_codebooks):
        nll = _nll(h.to(torch.float32) @ model.heads[c].to(torch.float32),
                   labels[..., c])
        losses.append(torch.sum(nll * mask)
                      / torch.clamp(torch.sum(mask), min=1.0))
    return sum(losses) / len(losses)


def loss_fn(cfg, model: LM, batch):
    """The training objective: (ce loss + aux, {"ce_loss", "aux_loss"}).
    batch: ``tokens``/``labels`` (+ ``mask``), or the frontends' inputs,
    as tensors or arrays."""
    x, positions, n_prefix = embed_inputs(cfg, model, batch)
    h, aux = backbone_loss(cfg, model, x, positions)
    labels = _on(model, batch, "labels", torch.long)
    if cfg.frontend == "audio_frames":
        mask = _on(model, batch, "mask", torch.float32, labels.shape[:2])
        loss = musicgen_loss(cfg, model, h, labels, mask)
    else:
        if n_prefix:
            h = h[:, n_prefix:]
        mask = _on(model, batch, "mask", torch.float32, labels.shape)
        loss = lm_loss(cfg, model, h, labels, mask)
    return loss + aux, {"ce_loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# Serving: caches, prefill, single-token decode
# ---------------------------------------------------------------------------

def _stacked(per_layer: list) -> dict:
    return {k: torch.stack([c[k] for c in per_layer]) for k in per_layer[0]}


def init_caches(cfg, batch: int, max_len: int, device):
    """Empty decode caches for every layer, stacked per stack: attention
    slots with kpos −1, recurrent state zero."""
    n = _layout(cfg)

    def repeat(one: dict, k: int) -> dict:
        return {key: v[None].repeat(k, *([1] * v.dim()))
                for key, v in one.items()}

    if cfg.family == "ssm":
        return {"stack": repeat(ssm_mod.mamba_init_state(cfg, batch, device),
                                n["layers"])}
    if cfg.rglru is not None:
        rec = rg.rglru_init_state(cfg, batch, device)
        caches = {"blocks": {
            f"sub{i}": repeat(rec if kind == "rec" else _attn_init_cache(
                cfg, batch, max_len, device), n["blocks"])
            for i, kind in enumerate(cfg.rglru.pattern)}}
        if n["tail"]:
            caches["tail"] = repeat(rec, n["tail"])
        return caches
    one = _attn_init_cache(cfg, batch, max_len, device)
    return {name: repeat(one, n[key])
            for name, key in (("dense_head", "dense_head"),
                              ("stack", "layers")) if n[key]}


def _ring(x, fill, n: int):
    """The sharded path's cache slots, built without an indexed write: a
    (B, S, ...) entry at slots pos % n of n, the rest ``fill``."""
    S = x.shape[1]
    if S >= n:
        # slot (S - n + j) % n holds x[S - n + j]: a roll by (S - n) % n,
        # made of slices (DTensor has no rule for roll in every version)
        y, shift = x[:, S - n:], (S - n) % n
        return torch.cat([y[:, n - shift:], y[:, :n - shift]], dim=1) \
            if shift else y
    pad = torch.full((x.shape[0], n - S) + tuple(x.shape[2:]), fill,
                     dtype=x.dtype)
    return torch.cat([x, pad], dim=1)


def _sharded_cache_from_prefill(cfg, kv, max_len: int) -> dict:
    """``_attn_cache_from_prefill`` on DTensor entries: the same slots,
    built by roll and concatenation, which keep the entries' sharding."""
    a, b = kv
    B, S = a.shape[:2]
    n = max_len if cfg.attn_type == "mla" else min(
        max_len, cfg.sliding_window or max_len)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    names = ("ckv", "krope") if cfg.attn_type == "mla" else ("k", "v")
    return {names[0]: _ring(a, 0, n), names[1]: _ring(b, 0, n),
            "kpos": _ring(pos, -1, n)}


def _attn_cache_from_prefill(cfg, kv, max_len: int):
    """Build one layer's decode cache from prefill-produced entries."""
    if is_dtensor(kv[0]):
        return _sharded_cache_from_prefill(cfg, kv, max_len)
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


def _cache_from_prefill(cfg, entry, max_len: int) -> dict:
    """A recurrent state (a dict) as it is; attention entries as a decode
    cache (``_attn_cache_from_prefill``)."""
    if isinstance(entry, dict):
        return entry
    return _attn_cache_from_prefill(cfg, entry, max_len)


@torch.no_grad()
def prefill(cfg, model: LM, batch, max_cache_len: int, *, device=None):
    """Process a prompt batch; returns (last-position logits float32, (B, 1,
    V) or the audio frontend's (B, 1, n_codebooks, V), decode caches). Runs
    on the card unless ``device="cpu"``, which must be where the model is.
    A recurrent layer's state is the prompt's: its conv state holds the
    prompt's last ``d_conv - 1`` inputs, fewer for a shorter prompt (as in
    the reference), which ``decode_step`` refuses."""
    check_model_device(model, device)
    x, positions, _ = embed_inputs(cfg, model, batch)
    h, _, entries = backbone_train(cfg, model, x, positions)
    caches = {}
    for (name, sub), es in entries.items():
        stacked = _stacked([_cache_from_prefill(cfg, e, max_cache_len)
                            for e in es])
        if sub is None:
            caches[name] = stacked
        else:
            caches.setdefault(name, {})[sub] = stacked
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
        x = _lookup(model, _tokens(token_inputs, dev))
        if cfg.pos_emb == "sinusoidal":
            x = _add_sinusoidal(cfg, x, at)
    for name, sub, i, layer in model.walk():
        stack = caches[name] if sub is None else caches[name][sub]
        x = layer_decode(cfg, layer, hold_batch(x, "layer input"), pos,
                         {k: v[i] for k, v in stack.items()})
    x = apply_norm(cfg, model.final_norm, x)
    return _logits_chunk(cfg, model, x), caches
