"""Batched serving engine: prefill + single-token decode loop.

Port of ``repro.serve.engine``. Greedy or temperature sampling over a batch
of equal-length prompts.

The reference runs its whole decode loop as one jitted ``lax.scan``. On the
card the port runs each ``greedy_generate`` call as one replay of a CUDA
graph that holds prefill, the sampling of every token, the
``max_new_tokens - 1`` decode steps, unrolled (each step's position is a
Python int fixed in the graph), and the concatenated tokens. The graph is
captured at the first call of a signature (batch, prompt length,
``max_cache_len``, ``max_new_tokens``, greedy or sampled), after one eager
prefill and decode step on a side stream, so that nothing is built or set up
for the first time inside the capture. Every call copies its prompt into
the graph's input, replays the graph once and returns a copy of its output.
The graphs live on the model (``LM.generate_graphs``), at most
``MAX_GRAPHS`` signatures, the least recently used dropped first, and die
with it. A capture or a replay that fails raises: the card has no eager
path. On the CPU the loop runs eagerly. The same holds for every family:
a recurrent model's prefill states and its decode steps' in-place state
writes are captured with the rest (static shapes, no host
synchronisation).

``DECODE_STATS["dispatches"]`` counts the host's dispatches of the decode
loop, as the reference's does: on the card one per call with
``max_new_tokens >= 1`` (the replay, prefill in it), on the CPU one per
``decode_step`` call, ``max_new_tokens - 1``; none for zero tokens.

A vision-patch model's prompt is its ``n_patches`` patch embeddings and
then its tokens, so its decode positions start at ``n_patches`` plus the
token count, as the reference's do; a captured graph holds a static copy
of the patches beside its static tokens. An audio-frame model is served
through ``prefill`` and ``decode_step`` with ``frame_embeds``: the
reference's generate loop feeds tokens back, which such a model does not
take, so it returns the empty result for zero tokens and raises for more,
and so does the port's.

Temperature sampling is Gumbel-max, ``argmax(logits / T - log(-log u))``,
which is what the reference's ``jax.random.categorical`` computes. ``u``,
(max_new_tokens, B, V) float32 uniform, is drawn for all steps at once from
the caller's ``torch.Generator`` before the loop (a graph advances no
generator), so the tokens are not the reference's ``jax.random`` ones.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..kernels.flash_attn import ops as _flash
from ..kernels.pim_matmul import ops as _pim
from ..models import decode_step, prefill
from ..models.transformer import check_model_device

# Host dispatches of the decode loop (see the module's docstring); tests
# reset it.
DECODE_STATS = {"dispatches": 0}
# The most call signatures whose graphs one model keeps.
MAX_GRAPHS = 4
# The dtypes of a graph's static prompt inputs.
_INPUT_DTYPES = {"tokens": torch.int32, "patch_embeds": torch.float32}


def _sample(cfg, logits, temperature, u):
    """Next tokens (B,) int32 from logits (B, 1, V'): the argmax when
    ``temperature`` is None, else Gumbel-max with ``temperature`` a 0-d
    float32 tensor and ``u`` (B, V) uniform in [0, 1), both on the logits'
    device."""
    lg = logits.reshape(logits.shape[0], -1)[:, :cfg.vocab_size].to(
        torch.float32)
    if temperature is not None:
        lg = lg / temperature - torch.log(-torch.log(u))
    return torch.argmax(lg, dim=-1).to(torch.int32)


def _prompt_len(cfg, batch) -> int:
    """Positions the prompt takes: its tokens, after the vision patches."""
    n = batch["tokens"].shape[1]
    return n + (cfg.n_patches if cfg.frontend == "vision_patches" else 0)


def _generate(cfg, model, batch, max_new_tokens, max_cache_len, temperature,
              u):
    """Prefill, then ``max_new_tokens - 1`` decode steps, token i sampled
    with ``u[i]``; returns (B, max_new_tokens) int32."""
    device = model.device
    prompt_len = _prompt_len(cfg, batch)
    logits, caches = prefill(cfg, model, batch, max_cache_len, device=device)
    tok = _sample(cfg, logits, temperature, None if u is None else u[0])
    out = [tok[:, None]]
    for i in range(1, max_new_tokens):
        logits, caches = decode_step(cfg, model, {"tokens": out[-1]},
                                     prompt_len + i - 1, caches,
                                     device=device)
        tok = _sample(cfg, logits, temperature, None if u is None else u[i])
        out.append(tok[:, None])
    return torch.cat(out, dim=1)


def _since(counts: dict, before: dict) -> dict:
    """The entries of ``counts`` that grew since its copy ``before``, by how
    much."""
    return {k: v - before.get(k, 0) for k, v in counts.items()
            if v != before.get(k, 0)}


class _Graph:
    """One captured signature: the CUDA graph, its static prompt (tokens
    int32, and patches float32 for a vision-patch model), noise,
    temperature and output tensors, the seconds its warm-up and capture
    took, the bytes its memory pool holds, and the kernel launches (by
    route; pim_matmul's also by (route, K, N) and by (mode, bits)) that
    each replay makes."""

    def __init__(self, cfg, model, inputs, max_new_tokens, max_cache_len,
                 sampled):
        dev = model.device
        self.inputs = {k: torch.empty(tuple(v.shape), dtype=_INPUT_DTYPES[k],
                                      device=dev).copy_(v)
                       for k, v in inputs.items()}
        shape = (max_new_tokens, inputs["tokens"].shape[0], cfg.vocab_size)
        self.u = torch.full(shape, 0.5, device=dev) if sampled else None
        self.temperature = torch.ones((), device=dev) if sampled else None
        batch = self.inputs
        # warm-up: one prefill and one decode step, eager, on a side stream
        # (kernel builds, shared-memory permissions, cuBLAS for these
        # shapes happen here, not in the capture)
        t = time.perf_counter()
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            _generate(cfg, model, batch, min(max_new_tokens, 2),
                      max_cache_len, self.temperature, self.u)
        current.wait_stream(side)
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t

        t = time.perf_counter()
        pim0, flash0 = dict(_pim.CAPTURED), dict(_flash.CAPTURED)
        shapes0 = dict(_pim.CAPTURED_SHAPES)
        kinds0 = dict(_pim.CAPTURED_KINDS)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(self.graph):
            self.out = _generate(cfg, model, batch, max_new_tokens,
                                 max_cache_len, self.temperature, self.u)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.pim_routes = {k: v - pim0[k] for k, v in _pim.CAPTURED.items()}
        self.pim_shapes = _since(_pim.CAPTURED_SHAPES, shapes0)
        self.pim_kinds = _since(_pim.CAPTURED_KINDS, kinds0)
        self.flash_routes = {k: v - flash0[k]
                             for k, v in _flash.CAPTURED.items()}
        self.capture_s = time.perf_counter() - t

    def __call__(self, inputs, temperature, generator) -> torch.Tensor:
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        if self.u is not None:
            self.u.uniform_(generator=generator)
            self.temperature.fill_(temperature)
        self.graph.replay()
        DECODE_STATS["dispatches"] += 1
        _pim.count_replay(self.pim_routes, self.pim_shapes, self.pim_kinds)
        _flash.count_replay(self.flash_routes)
        return self.out.clone()


@torch.no_grad()
def greedy_generate(cfg, model, batch, *, max_new_tokens: int,
                    max_cache_len: int | None = None,
                    temperature: float = 0.0,
                    generator: torch.Generator | None = None,
                    device=None) -> torch.Tensor:
    """batch: {"tokens": (B, S)}, and "patch_embeds" (B, n_patches, D)
    for a vision-patch model. Returns (B, max_new_tokens) int32 tokens.
    Runs on the card, as one CUDA-graph replay, unless ``device="cpu"``,
    which must be where the model is. ``generator`` draws the noise of
    temperature sampling and must be on the model's device."""
    device = check_model_device(model, device)
    if max_new_tokens < 0:
        raise ValueError(
            f"max_new_tokens must be >= 0, got {max_new_tokens}")
    audio = cfg.frontend == "audio_frames"
    if max_new_tokens == 0:
        # zero tokens is an empty result: no prefill or decode is run
        b = batch["frame_embeds" if audio else "tokens"].shape[0]
        return torch.zeros((b, 0), dtype=torch.int32, device=device)
    if audio:
        raise ValueError(
            f"{cfg.arch_id}: greedy_generate feeds sampled tokens back, and "
            "an audio_frames model takes frame_embeds; serve it through "
            "prefill and decode_step with {'frame_embeds': (B, 1, D)}")
    keys = ["tokens"] + (["patch_embeds"]
                         if cfg.frontend == "vision_patches" else [])
    inputs = {k: batch[k] if isinstance(batch[k], torch.Tensor)
              else torch.as_tensor(np.asarray(batch[k]),
                                   dtype=_INPUT_DTYPES[k]) for k in keys}
    B, S = inputs["tokens"].shape
    max_cache_len = max_cache_len or (_prompt_len(cfg, inputs)
                                      + max_new_tokens)
    sampled = temperature > 0.0
    if device.type != "cuda":
        t = u = None
        if sampled:
            t = torch.tensor(temperature, dtype=torch.float32)
            u = torch.empty((max_new_tokens, B, cfg.vocab_size)).uniform_(
                generator=generator)
        out = _generate(cfg, model, inputs, max_new_tokens, max_cache_len,
                        t, u)
        DECODE_STATS["dispatches"] += max_new_tokens - 1
        return out
    key = (cfg, B, S, max_cache_len, max_new_tokens, sampled)
    graphs = model.generate_graphs
    graph = graphs.pop(key, None)
    if graph is None:
        while len(graphs) >= MAX_GRAPHS:
            graphs.popitem(last=False)
        graph = _Graph(cfg, model, inputs, max_new_tokens, max_cache_len,
                       sampled)
    graphs[key] = graph                  # the most recently used is last
    return graph(inputs, temperature, generator)
