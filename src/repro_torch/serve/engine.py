"""Batched serving engine: prefill + single-token decode loop.

Port of ``repro.serve.engine``. Greedy or temperature sampling over a batch
of equal-length prompts. The reference runs its decode loop as one jitted
``lax.scan``; the port runs a Python loop of ``decode_step`` calls (a CUDA
graph of the step is later work, ROADMAP). Temperature sampling draws from
an explicit ``torch.Generator``, so its tokens are not the reference's
``jax.random`` ones.
"""
from __future__ import annotations

import torch

from ..models import decode_step, prefill
from ..models.transformer import check_model_device


def _sample(cfg, logits, temperature: float, generator):
    lg = logits.reshape(logits.shape[0], -1)[:, :cfg.vocab_size]
    if temperature <= 0.0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    probs = torch.softmax(lg.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@torch.no_grad()
def greedy_generate(cfg, model, batch, *, max_new_tokens: int,
                    max_cache_len: int | None = None,
                    temperature: float = 0.0,
                    generator: torch.Generator | None = None,
                    device=None) -> torch.Tensor:
    """batch: {"tokens": (B, S)}. Returns (B, max_new_tokens) int32 tokens.
    Runs on the card unless ``device="cpu"``, which must be where the model
    is."""
    device = check_model_device(model, device)
    if max_new_tokens < 0:
        raise ValueError(
            f"max_new_tokens must be >= 0, got {max_new_tokens}")
    tokens = batch["tokens"]
    if max_new_tokens == 0:
        # zero tokens is an empty result: no prefill or decode is run
        return torch.zeros((tokens.shape[0], 0), dtype=torch.int32,
                           device=device)
    prompt_len = tokens.shape[1]
    max_cache_len = max_cache_len or (prompt_len + max_new_tokens)

    logits, caches = prefill(cfg, model, batch, max_cache_len, device=device)
    tok = _sample(cfg, logits, temperature, generator)[:, None]
    out = [tok]
    for pos in range(prompt_len, prompt_len + max_new_tokens - 1):
        logits, caches = decode_step(cfg, model, {"tokens": tok}, pos,
                                     caches, device=device)
        tok = _sample(cfg, logits, temperature, generator)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
