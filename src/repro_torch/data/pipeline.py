"""Batch pipeline: packing, label shifting, modality stubs, host prefetch
(a copy of the reference's ``repro.data.pipeline``, numpy only; batches
stay numpy and the training loop moves them to the model's device).

``make_batch(cfg, shape, step)`` is a pure function of the step index, so the
pipeline is trivially resumable after restart (fault tolerance: the loader
has no state to checkpoint beyond the step counter) and identical across
hosts — each host materializes only its shard when ``lo/hi`` are given.

``Prefetcher`` overlaps host batch construction with device compute by one
step (double buffering).
"""
from __future__ import annotations

import threading
from queue import Queue

import numpy as np

from .synthetic import SyntheticTokens


def make_batch(cfg, *, batch: int, seq: int, step: int, seed: int = 0,
               lo: int = 0, hi: int | None = None):
    """Global batch [lo, hi) rows for one step (hi=None → full batch)."""
    hi = batch if hi is None else hi
    rows = hi - lo
    stream = SyntheticTokens(cfg.vocab_size, seed=seed)
    out_tokens = np.zeros((rows, seq + 1), np.int32)
    for r in range(rows):
        gidx = step * batch + lo + r
        out_tokens[r] = stream.block(gidx * (seq + 1), seq + 1)
    tokens = out_tokens[:, :-1]
    labels = out_tokens[:, 1:]
    mask = (labels != 0).astype(np.float32)      # don't train on separators

    if cfg.frontend == "audio_frames":
        rng = np.random.default_rng(seed * 1_000_003 + step)
        return {
            "frame_embeds": rng.standard_normal(
                (rows, seq, cfg.d_model)).astype(np.float32),
            "labels": np.stack(
                [labels % cfg.vocab_size] * cfg.n_codebooks, axis=-1
            ).astype(np.int32),
            "mask": mask,
        }
    if cfg.frontend == "vision_patches":
        P = cfg.n_patches
        text = max(seq - P, 1)
        rng = np.random.default_rng(seed * 1_000_003 + step)
        return {
            "tokens": tokens[:, :text],
            "patch_embeds": rng.standard_normal(
                (rows, P, cfg.d_model)).astype(np.float32),
            "labels": labels[:, :text],
            "mask": mask[:, :text],
        }
    return {"tokens": tokens, "labels": labels, "mask": mask}


class Prefetcher:
    """One-step-ahead host prefetch (double buffering)."""

    def __init__(self, make_fn, start_step: int = 0, depth: int = 2):
        self._make = make_fn
        self._q: Queue = Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._next
        while not self._stop.is_set():
            self._q.put((step, self._make(step)))
            step += 1

    def get(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass
