"""Deterministic synthetic LM data (a copy of the reference's
``repro.data.synthetic``, numpy only: importing the reference's goes
through JAX).

A keyed, stateless token stream: token[i] = h(seed, i) with a learnable
structure (n-gram-ish correlations) so tiny models show a falling loss — the
end-to-end example trains against this. Document boundaries every
``doc_len`` tokens exercise the packing/masking path.
"""
from __future__ import annotations

import numpy as np


class SyntheticTokens:
    def __init__(self, vocab_size: int, seed: int = 0, doc_len: int = 512,
                 correlation: int = 8):
        self.vocab = vocab_size
        self.seed = seed
        self.doc_len = doc_len
        self.correlation = max(1, correlation)

    def block(self, start: int, length: int) -> np.ndarray:
        """Tokens [start, start+length) — pure function of (seed, index)."""
        idx = np.arange(start, start + length, dtype=np.uint64)
        base = idx // self.correlation      # repeat-ish structure
        mixed = (base * np.uint64(2654435761) + np.uint64(self.seed)) \
            % np.uint64(0xFFFFFFFB)
        toks = (mixed % np.uint64(max(self.vocab - 2, 1))).astype(np.int64) + 1
        # document separators (token 0) at fixed period
        toks = np.where(idx % np.uint64(self.doc_len) == 0, 0, toks)
        return toks.astype(np.int32)
