"""Deterministic synthetic LM data and the batch pipeline (port of
``repro.data``): numpy only, bit-equal to the reference's batches."""
from .pipeline import Prefetcher, make_batch
from .synthetic import SyntheticTokens

__all__ = ["Prefetcher", "SyntheticTokens", "make_batch"]
