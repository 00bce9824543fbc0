"""Atomic checkpoints in the reference's layout (port of ``repro.ckpt``)."""
from . import checkpoint

__all__ = ["checkpoint"]
