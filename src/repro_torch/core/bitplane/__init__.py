"""Bit-parallel SIMD compute on horizontal data: the paper's app layer.
Port of ``repro.core.bitplane``."""
from .vm import PimVM
from . import arith, gf, layout, rs

__all__ = ["PimVM", "arith", "gf", "layout", "rs"]
