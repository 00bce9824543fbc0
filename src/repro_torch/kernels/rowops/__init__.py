"""Hand-written CUDA row kernels (``csrc/rowops.cu``) and their plain
torch versions."""
from .ops import (LAUNCHES, LAUNCHES_BY_OP, bitwise, meter_fold,
                  ripple_add, shift_cols)

__all__ = ["LAUNCHES", "LAUNCHES_BY_OP", "bitwise", "meter_fold",
           "ripple_add", "shift_cols"]
