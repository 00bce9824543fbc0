"""Hand-written CUDA row kernels (``csrc/rowops.cu``) and their plain
torch versions."""
from .ops import (LAUNCHES, LAUNCHES_BY_OP, ROWS_BY_OP, SHIFT_ROUTES,
                  bitwise, bitwise_rows, meter_fold, ripple_add, shift_cols,
                  shift_rows)

__all__ = ["LAUNCHES", "LAUNCHES_BY_OP", "ROWS_BY_OP", "SHIFT_ROUTES",
           "bitwise", "bitwise_rows", "meter_fold", "ripple_add",
           "shift_cols", "shift_rows"]
