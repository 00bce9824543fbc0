from .ops import pim_matmul, pim_linear, quantize
from . import ref
