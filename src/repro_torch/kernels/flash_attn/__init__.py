from .ops import flash_attention
from . import ref
