"""Assigned input shapes and the (arch × shape) applicability matrix.

Four shapes per arch (40 cells):
  train_4k     seq 4096,  global_batch 256  → train_step
  prefill_32k  seq 32768, global_batch 32   → prefill (inference)
  decode_32k   cache 32768, global_batch 128 → serve_step (1 new token)
  long_500k    cache 524288, global_batch 1  → serve_step; requires
               sub-quadratic attention state — runs only for SSM / hybrid /
               sliding-window archs, recorded as an explicit skip otherwise.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Archs with sub-quadratic (O(1) or windowed) decode state.
_SUBQUADRATIC = {
    "falcon-mamba-7b",          # O(1) SSM state
    "recurrentgemma-2b",        # RG-LRU state + 2k local window
    "starcoder2-7b",            # 4k sliding window
    "llava-next-mistral-7b",    # 4k sliding window (Mistral lineage)
}


def applicable(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in _SUBQUADRATIC
    return True


def skip_reason(arch_id: str, shape_name: str) -> str | None:
    if applicable(arch_id, shape_name):
        return None
    return ("full attention: 500k decode requires sub-quadratic attention "
            "state (DESIGN.md §5)")
