"""Where the port runs: the CUDA card unless the caller asks for the CPU."""
from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``device=None`` means the CUDA card. Without one, raise instead of
    running on the CPU: a CPU run has to be asked for (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def same_device(a, b) -> bool:
    """Whether two devices name the same one (``cuda`` is the current
    card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == (
        b.index if b.index is not None else current)


@functools.lru_cache(maxsize=8)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of card ``index``: the kernels size their
    grids and split counts by it."""
    return torch.cuda.get_device_properties(index).multi_processor_count
