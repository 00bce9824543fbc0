"""Public wrapper of the flash-attention forward kernel.

For a CUDA tensor ``flash_attention`` launches the hand-written kernel
(``csrc/flash_attn.cu``) on the current stream, or raises; for a CPU tensor
it runs the plain torch version in ``ref.py``. There is no other switch:
the device of the input decides. The kernel picks its own tiles and takes
any Sq and Sk, so the reference's block sizes and ``interpret`` have no
counterpart.

The layout is the models' (``models.attention.chunked_attention``): q
(B, Sq, KV, G, dh), k/v (B, Sk, KV, dh), pos_q (Sq,), pos_k (B, Sk) or
(Sk,). The reference's Pallas kernel takes one batch element as
q (KV·G, Sq, dh), k/v (KV, Sk, dh).

``LAUNCHES["flash_attn"]`` counts kernel launches; a plain-version call
counts nothing.
"""
from __future__ import annotations

import torch

from . import ref as _ref

LAUNCHES = {"flash_attn": 0}
HEAD_DIMS = (16, 32, 64, 128)       # the kernel's compiled head sizes


def reset_launches() -> None:
    LAUNCHES["flash_attn"] = 0


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"flash_attention takes CUDA or CPU tensors, got "
                     f"{x.device}")


def _lib():
    from .. import _build
    return _build.load("flash_attn")


def _check(q, k, v, pos_q, pos_k):
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q (B, Sq, KV, G, dh), k/v "
                         f"(B, Sk, KV, dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, KV, G, dh = q.shape
    if k.shape[0] != B or k.shape[2] != KV or k.shape[3] != dh:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    Sk = k.shape[1]
    if Sk == 0:
        raise ValueError("flash_attention: no keys (Sk = 0)")
    if tuple(pos_q.shape) != (Sq,) or tuple(pos_k.shape) not in ((Sk,),
                                                                 (B, Sk)):
        raise ValueError(f"flash_attention: pos_q {tuple(pos_q.shape)} and "
                         f"pos_k {tuple(pos_k.shape)} do not fit Sq={Sq}, "
                         f"Sk={Sk}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share bf16 or "
                        f"float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    devices = {t.device for t in (q, k, v, pos_q, pos_k)}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: operands on "
                         f"{sorted(map(str, devices))}")


def flash_attention(q, k, v, pos_q, pos_k, *, window=None,
                    scale=None) -> torch.Tensor:
    """Masked online-softmax attention forward; returns q's shape and
    dtype. ``window=None`` means no window; ``scale`` defaults to
    dh ** -0.5."""
    _check(q, k, v, pos_q, pos_k)
    if not _on_card(q):
        return _ref.ref_flash_attention(q, k, v, pos_q, pos_k, window=window,
                                        scale=scale)
    B, Sq, KV, G, dh = q.shape
    Sk = k.shape[1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if window is not None and int(window) < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    pos_q = pos_q.to(torch.int32).contiguous()
    pos_k = (pos_k if pos_k.dim() == 2 else pos_k[None, :].expand(B, Sk)
             ).to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    scale = float(dh ** -0.5 if scale is None else scale)
    rc = _lib().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_q.data_ptr(),
        pos_k.data_ptr(), out.data_ptr(), B, Sq, Sk, KV, G, dh,
        -1 if window is None else int(window), scale,
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["flash_attn"] += 1
    return out
