"""Public wrapper of the flash-attention forward kernels.

For a CUDA tensor ``flash_attention`` launches a hand-written kernel
(``csrc/flash_attn.cu``) on the current stream, or raises; for a CPU tensor
it runs the plain torch version in ``ref.py``. There is no other switch:
the device of the input decides whether a kernel runs, and ``route`` alone
decides which one, from the sizes (never from a failure: a launch that
returns a CUDA error raises):

- ``"split_kv"`` (``flash_split_kernel`` + ``flash_merge_kernel``) for at
  most ``SPLIT_MAX_ROWS`` query rows per (batch, kv head) pair, Sq·G: the
  key slots split over blocks, each block's (m, l, acc) merged in split
  order by a second kernel (decode);
- ``"tensor_core"`` (``flash_tc_kernel``) for more rows in bf16 with dk,
  dv ≤ ``TC_MAX_HEAD_DIM``: Q·Kᵀ and P·V on the tensor cores, skipping
  the key tiles no row of a block sees (prefill);
- ``"tiled"`` (``flash_tiled_kernel``) otherwise: float32, or wider
  heads; blocks of query rows walking every key tile on the CUDA cores.

``split_kv`` and ``tiled`` take any Sq and Sk and head sizes 1 ≤ dk, dv ≤
``MAX_HEAD_DIM``, ``tensor_core`` bf16 up to ``TC_MAX_HEAD_DIM``; each
picks its own tiles and splits, so the reference's block sizes and
``interpret`` have no counterpart.

The layout is the models' (``models.attention.chunked_attention``): q
(B, Sq, KV, G, dk), k (B, Sk, KV, dk), v (B, Sk, KV, dv), pos_q (Sq,),
pos_k (B, Sk) or (Sk,); the output is (B, Sq, KV, G, dv) in q's dtype. The
reference's Pallas kernel takes one batch element as q (KV·G, Sq, dh), k/v
(KV, Sk, dh).

``LAUNCHES["flash_attn"]`` counts calls that launched a kernel (one per
call, on any route) and ``ROUTES`` splits them by route; a plain-version
call counts nothing. A call made while the current stream captures a CUDA
graph runs nothing then: it counts in ``CAPTURED``, by route, instead, and
whoever replays the graph adds what it captured at each replay
(``count_replay``; ``serve.engine`` does), so that the counts stay
launches that ran.
"""
from __future__ import annotations

import functools

import torch

from ..._device import sm_count as _sm_count
from . import ref as _ref

LAUNCHES = {"flash_attn": 0}
ROUTES = {"tiled": 0, "split_kv": 0, "tensor_core": 0}
CAPTURED = dict.fromkeys(ROUTES, 0)
# the launches among ROUTES' that also wrote the log-sum-exp (training)
LSE_ROUTES = dict.fromkeys(ROUTES, 0)
# The largest dk and dv the kernels take: MLA's decode reads a 576-wide
# latent key (kv_lora_rank 512 + rope 64) and a 512-wide value.
MAX_HEAD_DIM = 576
# The largest dk and dv the tensor-core kernel takes: every prefill head
# size of the repo's configs (64, 128, MLA's 192 / 128, recurrentgemma's
# 256).
TC_MAX_HEAD_DIM = 256
# The most query rows per (batch, kv head) pair, Sq·G, that take the split
# route: decode (Sq = 1, G <= 16 in every config of the repo) takes it,
# prefill (Sq·G in the hundreds) the tensor-core or tiled one. On one H100
# (chip_smoke.py's `route threshold flash_attn` line; PERF.md) bf16 crosses
# over between 16 and 64 rows: at 16 the split route was 2.3x faster over
# 8,192 slots, at 64 the tensor-core route 1.6-1.9x faster over 144 and
# 8,192. 64 is kept: no call of the repo's paths has 17 to 64 rows, and
# float32 there would leave the split route for the tiled one (2.6-7.8x
# slower at 64 rows in those bf16 timings).
SPLIT_MAX_ROWS = 64


def reset_launches() -> None:
    LAUNCHES["flash_attn"] = 0
    for r in ROUTES:
        ROUTES[r] = 0
        LSE_ROUTES[r] = 0


def _count(which: str, lse: bool = False) -> None:
    """Count one launch of route ``which`` (in ``LSE_ROUTES`` too when it
    wrote the log-sum-exp), or one captured launch (a build of torch
    without CUDA has no capture to ask about)."""
    if torch.cuda.is_available() \
            and torch.cuda.is_current_stream_capturing():
        CAPTURED[which] += 1
        return
    LAUNCHES["flash_attn"] += 1
    ROUTES[which] += 1
    if lse:
        LSE_ROUTES[which] += 1


def count_replay(routes: dict) -> None:
    """Count one replay of a graph that captured ``routes``, launches by
    route (``CAPTURED`` after its capture less ``CAPTURED`` before)."""
    for which, n in routes.items():
        LAUNCHES["flash_attn"] += n
        ROUTES[which] += n


def route(sq: int, g: int, dtype: torch.dtype, dk: int, dv: int) -> str:
    """Which kernel a card call with ``sq`` queries of ``g`` heads per kv
    head, of ``dtype`` and head sizes ``dk``, ``dv``, takes: "split_kv" for
    ``sq * g <= SPLIT_MAX_ROWS`` query rows per pair; else "tensor_core"
    for bf16 with dk, dv <= ``TC_MAX_HEAD_DIM``; else "tiled" (float32
    keeps the CUDA cores' float32 products and its 2e-5 bound)."""
    if sq * g <= SPLIT_MAX_ROWS:
        return "split_kv"
    if dtype == torch.bfloat16 and max(dk, dv) <= TC_MAX_HEAD_DIM:
        return "tensor_core"
    return "tiled"


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


@functools.lru_cache(maxsize=64)
def _splits(pairs: int, rows: int, sk: int, dk: int, dv: int, bf16: int,
            index: int) -> int:
    """The split route's key splits for these sizes (the kernel's own cost
    rule, which reads the card's SM count and the kernel's occupancy)."""
    splits = _lib().flash_attn_split_kv_splits(pairs, rows, sk, dk, dv, bf16,
                                               _sm_count(index))
    if splits < 1:
        raise RuntimeError(f"flash_attention: no split count for pairs "
                           f"{pairs}, rows {rows}, Sk {sk}, dk {dk}, dv {dv}")
    return splits


def _check(q, k, v, pos_q, pos_k):
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: q (B, Sq, KV, G, dk), k "
                         f"(B, Sk, KV, dk), v (B, Sk, KV, dv); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, KV, G, dk = q.shape
    if k.shape[0] != B or k.shape[2] != KV or k.shape[3] != dk:
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


def flash_attention(q, k, v, pos_q, pos_k, *, window=None, scale=None,
                    return_lse: bool = False):
    """Masked online-softmax attention forward; returns (B, Sq, KV, G, dv)
    in q's dtype, and with ``return_lse`` also the float32 log-sum-exp
    (B, KV, G, Sq) of each row, m + log(max(l, 1e-30)), which the backward
    (``models.flash``) needs. ``window=None`` means no window; ``scale``
    defaults to dk ** -0.5."""
    _check(q, k, v, pos_q, pos_k)
    if not _on_card(q):
        return _ref.ref_flash_attention(q, k, v, pos_q, pos_k, window=window,
                                        scale=scale, return_lse=return_lse)
    B, Sq, KV, G, dk = q.shape
    Sk, dv = k.shape[1], v.shape[-1]
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if window is not None and int(window) < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    out = torch.empty((B, Sq, KV, G, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, KV, G, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    if not (1 <= dk <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: head sizes dk {dk}, dv {dv}; "
                         f"the kernels take 1 to {MAX_HEAD_DIM}")
    pos_q = pos_q.to(torch.int32).contiguous()
    pos_k = (pos_k if pos_k.dim() == 2 else pos_k[None, :].expand(B, Sk)
             ).to(torch.int32).contiguous()
    scale = float(dk ** -0.5 if scale is None else scale)
    _launch(q, k, v, pos_q, pos_k, out, window, scale,
            route(Sq, G, q.dtype, dk, dv), lse=lse)
    return (out, lse) if return_lse else out


def _launch(q, k, v, pos_q, pos_k, out, window, scale, which, splits=None,
            lse=None):
    """Launch the kernel(s) of route ``which`` into ``out`` (int32
    contiguous positions, pos_k (B, Sk)) and, when given, the float32
    (B, KV, G, Sq) ``lse``; ``splits`` overrides the split route's own
    choice of key splits."""
    B, Sq, KV, G, dk = q.shape
    Sk, dv = k.shape[1], v.shape[-1]
    bf16 = int(q.dtype == torch.bfloat16)
    if which == "tensor_core" and (not bf16 or max(dk, dv) > TC_MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: the tensor_core route takes bf16 "
                         f"with dk, dv <= {TC_MAX_HEAD_DIM}, got {q.dtype}, "
                         f"dk {dk}, dv {dv}")
    lib = _lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_q.data_ptr(),
            pos_k.data_ptr(), out.data_ptr())
    sizes = (B, Sq, Sk, KV, G, dk, dv, -1 if window is None else int(window),
             scale, bf16)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lse_ptr = None if lse is None else lse.data_ptr()
    if which == "split_kv":
        if splits is None:
            splits = _splits(B * KV, Sq * G, Sk, dk, dv, bf16,
                             q.device.index or 0)
        workspace = torch.empty(splits * B * KV * Sq * G * (dv + 2),
                                dtype=torch.float32, device=q.device)
        rc = lib.flash_attn_split_kv(*args, workspace.data_ptr(), *sizes,
                                     splits, lse_ptr, stream)
    elif which == "tensor_core":
        rc = lib.flash_attn_tc(*args, *sizes[:-1], lse_ptr, stream)
    else:
        rc = lib.flash_attn_fwd(*args, *sizes, lse_ptr, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({which}): "
                           f"CUDA error {rc}")
    _count(which, lse is not None)
    return out
