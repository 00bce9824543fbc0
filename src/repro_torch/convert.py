"""State and weights carried between the JAX reference and the port.

The PIM simulator has no weights; what crosses is device state and
programs. State crosses as numpy arrays: the reference's uint32 rows become int32
tensors by a dtype view (no value changes), meter fields float32/int32
0-d or ``(n_slots,)`` tensors. Programs cross as ``pim-trace`` text
(``PimProgram.to_trace()`` / ``to_trace_device()`` on one side,
``from_trace*`` on the other), which both packages read and write byte for
byte.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.pim.device import DeviceConfig, DeviceState
from .core.pim.state import (FLOAT_FIELDS, INT_FIELDS, CostMeter,
                             SubarrayState, as_rows, resolve_device)
from .core.pim.timing import DDR3Timing

_ROW_FIELDS = ("bits", "mig_top", "mig_bot", "dcc")


def meter_from_numpy(meter: dict, device=None) -> CostMeter:
    device = resolve_device(device)
    fields = {k: torch.from_numpy(np.array(meter[k], np.float32)).to(device)
              for k in FLOAT_FIELDS}
    fields.update({k: torch.from_numpy(np.array(meter[k], np.int32))
                   .to(device) for k in INT_FIELDS})
    return CostMeter(**fields)


def subarray_from_numpy(bits, mig_top, mig_bot, dcc, meter: dict, *,
                        device=None) -> SubarrayState:
    """A port state from uint32 arrays (with or without a leading slot
    axis) and a ``{field: value}`` meter dict."""
    device = resolve_device(device)
    return SubarrayState(bits=as_rows(bits, device),
                         mig_top=as_rows(mig_top, device),
                         mig_bot=as_rows(mig_bot, device),
                         dcc=as_rows(dcc, device),
                         meter=meter_from_numpy(meter, device))


def device_from_numpy(config_kwargs: dict, arrays: dict,
                      host_credit_ns: float = 0.0, *,
                      device=None) -> DeviceState:
    """A port device from ``DeviceConfig`` keyword arguments (``timing``
    may be a dict of ``DDR3Timing`` fields) and the slot-batched arrays of
    :func:`to_numpy`."""
    kwargs = dict(config_kwargs)
    if isinstance(kwargs.get("timing"), dict):
        kwargs["timing"] = DDR3Timing(**kwargs["timing"])
    banks = subarray_from_numpy(
        *(arrays[k] for k in _ROW_FIELDS),
        meter={k: arrays[k] for k in FLOAT_FIELDS + INT_FIELDS},
        device=device)
    return DeviceState(banks=banks, config=DeviceConfig(**kwargs),
                       host_credit_ns=float(np.float32(host_credit_ns)))


def to_numpy(state) -> dict:
    """The inverse: ``{field: array}`` with uint32 rows, float32 and int32
    meter fields. Takes a ``SubarrayState`` or a ``DeviceState`` (its
    slot-batched banks, plus ``host_credit_ns``)."""
    out = {}
    if isinstance(state, DeviceState):
        credit = state.host_credit_ns
        out["host_credit_ns"] = np.float32(
            credit.item() if isinstance(credit, torch.Tensor) else credit)
        state = state.banks
    for k in _ROW_FIELDS:
        out[k] = getattr(state, k).cpu().numpy().view(np.uint32)
    for k in FLOAT_FIELDS + INT_FIELDS:
        out[k] = getattr(state.meter, k).cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# LM weights
# ---------------------------------------------------------------------------

def _float(a, dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: exact in f32
        a = a.astype(np.float32)
    elif a.dtype.kind != "f":
        raise TypeError(f"expected a float array, got {a.dtype}")
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _exact(a, np_dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != np_dtype:
        raise TypeError(f"expected {np.dtype(np_dtype)}, got {a.dtype}")
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_numpy(cfg, params: dict, device=None):
    """The port's model from the reference's ``init_params`` pytree, its
    leaves as numpy arrays. The stacked ``(L, ...)`` layer leaves are
    sliced per layer; quantized linears keep ``w_int`` int8 and ``scales``
    float32 exactly; float weights take the config's dtype."""
    from .models import attention, ffn, transformer
    from .models.common import Linear, Norm, dtype_of

    transformer.check_supported(cfg)
    device = resolve_device(device)
    dt = dtype_of(cfg)

    def flt(a):
        return _float(a, dt, device)

    def norm(p, i=None):
        pick = (lambda a: a) if i is None else (lambda a: np.asarray(a)[i])
        return Norm(flt(pick(p["w"])),
                    flt(pick(p["b"])) if "b" in p else None)

    def lin(p, i):
        b = flt(np.asarray(p["b"])[i]) if "b" in p else None
        if "w_int" in p:
            return Linear(
                w_int=_exact(np.asarray(p["w_int"])[i], np.int8, device),
                scales=_exact(np.asarray(p["scales"])[i], np.float32,
                              device), b=b)
        return Linear(flt(np.asarray(p["w"])[i]), b=b)

    stack = params["stack"]
    a, f = stack["attn"], stack["ffn"]
    layers = []
    for i in range(cfg.n_layers):
        opt = {k: flt(np.asarray(a[k])[i]) for k in
               ("bq", "bk", "bv", "q_norm", "k_norm") if k in a}
        gqa = attention.GQA(*(flt(np.asarray(a[k])[i])
                              for k in ("wq", "wk", "wv", "wo")), **opt)
        dense = ffn.DenseFFN(lin(f["w1"], i), lin(f["w2"], i),
                             lin(f["w3"], i) if "w3" in f else None)
        layers.append(transformer.TFLayer(norm(stack["ln1"], i), gqa,
                                          norm(stack["ln2"], i), dense))
    lm_head = flt(params["lm_head"]) if "lm_head" in params else None
    return transformer.LM(cfg, flt(params["embed"]), layers,
                          norm(params["final_norm"]), lm_head)
