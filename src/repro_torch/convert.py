"""State carried between the JAX reference and the port.

The system has no weights; what crosses is device state and programs.
State crosses as numpy arrays: the reference's uint32 rows become int32
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
