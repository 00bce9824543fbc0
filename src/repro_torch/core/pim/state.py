"""Subarray / bank state for the in-DRAM PIM runtime, as torch tensors.

Port of ``repro.core.pim.state``. The paper's subarray is modeled
functionally:

- ``bits``    : (num_rows, words) int32 — the data rows. Column ``c`` of the
  8KB row (65,536 bitlines) lives at bit ``c % 32`` (little-endian) of word
  ``c // 32``.
- ``mig_top`` : (words,) int32 — migration-cell row at the top of the
  subarray, shared between bitline pair ``(2k, 2k+1)``.
- ``mig_bot`` : (words,) int32 — migration-cell row at the bottom, staggered
  pairing ``(2k+1, 2k+2)``.
- ``dcc``     : (words,) int32 — dual-contact-cell row (Ambit NOT).
- ``meter``   : cost meter advanced by every command (DDR3-1333 model).

Rows are int32 *bit patterns* of the reference's uint32 words: torch has no
``~``/``<<``/``>>`` on uint32 tensors, so every row tensor is int32 and the
only conversions happen at the numpy boundary by a dtype view
(``convert.py``). A batch of subarrays (a bank, or a device's slots) carries
a leading slot axis on every field — where the reference ``vmap``s, the port
writes the axis out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..._device import resolve_device  # noqa: F401  (re-exported)

# Paper/NVMain configuration: 8KB row buffer = 65,536 bitlines; 512 rows.
ROW_BITS = 65_536
WORD_BITS = 32
ROW_WORDS = ROW_BITS // WORD_BITS  # 2048
NUM_ROWS = 512

# Parity masks in little-endian bit order: even columns sit at bits 0,2,4,...
# As int32 bit patterns: 0x55555555 and 0xAAAAAAAA (= -1431655766).
EVEN_MASK = 0x5555_5555
ODD_MASK = 0xAAAA_AAAA - (1 << 32)

FLOAT_FIELDS = ("time_ns", "e_act", "e_pre", "e_refresh", "e_burst",
                "e_background")
INT_FIELDS = ("n_act", "n_pre", "n_aap", "n_shift", "n_tra", "n_refresh")


def as_rows(rows, device) -> torch.Tensor:
    """A fresh int32 tensor on ``device`` holding ``rows`` — an int32
    tensor, or a uint32 numpy array whose bits are kept by a dtype view."""
    if isinstance(rows, torch.Tensor):
        return rows.to(device=device, dtype=torch.int32, copy=True)
    return torch.from_numpy(
        np.array(rows, dtype=np.uint32).view(np.int32)).to(device)


@dataclasses.dataclass
class CostMeter:
    """DDR3-1333 time/energy accounting (ns / nJ), advanced per command.
    These are outputs of the DDR3 model, not times of the machine running
    the simulation. Float fields are float32, counters int32; every field
    is 0-d, or ``(B,)`` for a batch of subarrays."""

    time_ns: torch.Tensor
    e_act: torch.Tensor
    e_pre: torch.Tensor
    e_refresh: torch.Tensor
    e_burst: torch.Tensor
    e_background: torch.Tensor
    n_act: torch.Tensor
    n_pre: torch.Tensor
    n_aap: torch.Tensor
    n_shift: torch.Tensor
    n_tra: torch.Tensor
    n_refresh: torch.Tensor

    @staticmethod
    def zeros(device=None, shape=()) -> "CostMeter":
        device = resolve_device(device)
        fields = {k: torch.zeros(shape, dtype=torch.float32, device=device)
                  for k in FLOAT_FIELDS}
        fields.update({k: torch.zeros(shape, dtype=torch.int32,
                                      device=device) for k in INT_FIELDS})
        return CostMeter(**fields)

    @property
    def total_energy_nj(self) -> torch.Tensor:
        return (self.e_act + self.e_pre + self.e_refresh + self.e_burst
                + self.e_background)

    def stacked(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(..., 6)`` float32 and ``(..., 6)`` int32 field stacks."""
        return (torch.stack([getattr(self, k) for k in FLOAT_FIELDS], -1),
                torch.stack([getattr(self, k) for k in INT_FIELDS], -1))

    @staticmethod
    def from_stacked(f: torch.Tensor, i: torch.Tensor) -> "CostMeter":
        fields = {k: f[..., j] for j, k in enumerate(FLOAT_FIELDS)}
        fields.update({k: i[..., j] for j, k in enumerate(INT_FIELDS)})
        return CostMeter(**fields)

    def map(self, fn) -> "CostMeter":
        return CostMeter(**{k: fn(getattr(self, k))
                            for k in FLOAT_FIELDS + INT_FIELDS})


@dataclasses.dataclass
class SubarrayState:
    """One open-bitline subarray with the paper's two migration rows (or a
    batch of them, with a leading slot axis on every field)."""

    bits: torch.Tensor      # (num_rows, words) int32
    mig_top: torch.Tensor   # (words,) int32
    mig_bot: torch.Tensor   # (words,) int32
    dcc: torch.Tensor       # (words,) int32
    meter: CostMeter

    @property
    def num_rows(self) -> int:
        return self.bits.shape[-2]

    @property
    def words(self) -> int:
        return self.bits.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.bits.device

    def map(self, fn) -> "SubarrayState":
        """Apply ``fn`` to every tensor (e.g. slice or move the batch)."""
        return SubarrayState(bits=fn(self.bits), mig_top=fn(self.mig_top),
                             mig_bot=fn(self.mig_bot), dcc=fn(self.dcc),
                             meter=self.meter.map(fn))


def make_subarray(num_rows: int = NUM_ROWS, words: int = ROW_WORDS,
                  bits=None, *, device=None) -> SubarrayState:
    device = resolve_device(device)
    if bits is None:
        bits = torch.zeros((num_rows, words), dtype=torch.int32,
                           device=device)
    else:
        bits = as_rows(bits, device)
        if tuple(bits.shape) != (num_rows, words):
            raise ValueError(
                f"bits shape {tuple(bits.shape)} != ({num_rows}, {words})")
    zrow = torch.zeros((words,), dtype=torch.int32, device=device)
    return SubarrayState(bits=bits, mig_top=zrow, mig_bot=zrow.clone(),
                         dcc=zrow.clone(), meter=CostMeter.zeros(device))


def make_bank(num_subarrays: int, num_rows: int = NUM_ROWS,
              words: int = ROW_WORDS, *, device=None) -> SubarrayState:
    """A bank is a batch of subarrays: every field gains a leading
    ``(num_subarrays,)`` axis."""
    device = resolve_device(device)
    z = lambda *s: torch.zeros((num_subarrays,) + s, dtype=torch.int32,
                               device=device)
    return SubarrayState(bits=z(num_rows, words), mig_top=z(words),
                         mig_bot=z(words), dcc=z(words),
                         meter=CostMeter.zeros(device, (num_subarrays,)))
