"""Device-level model: channels × ranks × banks × subarrays over the
subarray runtime.

Port of ``repro.core.pim.device``. The paper's §5.1.4 configuration is 2
channels × 2 ranks × 8 banks/rank = 32 independently-operating banks; each
bank stacks ``subarrays`` (S) subarrays. A ``(bank, sub)`` pair is a
*slot*; slots execute concurrently but share their channel's command/data
bus, so the device-level wall clock (a DDR3 model output, like the meter) is

    wall = max over channels of serialized bus occupancy
         + max over slots of in-slot execution time
         + link-contended COPY drain                  (see ``schedule.py``)
    energy = sum over slots                (the paper's constant nJ/op)

``DeviceState.banks`` is a :class:`~.state.SubarrayState` whose tensors
carry a leading slot axis of length ``n_banks * subarrays`` (slot
``b*S + s``). At the paper's full geometry (32 banks × 2 subarrays × 512
rows × 2,048 words) that is 256 MiB of row state on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import ir
from .compile import sequential_sum
from .state import (NUM_ROWS, ROW_WORDS, SubarrayState, make_bank,
                    resolve_device)
from .timing import DDR3Timing, DEFAULT_TIMING, burst_time_ns


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """A DRAM device: ``channels × ranks × banks_per_rank`` banks of
    ``subarrays`` subarrays each, all sharing one subarray geometry and
    timing model. Frozen/hashable so it can sit in cache keys."""

    channels: int = 2
    ranks: int = 2
    banks_per_rank: int = 8
    subarrays: int = 1
    num_rows: int = NUM_ROWS
    words: int = ROW_WORDS
    timing: DDR3Timing = DEFAULT_TIMING

    @property
    def n_banks(self) -> int:
        return self.channels * self.ranks * self.banks_per_rank

    @property
    def n_slots(self) -> int:
        """Independently-executing units: every (bank, subarray) pair."""
        return self.n_banks * self.subarrays

    def bank_coords(self, bank: int) -> tuple[int, int, int]:
        """Flat bank index → (channel, rank, bank-in-rank)."""
        assert 0 <= bank < self.n_banks, bank
        ch, rest = divmod(bank, self.ranks * self.banks_per_rank)
        rk, bk = divmod(rest, self.banks_per_rank)
        return ch, rk, bk

    def slot_index(self, bank: int, sub: int = 0) -> int:
        """(bank, subarray) → flat slot index into the state's leading axis."""
        if not 0 <= bank < self.n_banks:
            raise ValueError(f"bank {bank} out of range [0, {self.n_banks})")
        if not 0 <= sub < self.subarrays:
            raise ValueError(
                f"subarray {sub} out of range [0, {self.subarrays})")
        return bank * self.subarrays + sub

    def slot_coords(self, slot: int) -> tuple[int, int]:
        """Flat slot index → (bank, subarray)."""
        assert 0 <= slot < self.n_slots, slot
        return divmod(slot, self.subarrays)

    def bank_slots(self, banks) -> tuple[int, ...]:
        """Flat slot indices of every subarray of the given banks, in
        (bank, subarray) order — the serving layer's placement unit."""
        return tuple(self.slot_index(b, s) for b in banks
                     for s in range(self.subarrays))

    def subdevice(self, n_banks: int) -> "DeviceConfig":
        """A private single-channel slice of this device: ``n_banks`` banks
        with the same subarray geometry and timing. Per-slot state and
        meters are layout-independent, so a tenant scheduled alone on its
        subdevice is bit-exact against the same programs running on its
        slots of the shared device (the multi-tenant differential leg)."""
        if not 0 < n_banks <= self.n_banks:
            raise ValueError(
                f"subdevice of {n_banks} banks from {self.n_banks}")
        return dataclasses.replace(self, channels=1, ranks=1,
                                   banks_per_rank=n_banks)


# §5.1.4 device sizes used throughout benchmarks: 1, 8 (one rank), 32 (all).
def paper_device(n_banks: int, num_rows: int = NUM_ROWS,
                 words: int = ROW_WORDS, subarrays: int = 1,
                 timing: DDR3Timing = DEFAULT_TIMING) -> DeviceConfig:
    """The paper's DDR3 topology scaled down to ``n_banks`` total banks."""
    shapes = {1: (1, 1, 1), 2: (1, 1, 2), 4: (1, 1, 4), 8: (1, 1, 8),
              16: (1, 2, 8), 32: (2, 2, 8)}
    if n_banks not in shapes:
        raise ValueError(
            f"n_banks must be one of {sorted(shapes)}, got {n_banks}")
    ch, rk, bk = shapes[n_banks]
    return DeviceConfig(channels=ch, ranks=rk, banks_per_rank=bk,
                        subarrays=subarrays, num_rows=num_rows, words=words,
                        timing=timing)


@dataclasses.dataclass
class DeviceState:
    """All subarrays of one device; every ``banks`` tensor has a leading
    ``(n_banks * subarrays,)`` slot axis (slot ``b*S + s``).

    ``host_credit_ns`` is the async-host-engine double-buffer window: the
    previous ``schedule`` step's compute+copy wall time (a DDR3 model
    output), against which the next step's off-chip HOSTW/HOSTR bursts may
    overlap when scheduled with ``async_host=True``. A float or a 0-d
    float32 tensor on the device, written without a host sync."""

    banks: SubarrayState
    config: DeviceConfig
    host_credit_ns: float | torch.Tensor = 0.0

    @property
    def n_banks(self) -> int:
        return self.config.n_banks

    @property
    def n_slots(self) -> int:
        return self.config.n_slots

    @property
    def device(self) -> torch.device:
        return self.banks.bits.device

    def slot(self, bank: int, sub: int = 0) -> SubarrayState:
        """One subarray's state, unbatched (a view)."""
        i = self.config.slot_index(bank, sub)
        return self.banks.map(lambda x: x[i])

    def bank(self, b: int) -> SubarrayState:
        """One bank's state: unbatched for single-subarray banks, a stacked
        ``(subarrays, ...)`` view otherwise."""
        if self.config.subarrays == 1:
            return self.slot(b, 0)
        i = self.config.slot_index(b, 0)
        return self.banks.map(lambda x: x[i:i + self.config.subarrays])

    @property
    def slot_time_ns(self) -> torch.Tensor:
        """(n_slots,) cumulative per-slot busy time, float32 on the device
        (no host sync). Meters are cumulative and slots are exclusively
        owned, so a tenant's busy time over any window is the difference
        of two snapshots of this tensor sliced at its slots."""
        return self.banks.meter.time_ns

    @property
    def slot_energy_nj(self) -> torch.Tensor:
        """(n_slots,) cumulative per-slot energy, float32 on the device:
        the meter's five energy fields added in the reference's order."""
        return self.banks.meter.total_energy_nj

    def with_banks(self, banks: SubarrayState,
                   host_credit_ns=None) -> "DeviceState":
        return DeviceState(banks=banks, config=self.config,
                           host_credit_ns=(self.host_credit_ns
                                           if host_credit_ns is None
                                           else host_credit_ns))


def make_device(config: DeviceConfig, reserve: bool = True, *,
                device=None) -> DeviceState:
    """Fresh device on ``device`` (the card unless ``device="cpu"``);
    ``reserve`` initializes the Ambit C0/C1 control rows in every subarray
    (meter-free, as in ``isa.reserve_control_rows``)."""
    banks = make_bank(config.n_slots, config.num_rows, config.words,
                      device=resolve_device(device))
    if reserve:
        banks.bits[:, -2] = -1          # C1: 0xFFFFFFFF as int32
    return DeviceState(banks=banks, config=config)


def issue_bus_ns(program: ir.PimProgram | None,
                 timing: DDR3Timing = DEFAULT_TIMING) -> float:
    """Command-bus occupancy of one slot's ISSUE bursts."""
    if program is None:
        return 0.0
    n_issue = sum(1 for o in program.ops if o.op == ir.OP_ISSUE)
    return n_issue * timing.t_issue


def host_bus_ns(program: ir.PimProgram | None,
                timing: DDR3Timing = DEFAULT_TIMING) -> float:
    """Channel occupancy of one slot's off-chip HOSTW/HOSTR bursts — the
    part of the stream that streams data over the channel and therefore
    cannot overlap with another slot's bursts on the SAME channel."""
    if program is None:
        return 0.0
    row_bytes = program.words * 4
    n_host = sum(1 for o in program.ops
                 if o.op in (ir.OP_WRITE, ir.OP_READ))
    return n_host * burst_time_ns(row_bytes, timing)


def bus_time_ns(program: ir.PimProgram | None,
                timing: DDR3Timing = DEFAULT_TIMING) -> float:
    """Total per-channel bus occupancy of one slot's stream: ISSUE bursts
    plus off-chip HOSTW/HOSTR burst windows. (Before the channel-aware
    model, only ISSUE counted — off-chip bursts were free on the wall
    clock.)"""
    return issue_bus_ns(program, timing) + host_bus_ns(program, timing)


def channel_bus_model(cfg: DeviceConfig, issue_slot, host_slot, *,
                      host_credit_ns: float = 0.0):
    """Serialize per-slot bus occupancy FCFS per channel.

    ``issue_slot`` / ``host_slot`` are length-``n_slots`` arrays of each
    slot's ISSUE / host-burst occupancy. Slots are served in slot order on
    their bank's channel; consecutive bus-active slots on one channel that
    sit in different ranks charge one ``tRTRS`` bus-turnaround penalty.
    ``host_credit_ns`` is the async-host overlap window: up to that much of
    each channel's HOST traffic is hidden under the *previous* step's
    compute (each channel's transfer engine overlaps the same window —
    channels stream independently).

    Returns ``(busy, switch_ns, hidden_ns)``: per-channel serialized
    occupancy (float array, switch penalties included, overlap deducted),
    the total rank-switch penalty, and the total host time hidden.
    """
    issue_ch, host_ch, switch_ch = channel_occupancy(cfg, issue_slot,
                                                     host_slot)
    hidden = np.minimum(host_ch, max(float(host_credit_ns), 0.0))
    busy = issue_ch + host_ch - hidden + switch_ch
    return busy, float(switch_ch.sum()), float(hidden.sum())


def channel_occupancy(cfg: DeviceConfig, issue_slot, host_slot):
    """The per-channel accumulation walk shared by ``channel_bus_model``
    and the scheduler's async-credit fold: serialize bus-active slots FCFS
    in slot order onto their bank's channel. Returns float64
    ``(issue_ch, host_ch, switch_ch)`` arrays of length ``channels`` —
    ISSUE occupancy, HOSTW/HOSTR occupancy (the part an async host engine
    may hide), and accumulated ``tRTRS`` rank-switch penalties."""
    issue_slot = np.asarray(issue_slot, np.float64)
    host_slot = np.asarray(host_slot, np.float64)
    issue_ch = np.zeros(cfg.channels)
    host_ch = np.zeros(cfg.channels)
    switch_ch = np.zeros(cfg.channels)
    last_rank: list = [None] * cfg.channels
    for k in range(cfg.n_slots):
        if issue_slot[k] + host_slot[k] <= 0.0:
            continue
        ch, rk, _ = cfg.bank_coords(k // cfg.subarrays)
        issue_ch[ch] += issue_slot[k]
        host_ch[ch] += host_slot[k]
        if last_rank[ch] is not None and last_rank[ch] != rk:
            switch_ch[ch] += cfg.timing.tRTRS
        last_rank[ch] = rk
    return issue_ch, host_ch, switch_ch


def device_wall_ns(bus_ns, exec_ns) -> torch.Tensor:
    """Legacy device-wide serialization: wall = Σ bus + max exec (float32,
    summed left to right). Kept as the A/B reference against the
    channel-aware model."""
    bus_ns = torch.from_numpy(np.array(bus_ns, np.float32).reshape(-1))
    exec_ns = torch.from_numpy(np.array(exec_ns, np.float32).reshape(-1))
    return sequential_sum(bus_ns) + (
        torch.max(exec_ns) if exec_ns.numel()
        else torch.zeros((), dtype=torch.float32))
