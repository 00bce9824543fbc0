"""DDR3-1333 timing & energy model (NVMain-equivalent, calibrated to paper).

Port of ``repro.core.pim.timing``. The paper configures NVMain as Micron
DDR3-1333 4Gb, 8 banks/rank, 2 ranks/channel, 2 channels, 512-row
subarrays, 8KB row buffer, and reports (Tables 2-3):

    single shift  : 208.7 ns, 31.321 nJ (30.24 nJ active)
    energy / ACT  : 30.24 / 8 = 3.78 nJ  (4 AAP = 8 ACTs per shift)
    AAP latency   : ~49.5 ns  (tRAS + tRP, matches Ambit's ~49 ns)
    refresh       : tREFI = 7.8 us, ~80 nJ + tRFC stall per event

Every nanosecond and nanojoule here is an output of this DDR3 model — what
the simulated DRAM would take — and never a time of the machine running the
simulation. The meter arithmetic is float32 in the reference's order: each
increment is rounded to float32 on the host (numpy, as the reference's
``jnp.float32`` constants are) and added by one torch op, so nothing is
contracted or reassociated and the meter is bit-identical on any device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .state import CostMeter


@dataclasses.dataclass(frozen=True)
class DDR3Timing:
    """All times ns, energies nJ, powers mW (nJ/ns = W; mW = 1e-6 nJ/ns)."""

    tCK: float = 1.5            # DDR3-1333 clock (667 MHz)
    tRCD: float = 13.5
    tRP: float = 13.5
    tRAS: float = 36.0
    tRC: float = 49.5           # tRAS + tRP
    tREFI: float = 7_800.0      # refresh interval
    tRFC: float = 260.0         # refresh cycle, 4Gb DDR3
    tRTRS: float = 3.0          # rank-to-rank switch (2 tCK bus turnaround)
    t_issue: float = 10.5       # command-bus issue overhead per op burst (7 tCK)

    # Energy. E_ACT covers one full-row (8KB) activation + restore.
    e_act: float = 3.78         # nJ / ACT   (paper: 30.24 nJ / 8 ACTs)
    e_pre: float = 0.25         # nJ / PRE
    e_ref: float = 80.0         # nJ / refresh event (paper: 77.1-96.4)
    e_burst_per_64b: float = 12.5   # nJ / 64B off-chip transfer (paper ~10-15)
    p_background: float = 0.39e-6   # nJ/ns standby power within the bank
    # Multi-row activation: extra restore energy per extra raised row.
    e_act_extra_row: float = 1.2    # nJ / additional row in DRA/TRA
    # LISA-style in-DRAM row movement (see the reference module).
    t_rbm: float = 8.0              # ns / inter-subarray link hop (LISA RBM)
    e_rbm: float = 0.2              # nJ / link hop
    t_copy_bank: float = 99.0       # ns inter-bank internal-bus transfer (2 tRC)
    e_copy_bank: float = 11.0       # nJ / inter-bank row transfer

    @property
    def t_aap(self) -> float:
        return self.tRAS + self.tRP  # ACT-ACT-PRE: second ACT overlaps restore

    @property
    def t_shift(self) -> float:
        return 4.0 * self.t_aap      # the paper's 4-AAP shift


DEFAULT_TIMING = DDR3Timing()

_f32 = np.float32


def _bump(meter: CostMeter, *, dt: float, e_act: float = 0.0,
          e_pre: float = 0.0, n_act: int = 0, n_pre: int = 0,
          n_aap: int = 0, n_shift: int = 0, n_tra: int = 0,
          cfg: DDR3Timing = DEFAULT_TIMING) -> CostMeter:
    """Advance the meter by one command, folding in background power."""
    dt = _f32(dt)
    return CostMeter(
        time_ns=meter.time_ns + float(dt),
        e_act=meter.e_act + float(_f32(e_act)),
        e_pre=meter.e_pre + float(_f32(e_pre)),
        e_refresh=meter.e_refresh,
        e_burst=meter.e_burst,
        e_background=meter.e_background + float(dt * _f32(cfg.p_background)),
        n_act=meter.n_act + n_act,
        n_pre=meter.n_pre + n_pre,
        n_aap=meter.n_aap + n_aap,
        n_shift=meter.n_shift + n_shift,
        n_tra=meter.n_tra + n_tra,
        n_refresh=meter.n_refresh,
    )


def charge_aap(meter: CostMeter, cfg: DDR3Timing = DEFAULT_TIMING) -> CostMeter:
    """ACT-ACT-PRE (RowClone intra-subarray copy): 2 activations, 1 precharge."""
    return _bump(meter, dt=cfg.t_aap, e_act=2 * cfg.e_act, e_pre=cfg.e_pre,
                 n_act=2, n_pre=1, n_aap=1, cfg=cfg)


def charge_mra(meter: CostMeter, k_rows: int,
               cfg: DDR3Timing = DEFAULT_TIMING) -> CostMeter:
    """Multi-row activation (DRA k=2 / TRA k=3) + PRE."""
    e = cfg.e_act + (k_rows - 1) * cfg.e_act_extra_row
    return _bump(meter, dt=cfg.tRC, e_act=e, e_pre=cfg.e_pre,
                 n_act=1, n_pre=1, n_tra=int(k_rows == 3), cfg=cfg)


def charge_shift(meter: CostMeter,
                 cfg: DDR3Timing = DEFAULT_TIMING) -> CostMeter:
    """One full-row 1-bit shift = 4 AAPs (the paper's primitive)."""
    m = meter
    for _ in range(4):
        m = charge_aap(m, cfg)
    m.n_shift = m.n_shift + 1
    return m


def copy_cost(hops: int = 0, inter_bank: bool = False,
              cfg: DDR3Timing = DEFAULT_TIMING):
    """(dt_ns, e_act, e_pre, n_act, n_pre, n_aap) of one LISA COPY.
    ``hops=0`` without ``inter_bank`` is exactly one AAP (RowClone)."""
    dt = cfg.t_aap + hops * cfg.t_rbm + (cfg.t_copy_bank if inter_bank
                                         else 0.0)
    e_act = 2 * cfg.e_act + hops * cfg.e_rbm + (cfg.e_copy_bank if inter_bank
                                                else 0.0)
    return dt, e_act, cfg.e_pre, 2, 1, 1


def charge_copy(meter: CostMeter, hops: int = 0, inter_bank: bool = False,
                cfg: DDR3Timing = DEFAULT_TIMING) -> CostMeter:
    """LISA row movement: source activation + RBM hops (+ internal bus)."""
    dt, e_act, e_pre, n_act, n_pre, n_aap = copy_cost(hops, inter_bank, cfg)
    return _bump(meter, dt=dt, e_act=e_act, e_pre=e_pre, n_act=n_act,
                 n_pre=n_pre, n_aap=n_aap, cfg=cfg)


def charge_issue(meter: CostMeter,
                 cfg: DDR3Timing = DEFAULT_TIMING) -> CostMeter:
    """One-time command-bus issue overhead for a burst of PIM commands."""
    return _bump(meter, dt=cfg.t_issue, cfg=cfg)


# Re-counts of the least fixed point on the card (see refresh_events).
_REFRESH_ROUNDS = 8


def _recount(busy, k, cfg: DDR3Timing) -> torch.Tensor:
    """``floor((busy + k·tRFC) / tREFI)`` in float32, as int32."""
    return torch.floor((busy + k.to(torch.float32) * cfg.tRFC)
                       / cfg.tREFI).to(torch.int32)


def _refresh_events_sync_free(busy, cfg: DDR3Timing) -> torch.Tensor:
    """The card's ``refresh_events``: no host sync (the step can be
    captured in a CUDA graph). The count starts at ``floor(busy / (tREFI -
    tRFC) · (1 - 2^-20)) - 3``, below which every n has ``f(n) > n`` in
    float32 (the four rounded operations move ``f`` by less than 2^-22 of
    it), so from there it climbs to the same least fixed point as from
    ``floor(busy / tREFI)``; ``_REFRESH_ROUNDS`` re-counts reach it for any
    count below 2^24 (about 130 s of DDR3 time), and a device-side assert
    fails the run if an element still grows. The start lies below the
    least fixed point only while ``tREFI / (tREFI - tRFC)`` stays under
    4 (every fixed point lies within that many counts of ``busy / (tREFI -
    tRFC)``); a timing with ``tRFC`` above ``tREFI / 2`` is refused, where
    a larger fixed point could pass the assert unseen."""
    if not 0.0 <= cfg.tRFC <= cfg.tREFI / 2:
        raise ValueError(
            f"refresh_events on the card needs 0 <= tRFC <= tREFI / 2, got "
            f"tRFC {cfg.tRFC} and tREFI {cfg.tREFI}")
    n = torch.floor(busy / cfg.tREFI).to(torch.int32)
    lo = torch.floor(busy.to(torch.float64) / (cfg.tREFI - cfg.tRFC)
                     * (1.0 - 2.0 ** -20)) - 3.0
    n = torch.maximum(n, lo.clamp(0.0, 2.0 ** 31 - 1).to(torch.int32))
    for _ in range(_REFRESH_ROUNDS):
        n = _recount(busy, n, cfg)
    torch._assert_async(torch.all(_recount(busy, n, cfg) <= n),
                        "refresh_events: the count still grows")
    return n


def refresh_events(busy, cfg: DDR3Timing = DEFAULT_TIMING) -> torch.Tensor:
    """Refresh events owed for ``busy`` ns of stall-free work: the least
    fixed point of ``n = floor((busy + n·tRFC) / tREFI)``, element-wise.

    On the CPU the reference's ``lax.while_loop`` becomes a plain loop that
    re-counts until no element grows (one host sync per round); on the card
    ``_refresh_events_sync_free`` reaches the same fixed point without
    waiting on the host."""
    busy = torch.as_tensor(busy, dtype=torch.float32)
    if busy.device.type == "cuda":
        return _refresh_events_sync_free(busy, cfg)
    n = torch.floor(busy / cfg.tREFI).to(torch.int32)
    while True:
        nxt = _recount(busy, n, cfg)
        if not bool((nxt > n).any()):
            return n
        n = nxt


def refresh_events_scalar(busy_ns: float,
                          cfg: DDR3Timing = DEFAULT_TIMING) -> int:
    """Python-scalar counterpart of :func:`refresh_events` for the
    closed-form float64 planners: same least fixed point."""
    n = int(busy_ns // cfg.tREFI)
    while int((busy_ns + n * cfg.tRFC) // cfg.tREFI) > n:
        n = int((busy_ns + n * cfg.tRFC) // cfg.tREFI)
    return n


def apply_refresh(meter: CostMeter,
                  cfg: DDR3Timing = DEFAULT_TIMING) -> CostMeter:
    """Fold in periodic refresh for the elapsed busy time — incrementally:
    only the events not yet charged (``n_refresh``) are added, each with a
    tRFC stall and ``e_ref`` energy. Same float32 ops in the same order as
    the reference."""
    prior = meter.n_refresh.to(torch.float32)
    busy = meter.time_ns - prior * cfg.tRFC
    n = refresh_events(busy, cfg)
    new = torch.clamp_min(n - meter.n_refresh, 0)
    new_f = new.to(torch.float32)
    return CostMeter(
        time_ns=meter.time_ns + new_f * cfg.tRFC,
        e_act=meter.e_act, e_pre=meter.e_pre,
        e_refresh=meter.e_refresh + new_f * cfg.e_ref,
        e_burst=meter.e_burst,
        e_background=meter.e_background
        + new_f * cfg.tRFC * float(_f32(cfg.p_background)),
        n_act=meter.n_act, n_pre=meter.n_pre, n_aap=meter.n_aap,
        n_shift=meter.n_shift, n_tra=meter.n_tra,
        n_refresh=meter.n_refresh + new,
    )


def burst_time_ns(num_bytes: int, cfg: DDR3Timing = DEFAULT_TIMING) -> float:
    """Modelled wall time of one off-chip HOSTW/HOSTR transfer: an ACT+PRE
    row access plus the data beats (64B burst = 8 beats at 0.75 ns/beat)."""
    transfers = -(-num_bytes // 64)
    return cfg.tRC + transfers * 6.0


def charge_burst(meter: CostMeter, num_bytes: int,
                 cfg: DDR3Timing = DEFAULT_TIMING) -> CostMeter:
    """Off-chip data transfer: one ACT+PRE plus burst energy+time."""
    transfers = -(-num_bytes // 64)
    m = _bump(meter, dt=burst_time_ns(num_bytes, cfg), e_act=cfg.e_act,
              e_pre=cfg.e_pre, n_act=1, n_pre=1, cfg=cfg)
    m.e_burst = m.e_burst + float(_f32(transfers * cfg.e_burst_per_64b))
    return m


def cpu_movement_energy_nj(num_bytes: int,
                           cfg: DDR3Timing = DEFAULT_TIMING) -> float:
    """Conventional path (paper §5.1.5): read row to CPU + write back."""
    transfers = -(-num_bytes // 64)
    return 2.0 * transfers * cfg.e_burst_per_64b
