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
import functools
import math

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


# The card's refresh count is proved for least fixed points below this
# many events (see _refresh_plan): about 63 s of DDR3 time at the default
# timing.
_REFRESH_COUNT_CAP = 2 ** 23


def _inverse(tREFI: float) -> float:
    """The float32 reciprocal of tREFI, by which the reference's compiled
    re-count multiplies where its code divides by the constant."""
    return float(np.float32(1.0) / np.float32(tREFI))


def _recount(busy64, k, cfg: DDR3Timing) -> torch.Tensor:
    """``floor((busy + k·tRFC) / tREFI)`` as the reference's XLA rounds
    it, as float32: the sum rounded once to float32 (XLA fuses the product
    and the sum into one multiply-add; float64 holds the sum exactly, as
    the span of a float32 busy time and k·tRFC, k below 2^29, stays under
    53 bits for the counts the re-count meets), the quotient as the
    float32 product by the reciprocal of tREFI (``_inverse``). ``busy64``
    is the float64 busy time, ``k`` the counts."""
    s = torch.add(busy64, k.to(torch.float64), alpha=float(_f32(cfg.tRFC)))
    return torch.floor(s.to(torch.float32) * _inverse(cfg.tREFI))


def _start(busy, cfg: DDR3Timing) -> torch.Tensor:
    """``floor(busy / tREFI)``, the loop's start, as a quotient: divided by
    a tensor, since the card takes a quotient by a host scalar as the
    product by its reciprocal (which rounds some quotients the other
    way)."""
    return torch.floor(busy / torch.full((), cfg.tREFI, dtype=torch.float32,
                                         device=busy.device))


@functools.lru_cache(maxsize=None)
def _refresh_plan(tRFC: float, tREFI: float) -> tuple[float, float, int, int]:
    """(tREFI - tRFC, the start's slope, its lowering, the re-counts) of
    the card's refresh count for a timing, in float32's tRFC = R and
    tREFI = T; ``ValueError`` where it has none.

    The proof. Let d = T - R > 0, r = T / d, m = busy / d, x(n) = (busy +
    n·R) / T = n + (m - n) / r, and f(n) = floor(q(n)) the float32
    re-count (``_recount``): three rounded operations (the reciprocal of T,
    the multiply-add, the product by the reciprocal), so ``|q / x - 1| <=
    ε``, ``ε = (1 + |fl(1/T)·T - 1|)·(1 + 2^-24)^2 - 1``.

    1. The loop starts at n0 = floor(busy / T) (``_start``: a quotient,
       as the reference's eager call takes it) and re-counts while a count
       grows. f never decreases, and f(n0) >= n0 for tRFC >= 2^-20·tREFI,
       so the loop climbs to n*, the least fixed point >= n0, and f(n) >=
       n + 1 for n0 <= n < n* (at tRFC = 0 every re-count is f(n0), which
       the loop, the reference and the card return). From any s with n0
       <= s <= n* the re-counts climb to n* and never past it (f(s) <=
       f(n*) = n*), at least one count a round.
    2. The start lies below n*. q(n*) < n* + 1 with q >= x·(1 - ε) gives
       n* > m·(1 - ε'r) - r·(1 + ε'), ε' = ε / (1 - ε), as for every
       fixed point; so ``lo = floor(m·(1 - σ·r)) - ceil(r) - 1`` < n* for
       σ = ε' + 2^-40 (the 2^-40 covers the float64 rounding of m), and s
       = max(n0, lo) <= n*.
    3. The re-counts. q(n*) >= n* gives n* <= m·(1 + ε) / (1 - ε(r - 1)),
       so n* - s <= e0 = floor(M·((1 + ε) / (1 - ε(r - 1)) - 1 + σ·r)) +
       ceil(r) + 2 for n* < M = ``_REFRESH_COUNT_CAP``. A round from n <
       n* at gap e = n* - n leaves e' < (R / T)·e + 1 + 2ε·n*, as f(n) >
       x(n)·(1 - ε) - 1 and x(n) = x(n*) - e·R / T >= n* / (1 + ε) - e·R /
       T; and e' <= e - 1 (1.). The rounds are the steps of that recursion
       from e0 to 0: 4 for the default timing, 11, 18 and 74 at tRFC =
       0.6, 0.78 and 0.95·tREFI (tREFI 7,800 ns).

    A timing with tRFC >= tREFI has no fixed point (the reference's loop
    never ends); one within about 2^-21·tREFI of it breaks the bound of
    3.; both are refused."""
    R, T = float(_f32(tRFC)), float(_f32(tREFI))
    if not 0.0 <= R < T:
        raise ValueError(
            f"refresh_events on the card needs 0 <= tRFC < tREFI, got tRFC "
            f"{tRFC} and tREFI {tREFI}")
    d = T - R
    r = T / d
    eps = (1 + abs(_inverse(tREFI) * T - 1)) * (1 + 2.0 ** -24) ** 2 - 1
    if eps * (r - 1) >= 0.5:
        raise ValueError(
            f"refresh_events on the card needs tREFI - tRFC above "
            f"{2 * eps:.3g} of tREFI, got tRFC {tRFC} and tREFI {tREFI}")
    sigma = eps / (1 - eps) + 2.0 ** -40
    top = (1 + eps) / (1 - eps * (r - 1))
    gap = (math.floor(_REFRESH_COUNT_CAP * (top - 1 + sigma * r))
           + math.ceil(r) + 2)
    climb = 1 + 2 * eps * _REFRESH_COUNT_CAP * top
    rounds = 0
    while gap > 0:
        gap = min(gap - 1, math.ceil(R / T * gap + climb) - 1)
        rounds += 1
    return d, 1.0 - sigma * r, math.ceil(r) + 1, rounds


def _refresh_events_sync_free(busy, cfg: DDR3Timing) -> torch.Tensor:
    """The card's ``refresh_events``: no host sync (the step can be
    captured in a CUDA graph). The count starts at ``max(floor(busy /
    tREFI), floor(busy / (tREFI - tRFC)·(1 - σ·r)) - ceil(r) - 1)``, r =
    tREFI / (tREFI - tRFC) and σ about 2^-22, at or below the least fixed
    point, and re-counts as the CPU's loop does, a number of rounds taken
    from the timing that reaches the fixed point for any count below
    ``_REFRESH_COUNT_CAP`` (``_refresh_plan`` holds the proof); a
    device-side assert fails the run if an element still grows. The count
    is carried in float32, which holds each integer it takes exactly."""
    d, slope, lowering, rounds = _refresh_plan(cfg.tRFC, cfg.tREFI)
    busy64 = busy.to(torch.float64)
    n = _start(busy, cfg)
    lo = torch.floor(busy64 / d * slope) - lowering
    n = torch.maximum(n, lo.clamp(0.0, 2.0 ** 31 - 1).to(torch.float32))
    for _ in range(rounds):
        n = _recount(busy64, n, cfg)
    torch._assert_async(torch.all(_recount(busy64, n, cfg) <= n),
                        "refresh_events: the count still grows")
    return n.to(torch.int32)


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
    busy64 = busy.to(torch.float64)
    prev, n = None, _start(busy, cfg)
    while prev is None or bool((n > prev).any()):
        prev, n = n, _recount(busy64, n, cfg)
    return n.to(torch.int32)


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
