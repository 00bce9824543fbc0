"""Workload scheduler for device-level (multi-bank, multi-subarray) PIM
execution.

Port of ``repro.core.pim.schedule``. Takes *heterogeneous* per-slot
:class:`~.ir.PimProgram`s (slot = one ``(bank, subarray)`` pair) and
executes them against a :class:`~.device.DeviceState`: slots whose command
streams are identical (same ops, shape and payload count — payload *data*
may differ) form one group, and each group runs as ONE compiled runner
over the group's slots — the reference ``vmap``s it, the port passes the
group as a slot batch, so each kernel of the group's program is one launch
for all its slots. When a group holds every slot it runs on the device
state directly; otherwise its slots are gathered with ``index_select`` and
scattered back with ``index_copy_``.

In-DRAM row movement (``COPY``, LISA-style): a slot's stream may carry
``COPY`` ops whose destination is *another* slot. The scheduler strips
those ops out of the compiled streams and drains them **after the step's
in-bank compute**: a cross-slot COPY reads its source row's *post-compute*
value, copies apply in (slot, stream-position) order, and the moved rows are
visible to the *next* ``schedule`` step. Each copy charges
``timing.copy_cost`` onto the **source** slot's meter. The drain is
link-contended: every inter-subarray RBM link and every channel's internal
bus is a FCFS resource.

Device accounting (DDR3 model outputs, not times of the machine running the
simulation): per-slot meters accumulate each slot's own busy time; the
schedule-level wall clock is channel-aware:

    wall = max_ch chan_busy_ch + max_k (Δt_k − bus_k) + copy drain makespan
    energy = Σ_k Δenergy_k

``async_host=True`` lets each channel's HOST traffic overlap the *previous*
step's compute+copy window (``DeviceState.host_credit_ns``).

One ``schedule`` call clones the device's rows once (256 MiB at the paper's
full geometry), runs every group on that copy in place, and leaves the
caller's state untouched. Float results are float32 in the reference's
order; sums over slots are taken left to right.

``schedule_pipeline`` runs K steps of one recurring layout and
``schedule_workload`` a sequence of such phases, back to back or in a given
interleaved order. The reference runs them under one ``lax.scan``; the port
runs the same cached step function once per step, the async host credit
chained from step to step exactly as K calls of ``schedule()`` chain it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np
import torch

from . import exec as pim_exec
from . import ir
from .compile import CompiledProgram, compile_program, sequential_sum
from .device import (DeviceConfig, DeviceState, channel_occupancy,
                     host_bus_ns, issue_bus_ns)
from .ir import PimProgram, ProgramBuilder
from .state import NUM_ROWS, CostMeter, as_rows
from .timing import DDR3Timing, DEFAULT_TIMING, copy_cost


def _unbatch_reads(group_reads, read_layout, n_steps=None):
    """ONE device->host transfer per group read tensor, then numpy slicing
    into the per-slot layout (uint32 rows, as the reference returns). With
    ``n_steps`` the tensors carry a leading step axis and a per-step list
    is returned."""
    n_slots, group_slots = read_layout
    host = [tuple(r.cpu().numpy().view(np.uint32) for r in g)
            for g in group_reads]

    def one_step(pick):
        out: list = [()] * n_slots
        for g, slots in enumerate(group_slots):
            for j, k in enumerate(slots):
                out[k] = tuple(pick(r, j) for r in host[g])
        return tuple(out)

    if n_steps is None:
        return one_step(lambda r, j: r[j])
    return [one_step(lambda r, j, k=k: r[k, j]) for k in range(n_steps)]


@dataclasses.dataclass
class ScheduleResult:
    """Outcome of one device-level schedule step. ``wall_ns`` and
    ``energy_nj`` are 0-d float32 tensors on the device (DDR3 model
    outputs); reading the underscored fields through their properties
    converts them."""

    state: DeviceState
    wall_ns: torch.Tensor       # max-channel bus + max in-slot exec + copies
    bus_ns: float               # total bus occupancy, summed over slots
    energy_nj: torch.Tensor     # summed across slots (this step only)
    copy_ns: float = 0.0        # COPY drain *makespan* (link-contended wall)
    host_bytes: int = 0         # off-chip bytes this step's streams moved
    rank_switch_ns: float = 0.0  # total tRTRS penalty charged this step
    copy_total_ns: float = 0.0  # Σ per-copy duration
    copy_queue_ns: float = 0.0  # Σ FCFS waiting behind busy links/buses
    link_busy_ns: dict = dataclasses.field(default_factory=dict)
    _host_bus_ns: float = 0.0   # HOSTW/HOSTR burst occupancy, Σ over slots
    _channel_bus_ns: object = ()  # per-channel occupancy (may be a tensor)
    _host_overlap_ns: object = 0.0  # host time hidden under prev step
    _group_reads: tuple = ()    # per group: per-read (n_group, words) rows
    _read_layout: tuple = (0, ())  # (n_slots, group slot-id tuples)

    @property
    def reads(self) -> tuple:
        """Per slot: host-read rows (uint32 numpy) in ``read_row`` order."""
        cached = getattr(self, "_reads_cache", None)
        if cached is None:
            cached = _unbatch_reads(self._group_reads, self._read_layout)
            self._reads_cache = cached
        return cached

    @property
    def host_bus_ns(self) -> float:
        return float(self._host_bus_ns)

    @property
    def host_overlap_ns_lazy(self):
        """The raw hidden-host-time value (a 0-d tensor on the device in
        async mode), for accumulators that must not sync
        (``host_overlap_ns`` converts)."""
        return self._host_overlap_ns

    @property
    def channel_bus_ns(self) -> tuple:
        """Per-channel serialized occupancy (+tRTRS), as floats."""
        return tuple(float(x) for x in self._channel_bus_ns)

    @property
    def host_overlap_ns(self) -> float:
        return float(self._host_overlap_ns)


def stream_key(p: PimProgram):
    """Slots with equal keys share one compiled runner: identical command
    stream and shape; HOSTW payload *data* is excluded (it is passed
    per-slot at run time)."""
    return (p.digest, p.num_rows, p.words, len(p.payloads))


# Host-orchestration counters, reset-able by tests:
#   dispatches     — schedule()/schedule_pipeline()/schedule_workload()
#                    calls (one each, however many steps they run)
#   plan_misses    — step-plan cache misses (a new schedule layout)
#   compile_misses — _compiled_for cache misses (a new program stream)
SCHED_STATS = {"dispatches": 0, "plan_misses": 0, "compile_misses": 0}


# One compiled artifact per distinct (stream, timing): groups recur across
# schedule() calls (e.g. PimVM flushes), so keep the compiled runners warm.
# LRU-bounded — long sessions stream many one-off programs through here,
# and insertion-order (FIFO) eviction would let them push out hot
# recurring streams.
_compile_cache: dict = {}
_COMPILE_CACHE_MAX = 512


def _compiled_for(program: PimProgram, timing: DDR3Timing) -> CompiledProgram:
    key = (stream_key(program), timing)
    hit = _compile_cache.pop(key, None)
    if hit is None:
        SCHED_STATS["compile_misses"] += 1
        if len(_compile_cache) >= _COMPILE_CACHE_MAX:
            _compile_cache.pop(next(iter(_compile_cache)))
        hit = compile_program(program, timing)
    _compile_cache[key] = hit           # (re)insert at the MRU end
    return hit


def compiled_for(program: PimProgram,
                 timing: DDR3Timing = DEFAULT_TIMING) -> CompiledProgram:
    """Public entry to the scheduler's LRU compile cache: equal streams
    (by columnar digest) share one :class:`CompiledProgram` — and thereby
    one set of runners — across calls. Use this instead of
    ``compile_program`` for recurring streams (``PimVM`` does)."""
    return _compiled_for(program, timing)


# Stacked payload batches keyed on the *identity* of the payload arrays
# and the device: recurring flushes schedule the same PimProgram objects
# over and over, so their stacked rows are uploaded once. Cache values hold
# references to the source arrays, pinning their ids for the lifetime of
# the entry. Bounded by entry count AND by pinned bytes.
_payload_cache: dict = {}
_PAYLOAD_CACHE_MAX = 256
_PAYLOAD_CACHE_MAX_BYTES = 256 << 20        # pinned stacked-array budget
_payload_cache_bytes = 0


def _entry_nbytes(hit) -> int:
    """Bytes one cache entry pins: the stacked tensor plus the host source
    arrays it keeps alive for id stability."""
    stacked, refs = hit
    n = stacked.numel() * stacked.element_size()
    for group in refs:
        n += sum(int(a.nbytes) for a in group)
    return n


def _payload_cache_get(key):
    """LRU hit: pop + reinsert at the MRU end (byte total unchanged)."""
    hit = _payload_cache.pop(key, None)
    if hit is not None:
        _payload_cache[key] = hit
    return hit


def _payload_cache_put(key, hit) -> None:
    """Insert at the MRU end, then evict LRU entries until both the entry
    count and the pinned-byte budget hold (never the newest entry)."""
    global _payload_cache_bytes
    _payload_cache[key] = hit
    _payload_cache_bytes += _entry_nbytes(hit)
    while (len(_payload_cache) > _PAYLOAD_CACHE_MAX
           or _payload_cache_bytes > _PAYLOAD_CACHE_MAX_BYTES):
        if len(_payload_cache) <= 1:
            break
        old = _payload_cache.pop(next(iter(_payload_cache)))
        _payload_cache_bytes -= _entry_nbytes(old)


def _payload_cache_clear() -> None:
    """Drop every pinned payload batch (test hygiene)."""
    global _payload_cache_bytes
    _payload_cache.clear()
    _payload_cache_bytes = 0


def _payload_stack(programs: Sequence[PimProgram], words: int,
                   device: torch.device) -> torch.Tensor:
    """(n_slots_in_group, n_payloads, words) int32 HOSTW payload batch."""
    n_pay = len(programs[0].payloads)
    if n_pay == 0:
        key = ("zeros", len(programs), words, str(device))
    else:
        # shape prefix disambiguates the partitioning: the same id sequence
        # could otherwise alias e.g. 2 programs x 2 payloads vs 4 x 1
        key = (str(device), len(programs), n_pay, words) + tuple(
            id(a) for p in programs for a in p.payloads)
    hit = _payload_cache_get(key)
    if hit is None:
        if n_pay == 0:
            stacked = torch.zeros((len(programs), 0, words),
                                  dtype=torch.int32, device=device)
            refs = ()
        else:
            stacked = as_rows(np.stack([np.stack(p.payloads)
                                        for p in programs]), device)
            refs = tuple(p.payloads for p in programs)
        _payload_cache_put(key, (stacked, refs))
        return stacked
    return hit[0]


def _normalize_programs(cfg: DeviceConfig, programs) -> list:
    """Accept per-bank (len ``n_banks``, entries optionally nested per
    subarray) or flat per-slot (len ``n_slots``) program sequences and
    return a flat per-slot list (``None`` = idle)."""
    programs = list(programs)
    flat: list = [None] * cfg.n_slots
    S = cfg.subarrays

    def put(slot, p):
        flat[slot] = p

    if len(programs) == cfg.n_slots and not any(
            isinstance(p, (list, tuple)) for p in programs):
        for k, p in enumerate(programs):
            put(k, p)
        return flat
    if len(programs) != cfg.n_banks:
        raise ValueError(
            f"got {len(programs)} programs for {cfg.n_banks} banks "
            f"({cfg.n_slots} slots)")
    for b, entry in enumerate(programs):
        if isinstance(entry, (list, tuple)):
            if len(entry) != S:
                raise ValueError(
                    f"bank {b}: {len(entry)} subarray programs for "
                    f"{S} subarrays")
            for s, p in enumerate(entry):
                put(b * S + s, p)
        else:
            put(b * S, entry)       # bare program → the bank's subarray 0
    return flat


def _split_copies(cfg: DeviceConfig, slot: int, program: PimProgram):
    """Partition one slot's stream into (compiled-stream program, deferred
    cross-slot copies). Same-slot COPYs are normalized to the executor's
    local ``COPY_SELF`` encoding and stay in-stream.

    The no-copy common case is detected vectorized on the columnar
    encoding (no per-op Python walk); only streams that actually carry
    cross-slot or explicitly-self-addressed COPYs take the op loop."""
    cols = program.columns
    is_copy = cols.code == ir.OP_CODE[ir.OP_COPY]
    b, s = cfg.slot_coords(slot)
    if not is_copy.any():
        return program, []              # no COPYs at all: nothing to strip
    self_like = (cols.delta == ir.COPY_SELF) & (cols.c == ir.COPY_SELF)
    if not (is_copy & ~self_like).any():
        return program, []              # every COPY already local-encoded
    self_dst = (ir.COPY_SELF, ir.COPY_SELF)
    kept, deferred = [], []
    changed = False
    for op in program.ops:
        # On the device, local means self-addressed or "destination IS the
        # carrying slot" — explicit (0, 0) on any other carrier is a real
        # transfer to bank 0, so ir.copy_is_local only applies at (0, 0).
        is_local = (op.op == ir.OP_COPY
                    and ((op.delta, op.c) == self_dst
                         or (op.delta, op.c) == (b, s)))
        if op.op != ir.OP_COPY or is_local:
            if is_local and (op.delta, op.c) != self_dst:
                op = dataclasses.replace(op, delta=ir.COPY_SELF,
                                         c=ir.COPY_SELF)
                changed = True
            kept.append(op)
            continue
        dst_slot = cfg.slot_index(op.delta, op.c)   # validates coordinates
        if not (0 <= op.a < cfg.num_rows and 0 <= op.b < cfg.num_rows):
            raise ValueError(
                f"slot {(b, s)}: COPY rows {(op.a, op.b)} out of range "
                f"[0, {cfg.num_rows})")
        deferred.append((slot, dst_slot, op))
        changed = True
    if not changed:
        return program, deferred
    return PimProgram(ops=tuple(kept), num_rows=program.num_rows,
                      words=program.words,
                      payloads=program.payloads), deferred


@dataclasses.dataclass
class CopyDrainStats:
    """Link-contention accounting of one step's COPY drain phase."""

    makespan_ns: float = 0.0    # FCFS queue-model wall of the drain
    total_ns: float = 0.0       # Σ per-copy duration (contention-free sum)
    queue_ns: float = 0.0       # Σ time copies waited behind busy resources
    link_busy_ns: dict = dataclasses.field(default_factory=dict)


def _copy_route(cfg: DeviceConfig, src_slot: int, dst_slot: int):
    """(hops, inter_bank, resources) of one cross-slot copy.

    Intra-bank: RBM hops between the two subarrays, crossing links
    ``(bank, i)`` for i in [min, max). Inter-bank: the row rides RBM links
    from the source subarray to the bank edge (subarray 0, where the
    chip's internal bus taps the bank), crosses the channel's shared
    internal bus, and rides links from the destination's edge inward —
    so an S-1 → S-1 move costs 2(S-1) hops on top of ``t_copy_bank``.
    """
    S = cfg.subarrays
    sb, ss = divmod(src_slot, S)
    db, ds = divmod(dst_slot, S)
    if sb == db:
        hops = abs(ds - ss)
        res = [("link", sb, i) for i in range(min(ss, ds), max(ss, ds))]
        return hops, False, res
    hops = ss + ds
    res = [("link", sb, i) for i in range(ss)]
    res += [("link", db, i) for i in range(ds)]
    s_ch = cfg.bank_coords(sb)[0]
    d_ch = cfg.bank_coords(db)[0]
    res.append(("ibus", s_ch))
    if d_ch != s_ch:
        res.append(("ibus", d_ch))
    return hops, True, res


@dataclasses.dataclass(frozen=True)
class _CopyDrainPlan:
    """Route-table + FCFS outcome of one copy *pattern* (the (src, dst)
    slot pairs, in drain order). Rows are not part of the pattern — the
    same gather shape recurs step after step with different rows, and
    everything here depends only on the slots, so it is computed once and
    cached."""

    dt_slot: np.ndarray         # (n_slots,) float32 Σ copy time per source
    e_act_slot: np.ndarray      # (n_slots,) float32
    e_pre_slot: np.ndarray      # (n_slots,) float32
    n_act_slot: np.ndarray      # (n_slots,) int32
    n_pre_slot: np.ndarray      # (n_slots,) int32
    n_aap_slot: np.ndarray      # (n_slots,) int32
    stats: CopyDrainStats


@functools.lru_cache(maxsize=256)
def _copy_drain_plan(cfg: DeviceConfig, pairs: tuple) -> _CopyDrainPlan:
    """Per-copy route tables and ``timing.copy_cost`` charges (computed
    once per pair in the FCFS walk), per-source meter increments (one
    ``np.add.at`` scatter per field), and the FCFS link/bus serialization
    — all keyed on (device, copy pattern) so recurring steps skip the
    whole computation."""
    t = cfg.timing
    n = cfg.n_slots
    src = np.fromiter((p[0] for p in pairs), np.int64, len(pairs))
    dt = np.zeros(len(pairs))
    e_act = np.zeros(len(pairs))
    stats = CopyDrainStats()
    ready: dict = {}                    # resource -> busy-until (drain clock)
    for i, (src_slot, dst_slot) in enumerate(pairs):
        hops, inter_bank, resources = _copy_route(cfg, src_slot, dst_slot)
        c_dt, c_ea, _, _, _, _ = copy_cost(hops, inter_bank, t)
        dt[i] = c_dt
        e_act[i] = c_ea
        start = max((ready.get(r, 0.0) for r in resources), default=0.0)
        end = start + c_dt
        for r in resources:
            ready[r] = end
            stats.link_busy_ns[r] = stats.link_busy_ns.get(r, 0.0) + c_dt
        stats.queue_ns += start
        stats.total_ns += c_dt
        stats.makespan_ns = max(stats.makespan_ns, end)
    dt_slot = np.zeros(n, np.float32)
    e_act_slot = np.zeros(n, np.float32)
    e_pre_slot = np.zeros(n, np.float32)
    n_act_slot = np.zeros(n, np.int32)
    n_pre_slot = np.zeros(n, np.int32)
    n_aap_slot = np.zeros(n, np.int32)
    np.add.at(dt_slot, src, dt.astype(np.float32))
    np.add.at(e_act_slot, src, e_act.astype(np.float32))
    np.add.at(e_pre_slot, src, np.float32(t.e_pre))
    np.add.at(n_act_slot, src, np.int32(2))
    np.add.at(n_pre_slot, src, np.int32(1))
    np.add.at(n_aap_slot, src, np.int32(1))
    return _CopyDrainPlan(dt_slot=dt_slot, e_act_slot=e_act_slot,
                          e_pre_slot=e_pre_slot, n_act_slot=n_act_slot,
                          n_pre_slot=n_pre_slot, n_aap_slot=n_aap_slot,
                          stats=stats)


@dataclasses.dataclass
class _StepPlan:
    """One schedule layout, fully lowered: the step function plus every
    static quantity of the step. Cached per (device config, flags, group
    signature, copy signature) so a recurring step pays one dict lookup."""

    fn: object                  # (banks, credit, payloads) -> ...
    group_slots: tuple          # tuple of slot-id tuples, plan group order
    bus_total: float            # Σ per-slot bus occupancy
    host_bus_total: float       # Σ per-slot host-burst occupancy
    chan_busy: tuple            # per-channel occupancy at credit=0 (+tRTRS)
    switch_ns: float
    host_bytes: int
    copy: "_CopyDrainPlan | None"
    # Static diagnostics of this layout (lint._plan_diagnostics), computed
    # ONCE at plan build: the verify=True gates of schedule()/
    # schedule_pipeline()/schedule_workload() scan this cached tuple, so a
    # verified warm step does no extra work.
    lint: tuple = ()


_plan_cache: dict = {}
_PLAN_CACHE_MAX = 256


def _plan_key(cfg: DeviceConfig, groups, deferred, *,
              use_kernels, interpret, refresh, async_host):
    """The step-plan cache key: everything about one schedule layout that
    shapes the step (streams via digests, grouping, copy pattern, flags)."""
    return (cfg, use_kernels, interpret, refresh, async_host,
            tuple((key, tuple(slots)) for key, slots in groups.items()),
            tuple((s, d, op.a, op.b) for s, d, op in deferred))


def _make_step_fn(cfg: DeviceConfig, runners, group_slots, bus_j,
                  chan_busy0, host_ch, copy_plan, copy_moves,
                  copy_independent, async_host):
    """Build the step: every stream group's batched run, the COPY drain
    (row scatter + meter bump), and the channel-bus fold. Float32 tensor
    ops in the reference's order, one op at a time."""
    n_slots = cfg.n_slots
    p_bg = float(np.float32(cfg.timing.p_background))
    makespan = float(np.float32(copy_plan.stats.makespan_ns
                                if copy_plan else 0.0))
    per_device: dict = {}

    def consts(dev):
        hit = per_device.get(dev)
        if hit is None:
            t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(dev)
            hit = {
                "bus_j": t(bus_j, np.float32),
                "busy0": t(chan_busy0, np.float32),
                "host_ch": t(host_ch, np.float32),
                "idx": [t(slots, np.int64) for slots in group_slots],
            }
            if copy_plan is not None:
                for name in ("dt_slot", "e_act_slot", "e_pre_slot"):
                    hit[name] = t(getattr(copy_plan, name), np.float32)
                for name in ("n_act_slot", "n_pre_slot", "n_aap_slot"):
                    hit[name] = t(getattr(copy_plan, name), np.int32)
                hit["moves"] = tuple(t(m, np.int64) for m in copy_moves)
            per_device[dev] = hit
        return hit

    def step(banks, credit, payloads):
        c = consts(banks.bits.device)
        t0 = banks.meter.time_ns
        e0 = banks.meter.total_energy_nj
        bits = banks.bits.clone()
        mt, mb, dcc = banks.mig_top, banks.mig_bot, banks.dcc
        f, i = banks.meter.stacked()
        reads = []
        for g, runner in enumerate(runners):
            meter = CostMeter.from_stacked(f, i)
            if group_slots[g] == tuple(range(n_slots)):
                # the group covers every slot: no gather/scatter round-trip
                out, group_reads = runner.raw(bits, mt, mb, dcc, meter,
                                              payloads[g])
                mt, mb, dcc = out.mig_top, out.mig_bot, out.dcc
                f, i = out.meter.stacked()
            else:
                idx = c["idx"][g]
                pick = lambda x: x.index_select(0, idx)
                sub_bits = pick(bits)
                out, group_reads = runner.raw(
                    sub_bits, pick(mt), pick(mb), pick(dcc),
                    meter.map(pick), payloads[g])
                bits.index_copy_(0, idx, out.bits)
                mt = mt.index_copy(0, idx, out.mig_top)
                mb = mb.index_copy(0, idx, out.mig_bot)
                dcc = dcc.index_copy(0, idx, out.dcc)
                fo, io = out.meter.stacked()
                f, i = f.index_copy(0, idx, fo), i.index_copy(0, idx, io)
            reads.append(group_reads)   # batched: per-slot view sliced lazily
        meter = CostMeter.from_stacked(f, i)
        # In-slot execution excludes each slot's own bus occupancy and the
        # drained copies (accounted by the contention model below).
        exec_ns = meter.time_ns - t0 - c["bus_j"]
        if copy_plan is not None:
            si, sr, di, dr = c["moves"]
            if copy_independent:
                # distinct destinations, none feeding a later copy: one
                # batched gather + scatter
                bits[di, dr] = bits[si, sr]
            else:
                for s_slot, s_row, d_slot, d_row in zip(*copy_moves):
                    bits[d_slot, d_row] = bits[s_slot, s_row]
            dt = c["dt_slot"]
            meter = dataclasses.replace(
                meter,
                time_ns=meter.time_ns + dt,
                e_act=meter.e_act + c["e_act_slot"],
                e_pre=meter.e_pre + c["e_pre_slot"],
                e_background=meter.e_background + dt * p_bg,
                n_act=meter.n_act + c["n_act_slot"],
                n_pre=meter.n_pre + c["n_pre_slot"],
                n_aap=meter.n_aap + c["n_aap_slot"])
        new_banks = dataclasses.replace(banks, bits=bits, mig_top=mt,
                                        mig_bot=mb, dcc=dcc, meter=meter)
        e1 = meter.total_energy_nj
        compute_ns = torch.max(exec_ns) + makespan
        if async_host:
            hidden = torch.minimum(c["host_ch"], torch.clamp_min(credit, 0.0))
        else:
            hidden = torch.zeros_like(c["host_ch"])
        busy = c["busy0"] - hidden
        wall = torch.max(busy) + compute_ns
        energy = sequential_sum(e1 - e0)
        # The outgoing double-buffer credit: only an ASYNC step prefetches
        # the next step's transfers under its compute window; a sync step
        # resets it to zero.
        credit_out = (compute_ns if async_host
                      else torch.zeros((), dtype=torch.float32,
                                       device=bits.device))
        return (new_banks, tuple(reads), wall, energy, credit_out, busy,
                sequential_sum(hidden))

    return step


def _plan_for(cfg: DeviceConfig, stripped, groups, deferred, *,
              use_kernels, interpret, refresh, async_host) -> _StepPlan:
    """Resolve (and cache) the step plan of one schedule layout."""
    plan_key = _plan_key(cfg, groups, deferred, use_kernels=use_kernels,
                         interpret=interpret, refresh=refresh,
                         async_host=async_host)
    plan = _plan_cache.pop(plan_key, None)
    if plan is not None:
        _plan_cache[plan_key] = plan    # (re)insert at the MRU end
        return plan
    SCHED_STATS["plan_misses"] += 1

    runners, group_slots = [], []
    issue_bus = np.zeros(cfg.n_slots, np.float32)
    host_bus = np.zeros(cfg.n_slots, np.float32)
    for key, slot_ids in groups.items():
        rep = stripped[slot_ids[0]]
        compiled = _compiled_for(rep, cfg.timing)
        runners.append(pim_exec.make_runner(
            compiled, cfg.timing, use_kernels=use_kernels,
            interpret=interpret, refresh=refresh, payload_arg=True))
        group_slots.append(tuple(slot_ids))
        g_issue = issue_bus_ns(rep, cfg.timing)
        g_host = host_bus_ns(rep, cfg.timing)
        for k in slot_ids:
            issue_bus[k] = g_issue
            host_bus[k] = g_host

    issue_ch, host_ch, switch_ch = channel_occupancy(cfg, issue_bus,
                                                     host_bus)
    chan_busy0 = issue_ch + host_ch + switch_ch
    switch_ns = float(switch_ch.sum())

    copy_plan = None
    copy_moves = None
    copy_independent = False
    if deferred:
        copy_plan = _copy_drain_plan(
            cfg, tuple((s, d) for s, d, _ in deferred))
        srcs = [(k, op.a) for k, _, op in deferred]
        dsts = [(d, op.b) for _, d, op in deferred]
        copy_independent = (len(set(dsts)) == len(dsts)
                            and not set(dsts) & set(srcs))
        copy_moves = (tuple(x[0] for x in srcs), tuple(x[1] for x in srcs),
                      tuple(x[0] for x in dsts), tuple(x[1] for x in dsts))

    host_bytes = sum(
        len(slots) * stripped[slots[0]].host_bytes
        for slots in group_slots)

    fn = _make_step_fn(cfg, tuple(runners), tuple(group_slots),
                       issue_bus + host_bus, chan_busy0, host_ch,
                       copy_plan, copy_moves, copy_independent, async_host)
    from . import lint as pim_lint      # lazy: lint imports this module
    plan_lint = pim_lint._plan_diagnostics(cfg, stripped, groups, deferred,
                                           async_host)
    plan = _StepPlan(
        fn=fn,
        group_slots=tuple(group_slots),
        bus_total=float((issue_bus + host_bus).sum(dtype=np.float64)),
        host_bus_total=float(host_bus.sum(dtype=np.float64)),
        chan_busy=tuple(float(x) for x in chan_busy0),
        switch_ns=switch_ns,
        host_bytes=host_bytes,
        copy=copy_plan,
        lint=plan_lint)
    if len(_plan_cache) >= _PLAN_CACHE_MAX:
        _plan_cache.pop(next(iter(_plan_cache)))
    _plan_cache[plan_key] = plan
    return plan


def _verify_plans(plans, what: str) -> None:
    """The ``verify=True`` gate: raise LintError when any plan in ``plans``
    carries error-severity diagnostics. Scans cached tuples only — no
    analysis runs here."""
    if all(not plan.lint for plan in plans):
        return
    from . import lint as pim_lint
    diags = tuple(d for plan in plans for d in plan.lint)
    if any(d.severity == pim_lint.ERROR for d in diags):
        raise pim_lint.LintError(pim_lint.LintReport(diags), what)


def _lower_step(cfg: DeviceConfig, programs):
    """Shared front half of schedule()/schedule_pipeline(): normalize the
    layout, strip cross-slot copies, group by stream digest. Returns
    ``(flat, stripped, groups, deferred)``."""
    flat = _normalize_programs(cfg, programs)
    for k, p in enumerate(flat):
        if p is not None and (p.num_rows, p.words) != (cfg.num_rows,
                                                       cfg.words):
            raise ValueError(
                f"slot {cfg.slot_coords(k)}: program shape "
                f"{(p.num_rows, p.words)} != device "
                f"shape {(cfg.num_rows, cfg.words)}")

    deferred: list = []
    stripped: list = [None] * cfg.n_slots
    for k, p in enumerate(flat):
        if p is None:
            continue
        stripped[k], slot_copies = _split_copies(cfg, k, p)
        deferred.extend(slot_copies)

    groups: dict = {}
    for k, p in enumerate(stripped):
        if p is not None and len(p.ops):
            groups.setdefault(stream_key(p), []).append(k)
    return flat, stripped, groups, deferred


def _lower_recurring(cfg: DeviceConfig, step_list, *, what: str, hint: str):
    """Lower a K-step RECURRING layout: step 0 fully, later steps only a
    per-slot stream-key check — identical command streams imply identical
    copy stripping and grouping, and stripping preserves HOSTW payloads,
    so the original (pre-strip) programs serve for per-step payloads.
    Returns ``(flats, stripped0, groups0, deferred0)``."""
    flat0, stripped0, groups0, deferred0 = _lower_step(cfg, step_list[0])
    flats = [flat0]
    for k, programs in enumerate(step_list[1:], 1):
        if programs is step_list[0]:
            flats.append(flat0)         # replicated layout: nothing to check
            continue
        flat_k = _normalize_programs(cfg, programs)
        for s in range(cfg.n_slots):
            a, b = flat0[s], flat_k[s]
            if ((a is None) != (b is None)
                    or (a is not None and stream_key(a) != stream_key(b))):
                raise ValueError(
                    f"{what} step {k} does not recur: slot "
                    f"{cfg.slot_coords(s)}'s command stream differs from "
                    f"step 0 — {hint}")
        flats.append(flat_k)
    return flats, stripped0, groups0, deferred0


def _step_payloads(plan: _StepPlan, programs, words: int,
                   device: torch.device) -> tuple:
    """Per group, the (n_group, n_payloads, words) HOSTW batch of one
    step's per-slot ``programs``."""
    return tuple(_payload_stack([programs[k] for k in slots], words, device)
                 for slots in plan.group_slots)


def _credit(device: DeviceState) -> torch.Tensor:
    """The device's async host credit as a 0-d float32 tensor."""
    credit = device.host_credit_ns
    if not isinstance(credit, torch.Tensor):
        credit = torch.tensor(float(credit), dtype=torch.float32,
                              device=device.device)
    return credit


def schedule(device: DeviceState,
             programs, *,
             use_kernels: bool | None = None,
             interpret: bool | None = None,
             refresh: bool = False,
             async_host: bool = False,
             verify: bool = False) -> ScheduleResult:
    """Run one program per slot (``None`` = idle slot) and fold the device
    timing model over the per-slot meters.

    ``programs`` may be per-bank (len ``n_banks``; entries are a program for
    the bank's subarray 0 or a nested per-subarray sequence) or flat
    per-slot (len ``n_slots``). Cross-slot ``COPY`` ops are stripped from
    the compiled streams and drained after the in-bank compute.

    ``refresh`` folds periodic-refresh stalls/energy into each slot's meter,
    incrementally against the meter's ``n_refresh`` history.
    ``async_host=True`` overlaps this step's HOSTW/HOSTR bursts with the
    previous step's compute+copy window (only the wall clock changes).
    ``verify=True`` raises :class:`~.lint.LintError` when the layout's
    static diagnostics (computed once per step plan) hold an error. The
    caller's ``device`` is not modified.
    """
    cfg = device.config
    _, stripped, groups, deferred = _lower_step(cfg, programs)
    plan = _plan_for(cfg, stripped, groups, deferred,
                     use_kernels=use_kernels, interpret=interpret,
                     refresh=refresh, async_host=async_host)
    if verify:
        _verify_plans((plan,), "schedule layout")
    payloads = _step_payloads(plan, stripped, cfg.words, device.device)
    new_banks, greads, wall, energy, credit_out, busy, hidden_sum = plan.fn(
        device.banks, _credit(device), payloads)
    SCHED_STATS["dispatches"] += 1
    stats = plan.copy.stats if plan.copy is not None else CopyDrainStats()
    return ScheduleResult(
        state=device.with_banks(new_banks, host_credit_ns=credit_out),
        wall_ns=wall,
        bus_ns=plan.bus_total,
        energy_nj=energy,
        _group_reads=greads,
        _read_layout=(cfg.n_slots, plan.group_slots),
        copy_ns=stats.makespan_ns,
        host_bytes=plan.host_bytes,
        rank_switch_ns=plan.switch_ns,
        copy_total_ns=stats.total_ns,
        copy_queue_ns=stats.queue_ns,
        link_busy_ns=dict(stats.link_busy_ns),
        _host_bus_ns=plan.host_bus_total,
        _channel_bus_ns=busy if async_host else plan.chan_busy,
        _host_overlap_ns=hidden_sum if async_host else 0.0)


# ---------------------------------------------------------------------------
# Multi-step pipelines and multi-phase workloads
# ---------------------------------------------------------------------------

def _sum_steps(x):
    """The reference's ``jnp.sum(jnp.asarray(x))`` of a per-step value: a
    (K,) float32 tensor summed left to right, or the plain 0.0 that a sync
    schedule records for its hidden host time."""
    if isinstance(x, torch.Tensor):
        return sequential_sum(x.reshape(-1))
    return x


class _StepLog:
    """What the steps of one layout produced, in step order."""

    def __init__(self):
        self.reads, self.walls, self.energies, self.hidden = [], [], [], []
        self.credit = None          # the credit leaving the last step

    def add(self, greads, wall, energy, hidden, credit) -> None:
        self.reads.append(greads)
        self.walls.append(wall)
        self.energies.append(energy)
        self.hidden.append(hidden)
        self.credit = credit

    def group_reads(self) -> tuple:
        """Per group, per read: a (K, n_group, words) tensor."""
        first = self.reads[0]
        return tuple(
            tuple(torch.stack([step[g][j] for step in self.reads])
                  for j in range(len(first[g])))
            for g in range(len(first)))


def _run_step(plan: _StepPlan, banks, credit, programs, words, log):
    """One step of a lowered layout on ``banks``; logs its outputs and
    returns ``(banks, credit)`` for the next step."""
    payloads = _step_payloads(plan, programs, words, banks.bits.device)
    new_banks, greads, wall, energy, credit_out, _busy, hidden = plan.fn(
        banks, credit, payloads)
    log.add(greads, wall, energy, hidden, credit_out)
    return new_banks, credit_out


def _copy_stats(plan: _StepPlan) -> dict:
    stats = plan.copy.stats if plan.copy is not None else CopyDrainStats()
    return dict(bus_ns=plan.bus_total, host_bytes=plan.host_bytes,
                copy_ns=stats.makespan_ns, copy_total_ns=stats.total_ns,
                copy_queue_ns=stats.queue_ns, rank_switch_ns=plan.switch_ns,
                link_busy_ns=dict(stats.link_busy_ns))


@dataclasses.dataclass
class _StepsResult:
    """K steps of one recurring layout, as ``PipelineResult`` and
    ``PhaseResult`` report them.

    Per-step timing tensors carry a leading step axis (float32 on the
    device); the static per-step quantities (bus occupancy, copy drain
    stats, host bytes) are identical every step — the layout recurs by
    construction."""

    wall_ns: torch.Tensor       # (K,) per-step wall clock
    energy_nj: torch.Tensor     # (K,) per-step energy
    n_steps: int
    bus_ns: float               # per-step bus occupancy (Σ slots)
    host_bytes: int             # per-step off-chip bytes
    copy_ns: float = 0.0        # per-step COPY drain makespan
    copy_total_ns: float = 0.0
    copy_queue_ns: float = 0.0
    rank_switch_ns: float = 0.0
    link_busy_ns: dict = dataclasses.field(default_factory=dict)
    _group_reads: tuple = ()    # per group: per-read (K, n_group, words)
    _read_layout: tuple = (0, ())  # (n_slots, group slot-id tuples)
    _host_overlap_ns: object = 0.0  # (K,) in async mode, else 0.0

    @property
    def reads(self) -> list:
        """Per-step reads, same nesting as ``ScheduleResult.reads``:
        ``reads[k][slot]`` is the slot's host-read rows of step ``k``."""
        cached = getattr(self, "_reads_cache", None)
        if cached is None:
            cached = _unbatch_reads(self._group_reads, self._read_layout,
                                    self.n_steps)
            self._reads_cache = cached
        return cached

    @property
    def host_overlap_ns_lazy(self):
        """Raw per-step hidden-host-time values (see
        ``ScheduleResult.host_overlap_ns_lazy``)."""
        return self._host_overlap_ns

    @property
    def total_wall_ns(self) -> float:
        return float(sequential_sum(self.wall_ns))

    @property
    def host_overlap_ns(self) -> float:
        """Total host-transfer time hidden across the steps (async)."""
        return float(_sum_steps(self._host_overlap_ns))


@dataclasses.dataclass
class PipelineResult(_StepsResult):
    """Outcome of ``schedule_pipeline``: K steps of one recurring layout,
    and the final device (credit = last step's compute)."""

    state: DeviceState = dataclasses.field(kw_only=True)


def schedule_pipeline(device: DeviceState, steps, *,
                      n_steps: int | None = None,
                      use_kernels: bool | None = None,
                      interpret: bool | None = None,
                      refresh: bool = False,
                      async_host: bool = False,
                      donate: bool = False,
                      verify: bool = False) -> PipelineResult:
    """Run K recurring schedule steps.

    ``steps`` is either a sequence of K per-step program layouts (anything
    ``schedule`` accepts — all steps must lower to the SAME layout:
    identical command streams per slot and copy pattern; HOSTW payload
    *data* may differ per step), or — with ``n_steps=K`` — a single layout
    replayed K times. Equal to calling ``schedule`` K times in a loop
    (states, reads and meters bit for bit; the async host credit chains
    identically); the layout is lowered and planned once. ``donate`` is
    accepted for signature parity and ignored (the caller's ``device`` is
    never modified); ``verify=True`` lints the layout as ``schedule`` does.
    """
    cfg = device.config
    step_list = ([steps] * int(n_steps) if n_steps is not None
                 else list(steps))
    if not step_list:
        raise ValueError("schedule_pipeline needs at least one step")
    flats, stripped0, groups0, deferred0 = _lower_recurring(
        cfg, step_list, what="pipeline",
        hint="schedule_pipeline runs ONE recurring step; use "
             "schedule_workload() for multi-phase sequences or schedule() "
             "for fully heterogeneous ones")
    plan = _plan_for(cfg, stripped0, groups0, deferred0,
                     use_kernels=use_kernels, interpret=interpret,
                     refresh=refresh, async_host=async_host)
    if verify:
        _verify_plans((plan,), "pipeline layout")
    banks, credit, log = device.banks, _credit(device), _StepLog()
    for flat in flats:
        banks, credit = _run_step(plan, banks, credit, flat, cfg.words, log)
    SCHED_STATS["dispatches"] += 1
    return PipelineResult(
        state=device.with_banks(banks, host_credit_ns=credit),
        wall_ns=torch.stack(log.walls),
        energy_nj=torch.stack(log.energies),
        n_steps=len(step_list),
        _group_reads=log.group_reads(),
        _read_layout=(cfg.n_slots, plan.group_slots),
        _host_overlap_ns=(torch.stack(log.hidden) if async_host else 0.0),
        **_copy_stats(plan))


@dataclasses.dataclass(frozen=True, eq=False)
class Phase:
    """One phase of a multi-phase workload: a RECURRING step layout (the
    ``schedule_pipeline`` contract) replayed once per entry of ``steps``.
    Payload data may differ per step; the command streams may not.

    ``async_host=None`` inherits the workload-level flag; an explicit
    ``True``/``False`` overrides it per phase."""

    steps: tuple
    async_host: bool | None = None

    @classmethod
    def repeat(cls, layout, n_steps: int, **kw) -> "Phase":
        """A phase that replays ONE layout ``n_steps`` times (payloads
        included — use explicit ``steps`` for per-step data)."""
        return cls(steps=(layout,) * int(n_steps), **kw)


def _as_phase(d) -> Phase:
    """Phase descriptors: a :class:`Phase`, a ``(layout, n_steps)`` pair,
    or a sequence of per-step layouts."""
    if isinstance(d, Phase):
        return d
    if (isinstance(d, tuple) and len(d) == 2
            and isinstance(d[1], (int, np.integer))):
        return Phase.repeat(d[0], int(d[1]))
    return Phase(steps=tuple(d))


@dataclasses.dataclass
class PhaseResult(_StepsResult):
    """One phase's slice of a :class:`WorkloadResult` — the
    :class:`PipelineResult` metrics minus the device state, plus the async
    credit observed at the phase boundary."""

    _boundary_credit_ns: object = 0.0   # credit leaving the phase's last step

    @property
    def boundary_credit_ns(self) -> float:
        """The ``host_credit_ns`` leaf as it left this phase's last step:
        the next phase's first step overlaps (at most) this much host
        traffic. Zero after a sync phase."""
        return float(self._boundary_credit_ns)


@dataclasses.dataclass
class WorkloadResult:
    """Outcome of ``schedule_workload``: the final device state plus one
    :class:`PhaseResult` per phase. ``order`` echoes the interleaved step
    order (``None`` for phases run back to back)."""

    state: DeviceState
    phases: tuple
    order: tuple | None = None

    @property
    def n_steps(self) -> int:
        return sum(p.n_steps for p in self.phases)

    @property
    def total_wall_ns(self) -> float:
        return sum(p.total_wall_ns for p in self.phases)

    @property
    def total_energy_nj(self) -> float:
        return float(sum(float(sequential_sum(p.energy_nj))
                         for p in self.phases))

    @property
    def host_overlap_ns(self) -> float:
        return sum(p.host_overlap_ns for p in self.phases)


def schedule_workload(device: DeviceState, phases, *,
                      order: Sequence[int] | None = None,
                      use_kernels: bool | None = None,
                      interpret: bool | None = None,
                      refresh: bool = False,
                      async_host: bool = False,
                      donate: bool = False,
                      verify: bool = False) -> WorkloadResult:
    """Run a HETEROGENEOUS multi-phase workload.

    ``phases`` is a sequence of phase descriptors (:class:`Phase`, a
    ``(layout, n_steps)`` pair, or a sequence of per-step layouts); each
    phase is one recurring step layout in the ``schedule_pipeline`` sense.
    Phases may differ arbitrarily from each other (streams, grouping, copy
    patterns, async flags).

    With ``order=None`` the phases run back to back. With
    ``order=[phase_idx, ...]`` the steps run in exactly that interleaved
    order, each phase's steps consumed FIFO, so ``order`` must name phase
    ``p`` exactly ``len(phases[p].steps)`` times.

    Equal to per-step ``schedule`` calls in the same order: states, reads
    and meters bit for bit, with the async host credit and the
    refresh-history meter threaded across every phase boundary (a sync
    phase resets the credit). ``donate`` is accepted and ignored;
    ``verify=True`` lints every phase's layout as ``schedule`` does.
    """
    cfg = device.config
    phase_list = [_as_phase(d) for d in phases]
    if not phase_list:
        raise ValueError("schedule_workload needs at least one phase")
    lowered = []                        # per phase: (plan, flats, async)
    for p, ph in enumerate(phase_list):
        step_list = list(ph.steps)
        if not step_list:
            raise ValueError(f"workload phase {p} has no steps")
        a_h = async_host if ph.async_host is None else bool(ph.async_host)
        flats, stripped0, groups0, deferred0 = _lower_recurring(
            cfg, step_list, what=f"workload phase {p}",
            hint="each phase of schedule_workload is ONE recurring "
                 "step layout; split heterogeneous steps into "
                 "separate phases")
        plan = _plan_for(cfg, stripped0, groups0, deferred0,
                         use_kernels=use_kernels, interpret=interpret,
                         refresh=refresh, async_host=a_h)
        lowered.append((plan, flats, a_h))
    if verify:
        _verify_plans([plan for plan, _, _ in lowered], "workload layout")

    n_ph = len(lowered)
    if order is None:
        seq = [p for p, (_, flats, _) in enumerate(lowered)
               for _ in flats]
    else:
        seq = [int(i) for i in order]
        counts = [0] * n_ph
        for i in seq:
            if not 0 <= i < n_ph:
                raise ValueError(
                    f"order index {i} out of range for {n_ph} phases")
            counts[i] += 1
        for p, (got, (_, flats, _)) in enumerate(zip(counts, lowered)):
            if got != len(flats):
                raise ValueError(
                    f"order names phase {p} {got} times but the phase has "
                    f"{len(flats)} steps — each phase's steps are consumed "
                    "FIFO")

    banks, credit = device.banks, _credit(device)
    logs = [_StepLog() for _ in lowered]
    cursor = [0] * n_ph
    for p in seq:
        plan, flats, _ = lowered[p]
        banks, credit = _run_step(plan, banks, credit, flats[cursor[p]],
                                  cfg.words, logs[p])
        cursor[p] += 1
    SCHED_STATS["dispatches"] += 1
    results = tuple(
        PhaseResult(
            wall_ns=torch.stack(log.walls),
            energy_nj=torch.stack(log.energies),
            n_steps=len(flats),
            _boundary_credit_ns=log.credit,
            _group_reads=log.group_reads(),
            _read_layout=(cfg.n_slots, plan.group_slots),
            _host_overlap_ns=torch.stack(log.hidden) if a_h else 0.0,
            **_copy_stats(plan))
        for (plan, flats, a_h), log in zip(lowered, logs))
    return WorkloadResult(
        state=device.with_banks(banks, host_credit_ns=credit),
        phases=results,
        order=None if order is None else tuple(seq))


# ---------------------------------------------------------------------------
# In-DRAM movement / reduction primitives
# ---------------------------------------------------------------------------

def gather_rows(cfg: DeviceConfig, moves, programs=None) -> list:
    """Per-slot COPY streams for in-DRAM row movement (zero host bytes).

    ``moves``: iterable of ``((src_bank, src_sub, src_row),
    (dst_bank, dst_sub, dst_row))``. Each move records one ``COPY`` in the
    *source* slot's stream; the scheduler drains them after the step's
    compute, so gathered rows hold post-compute values and are readable by
    the next step. ``programs`` (optional, any layout ``schedule`` accepts)
    is appended to — pass the step's compute programs to fuse compute +
    gather into one ``schedule`` call. Returns a flat per-slot list.
    """
    base = (_normalize_programs(cfg, programs) if programs is not None
            else [None] * cfg.n_slots)
    builders: dict[int, ProgramBuilder] = {}
    for (sb, ss, sr), (db, ds, dr) in moves:
        slot = cfg.slot_index(sb, ss)
        cfg.slot_index(db, ds)          # validate destination coordinates
        builders.setdefault(
            slot, ProgramBuilder(cfg.num_rows, cfg.words)).copy_row(
                sr, dr, db, ds)
    out = list(base)
    for slot, b in builders.items():
        copies = b.build()
        out[slot] = (copies if out[slot] is None
                     else ir.concat([out[slot], copies]))
    return out


def xor_reduce_program(num_rows: int, words: int, rows: Sequence[int],
                       dst: int) -> PimProgram:
    """One slot's in-place XOR fold: ``dst <- rows[0] ^ rows[1] ^ ...`` via
    Ambit XOR (rows must avoid the T0..T3 scratch). The reduction half of a
    gather/reduce step — all row traffic stays inside the subarray."""
    b = ProgramBuilder(num_rows, words)
    rows = list(rows)
    assert rows, "need at least one row to reduce"
    if rows[0] != dst:
        b.rowclone(rows[0], dst)
    for r in rows[1:]:
        b.ambit_xor(dst, r, dst)
    return b.build()


# ---------------------------------------------------------------------------
# Host-buffer partitioners: one large buffer → per-slot programs
# ---------------------------------------------------------------------------

BuildFn = Callable[[ProgramBuilder, list[int]], None]


def _chunk_program(chunk: np.ndarray, num_rows: int, words: int,
                   build: BuildFn | None, read_back: bool) -> PimProgram:
    b = ProgramBuilder(num_rows, words)
    b.issue()
    rows = list(range(chunk.shape[0]))
    for r in rows:
        b.write_row(r, chunk[r])
    if build is not None:
        build(b, rows)
    if read_back:
        for r in rows:
            b.read_row(r)
    return b.build()


def _regroup(programs: list, subarrays: int):
    """Flat chunk list → nested [bank][sub] when placing across the
    subarray axis; flat per-bank list otherwise (back-compat)."""
    if subarrays == 1:
        return programs
    return [programs[b * subarrays:(b + 1) * subarrays]
            for b in range(len(programs) // subarrays)]


def shard_rows(data: np.ndarray, n_banks: int, num_rows: int = NUM_ROWS, *,
               subarrays: int = 1, build: BuildFn | None = None,
               read_back: bool = False) -> list:
    """Split a ``(R, words)`` row buffer row-wise across ``n_banks`` banks
    (× ``subarrays`` slots per bank).

    Each slot receives a contiguous chunk of rows, HOSTW-written to its rows
    ``0..k-1`` after one ISSUE burst; ``build(builder, local_rows)`` then
    appends the per-slot compute. Chunks are ``np.array_split``-balanced, so
    R need not divide evenly (trailing slots may be one row short or idle).
    Returns a flat per-bank list, or nested ``[bank][sub]`` when
    ``subarrays > 1`` — both layouts feed ``schedule`` directly.
    """
    data = np.asarray(data, dtype=np.uint32)
    assert data.ndim == 2, data.shape
    chunks = np.array_split(data, n_banks * subarrays, axis=0)
    return _regroup(
        [_chunk_program(c, num_rows, data.shape[1], build, read_back)
         for c in chunks], subarrays)


def shard_lanes(data: np.ndarray, n_banks: int, num_rows: int = NUM_ROWS, *,
                subarrays: int = 1, build: BuildFn | None = None,
                read_back: bool = False) -> list:
    """Split a ``(R, words)`` row buffer lane-wise across ``n_banks`` banks
    (× ``subarrays`` slots per bank).

    Slot ``k`` receives the word-slice ``[:, k*w:(k+1)*w]`` of every row
    (``w = words // n_slots``) — all slots then run the SAME command stream
    over different columns, the natural SIMD split for element-parallel
    workloads (element width must divide 32 so lanes never straddle the
    word-slice boundary). Layout as in ``shard_rows``.
    """
    data = np.asarray(data, dtype=np.uint32)
    assert data.ndim == 2, data.shape
    words = data.shape[1]
    n_slots = n_banks * subarrays
    if words % n_slots:
        raise ValueError(f"words={words} not divisible by n_banks*subarrays="
                         f"{n_slots}")
    w = words // n_slots
    chunks = [data[:, k * w:(k + 1) * w] for k in range(n_slots)]
    return _regroup(
        [_chunk_program(c, num_rows, w, build, read_back) for c in chunks],
        subarrays)
