"""A row-register virtual machine over one PIM subarray.

Port of ``repro.core.bitplane.vm``. Registers are row indices and every
method records one or a few IR commands into a
:class:`~..pim.ir.ProgramBuilder`. The recorded stream is flushed through
the compiling executor (``pim/compile.py`` + ``pim/exec.py``) whenever a
host-visible value is needed (``read``/accounting), so long op sequences
run fused with one meter fold, bit- and meter-exact against the eager path.
``PimVM(..., eager=True)`` runs command by command through ``isa``.

Element width ``w`` fixes the horizontal layout; mask/constant rows are
host-written once per pattern and cached (their cost is charged through
``write_row`` like any other host traffic and reported separately by
``setup_energy_nj``).

``PimVM(..., n_banks=N)`` shards the row's lanes across N device banks
(§5.1.4): every method records the SAME command stream, but host payloads
(loads, masks) are split lane-wise so bank ``b`` operates on lanes
``[b*L/N, (b+1)*L/N)``. Flushes run through the device scheduler
(``pim.schedule``); ``time_ns`` is then the device wall clock and
``energy_nj`` the sum over banks. ``async_host=True`` lets each flush's
HOSTW/HOSTR bursts overlap the previous flush's compute.

The VM lives on ``device``: the CUDA card unless ``device="cpu"`` is asked
for. Meters are DDR3 model outputs; the sharded wall clock and hidden host
time accumulate as 0-d float32 tensors on that device, in the reference's
order, so every accounting property equals the reference's float32 value.
"""
from __future__ import annotations

import numpy as np
import torch

from ..._device import resolve_device
from ..pim import isa
from ..pim import exec as pim_exec
from ..pim.compile import sequential_sum
from ..pim.device import DeviceConfig, make_device
from ..pim.ir import PimProgram, ProgramBuilder
from ..pim.schedule import (Phase, _sum_steps, compiled_for, schedule,
                            schedule_pipeline, schedule_workload)
from ..pim.state import SubarrayState, as_rows, make_subarray
from ..pim.timing import DDR3Timing, DEFAULT_TIMING
from . import layout


class PimVM:
    RESERVED_TAIL = 8  # C0/C1/T0..T3 + margin

    def __init__(self, width: int, num_rows: int = 128, words: int = 16,
                 cfg: DDR3Timing = DEFAULT_TIMING, eager: bool = False,
                 n_banks: int = 1, async_host: bool = False,
                 verify: bool = False, *, device=None):
        assert (words * 32) % width == 0
        assert words % n_banks == 0, (words, n_banks)
        assert not (async_host and n_banks == 1), \
            "async_host rides the device scheduler; use n_banks > 1"
        self.device = resolve_device(device)
        self.width = width
        self.words = words
        self.cfg = cfg
        self.eager = eager
        self.n_banks = n_banks
        self.async_host = async_host
        self.verify = bool(verify)
        self.lanes = (words * 32) // width
        self._num_rows = num_rows
        self._reads: tuple = ()
        self._free = list(range(num_rows - self.RESERVED_TAIL - 1, -1, -1))
        self._mask_rows: dict[int, int] = {}
        if n_banks == 1:
            self._builder = ProgramBuilder(num_rows, words,
                                           verify=self.verify)
            st = make_subarray(num_rows, words, device=self.device)
            self.state: SubarrayState = isa.reserve_control_rows(st)
        else:
            assert not eager, "lane sharding needs the recorded-IR path"
            self.bank_words = words // n_banks
            assert (self.bank_words * 32) % width == 0, \
                "element width must tile the per-bank word slice"
            self.bank_lanes = (self.bank_words * 32) // width
            self._builder = ProgramBuilder(num_rows, self.bank_words,
                                           verify=self.verify)
            self._bank_payloads: list[list[np.ndarray]] = []
            self._read_result = None
            self._device = make_device(DeviceConfig(
                channels=1, ranks=1, banks_per_rank=n_banks,
                num_rows=num_rows, words=self.bank_words, timing=cfg),
                device=self.device)
            zero = torch.zeros((), dtype=torch.float32, device=self.device)
            self._wall_ns = zero
            self._host_overlap_ns = zero.clone()

    def _new_builder(self) -> ProgramBuilder:
        return ProgramBuilder(self._num_rows, self.words if self.n_banks == 1
                              else self.bank_words, verify=self.verify)

    # -- recording / flushing --------------------------------------------------
    def _op(self, name: str, *args) -> None:
        """Dispatch one ISA-surface call: eager shim or IR recording.
        ProgramBuilder mirrors isa minus the threaded state/cfg, so the
        same name and operand order serve both paths."""
        if self.eager:
            self.state = getattr(isa, name)(self.state, *args, self.cfg)
        else:
            getattr(self._builder, name)(*args)

    def _write_sharded(self, reg: int, full_row: np.ndarray) -> None:
        """Record one HOSTW whose payload differs per bank: the recorded op
        (and slot index) is shared, the data is the bank's word slice."""
        w = self.bank_words
        # copies, not views: recorded payloads must never alias caller data
        slices = [np.array(full_row[b * w:(b + 1) * w], dtype=np.uint32,
                           copy=True)
                  for b in range(self.n_banks)]
        self._builder.write_row(reg, slices[0])
        self._bank_payloads.append(slices)

    def _flush(self) -> None:
        """Execute the pending recorded stream against the current state."""
        if len(self._builder) == 0:
            return
        if self.n_banks == 1:
            res = pim_exec.execute(self._builder.build(), self.state, self.cfg)
            self.state = res.state
            self._reads = res.reads
            self._builder = self._new_builder()
            return
        prog = self._builder.build()
        programs = [
            prog.with_payloads(rows[b] for rows in self._bank_payloads)
            for b in range(self.n_banks)]
        res = schedule(self._device, programs, async_host=self.async_host)
        self._device = res.state
        self._read_result = res            # reads unbatch lazily on access
        self._wall_ns = self._wall_ns + res.wall_ns
        self._host_overlap_ns = (self._host_overlap_ns
                                 + res.host_overlap_ns_lazy)
        self._builder = self._new_builder()
        self._bank_payloads = []

    def take_recorded(self) -> PimProgram:
        """Hand the pending recorded stream over WITHOUT executing it (to
        schedule it on a device slot instead). Only meaningful before any
        flush, and only in single-bank mode. Resets the recorder."""
        assert self.n_banks == 1, "take_recorded needs a single-bank VM"
        prog = self._builder.build()
        self._builder = self._new_builder()
        return prog

    def _record_steps(self, step, xs, free0, masks0):
        """Record ``step(self, x)`` once per ``x``, rewinding the allocator
        and mask cache before each. Returns ``(progs, bank_payloads,
        read_slots, single)``."""
        progs, bank_payloads = [], []
        read_slots, single = None, False
        for x in xs:
            self._free, self._mask_rows = list(free0), dict(masks0)
            out = step(self, x)
            regs = list(out) if isinstance(out, (list, tuple)) else [out]
            slots = [self._builder.read_row(r) for r in regs]
            progs.append(self._builder.build())
            if self.n_banks > 1:
                bank_payloads.append(self._bank_payloads)
                self._bank_payloads = []
            self._builder = self._new_builder()
            if read_slots is None:
                read_slots = slots
                single = not isinstance(out, (list, tuple))
        return progs, bank_payloads, read_slots, single

    def _payload_steps(self, progs) -> torch.Tensor:
        """(K, n_payloads, words) int32 HOSTW data of K recorded steps, on
        the VM's device."""
        if progs[0].payloads:
            return as_rows(np.stack([np.stack(p.payloads) for p in progs]),
                           self.device)
        return torch.zeros((len(progs), 0, self.words), dtype=torch.int32,
                           device=self.device)

    def _bank_steps(self, progs, bank_payloads) -> list:
        return [[prog.with_payloads(rows[b] for rows in pays)
                 for b in range(self.n_banks)]
                for prog, pays in zip(progs, bank_payloads)]

    def _unpack_steps(self, n_steps, read_slots, single, row) -> list:
        out = []
        for k in range(n_steps):
            vals = [layout.unpack_elements(row(k, s), self.width, self.lanes)
                    for s in read_slots]
            out.append(vals[0] if single else vals)
        return out

    def run_pipeline(self, step, xs) -> list:
        """Execute ``step`` once per element of ``xs`` as one pipeline.

        ``step(vm, x)`` records one pipeline step through the normal VM
        vocabulary and returns the register (or sequence of registers) to
        read back; it must record the SAME command stream for every ``x``
        (HOSTW payload *data* may differ) and must not call
        ``read``/accounting mid-step. The allocator and mask cache are
        rewound to their pre-pipeline state before EVERY recording, so a
        mask created inside ``step`` is host-written in every step. Single-
        bank VMs run the K steps through ``exec.make_pipeline_runner``;
        lane-sharded VMs through ``schedule_pipeline`` (honoring
        ``async_host``). Returns one entry per step: the unpacked value of
        each returned register (a list when ``step`` returns a sequence).
        """
        assert not self.eager, "run_pipeline needs the recorded-IR path"
        xs = list(xs)
        assert xs, "need at least one pipeline step"
        self._flush()                   # pending ops run before the pipeline
        free0, masks0 = list(self._free), dict(self._mask_rows)
        progs, bank_payloads, read_slots, single = self._record_steps(
            step, xs, free0, masks0)
        # Registers allocated inside `step` are transient: the allocator
        # (and mask cache) return to the pre-pipeline state.
        self._free, self._mask_rows = list(free0), dict(masks0)
        key0 = (progs[0].digest, len(progs[0].payloads))
        for k, p in enumerate(progs[1:], 1):
            if (p.digest, len(p.payloads)) != key0:
                raise ValueError(
                    f"pipeline step {k} recorded a different command "
                    "stream than step 0; run_pipeline replays ONE "
                    "recurring step, so the step function must be "
                    "shape-deterministic")
        K = len(progs)
        if self.n_banks == 1:
            compiled = compiled_for(progs[0], self.cfg)
            pipe = pim_exec.make_pipeline_runner(compiled, self.cfg)
            self.state, reads_steps = pipe(self.state,
                                           self._payload_steps(progs))

            def row(k, slot):
                return reads_steps[slot][k]
        else:
            res = schedule_pipeline(self._device,
                                    self._bank_steps(progs, bank_payloads),
                                    async_host=self.async_host)
            self._device = res.state
            self._wall_ns = self._wall_ns + sequential_sum(res.wall_ns)
            self._host_overlap_ns = (self._host_overlap_ns
                                     + _sum_steps(res.host_overlap_ns_lazy))
            per_step = res.reads          # [k][bank] -> per-read rows

            def row(k, slot):
                return np.concatenate([per_step[k][b][slot]
                                       for b in range(self.n_banks)])
        return self._unpack_steps(K, read_slots, single, row)

    def run_workload(self, phases) -> list:
        """Execute a HETEROGENEOUS multi-phase workload.

        ``phases`` is a sequence of ``(step, xs)`` pairs: each phase is a
        ``run_pipeline``-style recurring step function replayed once per
        element of its ``xs``. The recurring contract applies WITHIN a
        phase. The allocator and mask cache rewind before every recording
        exactly as in ``run_pipeline``, so registers that must survive a
        phase boundary must be allocated BEFORE the call. Single-bank VMs
        run through ``exec.make_workload_runner``; lane-sharded VMs through
        ``schedule_workload`` (honoring ``async_host``). Returns one
        ``run_pipeline``-shaped result list per phase.
        """
        assert not self.eager, "run_workload needs the recorded-IR path"
        phase_list = [(step, list(xs)) for step, xs in phases]
        assert phase_list, "need at least one phase"
        self._flush()                   # pending ops run before the workload
        free0, masks0 = list(self._free), dict(self._mask_rows)
        recorded = []
        for p, (step, xs) in enumerate(phase_list):
            assert xs, f"workload phase {p} needs at least one step"
            progs, bank_payloads, read_slots, single = self._record_steps(
                step, xs, free0, masks0)
            key0 = (progs[0].digest, len(progs[0].payloads))
            for k, q in enumerate(progs[1:], 1):
                if (q.digest, len(q.payloads)) != key0:
                    raise ValueError(
                        f"workload phase {p} step {k} recorded a different "
                        "command stream than the phase's step 0; each "
                        "phase replays ONE recurring step — split "
                        "shape-divergent steps into separate phases")
            recorded.append((progs, bank_payloads, read_slots, single))
        self._free, self._mask_rows = list(free0), dict(masks0)
        if self.n_banks == 1:
            runner = pim_exec.make_workload_runner(
                [compiled_for(progs[0], self.cfg)
                 for progs, _, _, _ in recorded], self.cfg)
            self.state, reads_phases = runner(
                self.state, tuple(self._payload_steps(progs)
                                  for progs, _, _, _ in recorded))

            def row(p, k, slot):
                return reads_phases[p][slot][k]
        else:
            res = schedule_workload(
                self._device,
                [Phase(steps=tuple(self._bank_steps(progs, pays)))
                 for progs, pays, _, _ in recorded],
                async_host=self.async_host)
            self._device = res.state
            self._wall_ns = self._wall_ns + sum(
                sequential_sum(pr.wall_ns) for pr in res.phases)
            self._host_overlap_ns = self._host_overlap_ns + sum(
                _sum_steps(pr.host_overlap_ns_lazy) for pr in res.phases)

            def row(p, k, slot):
                return np.concatenate([res.phases[p].reads[k][b][slot]
                                       for b in range(self.n_banks)])
        return [self._unpack_steps(len(progs), read_slots, single,
                                   lambda k, s, p=p: row(p, k, s))
                for p, (progs, _, read_slots, single) in enumerate(recorded)]

    # -- register management -------------------------------------------------
    def alloc(self) -> int:
        return self._free.pop()

    def free(self, *regs: int) -> None:
        self._free.extend(regs)

    # -- host I/O -------------------------------------------------------------
    def _host_write(self, reg: int, full_row: np.ndarray) -> None:
        if self.n_banks == 1:
            self._op("write_row", reg, full_row)
        else:
            self._write_sharded(reg, full_row)

    def load(self, values, reg: int | None = None) -> int:
        reg = self.alloc() if reg is None else reg
        row = layout.pack_elements(np.asarray(values), self.width, self.words)
        self._host_write(reg, row)
        return reg

    def read(self, reg: int) -> np.ndarray:
        if self.eager:
            self.state, row = isa.read_row(self.state, reg, self.cfg)
            return layout.unpack_elements(row, self.width, self.lanes)
        return self.read_many([reg])[0]

    def read_many(self, regs) -> list[np.ndarray]:
        """Read several registers with ONE flush (a per-``read`` flush
        splits a pipeline step into several schedule steps)."""
        if self.eager:
            return [self.read(r) for r in regs]
        slots = [self._builder.read_row(r) for r in regs]
        self._flush()
        if not slots:
            return []           # pending ops flushed; nothing to unbatch
        out = []
        for slot in slots:
            if self.n_banks == 1:
                row = self._reads[slot]
            else:
                reads = self._read_result.reads
                row = np.concatenate([reads[b][slot]
                                      for b in range(self.n_banks)])
            out.append(layout.unpack_elements(row, self.width, self.lanes))
        return out

    def mask(self, element_pattern: int) -> int:
        """Row with ``element_pattern`` tiled into every element (cached)."""
        if element_pattern not in self._mask_rows:
            reg = self.alloc()
            row = layout.const_row(self.width, self.words, element_pattern)
            self._host_write(reg, row)
            self._mask_rows[element_pattern] = reg
        return self._mask_rows[element_pattern]

    # -- ISA ops (dst allocated when omitted; returns dst) --------------------
    def copy(self, a: int, dst: int | None = None) -> int:
        dst = self.alloc() if dst is None else dst
        self._op("rowclone", a, dst)
        return dst

    def and_(self, a: int, b: int, dst: int | None = None) -> int:
        dst = self.alloc() if dst is None else dst
        self._op("ambit_and", a, b, dst)
        return dst

    def or_(self, a: int, b: int, dst: int | None = None) -> int:
        dst = self.alloc() if dst is None else dst
        self._op("ambit_or", a, b, dst)
        return dst

    def xor(self, a: int, b: int, dst: int | None = None) -> int:
        dst = self.alloc() if dst is None else dst
        self._op("ambit_xor", a, b, dst)
        return dst

    def not_(self, a: int, dst: int | None = None) -> int:
        dst = self.alloc() if dst is None else dst
        self._op("ambit_not", a, dst)
        return dst

    def maj(self, a: int, b: int, c: int, dst: int | None = None) -> int:
        dst = self.alloc() if dst is None else dst
        self._op("ambit_maj", a, b, c, dst)
        return dst

    def zero(self, dst: int | None = None) -> int:
        dst = self.alloc() if dst is None else dst
        self._op("rowclone", isa.C0, dst)
        return dst

    def shift_cols(self, a: int, k: int, dst: int | None = None) -> int:
        """Shift |k| columns via |k| migration-cell shifts (no masking)."""
        dst = self.alloc() if dst is None else dst
        if self.eager:
            if k == 0:
                self.state = isa.rowclone(self.state, a, dst, self.cfg)
                return dst
            delta = 1 if k > 0 else -1
            self.state = isa.shift(self.state, a, dst, delta, self.cfg)
            for _ in range(abs(k) - 1):
                self.state = isa.shift(self.state, dst, dst, delta, self.cfg)
        else:
            self._builder.shift_k(a, dst, k)
        return dst

    def shift_elem(self, a: int, k: int, dst: int | None = None) -> int:
        """Element-local shift: column shift + boundary mask (crossing bits
        dropped). k > 0 shifts toward the element MSB (i.e. ``x << k``)."""
        dst = self.shift_cols(a, k, dst)
        if k == 0:
            return dst
        w = self.width
        if k > 0:
            pattern = ((1 << w) - 1) & ~((1 << min(k, w)) - 1)
        else:
            pattern = ((1 << w) - 1) >> min(-k, w)
        return self.and_(dst, self.mask(pattern), dst)

    # -- derived --------------------------------------------------------------
    def smear(self, a: int, dst: int | None = None) -> int:
        """OR-spread any set bit of each element across the whole element
        (log2(w) doubling rounds in each direction)."""
        dst = self.copy(a, dst)
        s = 1
        while s < self.width:
            up = self.shift_elem(dst, +s)
            self.or_(dst, up, dst)
            self.free(up)
            s *= 2
        s = 1
        while s < self.width:
            dn = self.shift_elem(dst, -s)
            self.or_(dst, dn, dst)
            self.free(dn)
            s *= 2
        return dst

    # -- accounting -----------------------------------------------------------
    @property
    def time_ns(self) -> float:
        """Single bank: the subarray meter. Sharded: the device wall clock
        (bus serialization + max over banks) accumulated across flushes."""
        self._flush()
        if self.n_banks == 1:
            return float(self.state.meter.time_ns)
        return float(self._wall_ns)

    @property
    def energy_nj(self) -> float:
        self._flush()
        if self.n_banks == 1:
            return float(self.state.meter.total_energy_nj)
        return float(sequential_sum(
            self._device.banks.meter.total_energy_nj))

    @property
    def host_overlap_ns(self) -> float:
        """Host-transfer time hidden under compute by the async engine
        (sharded VMs with ``async_host=True``), accumulated across flushes."""
        self._flush()
        return 0.0 if self.n_banks == 1 else float(self._host_overlap_ns)

    @property
    def setup_energy_nj(self) -> float:
        self._flush()
        if self.n_banks == 1:
            return float(self.state.meter.e_burst)
        return float(sequential_sum(self._device.banks.meter.e_burst))

    def counts(self) -> dict:
        self._flush()
        keys = ("n_act", "n_pre", "n_aap", "n_shift", "n_tra")
        if self.n_banks == 1:
            m = self.state.meter
            return {k: int(getattr(m, k)) for k in keys}
        m = self._device.banks.meter
        return {k: int(getattr(m, k).sum()) for k in keys}
