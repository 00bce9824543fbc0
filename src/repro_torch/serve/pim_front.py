"""Multi-tenant PIM serving front end: one device, N client workloads.

Port of ``repro.serve.pim_front`` on the port's scheduler: the device
state, the per-slot meters and every tenant's snapshots are tensors on the
front's device (the CUDA card unless ``device="cpu"``), where the
scheduler runs the row kernels; only a report or ``reconcile()`` copies
meters to the host, once per call.

The scheduler core (``core/pim/schedule.py``) runs one *layout* — a flat
per-slot program list — as a single dispatch. This module is the
request-level front end on top of it: N tenants submit
:class:`~repro_torch.core.pim.PimProgram` workloads against one
:class:`~repro_torch.core.pim.DeviceConfig`, and the front end

* **places** each tenant on an explicit set of banks (every subarray of
  an owned bank belongs to the tenant; the placement map is public),
  rejecting over-subscription at admission time;
* **verifies** submitted programs at admission with the static verifier
  (``lint_schedule`` over the tenant's private subdevice slice), so a
  hostile tenant is rejected with diagnostics at ``submit()`` and can
  never crash the shared step plan — cross-slot ``COPY`` destinations
  outside the tenant's own allocation surface as PIM301 errors on the
  subdevice and are rejected too (tenant isolation);
* **coalesces** identical command streams across tenants: tenant
  programs are written in *tenant-local* bank coordinates, relocated to
  device coordinates at placement, and merged into one layout — slots
  owned by different tenants whose streams share a columnar digest land
  in one ``stream_key`` group and run under ONE batched runner
  (the scheduler's existing grouping does the heavy lifting; the front
  end just places everyone into the same ``schedule`` call);
* runs a **continuous-batching loop**: admission and preemption happen
  only at step boundaries, a departing tenant's slots simply become idle
  ``None`` entries (the surviving layout's warm ``_StepPlan`` stays
  cached — nothing is invalidated), and windows where every tenant's
  stream recurs are dispatched as ONE ``schedule_pipeline`` scan instead
  of per-step round-trips;
* **accounts** per tenant by slicing the per-slot meters on the device
  (``DeviceState.slot_time_ns`` / ``slot_energy_nj``): meters are
  cumulative and slots are exclusively owned, so a tenant's busy time and
  energy are differences of two snapshots, and tenant sums reconcile with
  the device-level totals (exactly, when computed from the same per-slot
  diffs — see :meth:`PimServeFront.reconcile`).

DESIGN.md §13 documents the placement / coalescing / preemption /
accounting contracts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.pim import ir
from ..core.pim.device import DeviceConfig, DeviceState, make_device
from ..core.pim.ir import PimProgram
from ..core.pim.lint import LintReport, lint_schedule
from ..core.pim.schedule import (PipelineResult, ScheduleResult,
                                 _normalize_programs, schedule,
                                 schedule_pipeline, stream_key)

__all__ = ["AdmissionError", "FrontStepResult", "PimServeFront",
           "Placement", "TenantReport"]


class AdmissionError(ValueError):
    """A tenant submission was rejected at admission: over-subscription,
    malformed programs, or static-verifier errors. Carries the lint
    ``report`` when the verifier found the problem."""

    def __init__(self, tenant: str, reason: str,
                 report: LintReport | None = None):
        self.tenant = tenant
        self.report = report
        detail = ""
        if report is not None and report.errors:
            head = "; ".join(d.render() for d in report.errors[:3])
            more = (f" (+{len(report.errors) - 3} more)"
                    if len(report.errors) > 3 else "")
            detail = f": {head}{more}"
        super().__init__(f"tenant {tenant!r} rejected: {reason}{detail}")


@dataclasses.dataclass(frozen=True)
class Placement:
    """One tenant's allocation: device bank ids (every subarray of an
    owned bank belongs to the tenant) and the flat slot ids they imply."""

    tenant: str
    banks: tuple[int, ...]
    slots: tuple[int, ...]


@dataclasses.dataclass
class TenantReport:
    """Per-tenant accounting over the tenant's whole residency, sliced
    from the per-slot meters: busy time and energy are snapshot
    differences at the tenant's slots, ``host_bytes`` counts its own
    streams' off-chip traffic, and ``wall_ns`` holds the device step
    latency of every step the tenant was active in."""

    tenant: str
    banks: tuple[int, ...]
    slots: tuple[int, ...]
    n_steps: int
    busy_ns: float
    energy_nj: float
    host_bytes: int
    wall_ns: np.ndarray

    def wall_percentile(self, q: float) -> float:
        """Step-latency percentile (q in [0, 100]) over the tenant's
        active steps — the p50/p99 the serving bench reports."""
        if self.wall_ns.size == 0:
            return 0.0
        return float(np.percentile(self.wall_ns, q))

    @property
    def p50_wall_ns(self) -> float:
        return self.wall_percentile(50.0)

    @property
    def p99_wall_ns(self) -> float:
        return self.wall_percentile(99.0)


@dataclasses.dataclass
class FrontStepResult:
    """One front-end dispatch: a single device step (``result`` is a
    :class:`ScheduleResult`) or a recurring window of ``n_steps`` steps
    (``result`` is a :class:`PipelineResult`). ``placements`` maps the
    tenants active in this dispatch to their slots."""

    result: "ScheduleResult | PipelineResult"
    placements: dict
    n_steps: int
    n_groups: int               # coalesced stream groups in the layout
    n_active_slots: int         # slots that ran a program

    @property
    def coalescing(self) -> float:
        """Active slots per compiled stream group — N identical-digest
        tenants coalesce to factor ~N."""
        return (self.n_active_slots / self.n_groups if self.n_groups
                else 0.0)

    def tenant_reads(self, tenant: str):
        """The tenant's host-read rows, sliced from the batched
        reads: per-slot tuples for a single step, a per-step list of them
        for a pipeline window."""
        slots = self.placements[tenant]
        if isinstance(self.result, ScheduleResult):
            return tuple(self.result.reads[s] for s in slots)
        return [tuple(step[s] for s in slots) for step in self.result.reads]


@dataclasses.dataclass
class _Tenant:
    """Internal per-tenant record: relocated per-step slot fragments plus
    the meter snapshots taken at admission."""

    tid: str
    banks: tuple[int, ...]
    slots: tuple[int, ...]
    steps: list                 # per step: per-owned-slot program list
    t0_time: torch.Tensor       # float32 on the device
    t0_energy: torch.Tensor
    cursor: int = 0
    host_bytes: int = 0
    walls: list = dataclasses.field(default_factory=list)

    @property
    def remaining(self) -> int:
        return len(self.steps) - self.cursor


@dataclasses.dataclass
class _Pending:
    """A queued submission: admission-linted tenant-local steps waiting
    for enough free banks."""

    tid: str
    n_banks: int
    local_steps: list           # per step: tenant-local flat slot list


def _as_steps(steps):
    """Submission sugar: ``(layout, n)`` replays one layout n times
    (identical objects — the pipeline fast path recurs by identity);
    otherwise ``steps`` is a sequence of per-step layouts."""
    if (isinstance(steps, tuple) and len(steps) == 2
            and isinstance(steps[1], (int, np.integer))):
        return [steps[0]] * int(steps[1])
    return list(steps)


class PimServeFront:
    """Request-level multi-tenant front end over one shared PIM device.

    ``refresh`` / ``async_host`` are the scheduler flags applied to every
    shared step. ``admission_lint=False`` disables the static-verifier
    admission gate (benchmarking the gate itself; production keeps it on).
    The device state lives on ``device``: the CUDA card unless
    ``device="cpu"`` is asked for (without a card, that is an error).
    """

    def __init__(self, config: DeviceConfig, *, refresh: bool = False,
                 async_host: bool = False, admission_lint: bool = True,
                 device=None):
        self.cfg = config
        self.device: DeviceState = make_device(config, device=device)
        self.refresh = refresh
        self.async_host = async_host
        self.admission_lint = admission_lint
        self._free: list[int] = list(range(config.n_banks))
        self._active: dict[str, _Tenant] = {}
        self._pending: list[_Pending] = []
        self._done: dict[str, TenantReport] = {}
        self._lint_ok: set = set()      # (n_banks, per-slot digest sig)
        self._t0 = self.device.slot_time_ns.clone()
        self._e0 = self.device.slot_energy_nj.clone()
        self._host_bytes_total = 0
        self._n_steps_total = 0

    # -- introspection ----------------------------------------------------

    @property
    def active(self) -> tuple[str, ...]:
        return tuple(self._active)

    @property
    def pending(self) -> tuple[str, ...]:
        return tuple(p.tid for p in self._pending)

    @property
    def free_banks(self) -> tuple[int, ...]:
        return tuple(self._free)

    def placement(self, tenant: str | None = None):
        """The explicit placement map: ``{tenant: Placement}``, or one
        tenant's :class:`Placement`."""
        out = {tid: Placement(tid, t.banks, t.slots)
               for tid, t in self._active.items()}
        return out if tenant is None else out[tenant]

    # -- admission --------------------------------------------------------

    def _normalize_local(self, tid: str, steps, n_banks: int) -> list:
        """Validate + normalize every submitted step to a tenant-local
        flat slot list over the tenant's private subdevice slice."""
        sub = self.cfg.subdevice(n_banks)
        out = []
        for k, layout in enumerate(steps):
            if isinstance(layout, PimProgram):
                # a bare program replicates across every tenant bank
                # (subarray 0) — one stream, maximal coalescing
                layout = [layout] * sub.n_banks
            try:
                flat = _normalize_programs(sub, layout)
            except (ValueError, AssertionError) as e:
                raise AdmissionError(tid, f"step {k}: {e}") from e
            for p in flat:
                if p is not None and not isinstance(p, PimProgram):
                    raise AdmissionError(
                        tid, f"step {k}: {type(p).__name__} is not a "
                             "PimProgram")
                if p is not None and (p.num_rows, p.words) != (
                        self.cfg.num_rows, self.cfg.words):
                    raise AdmissionError(
                        tid, f"step {k}: program shape "
                             f"{(p.num_rows, p.words)} != device shape "
                             f"{(self.cfg.num_rows, self.cfg.words)}")
            out.append(flat)
        return out

    def _lint_gate(self, tid: str, local_steps: list, n_banks: int) -> None:
        """The admission-time ``verify=True`` gate: run the static
        verifier over every distinct step signature on the tenant's
        private subdevice. PIM301 on the subdevice doubles as the
        isolation check — a COPY addressed outside the tenant's own banks
        is outside its subdevice. Errors reject the submission BEFORE any
        allocation; the shared step plan never sees the program."""
        if not self.admission_lint:
            return
        sub = self.cfg.subdevice(n_banks)
        for flat in local_steps:
            sig = (n_banks, tuple(None if p is None else p.digest
                                  for p in flat),
                   tuple(() if p is None else
                         tuple(tuple(q.shape) for q in p.payloads)
                         for p in flat))
            if sig in self._lint_ok:
                continue
            report = lint_schedule(sub, flat, async_host=self.async_host)
            if not report.ok:
                raise AdmissionError(tid, "static verification failed",
                                     report)
            self._lint_ok.add(sig)

    @staticmethod
    def _relocate(program: PimProgram, banks: tuple[int, ...]) -> PimProgram:
        """Tenant-local → device coordinates: rewrite cross-slot COPY
        destination banks through the placement map. Programs without
        cross-slot COPYs are returned UNCHANGED (same object) so their
        digests — and therefore cross-tenant stream-group coalescing and
        the identity-keyed payload cache — are placement-independent."""
        cols = program.columns
        is_copy = cols.code == ir.OP_CODE[ir.OP_COPY]
        if not is_copy.any():
            return program
        cross = is_copy & ~((cols.delta == ir.COPY_SELF)
                            & (cols.c == ir.COPY_SELF))
        if not cross.any():
            return program
        ops = []
        for op in program.ops:
            if (op.op == ir.OP_COPY
                    and (op.delta, op.c) != (ir.COPY_SELF, ir.COPY_SELF)):
                ops.append(dataclasses.replace(op, delta=banks[op.delta]))
            else:
                ops.append(op)
        return PimProgram(ops=tuple(ops), num_rows=program.num_rows,
                          words=program.words, payloads=program.payloads)

    def _admit(self, tid: str, n_banks: int, local_steps: list) -> Placement:
        banks = tuple(self._free[:n_banks])
        del self._free[:n_banks]
        slots = self.cfg.bank_slots(banks)
        reloc: dict[int, PimProgram] = {}
        pins: list = []                 # keep source programs alive: the
        steps = []                      # reloc memo is id-keyed
        for flat in local_steps:
            step = []
            for p in flat:
                if p is None:
                    step.append(None)
                else:
                    r = reloc.get(id(p))
                    if r is None:
                        r = self._relocate(p, banks)
                        reloc[id(p)] = r
                        pins.append(p)
                    step.append(r)
            steps.append(step)
        idx = torch.tensor(slots, device=self.device.device)
        self._active[tid] = _Tenant(
            tid=tid, banks=banks, slots=slots, steps=steps,
            t0_time=self.device.slot_time_ns[idx],
            t0_energy=self.device.slot_energy_nj[idx])
        return Placement(tid, banks, slots)

    def submit(self, tenant: str, steps, *, banks: int = 1,
               queue: bool = False) -> Placement | None:
        """Admit a tenant workload: ``steps`` is a sequence of per-step
        layouts over the tenant's ``banks``-bank slice (anything
        ``schedule`` accepts for that slice, in TENANT-LOCAL bank
        coordinates), or ``(layout, n)`` to replay one layout n times.

        Admission validates shapes, runs the static verifier over the
        tenant's private subdevice (rejecting hostile programs with their
        diagnostics), and allocates ``banks`` free device banks. With
        ``queue=True`` a submission that does not fit *right now* waits in
        the FIFO pending queue and is admitted at a later step boundary;
        otherwise over-subscription raises :class:`AdmissionError`.
        Returns the :class:`Placement` (``None`` when queued)."""
        if tenant in self._active or tenant in {p.tid for p in self._pending}:
            raise AdmissionError(tenant, "tenant id already submitted")
        if banks < 1:
            raise AdmissionError(tenant, f"needs at least 1 bank, got "
                                         f"{banks}")
        if banks > self.cfg.n_banks:
            raise AdmissionError(
                tenant, f"requested {banks} banks; the device has "
                        f"{self.cfg.n_banks} — cannot ever fit")
        step_list = _as_steps(steps)
        if not step_list:
            raise AdmissionError(tenant, "workload has no steps")
        local_steps = self._normalize_local(tenant, step_list, banks)
        self._lint_gate(tenant, local_steps, banks)
        if len(self._free) < banks:
            if queue:
                self._pending.append(_Pending(tenant, banks, local_steps))
                return None
            raise AdmissionError(
                tenant, f"over-subscribed: needs {banks} banks, "
                        f"{len(self._free)} free (queue=True to wait)")
        return self._admit(tenant, banks, local_steps)

    # -- departure / preemption ------------------------------------------

    def _report_for(self, t: _Tenant) -> TenantReport:
        idx = torch.tensor(t.slots, device=self.device.device)
        n = len(t.slots)
        # One device-to-host copy: the tenant's slot meters now and at
        # admission, then every step wall it was active in.
        host = torch.cat([self.device.slot_time_ns[idx], t.t0_time,
                          self.device.slot_energy_nj[idx], t.t0_energy,
                          *t.walls]).cpu().numpy().astype(np.float64)
        busy = host[:n] - host[n:2 * n]
        energy = host[2 * n:3 * n] - host[3 * n:4 * n]
        walls = host[4 * n:]
        return TenantReport(
            tenant=t.tid, banks=t.banks, slots=t.slots, n_steps=t.cursor,
            busy_ns=float(busy.sum()), energy_nj=float(energy.sum()),
            host_bytes=t.host_bytes, wall_ns=walls)

    def depart(self, tenant: str) -> TenantReport:
        """Remove a tenant at the current step boundary (preemption:
        unconsumed steps are discarded). Its slots become idle ``None``
        entries in subsequent layouts — the surviving tenants' warm step
        plan is untouched — and its banks return to the free list."""
        t = self._active.pop(tenant, None)
        if t is None:
            for i, p in enumerate(self._pending):
                if p.tid == tenant:
                    del self._pending[i]
                    return self._done.setdefault(
                        tenant, TenantReport(tenant, (), (), 0, 0.0, 0.0,
                                             0, np.zeros(0)))
            raise KeyError(f"unknown tenant {tenant!r}")
        report = self._report_for(t)
        self._done[tenant] = report
        self._free.extend(t.banks)
        self._free.sort()
        return report

    def report(self, tenant: str) -> TenantReport:
        """Accounting snapshot: live tenants are measured up to the last
        completed step, departed tenants return their final report."""
        t = self._active.get(tenant)
        if t is not None:
            return self._report_for(t)
        return self._done[tenant]

    def reports(self) -> dict:
        return {**{tid: self._report_for(t)
                   for tid, t in self._active.items()},
                **dict(self._done)}

    # -- the serving loop -------------------------------------------------

    def _boundary(self) -> None:
        """Step-boundary bookkeeping: retire tenants whose steps are
        exhausted, then admit pending submissions FIFO while they fit."""
        for tid in [tid for tid, t in self._active.items()
                    if t.cursor >= len(t.steps)]:
            self.depart(tid)
        while self._pending and self._pending[0].n_banks <= len(self._free):
            p = self._pending.pop(0)
            self._admit(p.tid, p.n_banks, p.local_steps)

    def _merged(self, offset: int = 0) -> list:
        flat: list = [None] * self.cfg.n_slots
        for t in self._active.values():
            step = t.steps[t.cursor + offset]
            for i, s in enumerate(t.slots):
                flat[s] = step[i]
        return flat

    def _account(self, result, n_steps: int) -> FrontStepResult:
        placements = {}
        walls = (result.wall_ns if isinstance(result, PipelineResult)
                 else result.wall_ns.reshape(1))
        for t in self._active.values():
            placements[t.tid] = t.slots
            t.walls.append(walls)
            for j in range(n_steps):
                t.host_bytes += sum(
                    t.steps[t.cursor + j][i].host_bytes
                    for i, _ in enumerate(t.slots)
                    if t.steps[t.cursor + j][i] is not None)
            t.cursor += n_steps
        self._host_bytes_total += result.host_bytes * n_steps
        self._n_steps_total += n_steps
        group_slots = result._read_layout[1]
        n_active = sum(len(g) for g in group_slots)
        out = FrontStepResult(result=result, placements=placements,
                              n_steps=n_steps, n_groups=len(group_slots),
                              n_active_slots=n_active)
        self._boundary()
        return out

    def step(self) -> FrontStepResult:
        """Run ONE shared device step over every active tenant's current
        step programs (one ``schedule`` dispatch; slots of identical
        digests coalesce into shared batched groups)."""
        if not self._active:
            raise RuntimeError("no active tenants (queue admission happens "
                               "at step boundaries — call step()/run() "
                               "with at least one admitted tenant)")
        result = schedule(self.device, self._merged(),
                          refresh=self.refresh, async_host=self.async_host)
        self.device = result.state
        return self._account(result, 1)

    def _window_recurs(self, k: int) -> bool:
        """Do the next k steps of every active tenant carry identical
        command streams (payload data free)? Identity short-circuits the
        common replayed-layout case."""
        for t in self._active.values():
            s0 = t.steps[t.cursor]
            for j in range(1, k):
                sj = t.steps[t.cursor + j]
                if sj is s0:
                    continue
                for a, b in zip(s0, sj):
                    if ((a is None) != (b is None)
                            or (a is not None
                                and stream_key(a) != stream_key(b))):
                        return False
        return True

    def run(self, max_steps: int | None = None, *, chunk: int = 64,
            pipeline: bool = True) -> list[FrontStepResult]:
        """The continuous-batching loop: repeatedly dispatch the merged
        layout until every tenant (active AND queued) is served, or
        ``max_steps`` device steps have run. Windows of up to ``chunk``
        steps in which every tenant's streams recur — and no tenant
        finishes mid-window — run as ONE ``schedule_pipeline`` scan;
        membership changes (completion, admission from the queue) happen
        only between dispatches."""
        out: list[FrontStepResult] = []
        done = 0
        self._boundary()
        while self._active and (max_steps is None or done < max_steps):
            k = min(t.remaining for t in self._active.values())
            if max_steps is not None:
                k = min(k, max_steps - done)
            k = min(k, chunk)
            if pipeline and k > 1 and self._window_recurs(k):
                flats = [self._merged(j) for j in range(k)]
                result = schedule_pipeline(
                    self.device, flats, refresh=self.refresh,
                    async_host=self.async_host)
                self.device = result.state
                out.append(self._account(result, k))
            else:
                out.append(self.step())
            done += out[-1].n_steps
        return out

    # -- reconciliation ---------------------------------------------------

    def reconcile(self) -> dict:
        """Device-level totals vs per-tenant sums, from the SAME per-slot
        meter diffs: ``device_*`` sums every slot's cumulative delta since
        construction, ``tenant_*`` sums the per-tenant reports. With each
        slot owned by one tenant at a time and idle slots never metered,
        the two agree (exactly when slots are not re-used across tenants;
        to float64 rounding of the snapshot telescope otherwise)."""
        t_now, t0, e_now, e0 = torch.stack(
            [self.device.slot_time_ns, self._t0, self.device.slot_energy_nj,
             self._e0]).cpu().numpy().astype(np.float64)
        reports = self.reports().values()
        return {
            "device_busy_ns": float((t_now - t0).sum()),
            "device_energy_nj": float((e_now - e0).sum()),
            "device_host_bytes": self._host_bytes_total,
            "device_steps": self._n_steps_total,
            "tenant_busy_ns": float(sum(r.busy_ns for r in reports)),
            "tenant_energy_nj": float(sum(r.energy_nj for r in reports)),
            "tenant_host_bytes": int(sum(r.host_bytes for r in reports)),
        }
