"""The multi-tenant serving front end's scenarios, run on one package's
front (a "kit"): the scenarios of ``tests/test_pim_serve.py``, each keeping
that test's own assertions and returning what it observed as plain data.

``tests/test_torch_pim_serve.py`` runs them on the JAX reference and on the
port on the CPU; ``tests/test_torch_cuda.py`` on the port on the card and
on the CPU. This module imports nothing of JAX.
"""
import importlib
import os
import types

import numpy as np
import pytest

ROWS = 16
WORDS = 4
FLOAT_FIELDS = ("time_ns", "e_act", "e_pre", "e_refresh", "e_burst",
                "e_background")
INT_FIELDS = ("n_act", "n_pre", "n_aap", "n_shift", "n_tra", "n_refresh")
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "lint",
                       "pim104.trace")


def port_kit(device):
    """The port's front on ``device`` as a kit."""
    from repro_torch.core import pim
    from repro_torch.serve import pim_front
    return types.SimpleNamespace(
        name=f"port[{device}]", pim=pim, front=pim_front,
        sched=importlib.import_module("repro_torch.core.pim.schedule"),
        make=lambda cfg, **kw: pim_front.PimServeFront(cfg, device=device,
                                                       **kw),
        numpy=lambda x: x.cpu().numpy())


def cfg_of(k, banks=4, subarrays=1):
    return k.pim.DeviceConfig(channels=1, ranks=1, banks_per_rank=banks,
                              subarrays=subarrays, num_rows=ROWS,
                              words=WORDS)


def prog(k, seed=0, *, copy_to=None, words=WORDS):
    """A small verified stream: two host writes, an AND, a host read.
    ``copy_to`` adds a cross-bank COPY to tenant-local bank ``copy_to``."""
    b = k.pim.ProgramBuilder(ROWS, words)
    rng = np.random.default_rng(seed)
    b.write_row(2, rng.integers(0, 2**32, (words,), dtype=np.uint32))
    b.write_row(3, rng.integers(0, 2**32, (words,), dtype=np.uint32))
    b.ambit_and(2, 3, 4)
    if copy_to is not None:
        b.copy_row(4, 5, dst_bank=copy_to, dst_sub=0)
    b.read_row(4)
    return b.build()


def plain(x):
    """Reads and other nested results as comparable plain data."""
    if isinstance(x, dict):
        return {key: plain(v) for key, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if hasattr(x, "__array__"):
        return np.asarray(x).astype(np.uint32).tolist()
    return x


def f32(k, x):
    return k.numpy(x).astype(np.float32).view(np.uint32).tolist()


def device_obs(k, front):
    """Per-slot bits, integer meters and float32 meters as bit patterns."""
    banks = front.device.banks
    bits = k.numpy(banks.bits)
    if bits.dtype != np.uint32:
        bits = bits.view(np.uint32)
    obs = {"bits": bits.tolist()}
    for f in INT_FIELDS:
        obs[f] = k.numpy(getattr(banks.meter, f)).tolist()
    for f in FLOAT_FIELDS:
        obs[f] = f32(k, getattr(banks.meter, f))
    obs["slot_time_ns"] = f32(k, front.device.slot_time_ns)
    obs["slot_energy_nj"] = f32(k, front.device.slot_energy_nj)
    return obs


def report_obs(rep):
    return (rep.tenant, rep.banks, rep.slots, rep.n_steps, rep.busy_ns,
            rep.energy_nj, rep.host_bytes, rep.wall_ns.tolist(),
            rep.p50_wall_ns, rep.p99_wall_ns)


def front_obs(k, front):
    return {"device": device_obs(k, front),
            "reports": {t: report_obs(r)
                        for t, r in sorted(front.reports().items())},
            "reconcile": front.reconcile(), "free": front.free_banks,
            "active": front.active, "pending": front.pending}


def step_obs(res):
    return {"n_steps": res.n_steps, "n_groups": res.n_groups,
            "n_active_slots": res.n_active_slots,
            "coalescing": res.coalescing,
            "placements": {t: tuple(s) for t, s in res.placements.items()},
            "reads": {t: plain(res.tenant_reads(t))
                      for t in sorted(res.placements)}}


def admission(k, fn):
    with pytest.raises(k.front.AdmissionError) as ei:
        fn()
    e = ei.value
    return (e.tenant, str(e),
            None if e.report is None else e.report.codes())


# ---------------------------------------------------------------------------
# The reference's scenarios, run in both packages
# ---------------------------------------------------------------------------

def sc_placement_map_is_explicit_and_exclusive(k):
    front = k.make(cfg_of(k, banks=4, subarrays=2))
    pa = front.submit("A", (prog(k, 0), 2), banks=2)
    pb = front.submit("B", (prog(k, 1), 2), banks=1)
    assert isinstance(pa, k.front.Placement)
    assert pa.banks == (0, 1) and pb.banks == (2,)
    assert pa.slots == (0, 1, 2, 3) and pb.slots == (4, 5)
    assert front.free_banks == (3,)
    assert front.placement("A") == pa
    assert set(front.placement()) == {"A", "B"}
    return [(p.tenant, p.banks, p.slots)
            for p in front.placement().values()]


def sc_oversubscription_rejected_at_admission(k):
    front = k.make(cfg_of(k, banks=4))
    front.submit("A", (prog(k), 2), banks=3)
    return [admission(k, lambda: front.submit("B", (prog(k), 2), banks=2)),
            admission(k, lambda: front.submit("C", (prog(k), 2), banks=5,
                                              queue=True)),
            admission(k, lambda: front.submit("A", (prog(k), 1), banks=1)),
            admission(k, lambda: front.submit("D", (prog(k), 1), banks=0)),
            admission(k, lambda: front.submit("E", [], banks=1))]


def sc_queued_tenant_admitted_at_step_boundary(k):
    front = k.make(cfg_of(k, banks=2))
    front.submit("A", (prog(k, 0), 2), banks=2)
    assert front.submit("B", (prog(k, 1), 3), banks=1, queue=True) is None
    assert front.pending == ("B",)
    results = front.run()
    assert front.pending == () and front.active == ()
    assert front.report("A").n_steps == 2
    assert front.report("B").n_steps == 3
    return [step_obs(r) for r in results], front_obs(k, front)


def sc_hostile_tenant_rejected_with_diagnostics(k):
    bad = k.pim.PimProgram.from_trace(open(FIXTURE).read())
    cfg = k.pim.DeviceConfig(channels=1, ranks=1, banks_per_rank=2,
                             num_rows=16, words=2)
    front = k.make(cfg)
    err = admission(k, lambda: front.submit("evil", (bad, 2), banks=1))
    assert "PIM104" in err[2]
    assert front.free_banks == (0, 1)
    good = k.pim.ProgramBuilder(16, 2)
    good.write_row(2, np.zeros(2, np.uint32))
    good.read_row(2)
    front.submit("good", (good.build(), 1), banks=1)
    results = front.run()
    assert front.report("good").n_steps == 1
    return err, [step_obs(r) for r in results], front_obs(k, front)


def sc_shape_and_type_rejected(k):
    front = k.make(cfg_of(k))
    return [admission(k, lambda: front.submit(
                "A", (prog(k, words=2, seed=0), 1), banks=1)),
            admission(k, lambda: front.submit("B", [["not a program"]],
                                              banks=1))]


def sc_copy_escape_rejected_as_pim301(k):
    front = k.make(cfg_of(k, banks=4))
    err = admission(k, lambda: front.submit(
        "A", ([prog(k, copy_to=1)], 1), banks=1))
    assert "PIM301" in err[2]
    return err


def sc_confined_copy_relocated_through_placement(k):
    front = k.make(cfg_of(k, banks=4))
    front.submit("filler", (prog(k, 9), 1), banks=2)
    p = front.submit("C", ([prog(k, 0, copy_to=1), None], 1), banks=2)
    assert p.banks == (2, 3)
    reloc = front._active["C"].steps[0][0]
    copies = [op for op in reloc.ops if op.op == k.pim.ir.OP_COPY]
    assert copies and copies[0].delta == 3     # local bank 1 -> device 3
    res = front.step()
    expect = np.asarray(res.tenant_reads("C")[0])[0]
    got = k.numpy(res.result.state.banks.bits[3][5]).view(np.uint32)
    np.testing.assert_array_equal(got, expect)
    return step_obs(res), front_obs(k, front)


def sc_copy_free_programs_not_rewritten(k):
    front = k.make(cfg_of(k, banks=4))
    p = prog(k, 0)
    front.submit("filler", (prog(k, 9), 1), banks=1)
    front.submit("A", (p, 2), banks=1)
    assert front._active["A"].steps[0][0] is p
    return front.placement("A").slots


def sc_identical_streams_coalesce_across_tenants(k):
    front = k.make(cfg_of(k, banks=4))
    shared = prog(k, 7)
    for tid, banks in (("A", 2), ("B", 1), ("C", 1)):
        front.submit(tid, (shared, 2), banks=banks)
    res = front.step()
    assert (res.n_active_slots, res.n_groups, res.coalescing) == (4, 1, 4.0)
    return step_obs(res), front_obs(k, front)


def sc_same_stream_different_payloads_still_coalesce(k):
    front = k.make(cfg_of(k, banks=2))
    front.submit("A", (prog(k, 0), 1), banks=1)
    front.submit("B", (prog(k, 1), 1), banks=1)
    res = front.step()
    assert res.n_groups == 1 and res.coalescing == 2.0
    return step_obs(res), front_obs(k, front)


def sc_distinct_streams_do_not_coalesce(k):
    other = k.pim.ProgramBuilder(ROWS, WORDS)
    other.write_row(2, np.zeros(WORDS, np.uint32))
    other.shift_k(2, 6, 2)
    other.read_row(6)
    front = k.make(cfg_of(k, banks=2))
    front.submit("A", (prog(k, 0), 1), banks=1)
    front.submit("B", (other.build(), 1), banks=1)
    res = front.step()
    assert res.n_groups == 2 and res.coalescing == 1.0
    return step_obs(res), front_obs(k, front)


def sc_departure_keeps_surviving_plan_warm(k):
    stats = k.sched.SCHED_STATS
    k.sched._plan_cache.clear()     # an earlier scenario may hold A+B's plan
    front = k.make(cfg_of(k, banks=4))
    front.submit("A", (prog(k, 1), 10), banks=2)
    front.step()
    front.step()
    misses = [stats["plan_misses"]]
    front.submit("B", (prog(k, 2), 2), banks=1)
    front.step()
    misses.append(stats["plan_misses"])
    front.step()
    assert front.active == ("A",)
    front.step()
    misses.append(stats["plan_misses"])
    assert misses == [1, 2, 2]
    return misses, front_obs(k, front)


def sc_run_pipelines_recurring_windows_single_dispatch(k):
    stats = k.sched.SCHED_STATS
    front = k.make(cfg_of(k, banks=4))
    front.submit("A", (prog(k, 0), 8), banks=2)
    front.submit("B", (prog(k, 1), 8), banks=2)
    d0 = stats["dispatches"]
    results = front.run(chunk=8)
    assert sum(r.n_steps for r in results) == 8
    assert stats["dispatches"] - d0 == 1
    assert all(front.report(t).n_steps == 8 for t in ("A", "B"))
    return [step_obs(r) for r in results], front_obs(k, front)


def sc_run_windows_break_at_membership_changes(k):
    front = k.make(cfg_of(k, banks=2))
    front.submit("A", (prog(k, 0), 6), banks=1)
    front.submit("B", (prog(k, 1), 2), banks=1)
    front.submit("C", (prog(k, 2), 3), banks=1, queue=True)
    results = front.run(chunk=64)
    assert [r.n_steps for r in results] == [2, 3, 1]
    assert front.report("C").n_steps == 3
    return [step_obs(r) for r in results], front_obs(k, front)


def sc_same_digest_steps_pipeline_even_as_distinct_objects(k):
    stats = k.sched.SCHED_STATS
    front = k.make(cfg_of(k, banks=2))
    front.submit("A", [prog(k, 0), prog(k, 1), prog(k, 2)], banks=1)
    d0 = stats["dispatches"]
    results = front.run()
    assert sum(r.n_steps for r in results) == 3
    assert stats["dispatches"] - d0 == 1
    return [step_obs(r) for r in results], front_obs(k, front)


def sc_non_recurring_steps_fall_back_to_per_step(k):
    def variant(n):
        b = k.pim.ProgramBuilder(ROWS, WORDS)
        b.write_row(2, np.zeros(WORDS, np.uint32))
        b.shift_k(2, 6, n)
        b.read_row(6)
        return b.build()

    stats = k.sched.SCHED_STATS
    front = k.make(cfg_of(k, banks=2))
    front.submit("A", [variant(1), variant(2), variant(3)], banks=1)
    d0 = stats["dispatches"]
    results = front.run()
    assert sum(r.n_steps for r in results) == 3
    assert stats["dispatches"] - d0 == 3
    return [step_obs(r) for r in results], front_obs(k, front)


def sc_depart_preempts_and_frees_banks(k):
    front = k.make(cfg_of(k, banks=4))
    front.submit("A", (prog(k, 0), 100), banks=3)
    front.step()
    rep = front.depart("A")
    assert rep.n_steps == 1
    assert front.free_banks == (0, 1, 2, 3)
    assert front.report("A").n_steps == 1
    with pytest.raises(KeyError):
        front.depart("A")
    front.submit("Q", (prog(k, 1), 1), banks=4)
    assert front.submit("R", (prog(k, 2), 1), banks=1, queue=True) is None
    pending = front.depart("R")               # a queued tenant departs
    return report_obs(rep), report_obs(pending), front_obs(k, front)


def sc_step_with_no_tenants_raises(k):
    front = k.make(cfg_of(k))
    with pytest.raises(RuntimeError, match="no active tenants") as ei:
        front.step()
    return str(ei.value)


def sc_tenant_accounting_reconciles_with_device(k):
    front = k.make(cfg_of(k, banks=4))
    front.submit("A", (prog(k, 0), 5), banks=2)
    front.submit("B", (prog(k, 1), 3), banks=1)
    results = front.run()
    front.submit("C", (prog(k, 2), 4), banks=3)   # reuses freed banks
    results += front.run()
    rec = front.reconcile()
    assert rec["tenant_busy_ns"] == pytest.approx(rec["device_busy_ns"],
                                                  rel=1e-9)
    assert rec["tenant_energy_nj"] == pytest.approx(
        rec["device_energy_nj"], rel=1e-9)
    assert rec["tenant_host_bytes"] == rec["device_host_bytes"]
    assert rec["device_steps"] == 5 + 4
    return [step_obs(r) for r in results], front_obs(k, front)


def sc_tenant_report_walls_and_percentiles(k):
    front = k.make(cfg_of(k, banks=2))
    front.submit("A", (prog(k, 0), 4), banks=1)
    results = front.run(chunk=2)
    rep = front.report("A")
    assert rep.wall_ns.shape == (4,)
    assert rep.p50_wall_ns > 0
    assert rep.p99_wall_ns >= rep.p50_wall_ns
    assert rep.busy_ns > 0 and rep.energy_nj > 0
    assert rep.host_bytes == 4 * prog(k, 0).host_bytes
    return [step_obs(r) for r in results], report_obs(rep)


def sc_live_report_tracks_progress(k):
    front = k.make(cfg_of(k, banks=2))
    front.submit("A", (prog(k, 0), 3), banks=1)
    front.step()
    r1 = front.report("A")
    front.step()
    r2 = front.report("A")
    assert r1.n_steps == 1 and r2.n_steps == 2
    assert r2.energy_nj > r1.energy_nj
    return report_obs(r1), report_obs(r2)


def sc_async_refresh_front(k):
    """The scheduler flags every shared step carries: async host transfers
    and periodic refresh, over a recurring window and a single step."""
    front = k.make(cfg_of(k, banks=4, subarrays=2), refresh=True,
                   async_host=True)
    front.submit("A", (prog(k, 3), 3), banks=2)
    front.submit("B", [prog(k, 4), prog(k, 5, copy_to=0)], banks=1)
    results = front.run()
    return [step_obs(r) for r in results], front_obs(k, front)


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items())
             if name.startswith("sc_")}
