"""Parity of the port's multi-step paths with the JAX reference, on the CPU:
``make_pipeline_runner``/``make_workload_runner`` against the reference's
per-step ``execute()`` loop, ``schedule_pipeline``/``schedule_workload``
(back to back and with ``order=``) against the reference's per-step
``schedule()`` loop, and ``PimVM.run_pipeline``/``run_workload`` against
the reference VM's.

The reference's own ``schedule_pipeline`` is not the yardstick: its XLA
compile has crashed under load (ROADMAP §C); its per-step loop is what the
reference defines the pipeline to equal. 8 slots and up to 40 steps, and
16, 32 and 64 slots (``paper_device(n, 32, 8, subarrays=2)``) for the
energy sums, whose order is XLA's (``compile.xla_sum``); the workload plan
(``PipelinePlan``) and its signature against the reference's.
Tolerance: exact — rows, reads and integer meters equal; float32 meters,
per-step ``wall_ns``/``energy_nj`` and hidden host time equal as float32
bit patterns.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pim as ref  # noqa: E402
from repro.core.bitplane import PimVM as RefVM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pim as port  # noqa: E402
from repro_torch.core.bitplane import PimVM as PortVM  # noqa: E402
from test_torch_pim_schedule import (FLOAT_FIELDS, INT_FIELDS, ROWS,  # noqa: E402,E501
                                     WIDE_BANKS, WORDS, assert_device_equal,
                                     configs, f32_bits, stream_pool,
                                     to_port_layout, wide_configs,
                                     wide_layout)


def rand_row(rng, words=WORDS):
    return rng.integers(0, 2**32, (words,), dtype=np.uint32)


def with_fresh_payloads(prog, seed):
    rng = np.random.default_rng(seed)
    return prog.with_payloads([rand_row(rng, p.shape[0])
                               for p in prog.payloads])


def assert_subarray_equal(r_state, p_state, what=""):
    got = convert.to_numpy(p_state)
    for f in ("bits", "mig_top", "mig_bot", "dcc"):
        assert np.array_equal(np.asarray(getattr(r_state, f)), got[f]), \
            f"{what}: {f}"
    for f in FLOAT_FIELDS:
        assert np.array_equal(f32_bits(getattr(r_state.meter, f)),
                              f32_bits(got[f])), f"{what}: meter.{f}"
    for f in INT_FIELDS:
        assert np.array_equal(np.asarray(getattr(r_state.meter, f)),
                              got[f]), f"{what}: meter.{f}"


def mixed_program(seed, n_ops=8):
    """Two host writes, ``n_ops`` random commands (fused shift chains,
    Ambit XOR/MAJ/NOT, TRA, local COPY, host reads), then a shift, an XOR
    and two host reads: every step carries data in and out."""
    rng = np.random.default_rng(seed)
    b = ref.ProgramBuilder(ROWS, WORDS)
    b.issue().write_row(3, rand_row(rng)).write_row(7, rand_row(rng))
    for kind in rng.choice(("xor", "chain", "maj", "not", "tra", "copy",
                            "read"), n_ops):
        r = [int(x) for x in rng.choice(ROWS - 8, 4, replace=False)]
        if kind == "xor":
            b.ambit_xor(r[0], r[1], r[2])
        elif kind == "chain":
            b.shift_k(r[0], r[1], int(rng.choice([-1, 1]))
                      * int(rng.integers(2, 50)))
        elif kind == "maj":
            b.ambit_maj(*r)
        elif kind == "not":
            b.ambit_not(r[0], r[1])
        elif kind == "tra":
            b.tra(r[0], r[1], r[2])
        elif kind == "copy":
            b.copy_row(r[0], r[1])
        else:
            b.read_row(r[0])
    b.shift_k(3, 11, 5).ambit_xor(7, 11, 12)
    b.read_row(12)
    b.read_row(7)
    return b.build()


def port_program(prog):
    return port.PimProgram.from_trace(prog.to_trace())


def payload_steps(progs):
    return torch.from_numpy(np.stack([np.stack(p.payloads) for p in progs])
                            .astype(np.uint32).view(np.int32))


def exec_per_step(prog_steps, refresh):
    """The reference's per-step ``execute`` loop: final state and reads."""
    state = ref.make_subarray(ROWS, WORDS)
    reads = []
    for p in prog_steps:
        res = ref.execute(p, state, refresh=refresh)
        state = res.state
        reads.append(res.reads)
    return state, reads


# ---------------------------------------------------------------------------
# exec runners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("refresh", [False, True])
def test_pipeline_runner_matches_per_step_execute(refresh):
    base = mixed_program(1, 14)
    steps = [with_fresh_payloads(base, 10 + k) for k in range(5)]
    r_state, r_reads = exec_per_step(steps, refresh)
    pipe = port.make_pipeline_runner(port_program(base), refresh=refresh)
    p_state, p_reads = pipe(port.make_subarray(ROWS, WORDS, device="cpu"),
                            payload_steps(steps))
    assert_subarray_equal(r_state, p_state, "pipeline")
    assert len(p_reads) == base.n_reads
    for j, rows in enumerate(p_reads):
        assert tuple(rows.shape) == (5, WORDS)
        for k in range(5):
            assert np.array_equal(np.asarray(r_reads[k][j]),
                                  rows[k].numpy().view(np.uint32)), (k, j)


def test_workload_runner_matches_per_step_execute():
    progs = [mixed_program(s, n) for s, n in ((3, 10), (5, 16), (7, 6))]
    counts = (3, 2, 4)
    steps = [[with_fresh_payloads(p, 100 * i + k) for k in range(n)]
             for i, (p, n) in enumerate(zip(progs, counts))]
    r_state, r_reads = exec_per_step([q for s in steps for q in s], False)
    runner = port.make_workload_runner([port_program(p) for p in progs])
    p_state, p_reads = runner(port.make_subarray(ROWS, WORDS, device="cpu"),
                              tuple(payload_steps(s) for s in steps))
    assert_subarray_equal(r_state, p_state, "workload")
    flat = [(p, k) for p, n in enumerate(counts) for k in range(n)]
    for t, (p, k) in enumerate(flat):
        for j, rows in enumerate(p_reads[p]):
            assert np.array_equal(np.asarray(r_reads[t][j]),
                                  rows[k].numpy().view(np.uint32))


def test_runners_are_cached():
    prog = port_program(ref.shift_workload_program(9, ROWS, WORDS))
    compiled = port.compile_program(prog)
    port.reset_stats()
    a = port.make_pipeline_runner(compiled)
    b = port.make_pipeline_runner(compiled)
    w1 = port.make_workload_runner([compiled, compiled])
    w2 = port.make_workload_runner([compiled, compiled])
    assert a is b and w1 is w2
    assert port.RUNNER_STATS["traces"] == 3    # base, pipeline, workload
    state, reads = a(port.make_subarray(ROWS, WORDS, device="cpu"),
                     torch.zeros((3, 0, WORDS), dtype=torch.int32))
    assert reads == () and int(state.meter.n_shift) == 27


# ---------------------------------------------------------------------------
# schedule_pipeline / schedule_workload
# ---------------------------------------------------------------------------

def pipeline_layout(cfg, seed, k):
    """One step of a recurring 8-slot layout: the streams stay, the HOSTW
    data changes with ``k``; a cross-bank COPY recurs every step."""
    flat = [mixed_program(seed + s) if s != 4 else None
            for s in range(cfg.n_slots)]
    flat[1] = ref.shift_workload_program(20, ROWS, WORDS)
    flat = [p if p is None or not p.payloads
            else with_fresh_payloads(p, 1000 * k + s)
            for s, p in enumerate(flat)]
    return ref.gather_rows(cfg, [((0, 0, 1), (2, 1, 5))], flat)


def ref_step_loop(dev, layouts, flags_per_step):
    results = []
    for layout, flags in zip(layouts, flags_per_step):
        r = ref.schedule(dev, layout, **flags)
        results.append(r)
        dev = r.state
    return dev, results


def assert_step(r, p_wall, p_energy, p_reads, what):
    assert f32_bits(r.wall_ns) == f32_bits(p_wall), what
    assert f32_bits(r.energy_nj) == f32_bits(p_energy), what
    assert len(r.reads) == len(p_reads)
    for slot, (rr, pr) in enumerate(zip(r.reads, p_reads)):
        assert len(rr) == len(pr), (what, slot)
        for x, y in zip(rr, pr):
            assert np.array_equal(np.asarray(x), y), (what, slot)


@pytest.mark.parametrize("async_host,refresh", [(False, False),
                                                (True, False), (True, True)])
def test_schedule_pipeline_matches_per_step_schedule(async_host, refresh):
    cfg_r, cfg_p = configs()
    K = 4
    layouts = [pipeline_layout(cfg_r, 7, k) for k in range(K)]
    flags = dict(async_host=async_host, refresh=refresh)
    r_dev, r_res = ref_step_loop(ref.make_device(cfg_r), layouts,
                                 [flags] * K)
    p_dev0 = port.make_device(cfg_p, device="cpu")
    res = port.schedule_pipeline(
        p_dev0, [to_port_layout(cfg_r, lay) for lay in layouts], **flags)
    assert res.n_steps == K and tuple(res.wall_ns.shape) == (K,)
    assert_device_equal(r_dev, res.state, "pipeline final")
    for k, r in enumerate(r_res):
        assert_step(r, res.wall_ns[k], res.energy_nj[k], res.reads[k],
                    f"step {k}")
        if async_host:
            assert f32_bits(r.host_overlap_ns) == f32_bits(
                res.host_overlap_ns_lazy[k])
    if not async_host:
        assert res.host_overlap_ns_lazy == 0.0
    for f in ("bus_ns", "host_bytes", "copy_ns", "copy_total_ns",
              "copy_queue_ns", "rank_switch_ns", "link_busy_ns"):
        assert getattr(res, f) == getattr(r_res[0], f), f
    total = np.float32(0.0)
    for r in r_res:
        total = np.float32(total + np.float32(r.wall_ns))
    assert f32_bits(res.total_wall_ns) == f32_bits(total)
    assert int(p_dev0.banks.meter.n_act.sum()) == 0   # caller untouched


def test_schedule_pipeline_replays_one_layout():
    cfg_r, cfg_p = configs()
    layout = pipeline_layout(cfg_r, 3, 0)
    r_dev, r_res = ref_step_loop(ref.make_device(cfg_r), [layout] * 3,
                                 [{"async_host": True}] * 3)
    res = port.schedule_pipeline(port.make_device(cfg_p, device="cpu"),
                                 to_port_layout(cfg_r, layout), n_steps=3,
                                 async_host=True, donate=True)
    assert_device_equal(r_dev, res.state, "replay")
    for k, r in enumerate(r_res):
        assert_step(r, res.wall_ns[k], res.energy_nj[k], res.reads[k], k)
    hidden = [np.float32(r.host_overlap_ns) for r in r_res]
    acc = np.float32(0.0)
    for h in hidden:
        acc = np.float32(acc + h)
    assert f32_bits(res.host_overlap_ns) == f32_bits(acc)


def workload_phases(cfg, order_counts=(3, 2, 2)):
    """Three phases with different streams: a compute phase, a copy-only
    gather, and a host-write phase."""
    a = [pipeline_layout(cfg, 11, k) for k in range(order_counts[0])]
    gather = ref.gather_rows(cfg, [((1, 0, 3), (0, 1, 6)),
                                   ((3, 1, 2), (1, 0, 7))])
    b = [gather] * order_counts[1]
    c = [pipeline_layout(cfg, 29, k) for k in range(order_counts[2])]
    return [a, b, c]


@pytest.mark.parametrize("order", [None, (0, 2, 1, 0, 2, 1, 0)])
def test_schedule_workload_matches_per_step_schedule(order):
    cfg_r, cfg_p = configs()
    phases = workload_phases(cfg_r)
    phase_async = (True, None, False)        # None inherits async_host=True
    seq = order if order is not None else (0, 0, 0, 1, 1, 2, 2)
    cursor = [0, 0, 0]
    layouts, flags = [], []
    for p in seq:
        layouts.append(phases[p][cursor[p]])
        cursor[p] += 1
        a_h = True if phase_async[p] is None else phase_async[p]
        flags.append({"async_host": a_h})
    r_dev, r_res = ref_step_loop(ref.make_device(cfg_r), layouts, flags)

    port_phases = [
        port.Phase(steps=tuple(to_port_layout(cfg_r, lay) for lay in ph),
                   async_host=a)
        for ph, a in zip(phases, phase_async)]
    res = port.schedule_workload(port.make_device(cfg_p, device="cpu"),
                                 port_phases, order=order, async_host=True)
    assert res.order == (None if order is None else tuple(order))
    assert res.n_steps == 7
    assert_device_equal(r_dev, res.state, "workload final")
    taken = [0, 0, 0]
    for t, p in enumerate(seq):
        k = taken[p]
        taken[p] += 1
        pr = res.phases[p]
        assert_step(r_res[t], pr.wall_ns[k], pr.energy_nj[k], pr.reads[k],
                    f"step {t} (phase {p}, {k})")
        if flags[t]["async_host"]:
            assert f32_bits(r_res[t].host_overlap_ns) == f32_bits(
                pr.host_overlap_ns_lazy[k])
        if k == len(phases[p]) - 1:
            assert f32_bits(pr.boundary_credit_ns) == f32_bits(
                r_res[t].state.host_credit_ns)
    assert res.phases[2].host_overlap_ns_lazy == 0.0
    assert res.phases[1].copy_ns == r_res[seq.index(1)].copy_ns > 0


def test_schedule_workload_descriptor_forms():
    """A ``(layout, n_steps)`` pair and a bare per-step sequence lower like
    explicit Phases."""
    cfg_r, cfg_p = configs()
    lay = to_port_layout(cfg_r, pipeline_layout(cfg_r, 5, 0))
    a = port.schedule_workload(port.make_device(cfg_p, device="cpu"),
                               [(lay, 2), [lay]])
    b = port.schedule_workload(port.make_device(cfg_p, device="cpu"),
                               [port.Phase.repeat(lay, 2),
                                port.Phase(steps=(lay,))])
    assert [p.n_steps for p in a.phases] == [2, 1]
    assert torch.equal(a.state.banks.bits, b.state.banks.bits)
    assert f32_bits(a.total_energy_nj) == f32_bits(b.total_energy_nj)


def test_recurring_layout_errors():
    cfg_r, cfg_p = configs()
    dev = port.make_device(cfg_p, device="cpu")
    s1 = to_port_layout(cfg_r, pipeline_layout(cfg_r, 7, 0))
    s2 = to_port_layout(cfg_r, pipeline_layout(cfg_r, 8, 0))
    with pytest.raises(ValueError, match="pipeline step 1 does not recur"):
        port.schedule_pipeline(dev, [s1, s2])
    with pytest.raises(ValueError, match="at least one step"):
        port.schedule_pipeline(dev, [])
    with pytest.raises(ValueError, match="workload phase 0 step 1 does not "
                                         "recur"):
        port.schedule_workload(dev, [[s1, s2]])
    with pytest.raises(ValueError, match="has no steps"):
        port.schedule_workload(dev, [[s1], []])
    with pytest.raises(ValueError, match="at least one phase"):
        port.schedule_workload(dev, [])
    with pytest.raises(ValueError, match="out of range"):
        port.schedule_workload(dev, [[s1], [s2]], order=[0, 2])
    with pytest.raises(ValueError, match="consumed FIFO"):
        port.schedule_workload(dev, [[s1], [s2]], order=[0, 0])
    # verify=True lints the layout (clean here) and runs it unchanged
    for fn, arg in ((port.schedule_pipeline, [s1]),
                    (port.schedule_workload, [[s1]])):
        got = fn(dev, arg, verify=True)
        want = fn(dev, arg)
        assert torch.equal(got.state.banks.bits, want.state.banks.bits)


# ---------------------------------------------------------------------------
# Wide devices (16, 32 and 64 slots) and the workload plan
# ---------------------------------------------------------------------------

def fresh_layout(layout, seed):
    """The same streams with new HOSTW data (a recurring layout's next
    step)."""
    return [p if p is None or not p.payloads else
            with_fresh_payloads(p, seed + s) for s, p in enumerate(layout)]


@pytest.mark.parametrize("n_banks", WIDE_BANKS)
def test_pipeline_and_workload_match_on_wide_devices(n_banks):
    """``schedule_pipeline`` (async) and a two-phase ``schedule_workload``
    (the pipeline's layout, then a sync phase of another layout) at 16, 32
    and 64 slots against the reference's per-step ``schedule()``: states,
    reads and per-step wall, energy and hidden host time bit for bit, and
    the totals against the reference's eager ``jnp.sum``."""
    cfg_r, cfg_p = wide_configs(n_banks)
    rng = np.random.default_rng(40 + n_banks)
    pool = stream_pool(rng)
    base = wide_layout(cfg_r, rng, pool)
    steps = [fresh_layout(base, 100 * k) for k in range(3)]
    other = wide_layout(cfg_r, rng, pool, copies=False)
    flags = [{"async_host": True}] * 3
    r_dev, r_res = ref_step_loop(ref.make_device(cfg_r), steps, flags)
    res = port.schedule_pipeline(
        port.make_device(cfg_p, device="cpu"),
        [to_port_layout(cfg_r, lay) for lay in steps], async_host=True)
    assert_device_equal(r_dev, res.state, f"{cfg_r.n_slots} slots")
    for k, r in enumerate(r_res):
        assert_step(r, res.wall_ns[k], res.energy_nj[k], res.reads[k],
                    f"step {k}")
        assert f32_bits(r.host_overlap_ns) == f32_bits(
            res.host_overlap_ns_lazy[k])
    walls = jnp.asarray([r.wall_ns for r in r_res])
    assert f32_bits(res.total_wall_ns) == f32_bits(jnp.sum(walls))

    r_dev2, r_res2 = ref_step_loop(r_dev, [other] * 2, [{}] * 2)
    wl = port.schedule_workload(
        port.make_device(cfg_p, device="cpu"),
        [port.Phase(steps=tuple(to_port_layout(cfg_r, lay)
                                for lay in steps)),
         port.Phase.repeat(to_port_layout(cfg_r, other), 2,
                           async_host=False)], async_host=True)
    assert_device_equal(r_dev2, wl.state, "workload")
    for pr, rs in zip(wl.phases, (r_res, r_res2)):
        for k, r in enumerate(rs):
            assert_step(r, pr.wall_ns[k], pr.energy_nj[k], pr.reads[k], k)
    energies = [jnp.asarray([r.energy_nj for r in rs])
                for rs in (r_res, r_res2)]
    assert f32_bits(wl.total_energy_nj) == f32_bits(
        np.float32(sum(float(jnp.sum(e)) for e in energies)))


def test_pipeline_totals_past_one_window():
    """40 replayed steps: ``total_wall_ns`` and ``host_overlap_ns`` sum
    past XLA's 32-wide reduce window, as the reference's eager
    ``jnp.sum`` does."""
    cfg_r, cfg_p = configs()
    layout = pipeline_layout(cfg_r, 3, 0)
    r_dev, r_res = ref_step_loop(ref.make_device(cfg_r), [layout] * 40,
                                 [{"async_host": True}] * 40)
    res = port.schedule_pipeline(port.make_device(cfg_p, device="cpu"),
                                 to_port_layout(cfg_r, layout), n_steps=40,
                                 async_host=True)
    assert_device_equal(r_dev, res.state, "40 steps")
    walls = jnp.asarray([r.wall_ns for r in r_res])
    hidden = jnp.asarray([r.host_overlap_ns for r in r_res])
    assert f32_bits(res.total_wall_ns) == f32_bits(jnp.sum(walls))
    assert f32_bits(res.host_overlap_ns) == f32_bits(jnp.sum(hidden))


def test_workload_plan_identity_and_signature():
    """Counterpart of the reference's
    ``test_workload_plan_identity_is_stable_across_warm_calls``: warm
    ``schedule_workload`` calls with fresh payload data return the SAME
    ``PipelinePlan``, whose 16-byte signature equals the reference's for
    the same phases (both hash the repr of the same plan keys)."""
    import importlib
    ref_sched = importlib.import_module("repro.core.pim.schedule")
    port_sched = importlib.import_module("repro_torch.core.pim.schedule")
    cfg_r, cfg_p = configs()
    phases = workload_phases(cfg_r)

    def port_phases(k):
        return [[to_port_layout(cfg_r, fresh_layout(lay, 1000 * k))
                 for lay in ph] for ph in phases]

    port.schedule_workload(port.make_device(cfg_p, device="cpu"),
                           port_phases(0))
    plan = list(port_sched._workload_plan_cache.values())[-1]
    port.schedule_workload(port.make_device(cfg_p, device="cpu"),
                           port_phases(1))
    assert list(port_sched._workload_plan_cache.values())[-1] is plan
    assert isinstance(plan, port.PipelinePlan)
    assert plan.n_steps == (3, 2, 2) and plan.async_host == (False,) * 3
    assert isinstance(plan.signature, bytes) and len(plan.signature) == 16
    ref.schedule_workload(ref.make_device(cfg_r), phases)
    ref_plan = list(ref_sched._workload_plan_cache.values())[-1]
    assert ref_plan.signature == plan.signature


# ---------------------------------------------------------------------------
# PimVM.run_pipeline / run_workload
# ---------------------------------------------------------------------------

def _vm_step(vm, x):
    a = vm.load(x[0])
    b = vm.load(x[1])
    r = vm.xor(a, b)
    s = vm.shift_elem(r, 1)
    vm.free(a, b, r)
    return s


def _vm_pair_step(vm, x):
    a = vm.load(x[0])
    b = vm.load(x[1])
    r = vm.and_(a, b)
    s = vm.not_(r)
    vm.free(a, b)
    return [r, s]


def vm_meters(vm):
    return [f32_bits(m) for m in (vm.time_ns, vm.energy_nj,
                                  vm.setup_energy_nj, vm.host_overlap_ns)]


@pytest.mark.parametrize("n_banks", [1, 4])
def test_vm_run_pipeline_matches_reference(n_banks):
    out = []
    for make in (RefVM, lambda **k: PortVM(device="cpu", **k)):
        rng = np.random.default_rng(11)
        vm = make(width=8, num_rows=96, words=16, n_banks=n_banks,
                  async_host=n_banks > 1)
        vm.mask(0xFE)                   # pre-create the shift mask
        xs = [(rng.integers(0, 256, vm.lanes), rng.integers(0, 256, vm.lanes))
              for _ in range(3)]
        got = vm.run_pipeline(_vm_step, xs)
        got2 = vm.run_pipeline(_vm_pair_step, xs[:2])
        out.append((got, got2, vm.counts(), vm_meters(vm), xs))
    (rg, rg2, rc, rm, xs), (pg, pg2, pc, pm, _) = out
    for k, (a, b) in enumerate(xs):
        assert np.array_equal(pg[k], ((a ^ b) << 1) & 0xFF), k
        assert np.array_equal(pg[k], rg[k])
    for r, p in zip(rg2, pg2):
        assert all(np.array_equal(x, y) for x, y in zip(r, p))
    assert rc == pc and rm == pm


@pytest.mark.parametrize("n_banks", [1, 2])
def test_vm_run_workload_matches_reference(n_banks):
    out = []
    for make in (RefVM, lambda **k: PortVM(device="cpu", **k)):
        rng = np.random.default_rng(10)
        vm = make(width=8, num_rows=96, words=8, n_banks=n_banks,
                  async_host=n_banks > 1)
        vm.mask(0xFE)
        xs_a = [(rng.integers(0, 256, vm.lanes),
                 rng.integers(0, 256, vm.lanes)) for _ in range(3)]
        xs_b = [(rng.integers(0, 256, vm.lanes),
                 rng.integers(0, 256, vm.lanes)) for _ in range(2)]
        got_a, got_b = vm.run_workload([(_vm_step, xs_a),
                                        (_vm_pair_step, xs_b)])
        out.append((got_a, got_b, vm.counts(), vm_meters(vm), xs_b))
    (ra, rb, rc, rm, xs_b), (pa, pb, pc, pm, _) = out
    assert all(np.array_equal(x, y) for x, y in zip(ra, pa))
    for k, (a, b) in enumerate(xs_b):
        assert np.array_equal(pb[k][1], (~(a & b)) & 0xFF), k
        assert all(np.array_equal(x, y) for x, y in zip(rb[k], pb[k]))
    assert rc == pc and rm == pm


def test_vm_divergent_steps_raise():
    vm = PortVM(width=8, num_rows=96, words=16, device="cpu")
    rng = np.random.default_rng(12)
    calls = {"n": 0}

    def bad_step(vm, x):
        calls["n"] += 1
        a = vm.load(x)
        return vm.not_(a) if calls["n"] > 1 else a

    xs = [rng.integers(0, 256, vm.lanes) for _ in range(2)]
    with pytest.raises(ValueError, match="pipeline step 1 recorded a "
                                         "different"):
        vm.run_pipeline(bad_step, xs)
    calls["n"] = 0
    with pytest.raises(ValueError, match="workload phase 0 step 1 recorded "
                                         "a different"):
        vm.run_workload([(bad_step, xs)])
