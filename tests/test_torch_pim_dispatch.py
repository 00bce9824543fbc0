"""The port's counterpart of the reference's single-dispatch contracts, on
the CPU: the identity fast path of ``schedule_workload`` (the reference's
``_layout_ids``, ``_phase_lower_cache`` and ``_workload_fast_cache``), the
dispatch and trace counters, the step payload stacks, the meter stacks a
CUDA graph copies in one piece, and the card's sync-free refresh count.

On the CPU every call runs eagerly (a CUDA graph is the card's); the card's
replays are held against these eager runs in ``tests/test_torch_cuda.py``
(``-k pim_graph``). Results are held against the reference's per-step
``schedule()`` loop, which the reference defines its workload to equal (its
own ``schedule_workload`` compile has crashed under load, ROADMAP C4).
Tolerance: exact — rows, reads and integer meters equal, float32 meters
and per-step ``wall_ns``/``energy_nj`` equal as bit patterns.
"""
import dataclasses
import gc
import importlib
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import pim as ref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pim as port  # noqa: E402
from repro_torch.core.pim import exec as port_exec  # noqa: E402
from repro_torch.core.pim import graphs  # noqa: E402
from repro_torch.core.pim import ir as port_ir  # noqa: E402
from repro_torch.core.pim import timing as port_timing  # noqa: E402
from test_torch_pim_schedule import assert_device_equal, f32_bits  # noqa: E402,E501

port_sched = importlib.import_module("repro_torch.core.pim.schedule")

ROWS, WORDS = 32, 8


def rand_row(rng):
    return rng.integers(0, 2**32, (WORDS,), dtype=np.uint32)


def cfgs(banks=4):
    return tuple(m.DeviceConfig(channels=1, ranks=1, banks_per_rank=banks,
                                num_rows=ROWS, words=WORDS)
                 for m in (ref, port))


def compute_prog(m, data, k=4):
    b = m.ProgramBuilder(ROWS, WORDS)
    b.issue().write_row(0, data).shift_k(0, 1, k).ambit_xor(0, 1, 2)
    b.read_row(2)
    return b.build()


def readback_prog(m, rows=(0, 2)):
    b = m.ProgramBuilder(ROWS, WORDS)
    for r in rows:
        b.read_row(r)
    return b.build()


def workload(m, cfg, seed):
    """compute (fresh payloads per step) -> gather COPYs -> readback, the
    reference test's workload, built in package ``m`` from ``seed``."""
    rng = np.random.default_rng(seed)
    layout = [compute_prog(m, rand_row(rng), k=3), None,
              compute_prog(m, rand_row(rng), k=5), None]
    compute = m.Phase(steps=tuple(
        [p.with_payloads([rand_row(rng)]) if p is not None else None
         for p in layout] for _ in range(3)), async_host=True)
    gather = m.gather_rows(cfg, [((0, 0, 2), (1, 0, 4)),
                                 ((2, 0, 2), (3, 0, 4))])
    readback = [readback_prog(m, (4,)) if b in (1, 3) else None
                for b in range(4)]
    return [compute, m.Phase.repeat(gather, 2),
            m.Phase.repeat(readback, 1, async_host=True)]


def ref_per_step(cfg, phases, dev=None):
    """The reference's per-step schedule() loop over ``phases`` (from
    ``dev``, else a fresh device): the final device and, per phase, per
    step (reads, wall, energy)."""
    dev = ref.make_device(cfg) if dev is None else dev
    out = [[] for _ in phases]
    for p, ph in enumerate(phases):
        for step in ph.steps:
            r = ref.schedule(dev, step, async_host=bool(ph.async_host))
            dev = r.state
            out[p].append((r.reads, f32_bits(r.wall_ns),
                           f32_bits(r.energy_nj)))
    return dev, out


def assert_workload_equal(r_dev, r_steps, res, what=""):
    assert_device_equal(r_dev, res.state, what)
    for p, ph in enumerate(res.phases):
        walls = f32_bits(ph.wall_ns.numpy())
        energies = f32_bits(ph.energy_nj.numpy())
        for k, (reads, wall, energy) in enumerate(r_steps[p]):
            assert walls[k] == wall and energies[k] == energy, (what, p, k)
            for a, b in zip(reads, ph.reads[k]):
                assert len(a) == len(b)
                assert all(np.array_equal(np.asarray(x), y)
                           for x, y in zip(a, b)), (what, p, k)


class Spy:
    """Counts calls of ``module.name`` within ``with``."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def spy(*a, **kw):
            self.calls += 1
            return self.real(*a, **kw)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


# ---------------------------------------------------------------------------
# The identity fast path
# ---------------------------------------------------------------------------

def test_workload_fast_cache_pins_key_steps():
    """Counterpart of the reference's test of the same name: the cached
    entries pin the steps' programs while cached and release them when
    both id-keyed caches are cleared."""
    rng = np.random.default_rng(23)
    cfg = port.DeviceConfig(channels=1, ranks=1, banks_per_rank=2,
                            num_rows=ROWS, words=WORDS)
    dev = port.make_device(cfg, device="cpu")
    base = compute_prog(port, rand_row(rng))
    layout = [base.with_payloads([rand_row(rng)]) for _ in range(2)]
    phases = [port.Phase.repeat(layout, 2)]
    port.schedule_workload(dev, phases)
    pinned = weakref.ref(layout[0])
    del layout, phases, base
    gc.collect()
    assert pinned() is not None, "cached workload entry dropped its key pin"
    port_sched._workload_fast_cache.clear()
    port_sched._phase_lower_cache.clear()
    # the stream-keyed caches hold a program of each stream (here this
    # one: the test's stream may be new to them), not the layout
    port_sched._workload_plan_cache.clear()
    port_sched._plan_cache.clear()
    port_sched._compile_cache.clear()
    gc.collect()
    assert pinned() is None, "programs leak after workload-cache eviction"


def test_warm_workload_with_fresh_payloads_rebuilds_nothing():
    """Counterpart of the reference's test of the same name: a warm call of
    the same phase sequence with brand-new payload data is cache traffic
    only (no plan, compile, column or runner miss, one dispatch) and gives
    the reference's reads, walls, energies and device bit for bit."""
    r_cfg, p_cfg = cfgs()
    rng = np.random.default_rng(2)
    seeds = [rand_row(rng) for _ in range(2)]

    fixed = {m: (compute_prog(m, seeds[0]),
                 m.gather_rows(cfg, [((0, 0, 2), (1, 0, 4))]),
                 [None, readback_prog(m, (4,)), None, None])
             for m, cfg in ((ref, r_cfg), (port, p_cfg))}

    def make_phases(m, cfg, k):
        # only the payload DATA is fresh; with_payloads shares columns
        rng = np.random.default_rng(100 + k)
        layout, gather, readback = fixed[m]
        compute = m.Phase(steps=tuple(
            [layout.with_payloads([rand_row(rng)]), None, None, None]
            for _ in range(3)))
        return [compute, m.Phase.repeat(gather, 2),
                m.Phase.repeat(readback, 1)]

    port.schedule_workload(port.make_device(p_cfg, device="cpu"),
                           make_phases(port, p_cfg, 0))
    port.reset_stats()
    builds0 = port_ir.COLUMN_STATS["builds"]
    res = port.schedule_workload(port.make_device(p_cfg, device="cpu"),
                                 make_phases(port, p_cfg, 1))
    assert port_sched.SCHED_STATS == {"dispatches": 1, "plan_misses": 0,
                                      "compile_misses": 0}
    assert port_exec.RUNNER_STATS["traces"] == 0
    assert port_ir.COLUMN_STATS["builds"] == builds0
    assert res.n_steps == 6
    r_dev, r_steps = ref_per_step(r_cfg, make_phases(ref, r_cfg, 1))
    assert_workload_equal(r_dev, r_steps, res, "fresh payloads")


def test_warm_workload_with_the_same_steps_lowers_nothing():
    """A warm call whose Phase.steps are the same objects skips the
    recurrence check, the planning and the payload stacking entirely, and
    still equals the reference."""
    r_cfg, p_cfg = cfgs()
    phases = workload(port, p_cfg, 4)
    first = port.schedule_workload(port.make_device(p_cfg, device="cpu"),
                                   phases)
    port.reset_stats()
    with Spy(port_sched, "_lower_recurring") as lower, \
            Spy(port_sched, "_plan_for") as plan, \
            Spy(port_sched, "_steps_payloads") as stack:
        res = port.schedule_workload(first.state, phases)
    assert (lower.calls, plan.calls, stack.calls) == (0, 0, 0)
    assert port_sched.SCHED_STATS["dispatches"] == 1
    r_phases = workload(ref, r_cfg, 4)
    r_dev, _ = ref_per_step(r_cfg, r_phases)
    r_dev, r_steps = ref_per_step(r_cfg, r_phases, r_dev)
    assert_workload_equal(r_dev, r_steps, res, "same steps, warm")


@pytest.mark.parametrize("order", [None, (0, 1, 0, 2, 0, 1)])
def test_layout_mutated_in_place_is_lowered_anew(order):
    """Mutating a step layout (a list) inside the same Phase object swaps a
    program id: neither the fast path nor the lowering memo serves the old
    lowering or the old payloads."""
    r_cfg, p_cfg = cfgs()
    rng = np.random.default_rng(31)
    new_rows = [rand_row(rng) for _ in range(3)]

    def phases_of(m, cfg):
        ph = workload(m, cfg, 5)
        return ph, list(ph[0].steps)

    p_phases, p_steps = phases_of(port, p_cfg)
    port.schedule_workload(port.make_device(p_cfg, device="cpu"), p_phases,
                           order=order)
    r_phases, r_steps = phases_of(ref, r_cfg)
    for m, steps in ((port, p_steps), (ref, r_steps)):
        for k, step in enumerate(steps):
            # new payload data in slot 0, another stream in slot 2
            step[0] = step[0].with_payloads([new_rows[k]])
            step[2] = compute_prog(m, new_rows[k], k=9)
    port.reset_stats()
    with Spy(port_sched, "_lower_recurring") as lower:
        res = port.schedule_workload(port.make_device(p_cfg, device="cpu"),
                                     p_phases, order=order)
    assert lower.calls == 1                 # the mutated phase alone
    if order is None:
        r_dev, r_out = ref_per_step(r_cfg, r_phases)
    else:
        dev, r_out = ref.make_device(r_cfg), [[] for _ in r_phases]
        cursor = [0] * len(r_phases)
        for p in order:
            r = ref.schedule(dev, r_phases[p].steps[cursor[p]],
                             async_host=bool(r_phases[p].async_host))
            cursor[p] += 1
            dev = r.state
            r_out[p].append((r.reads, f32_bits(r.wall_ns),
                             f32_bits(r.energy_nj)))
        r_dev = dev
    assert_workload_equal(r_dev, r_out, res, f"mutated, order={order}")


def test_layout_ids_fingerprint():
    p = compute_prog(port, np.zeros(WORDS, np.uint32))
    q = compute_prog(port, np.zeros(WORDS, np.uint32))
    lay = [p, None, [q, None]]
    ids = port_sched._layout_ids((lay, lay))
    assert ids == ((id(p), id(None), (id(q), id(None))),) * 2
    lay[2][0] = p
    assert port_sched._layout_ids((lay, lay)) != ids
    assert port_sched._layout_ids(({"slot": p},)) is None


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

def test_cpu_dispatch_and_trace_counts():
    """On the CPU every call runs eagerly: one dispatch per schedule(),
    schedule_pipeline() and schedule_workload() call, whatever its steps
    or order (the reference's one XLA dispatch), and warm calls build no
    runner and capture nothing."""
    _, cfg = cfgs()
    phases = workload(port, cfg, 6)
    dev = port.make_device(cfg, device="cpu")
    lay = list(phases[0].steps[0])
    port.schedule(dev, lay)
    port.schedule_pipeline(dev, lay, n_steps=4)
    port.schedule_workload(dev, phases)
    port.schedule_workload(dev, phases, order=(0, 1, 0, 2, 0, 1))
    port.reset_stats()
    port.schedule(dev, lay)
    assert port_sched.SCHED_STATS["dispatches"] == 1
    port.schedule_pipeline(dev, lay, n_steps=4)
    assert port_sched.SCHED_STATS["dispatches"] == 2
    port.schedule_workload(dev, phases)
    assert port_sched.SCHED_STATS["dispatches"] == 3
    port.schedule_workload(dev, phases, order=(0, 1, 0, 2, 0, 1))
    assert port_sched.SCHED_STATS["dispatches"] == 4
    assert port_exec.RUNNER_STATS["traces"] == 0
    assert port_sched.SCHED_STATS["plan_misses"] == 0
    assert not graphs._entries and not graphs._seen   # nothing is captured


def test_calls_never_write_their_inputs():
    """The eager run clones what the steps write in place: the caller's
    device and a result already returned stay as they were."""
    _, cfg = cfgs()
    phases = workload(port, cfg, 7)
    dev = port.make_device(cfg, device="cpu")
    dev.banks.bits.random_(-2**31, 2**31,
                           generator=torch.Generator().manual_seed(7))
    before = {k: v.copy() for k, v in convert.to_numpy(dev).items()}
    r1 = port.schedule_workload(dev, phases)
    kept = {k: v.copy() for k, v in convert.to_numpy(r1.state).items()}
    port.schedule_workload(dev, phases)
    port.schedule_pipeline(r1.state, list(phases[0].steps[0]), n_steps=2)
    for got, want in ((dev, before), (r1.state, kept)):
        now = convert.to_numpy(got)
        assert all(np.array_equal(now[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# What the card's graphs copy: payload stacks, meter stacks, refresh counts
# ---------------------------------------------------------------------------

def test_step_payloads_stack_once_per_layout():
    _, cfg = cfgs()
    rng = np.random.default_rng(8)
    lay = [compute_prog(port, rand_row(rng)) for _ in range(4)]
    steps = [[p.with_payloads([rand_row(rng)]) for p in lay]
             for _ in range(3)]
    dev = port.make_device(cfg, device="cpu")
    flats = [port_sched._normalize_programs(cfg, s) for s in steps]
    _, stripped, groups, deferred = port_sched._lower_step(cfg, steps[0])
    plan = port_sched._plan_for(cfg, stripped, groups, deferred,
                                use_kernels=None, interpret=None,
                                refresh=False, async_host=False)
    xs = port_sched._steps_payloads(plan, flats, WORDS, dev.device)
    assert xs is not port_sched._steps_payloads(plan, flats, WORDS,
                                                dev.device)
    assert xs[0] is port_sched._steps_payloads(plan, flats, WORDS,
                                               dev.device)[0]
    want = np.stack([[s[k].payloads[0] for k in plan.group_slots[0]]
                     for s in steps])[:, :, None, :]
    assert np.array_equal(xs[0].numpy().view(np.uint32), want)
    rep = port_sched._steps_payloads(plan, [flats[0]] * 5, WORDS, dev.device)
    assert rep[0].shape == (5, 4, 1, WORDS)
    assert all(np.array_equal(rep[0][k].numpy(), xs[0][0].numpy())
               for k in range(5))


def test_meters_come_as_stacks():
    """Every meter a run returns, and a fresh one, is two stacks: the card
    copies each into a graph in one memcpy. Fields of mixed origin are
    stacked anew."""
    from repro_torch.core.pim.state import FLOAT_FIELDS, INT_FIELDS
    m = port.CostMeter.zeros("cpu", (3,))
    f = [getattr(m, k) for k in FLOAT_FIELDS]
    assert graphs._stacked_base(f) is not None
    assert graphs._stacked_base([getattr(m, k) for k in INT_FIELDS]) \
        is not None
    _, cfg = cfgs()
    r = port.schedule(port.make_device(cfg, device="cpu"),
                      list(workload(port, cfg, 9)[0].steps[0]))
    out = [getattr(r.state.banks.meter, k) for k in FLOAT_FIELDS]
    assert graphs._stacked_base(out) is not None
    mixed = [f[0] + 1.0] + f[1:]
    assert graphs._stacked_base(mixed) is None
    assert torch.equal(graphs.stack_fields(mixed), torch.stack(mixed, -1))
    one = port.CostMeter.zeros("cpu")
    assert graphs._stacked_base([getattr(one, k).unsqueeze(0)
                                 for k in FLOAT_FIELDS]) is not None


def long_refresh(frac):
    """The default timing with tRFC = ``frac``·tREFI."""
    return dataclasses.replace(port_timing.DEFAULT_TIMING,
                               tRFC=frac * port_timing.DEFAULT_TIMING.tREFI)


@pytest.mark.parametrize("cfg", [
    port_timing.DEFAULT_TIMING,
    dataclasses.replace(port_timing.DEFAULT_TIMING, tREFI=3_900.0,
                        tRFC=1_950.0),
    long_refresh(0.6), long_refresh(0.78), long_refresh(0.95)],
    ids=["default", "tRFC-half-tREFI", "tRFC-0.6-tREFI", "tRFC-0.78-tREFI",
         "tRFC-0.95-tREFI"])
def test_sync_free_refresh_count_is_the_loop(cfg):
    """The card's refresh count (a lower bound, re-counts as many as the
    timing needs, no host sync) against the CPU's loop to convergence, and
    that against the reference's ``while_loop``, over busy times from 0 to
    10^12 ns and at the interval edges, each count below 2^30 (an int32
    holds the loop's counts): for the default timing, and for refresh
    cycles of a half to 0.95 of the interval."""
    rng = np.random.default_rng(10)
    edges = np.array([k * cfg.tREFI + d for k in (0, 1, 2, 29, 30, 31, 1000)
                      for d in (-1.0, -0.5, 0.0, 0.5)])
    busy = np.concatenate([
        rng.random(20000) * 10.0 ** rng.integers(0, 12, 20000),
        edges[edges >= 0],
        [0.0, 2.0 ** 24 * (cfg.tREFI - cfg.tRFC)]]).astype(np.float32)
    busy = busy[busy / (cfg.tREFI - cfg.tRFC) < 2.0 ** 30]
    t = torch.from_numpy(busy)
    loop = port_timing.refresh_events(t, cfg)
    assert torch.equal(port_timing._refresh_events_sync_free(t, cfg), loop)
    ref_cfg = dataclasses.replace(ref.DEFAULT_TIMING, tRFC=cfg.tRFC,
                                  tREFI=cfg.tREFI)
    assert np.array_equal(np.asarray(ref.refresh_events(jnp.asarray(busy),
                                                        ref_cfg)),
                          loop.numpy())


def test_sync_free_refresh_count_rounds():
    """The re-counts the card runs: the default timing's 4 (8 before the
    bound came from the timing), more as the refresh cycle nears the
    interval."""
    rounds = [port_timing._refresh_plan(c.tRFC, c.tREFI)[3]
              for c in (port_timing.DEFAULT_TIMING, long_refresh(0.6),
                        long_refresh(0.78), long_refresh(0.95))]
    assert rounds == [4, 11, 18, 74]


@pytest.mark.parametrize("frac", [1.0, 1.2])
def test_sync_free_refresh_count_refuses_no_fixed_point(frac):
    """A refresh cycle as long as its interval has no fixed point (the
    reference's loop never ends): the card's count refuses it."""
    with pytest.raises(ValueError, match="tRFC < tREFI"):
        port_timing._refresh_events_sync_free(
            torch.tensor([1.0e6], dtype=torch.float32), long_refresh(frac))


@pytest.mark.parametrize("count", ["loop", "sync_free"])
def test_apply_refresh_long_refresh_cycle_is_the_reference(monkeypatch,
                                                           count):
    """``apply_refresh`` at tRFC = 0.6·tREFI against the reference's on
    the same seeded meters, applied twice (the second charges only what
    the first left), bit for bit: with the CPU's loop and with the card's
    sync-free count."""
    cfg = long_refresh(0.6)
    ref_cfg = dataclasses.replace(ref.DEFAULT_TIMING, tRFC=cfg.tRFC)
    if count == "sync_free":
        monkeypatch.setattr(port_timing, "refresh_events",
                            port_timing._refresh_events_sync_free)
    rng = np.random.default_rng(11)
    n = 256
    prior = rng.integers(0, 50, n).astype(np.int32)
    busy = rng.random(n) * 10.0 ** rng.integers(2, 10, n)
    meter = {"time_ns": (busy + prior * cfg.tRFC).astype(np.float32)}
    meter.update({f: (rng.random(n) * 1e6).astype(np.float32)
                  for f in ("e_act", "e_pre", "e_refresh", "e_burst",
                            "e_background")})
    meter.update({f: rng.integers(0, 50, n).astype(np.int32)
                  for f in ("n_act", "n_pre", "n_aap", "n_shift", "n_tra")})
    meter["n_refresh"] = prior
    r = ref.CostMeter(**{k: jnp.asarray(v) for k, v in meter.items()})
    p = convert.meter_from_numpy(meter, device="cpu")
    for _ in range(2):
        r, p = ref.apply_refresh(r, ref_cfg), port_timing.apply_refresh(p,
                                                                        cfg)
        for f in r.__dataclass_fields__:
            got = getattr(p, f).numpy()
            want = np.asarray(getattr(r, f))
            assert np.array_equal(want.view(np.int32), got.view(np.int32)), f
    assert int(np.asarray(r.n_refresh).sum()) > int(prior.sum())


def test_recorded_launches_leave_the_counts():
    """Launches counted while a graph is captured (``kops.recorded``) are
    taken back out of the counts, also when the capture raises, and handed
    over as the graph's label; launches that ran stay counted."""
    from repro_torch.kernels.rowops import ops as kops
    kops.reset_launches()
    kops.LAUNCHES["shift_rows"] += 1                  # one that ran
    label: dict = {}
    with pytest.raises(RuntimeError):
        with kops.recorded(label):
            kops.LAUNCHES["shift_rows"] += 2
            kops.SHIFT_ROUTES["in_place"] += 2
            kops.LAUNCHES["meter_fold"] += 1
            raise RuntimeError("the capture failed")
    assert label == {("launches", "shift_rows"): 2,
                     ("routes", "in_place"): 2,
                     ("launches", "meter_fold"): 1}
    assert kops.LAUNCHES["shift_rows"] == 1
    assert kops.SHIFT_ROUTES["in_place"] == kops.LAUNCHES["meter_fold"] == 0
    kops.reset_launches()
