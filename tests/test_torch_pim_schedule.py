"""Parity of the port's device model and ``schedule()`` with the JAX
reference, on the CPU.

A small device of the paper's topology (``paper_device(4, num_rows=32,
words=8, subarrays=2)``: 4 banks x 2 subarrays = 8 slots) runs the same
heterogeneous per-slot programs in both packages — shared streams with
different payloads, fused shift chains, Ambit XOR, host writes and reads,
idle slots, and cross-slot COPY drains — over several steps with
``async_host`` and ``refresh``; the wide devices ``paper_device(n, 32, 8,
subarrays=2)`` with 16, 32 and 64 slots run random layouts, where the
step's energy sum follows XLA's reduction order (``compile.xla_sum``,
itself held against ``jnp.sum`` at every length from 1 to 256). Programs
cross as pim-trace v3 text. Tolerance: exact equality for rows, reads,
integer meter fields and the copy-drain statistics; float32 meters,
``wall_ns`` and ``energy_nj`` are compared as float32 bit patterns.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import pim as ref  # noqa: E402
from repro.core.pim import ir as ref_ir  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pim as port  # noqa: E402
from repro_torch.core.pim.compile import xla_sum  # noqa: E402

ROWS, WORDS = 32, 8
FLOAT_FIELDS = ("time_ns", "e_act", "e_pre", "e_refresh", "e_burst",
                "e_background")
INT_FIELDS = ("n_act", "n_pre", "n_aap", "n_shift", "n_tra", "n_refresh")


def f32_bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def configs():
    return (ref.paper_device(4, ROWS, WORDS, subarrays=2),
            port.paper_device(4, ROWS, WORDS, subarrays=2))


def nested(cfg, flat):
    S = cfg.subarrays
    return [list(flat[b * S:(b + 1) * S]) for b in range(cfg.n_banks)]


def to_port_layout(cfg, flat):
    """Per-slot reference programs → the port's nested programs, through
    pim-trace v3 (idle slots come back as empty programs)."""
    text = ref.to_trace_device(nested(cfg, flat))
    out = port.from_trace_device(text)
    assert port.to_trace_device(out) == text
    return out


def random_program(rng, n_ops, payload_seed=None):
    b = ref_ir.ProgramBuilder(ROWS, WORDS)
    prng = np.random.default_rng(payload_seed) if payload_seed else rng
    b.issue()
    for kind in rng.choice(("write", "xor", "chain", "maj", "not", "read",
                            "tra", "copy"), n_ops):
        r = [int(x) for x in rng.choice(ROWS - 8, 4, replace=False)]
        if kind == "write":
            b.write_row(r[0], prng.integers(0, 2**32, (WORDS,),
                                            dtype=np.uint32))
        elif kind == "xor":
            b.ambit_xor(r[0], r[1], r[2])
        elif kind == "chain":
            b.shift_k(r[0], r[1], int(rng.choice([-1, 1]))
                      * int(rng.integers(2, 50)))
        elif kind == "maj":
            b.ambit_maj(*r)
        elif kind == "not":
            b.ambit_not(r[0], r[1])
        elif kind == "read":
            b.read_row(r[0])
        elif kind == "tra":
            b.tra(r[0], r[1], r[2])
        else:
            b.copy_row(r[0], r[1])
    return b.build()


def step_programs(cfg, rng, k):
    """One step's per-slot programs: two slots share a stream with
    different payloads, one is idle, the rest differ; plus cross-slot
    COPYs (a dependent chain on odd steps)."""
    shared = random_program(np.random.default_rng(50 + k), 6)
    flat = [shared,
            shared.with_payloads([np.random.default_rng(60 + k).integers(
                0, 2**32, p.shape, dtype=np.uint32) for p in shared.payloads]),
            ref.shift_workload_program(40 + k, ROWS, WORDS),
            ref.ambit_xor_program(ROWS, WORDS, a=0, b=1, dst=2),
            None,
            random_program(rng, 8),
            random_program(rng, 12),
            random_program(rng, 4)]
    moves = [((0, 0, 1), (1, 1, 5)), ((2, 1, 4), (3, 0, 6)),
             ((1, 0, 2), (0, 1, 7))]
    if k % 2:
        # a chain: the second copy reads the row the first one wrote
        moves += [((3, 1, 3), (2, 0, 8)), ((2, 0, 8), (0, 0, 9))]
    return ref.gather_rows(cfg, moves, flat)


def assert_device_equal(r_dev, p_dev, what=""):
    got = convert.to_numpy(p_dev)
    for f in ("bits", "mig_top", "mig_bot", "dcc"):
        assert np.array_equal(np.asarray(getattr(r_dev.banks, f)), got[f]), \
            f"{what}: {f}"
    for f in FLOAT_FIELDS:
        assert np.array_equal(f32_bits(getattr(r_dev.banks.meter, f)),
                              f32_bits(got[f])), f"{what}: meter.{f}"
    for f in INT_FIELDS:
        assert np.array_equal(np.asarray(getattr(r_dev.banks.meter, f)),
                              got[f]), f"{what}: meter.{f}"
    assert f32_bits(r_dev.host_credit_ns) == f32_bits(got["host_credit_ns"])


def assert_result_equal(r, p, what=""):
    assert_device_equal(r.state, p.state, what)
    assert f32_bits(r.wall_ns) == f32_bits(p.wall_ns.cpu()), what
    assert f32_bits(r.energy_nj) == f32_bits(p.energy_nj.cpu()), what
    for f in ("bus_ns", "copy_ns", "copy_total_ns", "copy_queue_ns",
              "host_bytes", "rank_switch_ns", "link_busy_ns", "host_bus_ns",
              "channel_bus_ns", "host_overlap_ns"):
        assert getattr(r, f) == getattr(p, f), f"{what}: {f}"
    assert len(r.reads) == len(p.reads)
    for slot, (rr, pr) in enumerate(zip(r.reads, p.reads)):
        assert len(rr) == len(pr), (what, slot)
        for x, y in zip(rr, pr):
            assert np.array_equal(np.asarray(x), y), (what, slot)


@pytest.mark.parametrize("seed", range(3))
def test_schedule_matches_over_steps(seed):
    """Sync, async and refreshed steps on one accumulating device."""
    cfg_r, cfg_p = configs()
    rng = np.random.default_rng(seed)
    dev_r = ref.make_device(cfg_r)
    dev_p = port.make_device(cfg_p, device="cpu")
    for k, flags in enumerate(({}, {"async_host": True},
                               {"async_host": True, "refresh": True},
                               {"refresh": True})):
        flat = step_programs(cfg_r, rng, k)
        r = ref.schedule(dev_r, flat, **flags)
        p = port.schedule(dev_p, to_port_layout(cfg_r, flat), **flags)
        assert_result_equal(r, p, f"step {k} {flags}")
        dev_r, dev_p = r.state, p.state
    assert int(dev_p.banks.meter.n_refresh.max()) >= 1
    assert any(x > 0 for x in port.schedule(
        dev_p, to_port_layout(cfg_r, step_programs(cfg_r, rng, 9)),
        async_host=True).channel_bus_ns)


def test_schedule_from_converted_state_and_no_mutation():
    """A reference device's state carried into the port runs on to the
    same result, and schedule() leaves the caller's device untouched."""
    cfg_r, cfg_p = configs()
    rng = np.random.default_rng(5)
    r = ref.schedule(ref.make_device(cfg_r), step_programs(cfg_r, rng, 0),
                     async_host=True)
    arrays = {f: np.asarray(getattr(r.state.banks, f))
              for f in ("bits", "mig_top", "mig_bot", "dcc")}
    arrays.update({f: np.asarray(getattr(r.state.banks.meter, f))
                   for f in FLOAT_FIELDS + INT_FIELDS})
    dev_p = convert.device_from_numpy(
        dict(channels=cfg_p.channels, ranks=cfg_p.ranks,
             banks_per_rank=cfg_p.banks_per_rank, subarrays=2,
             num_rows=ROWS, words=WORDS),
        arrays, float(r.state.host_credit_ns), device="cpu")
    assert dev_p.config == cfg_p
    before = convert.to_numpy(dev_p)
    flat = step_programs(cfg_r, rng, 1)
    r2 = ref.schedule(r.state, flat, async_host=True)
    p2 = port.schedule(dev_p, to_port_layout(cfg_r, flat), async_host=True)
    assert_result_equal(r2, p2, "converted")
    after = convert.to_numpy(dev_p)
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_homogeneous_device_and_plan_cache():
    """Every slot on one stream (the no-gather path); a recurring layout
    reuses its plan and runner."""
    cfg_r, cfg_p = configs()
    prog = ref.shift_workload_program(33, ROWS, WORDS)
    layout = [prog] * cfg_r.n_slots
    dev_r, dev_p = ref.make_device(cfg_r), port.make_device(cfg_p,
                                                            device="cpu")
    port.reset_stats()
    pl = to_port_layout(cfg_r, layout)
    for k in range(3):
        r = ref.schedule(dev_r, layout, refresh=True)
        p = port.schedule(dev_p, pl, refresh=True)
        assert_result_equal(r, p, f"homogeneous {k}")
        dev_r, dev_p = r.state, p.state
    assert port.SCHED_STATS == {"dispatches": 3, "plan_misses": 1,
                                "compile_misses": 1}
    assert port.RUNNER_STATS["traces"] == 1


def test_movement_and_partition_builders_match():
    cfg_r, cfg_p = configs()
    data = np.random.default_rng(3).integers(0, 2**32, (16, WORDS),
                                             dtype=np.uint32)
    for fn in ("shard_rows", "shard_lanes"):
        for kw in ({}, {"subarrays": 2, "read_back": True}):
            r = getattr(ref, fn)(data, 4, ROWS, **kw)
            p = getattr(port, fn)(data, 4, ROWS, **kw)
            flat = lambda xs: [q for x in xs for q in
                               (x if isinstance(x, list) else [x])]
            assert [q.to_trace() for q in flat(p)] == \
                [q.to_trace() for q in flat(r)]
    assert port.xor_reduce_program(ROWS, WORDS, [1, 2, 3], 4).digest == \
        ref.xor_reduce_program(ROWS, WORDS, [1, 2, 3], 4).digest
    moves = [((0, 1, 2), (3, 0, 4)), ((2, 0, 1), (2, 1, 1))]
    gr, gp = ref.gather_rows(cfg_r, moves), port.gather_rows(cfg_p, moves)
    assert [q and q.to_trace() for q in gp] == [q and q.to_trace() for q in gr]


def test_bus_models_match():
    cfg_r, cfg_p = configs()
    rng = np.random.default_rng(4)
    issue = rng.random(cfg_r.n_slots) * (rng.random(cfg_r.n_slots) < 0.7)
    host = rng.random(cfg_r.n_slots) * 100
    rb = ref.channel_bus_model(cfg_r, issue, host, host_credit_ns=30.0)
    pb = port.channel_bus_model(cfg_p, issue, host, host_credit_ns=30.0)
    assert np.array_equal(rb[0], pb[0]) and rb[1:] == pb[1:]
    bus = rng.random(5).astype(np.float32) * 50
    ex = rng.random(5).astype(np.float32) * 500
    assert f32_bits(ref.device_wall_ns(bus, ex)) == f32_bits(
        port.device_wall_ns(bus, ex))
    prog = ref.shift_workload_program(3, ROWS, WORDS)
    pp = port.PimProgram.from_trace(prog.to_trace())
    for fn in ("issue_bus_ns", "host_bus_ns", "bus_time_ns"):
        assert getattr(port, fn)(pp) == getattr(ref, fn)(prog)


def test_schedule_refuses_unported_verify_and_bad_layouts():
    _, cfg_p = configs()
    dev = port.make_device(cfg_p, device="cpu")
    # verify=True is ported: an idle layout lints clean and runs
    res = port.schedule(dev, [None] * cfg_p.n_slots, verify=True)
    assert torch.equal(res.state.banks.bits, dev.banks.bits)
    with pytest.raises(ValueError):
        port.schedule(dev, [None] * 3)


# ---------------------------------------------------------------------------
# Wide devices: the step's sums in XLA's order
# ---------------------------------------------------------------------------

WIDE_BANKS = (8, 16, 32)   # paper_device(n, subarrays=2): 16, 32, 64 slots


def wide_configs(n_banks):
    return (ref.paper_device(n_banks, ROWS, WORDS, subarrays=2),
            port.paper_device(n_banks, ROWS, WORDS, subarrays=2))


def stream_pool(rng, n=6):
    return [random_program(rng, int(rng.integers(3, 12))) for _ in range(n)]


def wide_layout(cfg, rng, pool, copies=True):
    """Every slot one of ``pool``'s streams with payloads of its own (about
    a tenth idle), plus three independent cross-bank COPYs."""
    flat = []
    for _ in range(cfg.n_slots):
        if rng.random() < 0.1:
            flat.append(None)
            continue
        p = pool[int(rng.integers(len(pool)))]
        flat.append(p.with_payloads([rng.integers(0, 2**32, q.shape,
                                                  dtype=np.uint32)
                                     for q in p.payloads]))
    moves = [((int(rng.integers(cfg.n_banks)), int(rng.integers(2)), j),
              (int(rng.integers(cfg.n_banks)), int(rng.integers(2)), 20 + j))
             for j in range(3)] if copies else []
    return ref.gather_rows(cfg, moves, flat)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("n_banks", WIDE_BANKS)
def test_schedule_matches_on_wide_devices(n_banks, seed):
    """16, 32 and 64 slots: a sync step with COPY drains, then an async
    refreshed one; ``energy_nj`` bit-equal to the reference's jitted
    ``jnp.sum`` (left to right it is off by an ulp in most seeds)."""
    cfg_r, cfg_p = wide_configs(n_banks)
    rng = np.random.default_rng(100 + seed)
    pool = stream_pool(rng)
    dev_r = ref.make_device(cfg_r)
    dev_p = port.make_device(cfg_p, device="cpu")
    for k, flags in enumerate(({}, {"async_host": True, "refresh": True})):
        flat = wide_layout(cfg_r, rng, pool, copies=k == 0)
        r = ref.schedule(dev_r, flat, **flags)
        p = port.schedule(dev_p, to_port_layout(cfg_r, flat), **flags)
        assert_result_equal(r, p, f"{cfg_r.n_slots} slots, step {k}")
        dev_r, dev_p = r.state, p.state


def _fused_energy_sum(n):
    """The reference step's reduce: Σ over slots of the five-field energy
    after less before, one jitted computation (XLA fuses the adds into the
    reduce)."""
    def total(m):
        return m[0] + m[1] + m[2] + m[3] + m[4]
    return jax.jit(lambda a, b: jnp.sum(total(a) - total(b)))


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("first", range(1, 257, 32))
def test_xla_sum_is_jnp_sum_at_every_length(first, fused):
    """``xla_sum`` against ``jnp.sum`` at every length from 1 to 256, as a
    standalone eager sum and fused into the step's energy expression; wide
    exponents and both signs, so that another order shows."""
    rng = np.random.default_rng(first + 1000 * fused)
    for n in range(first, first + 32):
        fn = _fused_energy_sum(n) if fused else None
        for _ in range(6):
            a = [(rng.choice([-1, 1], n) * np.exp2(rng.uniform(-8, 10, n)))
                 .astype(np.float32) for _ in range(5)]
            b = [np.exp2(rng.uniform(-8, 10, n)).astype(np.float32)
                 for _ in range(5)]
            d = ((a[0] + a[1] + a[2] + a[3] + a[4])
                 - (b[0] + b[1] + b[2] + b[3] + b[4])).astype(np.float32)
            exp = fn(a, b) if fused else jnp.sum(jnp.asarray(d))
            got = xla_sum(torch.from_numpy(d), fused=fused)
            assert f32_bits(got) == f32_bits(exp), (n, fused)
