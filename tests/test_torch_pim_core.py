"""Parity of the port's PIM core (state, timing, eager ISA, IR, compile,
exec) with the JAX reference, on the CPU.

The same inputs, made with numpy from a seed, go through both packages:
programs are recorded with the reference's builder and cross to the port
as pim-trace text, initial rows cross as uint32 arrays (int32 bit patterns
on the port's side). Tolerance: exact equality for bits, migration and DCC
rows, reads, digests, column tables, segment lists and integer meter
fields; float32 meter fields are compared as float32 bit patterns.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pim as ref  # noqa: E402
from repro.core.pim import exec as ref_exec  # noqa: E402
from repro.core.pim import ir as ref_ir  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pim as port  # noqa: E402
from repro_torch.core.pim import exec as port_exec  # noqa: E402

ROWS, WORDS = 32, 8
USER_ROWS = ROWS - 8          # keep clear of C0/C1/T0..T3 (+ margin)
FLOAT_FIELDS = ("time_ns", "e_act", "e_pre", "e_refresh", "e_burst",
                "e_background")
INT_FIELDS = ("n_act", "n_pre", "n_aap", "n_shift", "n_tra", "n_refresh")
KINDS = ("rowclone", "dra", "tra", "shift", "chain", "copy", "and", "or",
         "xor", "not", "maj", "write", "read", "fill", "issue")
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def build_program(rng, n_ops, rows=ROWS, words=WORDS):
    """One random mixed program over the user rows, recorded with the
    reference's builder."""
    b = ref_ir.ProgramBuilder(rows, words)
    user = rows - 8
    pick = lambda n: [int(r) for r in rng.choice(user, n, replace=False)]
    for kind in rng.choice(KINDS, n_ops):
        if kind == "rowclone":
            b.rowclone(*pick(2))
        elif kind == "dra":
            b.dra(*pick(2))
        elif kind == "tra":
            b.tra(*pick(3))
        elif kind == "shift":
            b.shift(*pick(2), int(rng.choice([-1, 1])))
        elif kind == "chain":
            src, dst = pick(2)
            b.shift_k(src, dst, int(rng.integers(2, 8))
                      * int(rng.choice([-1, 1])))
        elif kind == "copy":
            b.copy_row(*pick(2))
        elif kind in ("and", "or", "xor"):
            getattr(b, f"ambit_{kind}")(*pick(3))
        elif kind == "not":
            b.ambit_not(*pick(2))
        elif kind == "maj":
            b.ambit_maj(*pick(4))
        elif kind == "write":
            b.write_row(pick(1)[0],
                        rng.integers(0, 2**32, (words,), dtype=np.uint32))
        elif kind == "read":
            b.read_row(pick(1)[0])
        elif kind == "fill":
            b.fill(pick(1)[0], int(rng.integers(0, 2**32)))
        else:
            b.issue()
    return b.build()


def to_port_program(prog):
    out = port.PimProgram.from_trace(prog.to_trace())
    assert out.digest == prog.digest
    return out


def states(rng, rows=ROWS, words=WORDS):
    """The same fresh subarray in both packages: random rows, then C0/C1."""
    bits = rng.integers(0, 2**32, (rows, words), dtype=np.uint32)
    r = ref.reserve_control_rows(ref.make_subarray(rows, words,
                                                   jnp.asarray(bits)))
    p = port.reserve_control_rows(port.make_subarray(rows, words, bits,
                                                     device="cpu"))
    return r, p


def f32_bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def assert_meter_equal(r, p, what=""):
    for f in FLOAT_FIELDS:
        assert np.array_equal(f32_bits(getattr(r, f)),
                              f32_bits(getattr(p, f).cpu().numpy())), \
            f"{what} meter.{f}: {getattr(r, f)} != {getattr(p, f)}"
    for f in INT_FIELDS:
        assert np.array_equal(np.asarray(getattr(r, f)),
                              getattr(p, f).cpu().numpy()), \
            f"{what} meter.{f}"


def assert_state_equal(r, p, what=""):
    got = convert.to_numpy(p)
    for f in ("bits", "mig_top", "mig_bot", "dcc"):
        assert np.array_equal(np.asarray(getattr(r, f)), got[f]), \
            f"{what} {f} diverges"
    assert_meter_equal(r.meter, p.meter, what)


def assert_reads_equal(r_reads, p_reads):
    assert len(r_reads) == len(p_reads)
    for x, y in zip(r_reads, p_reads):
        assert np.array_equal(np.asarray(x), y.cpu().numpy().view(np.uint32))


def seg_key(seg):
    """A segment as comparable plain data (the classes differ by package)."""
    fields = []
    for f in dataclasses.fields(seg):
        v = getattr(seg, f.name)
        if f.name == "ops":
            v = tuple(dataclasses.astuple(o) for o in v)
        elif dataclasses.is_dataclass(v):
            v = dataclasses.astuple(v)
        fields.append(v)
    return (type(seg).__name__, tuple(fields))


# ---------------------------------------------------------------------------
# state + timing
# ---------------------------------------------------------------------------

def test_state_constants_and_fresh_state():
    assert port.EVEN_MASK == 0x5555_5555
    assert np.uint32(int(ref.ODD_MASK)) == np.int32(port.ODD_MASK).view(
        np.uint32) and port.ODD_MASK == -1431655766
    assert (port.ROW_WORDS, port.NUM_ROWS) == (ref.ROW_WORDS, ref.NUM_ROWS)
    s = port.make_subarray(ROWS, WORDS, device="cpu")
    assert s.bits.dtype == torch.int32 and s.bits.shape == (ROWS, WORDS)
    assert s.meter.time_ns.dtype == torch.float32
    assert s.meter.n_act.dtype == torch.int32
    bank = port.make_bank(3, ROWS, WORDS, device="cpu")
    assert bank.bits.shape == (3, ROWS, WORDS)
    assert bank.meter.time_ns.shape == (3,)


def test_refresh_events_fixed_point_matches():
    rng = np.random.default_rng(0)
    busy = (rng.random(200) * 10.0 ** rng.integers(1, 8, 200)).astype(
        np.float32)
    exp = np.asarray(ref.refresh_events(jnp.asarray(busy)))
    got = port.refresh_events(torch.from_numpy(busy)).numpy()
    assert np.array_equal(exp, got)
    for b in (0.0, 7799.0, 7800.0, 1e6, 3.3e7):
        assert port.refresh_events_scalar(b) == ref.timing.refresh_events_scalar(b)


def test_apply_refresh_matches_on_accumulating_meters():
    rng = np.random.default_rng(1)
    n = 64
    meter = {f: (rng.random(n) * 1e6).astype(np.float32) for f in FLOAT_FIELDS}
    meter.update({f: rng.integers(0, 50, n).astype(np.int32)
                  for f in INT_FIELDS})
    r = ref.CostMeter(**{k: jnp.asarray(v) for k, v in meter.items()})
    p = convert.meter_from_numpy(meter, device="cpu")
    for _ in range(2):                       # incremental: apply twice
        r, p = ref.apply_refresh(r), port.apply_refresh(p)
        assert_meter_equal(r, p, "apply_refresh")


# ---------------------------------------------------------------------------
# eager ISA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_eager_isa_matches_on_random_streams(seed):
    rng = np.random.default_rng(seed)
    prog = build_program(rng, 25)
    r0, p0 = states(rng)
    r, r_reads = ref.run_program(r0, prog)
    p, p_reads = port.run_program(p0, to_port_program(prog))
    assert_state_equal(r, p, "eager")
    assert_reads_equal(r_reads, p_reads)


def test_eager_composites_and_costs_match():
    rng = np.random.default_rng(11)
    r, p = states(rng)
    for fn, args in (("ambit_xor", (0, 1, 2)), ("ambit_and", (3, 4, 5)),
                     ("ambit_or", (5, 6, 7)), ("ambit_not", (7, 8)),
                     ("ambit_maj", (1, 2, 3, 9)), ("dra", (9, 10)),
                     ("lisa_copy", (10, 11)), ("shift", (11, 12, -1)),
                     ("issue", ())):
        r = getattr(ref, fn)(r, *args)
        p = getattr(port, fn)(p, *args)
        assert_state_equal(r, p, fn)
    row = rng.integers(0, 2**32, (WORDS,), dtype=np.uint32)
    r = ref.write_row(r, 3, jnp.asarray(row))
    p = port.write_row(p, 3, row)
    (r, rr), (p, pr) = ref.read_row(r, 3), port.read_row(p, 3)
    assert_state_equal(r, p, "host")
    assert np.array_equal(np.asarray(rr), pr.numpy().view(np.uint32))
    with pytest.raises(ValueError):
        port.ambit_xor(p, 0, port.T0, 1)


def test_eager_isa_runs_on_a_bank_batch():
    rng = np.random.default_rng(2)
    prog = build_program(rng, 20)
    bank = port.reserve_control_rows(port.make_bank(3, ROWS, WORDS,
                                                    device="cpu"))
    out, _ = port.run_program(bank, to_port_program(prog))
    one, _ = port.run_program(port.reserve_control_rows(
        port.make_subarray(ROWS, WORDS, device="cpu")), to_port_program(prog))
    for s in range(3):
        assert torch.equal(out.bits[s], one.bits)
        assert torch.equal(out.meter.time_ns[s], one.meter.time_ns)


# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,load,dump", [
    ("golden_v1.trace", lambda m, t: m.PimProgram.from_trace(t),
     lambda m, p: p.to_trace()),
    ("golden_v2.trace", lambda m, t: m.from_trace_banks(t),
     lambda m, p: m.to_trace_banks(p)),
    ("golden_v3.trace", lambda m, t: m.from_trace_device(t),
     lambda m, p: m.to_trace_device(p)),
])
def test_golden_traces_reexport_byte_identical(name, load, dump):
    with open(os.path.join(FIXTURES, name)) as f:
        text = f.read()
    assert dump(port, load(port, text)) == text
    assert dump(port, load(port, text)) == dump(ref, load(ref, text))


@pytest.mark.parametrize("seed", range(4))
def test_ir_digests_and_columns_match(seed):
    rng = np.random.default_rng(100 + seed)
    a, b = build_program(rng, 30), build_program(rng, 10)
    pa, pb = to_port_program(a), to_port_program(b)
    assert np.array_equal(pa.columns.table, a.columns.table)
    assert pa.payload_digest == a.payload_digest
    assert port.sequence_digest([pa.digest, pb.digest]) == \
        ref.sequence_digest([a.digest, b.digest])
    cat_r, cat_p = ref_ir.concat([a, b]), port.concat([pa, pb])
    assert cat_p.digest == cat_r.digest
    assert cat_p.to_trace() == cat_r.to_trace()
    assert pa.counts() == a.counts() and pa.host_bytes == a.host_bytes
    # the port's builder records the same stream as the reference's
    rec = lambda m: m.ProgramBuilder(ROWS, WORDS).reserve_control_rows() \
        .ambit_xor(0, 1, 2).shift_k(2, 3, 40).copy_row(3, 4).build()
    assert rec(port).digest == rec(ref).digest


# ---------------------------------------------------------------------------
# compile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_cost_tables_pass_and_fusion_match(seed):
    rng = np.random.default_rng(200 + seed)
    prog = build_program(rng, 40)
    b = ref_ir.ProgramBuilder(ROWS, WORDS)
    b.shift_k(0, 1, 40)          # a chain long enough to fuse
    prog = ref_ir.concat([prog, b.build()])
    pp = to_port_program(prog)
    for fn in ("cost_tables", "cost_tables_reference"):
        rf, ri = getattr(ref, fn)(prog)
        pf, pi = getattr(port, fn)(pp)
        assert np.array_equal(f32_bits(rf), f32_bits(pf))
        assert np.array_equal(ri, pi)
    assert_meter_equal(ref.cost_pass(prog), port.cost_pass(pp, device="cpu"),
                       "cost_pass")
    assert port.cost_summary(pp, refresh=True) == ref.cost_summary(
        prog, refresh=True)
    assert [seg_key(s) for s in port.fuse(pp)] == \
        [seg_key(s) for s in ref.fuse(prog)]
    assert any(type(s).__name__ == "SegShiftRun" for s in port.fuse(pp))
    dce_r = ref.dead_copy_elimination(prog)
    dce_p = port.dead_copy_elimination(pp)
    assert dce_p.to_trace() == dce_r.to_trace()


def test_unported_gates_raise():
    """The verify gates, stubs before the static tools were ported, now lint
    and prove: a clean program passes each gate, a stream with a TRA hazard
    raises LintError, and a corrupted fusion raises EquivalenceError."""
    prog = to_port_program(ref.ambit_xor_program())
    bad = port.PimProgram(ops=(port.PimOp(port.ir.OP_TRA, a=3, b=3, c=5),),
                          num_rows=16, words=2)
    for gate in (lambda p: port.compile_program(p, verify=True),
                 lambda p: port.execute(p, verify=True, device="cpu")):
        gate(prog)
        with pytest.raises(port.LintError, match="PIM103"):
            gate(bad)
    port.compile_program(prog, verify_semantics=True)
    segs = port.fuse(prog)
    with pytest.raises(port.EquivalenceError):
        port.verify_fusion(prog, segs[:-1])
    b = port.ProgramBuilder(16, 2, verify=True)
    b.tra(3, 3, 5)
    with pytest.raises(port.LintError, match="PIM103"):
        b.build()


# ---------------------------------------------------------------------------
# exec
# ---------------------------------------------------------------------------

def segment_kinds_program(rng):
    """One program that hits every segment kind: a fused shift chain of
    k >= 32 (and one of k >= 32·W), MAJ and NOT idioms, residual ops, and
    host WRITE/READ/FILL."""
    b = ref_ir.ProgramBuilder(ROWS, WORDS)
    b.issue().reserve_control_rows()
    b.write_row(0, rng.integers(0, 2**32, (WORDS,), dtype=np.uint32))
    b.write_row(1, rng.integers(0, 2**32, (WORDS,), dtype=np.uint32))
    b.shift_k(0, 2, 45)                       # SegShiftRun, k >= 32
    b.shift_k(1, 3, -33)
    b.ambit_xor(2, 3, 4)                      # SegMaj + SegNot
    b.tra(5, 6, 7).dra(4, 8).copy_row(8, 9).shift(9, 10, 1)   # residual
    b.not_to_dcc(10).rowclone(10, 11).dcc_to(12)
    b.fill(13, 0xFFFF_0000)
    b.read_row(4)
    b.read_row(12)
    b.shift_k(13, 14, 32 * WORDS + 3)         # shifted wholly out
    b.read_row(14)
    return b.build()


@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("use_kernels", [None, True])
@pytest.mark.parametrize("seed", range(3))
def test_execute_matches_reference_and_eager(seed, use_kernels, refresh):
    rng = np.random.default_rng(300 + seed)
    prog = ref_ir.concat([segment_kinds_program(rng),
                          build_program(rng, 30)])
    pp = to_port_program(prog)
    r0, p0 = states(rng)
    p0_copy = convert.to_numpy(p0)
    r = ref_exec.execute(prog, r0, refresh=refresh)
    p = port.execute(pp, p0, use_kernels=use_kernels, refresh=refresh)
    assert_state_equal(r.state, p.state, "execute")
    assert_reads_equal(r.reads, p.reads)
    # the port's eager ISA is the oracle of its compiled path too
    e, e_reads = port.run_program(p0, pp)
    if refresh:
        e.meter = port.apply_refresh(e.meter)
    for f in ("bits", "mig_top", "mig_bot", "dcc"):
        assert torch.equal(getattr(e, f), getattr(p.state, f))
    assert [torch.equal(x, y) for x, y in zip(e_reads, p.reads)] == \
        [True] * len(e_reads)
    # the caller's state was not written
    after = convert.to_numpy(p0)
    assert all(np.array_equal(p0_copy[k], after[k]) for k in p0_copy)


def test_execute_matches_pallas_lowering():
    """The reference with its Pallas kernels (interpret mode) against the
    port's kernel-wrapper path on the same program."""
    rng = np.random.default_rng(7)
    prog = segment_kinds_program(rng)
    r0, p0 = states(rng)
    r = ref_exec.execute(prog, r0, use_kernels=True, interpret=True)
    p = port.execute(to_port_program(prog), p0, use_kernels=True)
    assert_state_equal(r.state, p.state, "execute(kernels)")
    assert_reads_equal(r.reads, p.reads)


def test_execute_meter_accumulates_across_calls_and_refresh():
    """A chain long enough to owe refresh events, run three times on one
    accumulating state: every event is charged exactly once."""
    b = ref_ir.ProgramBuilder(ROWS, WORDS)
    b.issue().shift_k(0, 1, 60)
    prog = b.build()
    pp = to_port_program(prog)
    rng = np.random.default_rng(8)
    r, p = states(rng)
    for _ in range(3):
        r = ref_exec.execute(prog, r, refresh=True).state
        p = port.execute(pp, p, refresh=True).state
        assert_state_equal(r, p, "accumulating")
    assert int(p.meter.n_refresh) > 1


def test_execute_full_geometry():
    """One execute at the paper's 512 x 2048 geometry: the quickstart's
    write -> issue -> 1000-column shift -> read stream, with refresh."""
    rng = np.random.default_rng(9)
    row = rng.integers(0, 2**32, (2048,), dtype=np.uint32)
    b = ref_ir.ProgramBuilder(512, 2048)
    b.write_row(0, row).issue().shift_k(0, 1, 1000).read_row(1)
    prog = b.build()
    r0 = ref.reserve_control_rows(ref.make_subarray(512, 2048))
    p0 = port.reserve_control_rows(port.make_subarray(512, 2048,
                                                      device="cpu"))
    r = ref_exec.execute(prog, r0, refresh=True)
    p = port.execute(to_port_program(prog), p0, refresh=True)
    assert_state_equal(r.state, p.state, "full geometry")
    assert_reads_equal(r.reads, p.reads)


def test_runner_cache_and_batched_runs():
    rng = np.random.default_rng(10)
    prog = to_port_program(build_program(rng, 20))
    port.reset_stats()
    compiled = port.compile_program(prog)
    run = port.make_runner(compiled)
    assert port.make_runner(compiled) is run
    assert port.RUNNER_STATS["traces"] == 1
    bank = port.reserve_control_rows(port.make_bank(4, ROWS, WORDS,
                                                    device="cpu"))
    bank.bits[:, :USER_ROWS] = torch.from_numpy(rng.integers(
        -2**31, 2**31, (4, USER_ROWS, WORDS), dtype=np.int32))
    out = run(bank)
    for s in range(4):
        one = run(bank.map(lambda t: t[s]))
        assert torch.equal(out.state.bits[s], one.state.bits)
        assert torch.equal(out.state.meter.e_background[s],
                           one.state.meter.e_background)
        for x, y in zip(out.reads, one.reads):
            assert torch.equal(x[s], y)
    with pytest.raises(ValueError, match="use_kernels=False"):
        port_exec._kernels_for(False, torch.device("cuda"))


def test_program_helpers_match():
    rng = np.random.default_rng(12)
    for n in (1, 3, 40):
        assert port.shift_workload_program(n, 16, 4).digest == \
            ref.shift_workload_program(n, 16, 4).digest
    assert port.ambit_xor_program(16, 2).digest == \
        ref.ambit_xor_program(16, 2).digest
    assert port.estimate_cost(100, 3, 2) == ref.estimate_cost(100, 3, 2)
    row = rng.integers(0, 2**32, (WORDS,), dtype=np.uint32)
    r = ref.run_shift_workload(jnp.asarray(row), 70, ROWS, WORDS)
    p = port.run_shift_workload(row, 70, ROWS, WORDS, device="cpu")
    assert_state_equal(r, p, "run_shift_workload")
    r0, p0 = states(rng)
    assert_state_equal(ref.shift_k(r0, 2, 3, -40),
                       port.shift_k(p0, 2, 3, -40), "shift_k")
    bank_r = ref.make_bank(3, ROWS, WORDS)
    bank_p = port.make_bank(3, ROWS, WORDS, device="cpu")
    prog = ref.shift_workload_program(40, ROWS, WORDS)
    sr, wr, er = ref.bank_parallel(prog, 3)(bank_r)
    sp, wp, ep = port.bank_parallel(to_port_program(prog), 3)(bank_p)
    assert_state_equal(sr, sp, "bank_parallel")
    assert f32_bits(wr) == f32_bits(wp.numpy())
    assert f32_bits(er) == f32_bits(ep.numpy())


@pytest.mark.parametrize("n_banks", [16, 32, 64])
def test_bank_parallel_on_wide_banks(n_banks):
    """``bank_parallel`` over 16, 32 and 64 banks that start from meters
    of their own: states, wall and the energy total (the reference's eager
    ``jnp.sum``, in XLA's order) bit for bit."""
    rng = np.random.default_rng(n_banks)
    arrays = convert.to_numpy(port.make_bank(n_banks, ROWS, WORDS,
                                             device="cpu"))
    arrays["bits"] = rng.integers(0, 2**32, arrays["bits"].shape,
                                  dtype=np.uint32)
    for f in FLOAT_FIELDS:
        arrays[f] = np.exp2(rng.uniform(-4, 12, n_banks)).astype(np.float32)
    rows = ("bits", "mig_top", "mig_bot", "dcc")
    bank_p = convert.subarray_from_numpy(
        *(arrays[k] for k in rows),
        meter={k: arrays[k] for k in FLOAT_FIELDS + INT_FIELDS},
        device="cpu")
    bank_r = ref.make_bank(n_banks, ROWS, WORDS)
    bank_r = dataclasses.replace(
        bank_r, bits=jnp.asarray(arrays["bits"]),
        meter=dataclasses.replace(bank_r.meter, **{
            k: jnp.asarray(arrays[k]) for k in FLOAT_FIELDS}))
    prog = build_program(rng, 12)
    sr, wr, er = ref.bank_parallel(prog, n_banks)(bank_r)
    sp, wp, ep = port.bank_parallel(to_port_program(prog), n_banks)(bank_p)
    assert_state_equal(sr, sp, "bank_parallel")
    assert f32_bits(wr) == f32_bits(wp.numpy())
    assert f32_bits(er) == f32_bits(ep.numpy())


def test_convert_round_trip():
    rng = np.random.default_rng(13)
    r, _ = states(rng)
    r = ref.run_program(r, build_program(rng, 20))[0]
    arrays = {f: np.asarray(getattr(r, f)) for f in
              ("bits", "mig_top", "mig_bot", "dcc")}
    meter = {f: np.asarray(getattr(r.meter, f)) for f in
             FLOAT_FIELDS + INT_FIELDS}
    p = convert.subarray_from_numpy(**arrays, meter=meter, device="cpu")
    assert_state_equal(r, p, "convert")
    back = convert.to_numpy(p)
    assert back["bits"].dtype == np.uint32
    assert all(np.array_equal(back[k], arrays[k]) for k in arrays)
