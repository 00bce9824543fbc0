"""Parity of the port's symbolic analyzer (``repro_torch.core.pim.sem``)
with the JAX reference, on the CPU.

Counterparts of ``tests/test_pim_sem.py`` and of the static-semantics leg
of ``tests/test_pim_differential.py`` (``_assert_sem_agrees``). Every
program is recorded once per package with the same builder calls, or
crosses as pim-trace text. Tolerance: verdicts, components, unknown lists,
witnesses (kind, index, lane, rows), ``summarize``/``render_value``
strings, supports and findings equal to the reference's; every DIFFERENT
witness replays on the port's eager ISA (CPU), and every EQUIVALENT pair
executes to equal states on random inputs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pim as ref  # noqa: E402
from repro.core.pim import sem as ref_sem  # noqa: E402
from repro.core.pim.lint import (_recorded_rs_encode,  # noqa: E402
                                 _recorded_xtime)
from repro_torch.core import pim as port  # noqa: E402
from repro_torch.core.pim import compile as port_compile  # noqa: E402
from repro_torch.core.pim import ir as port_ir  # noqa: E402
from repro_torch.core.pim import isa as port_isa  # noqa: E402
from repro_torch.core.pim import lint as port_lint  # noqa: E402
from repro_torch.core.pim import sem as port_sem  # noqa: E402
from repro_torch.core.pim.schedule import xor_reduce_program  # noqa: E402
from test_pim_differential import (_build_program,  # noqa: E402
                                   _mutate)

ROWS = 16
WORDS = 2
LANES = WORDS * 32


def both(record, rows=ROWS, words=WORDS):
    """``record(builder, pim)`` run once per package: (reference, port)."""
    out = []
    for mod in (ref, port):
        b = mod.ProgramBuilder(rows, words)
        record(b, mod)
        out.append(b.build())
    return tuple(out)


def crossed(prog):
    """A reference program and its port twin, read from one trace text."""
    text = prog.to_trace()
    return ref.PimProgram.from_trace(text), port.PimProgram.from_trace(text)


def witness_key(w):
    if w is None:
        return None
    d = dataclasses.asdict(w)
    d["rows"] = {int(r): np.asarray(v, np.uint32).tolist()
                 for r, v in w.rows.items()}
    return d


def report_key(rep):
    return (rep.verdict, rep.component, tuple(rep.unknown),
            witness_key(rep.witness))


# ---------------------------------------------------------------------------
# Closed forms: the paper's kernels, proved
# ---------------------------------------------------------------------------

def _and_or_not(b, m):
    b.reserve_control_rows()
    b.ambit_and(0, 1, 2)
    b.ambit_or(0, 1, 3)
    b.ambit_not(0, 4)


CLOSED = {
    "and_or_not": (_and_or_not, {2: "r0 & r1", 3: "r0 | r1", 4: "~r0"}),
    "tra": (lambda b, m: b.tra(0, 1, 2),
            {r: "maj(r0, r1, r2)" for r in (0, 1, 2)}),
    "shift_k": (lambda b, m: b.shift_k(0, 1, 5), {}),
    "shift_left": (lambda b, m: b.shift_k(0, 1, -3), {}),
    "xor_maj_chain": (lambda b, m: (b.reserve_control_rows(),
                                    b.ambit_xor(0, 1, 2),
                                    b.ambit_maj(2, 3, 4, 5)), {2: "r0 ^ r1"}),
}


@pytest.mark.parametrize("name", sorted(CLOSED))
def test_closed_forms_equal_the_reference(name):
    record, expect = CLOSED[name]
    r, p = both(record)
    got = port_sem.summarize(p)
    assert got == ref_sem.summarize(r)
    for row, text in expect.items():
        assert got[row] == text
    mr, mp = ref_sem.analyze(r), port_sem.analyze(p)
    assert sorted(mp.written) == sorted(mr.written)
    for row in mp.written:
        vr, vp = mr.value(row), mp.value(row)
        assert port_sem.render_value(vp) == ref_sem.render_value(vr)
        assert vp.sup == vr.sup
        assert [port_sem.lane_const(vp, lane) for lane in range(LANES)] == \
            [ref_sem.lane_const(vr, lane) for lane in range(LANES)]


def test_ambit_xor_summarizes_to_xor():
    assert port_sem.summarize(port.ambit_xor_program())[2] == "r0 ^ r1"


def test_shift_k_is_exact_displacement_with_boundary_fill():
    k = 5
    _, p = both(lambda b, m: b.shift_k(0, 1, k))
    v = port_sem.analyze(p).value(1)
    assert v.sup == ((0, k),)
    for lane in range(k):
        assert port_sem.lane_const(v, lane) == 0
    for lane in range(k, LANES):
        assert port_sem.lane_const(v, lane) is None
    rendered = port_sem.summarize(p)[1]
    assert "(r0 << 5)" in rendered and "5 boundary lane(s)" in rendered


# ---------------------------------------------------------------------------
# Equivalence proving: the sound-verdict contract
# ---------------------------------------------------------------------------

def _pair_maj_commutes():
    def a(b, m):
        b.reserve_control_rows()
        b.ambit_and(0, 1, 2)

    def c(b, m):
        b.reserve_control_rows()
        b.ambit_and(1, 0, 2)
    return both(a), both(c), {"outputs": [2]}, ref_sem.EQUIVALENT


def _pair_shift_round_trip():
    return (both(lambda b, m: (b.shift_k(0, 1, 3), b.shift_k(1, 1, -3))),
            both(lambda b, m: b.rowclone(0, 1)), {"outputs": [1]},
            ref_sem.DIFFERENT)


def _pair_or_vs_and():
    def a(b, m):
        b.reserve_control_rows()
        b.ambit_and(0, 1, 2)

    def c(b, m):
        b.reserve_control_rows()
        b.ambit_or(0, 1, 2)
    return both(a), both(c), {"outputs": [2]}, ref_sem.DIFFERENT


def _pair_reads_len():
    return (both(lambda b, m: (b.fill(0, 1), b.read_row(0), b.read_row(0))),
            both(lambda b, m: (b.fill(0, 1), b.read_row(0))), {},
            ref_sem.DIFFERENT)


def _pair_side_state():
    return (both(lambda b, m: (b.shift(0, 1, +1), b.fill(1, 0))),
            both(lambda b, m: b.fill(1, 0)), {}, ref_sem.DIFFERENT)


def _pair_payload_content():
    a = both(lambda b, m: (b.write_row(0, np.zeros(WORDS, np.uint32)),
                           b.read_row(0)))
    c = tuple(p.with_payloads((np.full(WORDS, 0xFFFF_FFFF, np.uint32),))
              for p in a)
    assert a[1].digest == c[1].digest
    assert a[1].payload_digest != c[1].payload_digest
    return a, c, {}, ref_sem.DIFFERENT


def _pair_budget():
    a = both(lambda b, m: b.tra(0, 1, 2))
    return a, a, {"max_inputs": 2}, ref_sem.UNKNOWN


def _pair_same():
    a = crossed(ref.ambit_xor_program())
    return a, a, {}, ref_sem.EQUIVALENT


PAIRS = {"maj_commutes": _pair_maj_commutes,
         "shift_round_trip": _pair_shift_round_trip,
         "or_vs_and": _pair_or_vs_and, "reads_len": _pair_reads_len,
         "side_state": _pair_side_state,
         "payload_content": _pair_payload_content, "budget": _pair_budget,
         "same": _pair_same}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_proofs_equal_the_reference(name):
    (ra, pa), (rb, pb), kw, verdict = PAIRS[name]()
    want = ref_sem.prove_equivalent(ra, rb, **kw)
    got = port_sem.prove_equivalent(pa, pb, **kw)
    assert report_key(got) == report_key(want)
    assert got.verdict == verdict
    assert got.ok is (verdict == port_sem.EQUIVALENT)
    if verdict == port_sem.DIFFERENT:
        assert port_sem.check_witness(pa, pb, got.witness, device="cpu")
    if verdict == port_sem.UNKNOWN:
        assert got.unknown


def test_witness_details_of_the_reference_tests():
    (_, pa), (_, pb), kw, _ = _pair_shift_round_trip()
    rep = port_sem.prove_equivalent(pa, pb, **kw)
    assert rep.component == "row 1" and rep.witness.lane >= LANES - 3
    (_, pa), (_, pb), kw, _ = _pair_reads_len()
    rep = port_sem.prove_equivalent(pa, pb, **kw)
    assert rep.component == "number of host reads"
    assert rep.witness.kind == "reads_len"
    (_, pa), (_, pb), kw, _ = _pair_side_state()
    assert port_sem.prove_equivalent(pa, pb).witness.kind in ("mig_top",
                                                              "mig_bot")


def test_shape_mismatch_raises():
    a = port.ProgramBuilder(ROWS, WORDS)
    a.issue()
    b = port.ProgramBuilder(ROWS, WORDS * 2)
    b.issue()
    with pytest.raises(ValueError, match="shapes"):
        port_sem.prove_equivalent(a.build(), b.build())


def test_analysis_cache_hits_same_content_misses_new_content():
    _, p1 = both(lambda b, m: (b.write_row(0, np.zeros(WORDS, np.uint32)),
                               b.read_row(0)))
    p2 = p1.with_payloads((np.ones(WORDS, np.uint32),))
    port_sem.analyze(p1)                  # warm
    port.reset_stats()
    port_sem.analyze(p1)
    assert port_sem.SEM_STATS["analysis_hits"] == 1
    assert port_sem.SEM_STATS["analyses"] == 0
    port_sem.analyze(p2)                  # same digest, new content: MISS
    assert port_sem.SEM_STATS["analyses"] == 1


def test_caches_are_the_ports_own():
    """The reference's analysis of a program does not warm the port's
    cache: the two packages share no module state."""
    r, p = crossed(ref.ambit_xor_program(16, 2))
    port_sem._SEM_CACHE.clear()
    ref_sem.analyze(r)
    port.reset_stats()
    port_sem.analyze(p)
    assert port_sem.SEM_STATS["analyses"] == 1
    assert port_sem._SEM_CACHE is not ref_sem._SEM_CACHE


# ---------------------------------------------------------------------------
# The compile gate: fused == unfused, proved
# ---------------------------------------------------------------------------

REAL_KERNELS = {
    "ambit_xor": lambda: crossed(ref.ambit_xor_program()),
    "shift_workload": lambda: crossed(
        ref.shift_workload_program(64, num_rows=64, words=32)),
    "xor_reduce": lambda: crossed(ref.xor_reduce_program(
        32, 8, rows=[0, 1, 2], dst=3)),
    "gf.xtime": lambda: (_recorded_xtime(),
                         port_lint._recorded_xtime("cpu")),
    "rs.encode": lambda: (_recorded_rs_encode(),
                          port_lint._recorded_rs_encode("cpu")),
}


@pytest.mark.parametrize("name", sorted(REAL_KERNELS))
def test_verify_semantics_gate_passes_real_kernels(name):
    r, p = REAL_KERNELS[name]()
    assert p.to_trace() == r.to_trace()
    compiled = port.compile_program(p, verify_semantics=True)
    assert len(compiled.segments) == len(port_compile.fuse(p))
    got = port_sem.fusion_report(p)
    assert report_key(got) == report_key(ref_sem.fusion_report(r))
    assert got.verdict == port_sem.EQUIVALENT


def test_xor_reduce_is_the_ports_own():
    assert xor_reduce_program(32, 8, rows=[0, 1, 2], dst=3).to_trace() == \
        ref.xor_reduce_program(32, 8, rows=[0, 1, 2], dst=3).to_trace()


def test_corrupted_segments_fail_the_gate_with_witness():
    r, p = crossed(ref.shift_workload_program(40, num_rows=32, words=4))
    good = port_compile.fuse(p)
    runs = [i for i, s in enumerate(good)
            if isinstance(s, port_compile.SegShiftRun)]
    assert runs, "expected a fused shift run"
    bad = list(good)
    bad[runs[0]] = dataclasses.replace(bad[runs[0]], k=bad[runs[0]].k - 1)
    with pytest.raises(port_sem.EquivalenceError) as ei:
        port_sem.verify_fusion(p, tuple(bad))
    rep = ei.value.report
    assert rep.verdict == port_sem.DIFFERENT
    assert port_sem.check_witness(p, p, rep.witness, device="cpu") is False
    assert port_sem.fusion_report(p, tuple(bad)).verdict == \
        port_sem.DIFFERENT
    assert port_sem.fusion_report(p, good).verdict == port_sem.EQUIVALENT
    # the reference finds the same difference in its own corrupted list
    rgood = ref.fuse(r)
    rbad = list(rgood)
    rbad[runs[0]] = dataclasses.replace(rbad[runs[0]],
                                        k=rbad[runs[0]].k - 1)
    want = ref_sem.fusion_report(r, tuple(rbad))
    assert report_key(rep) == report_key(want)
    assert str(ei.value) == str(ref_sem.EquivalenceError(want))


def test_dropped_host_read_fails_the_gate():
    p = port.ambit_xor_program()
    good = port_compile.fuse(p)
    bad = tuple(s for s in good
                if not isinstance(s, port_compile.SegHost)
                or s.op.op != port_ir.OP_READ)
    assert len(bad) == len(good) - 1
    with pytest.raises(port_sem.EquivalenceError):
        port_sem.verify_fusion(p, bad)
    with pytest.raises(port_sem.EquivalenceError):
        port_sem.verify_fusion(p, bad[:-1] + (bad[-1], bad[-1]))


# ---------------------------------------------------------------------------
# PIM4xx findings through lint (default OFF, opt-in ON)
# ---------------------------------------------------------------------------

def test_lint_semantic_tier_is_opt_in():
    r, p = both(lambda b, m: (b.rowclone(0, 1), b.rowclone(1, 0)))
    assert "PIM404" not in port.lint_program(p).codes()
    report = port.lint_program(p, semantic=True)
    assert [dataclasses.asdict(d) for d in report.diagnostics] == \
        [dataclasses.asdict(d)
         for d in ref.lint_program(r, semantic=True).diagnostics]
    hit = next(d for d in report.diagnostics if d.code == "PIM404")
    assert hit.op_index == 1
    assert report.ok


def _constant(b, m):
    b.rowclone(0, m.T0)
    b.not_to_dcc(0)
    b.dcc_to(m.T1)
    b.rowclone(m.C0, m.T2)
    b.tra(m.T0, m.T1, m.T2)         # maj(x, ~x, 0) == 0


FINDINGS = {
    "constant": (_constant, "PIM401"),
    "double_not": (lambda b, m: (b.not_to_dcc(0), b.dcc_to(1),
                                 b.not_to_dcc(1), b.dcc_to(2)), "PIM403"),
    "shift_off_edge": (lambda b, m: b.shift_k(0, 1, LANES), "PIM401"),
    "shift_cancels": (lambda b, m: (b.fill(0, 0x0FF0), b.shift_k(0, 1, 4),
                                    b.shift_k(1, 1, -4)), "PIM403"),
    "equal_operands": (lambda b, m: (b.rowclone(0, 1), b.tra(0, 1, 2)),
                       "PIM402"),
}


@pytest.mark.parametrize("name", sorted(FINDINGS))
def test_findings_equal_the_reference(name):
    record, code = FINDINGS[name]
    r, p = both(record)
    got = port_sem.semantic_findings(p)
    assert got == ref_sem.semantic_findings(r)
    assert code in [c for c, _, _ in got]


def test_malformed_streams_give_no_findings():
    ops = (port_ir.PimOp(port_ir.OP_WRITE, b=0, payload=3),)
    p = port_ir.PimProgram(ops=ops, num_rows=ROWS, words=WORDS)
    assert port_sem.semantic_findings(p) == ()


# ---------------------------------------------------------------------------
# Scale and warm hits (the reference's timing guard is printed by
# chip_smoke.py, not asserted here)
# ---------------------------------------------------------------------------

def test_100k_op_stream_analyzes_to_a_constant():
    n = 100_000
    b = port.ProgramBuilder(64, 4)
    b.shift(0, 1, +1)
    for _ in range(n - 1):
        b.shift(1, 1, +1)
    m = port_sem.analyze(b.build())
    assert port_sem.is_const(m.value(1))
    assert port_sem.lane_const(m.value(1), 0) == 0


def test_warm_hits_rebuild_zero_column_tables():
    b = port.ProgramBuilder(ROWS, WORDS)
    b.reserve_control_rows()
    b.ambit_xor(0, 1, 2)
    prog = b.build()
    for _ in range(2):
        if _:
            port.reset_stats()
        port_sem.analyze(prog)
        port_sem.semantic_findings(prog)
        port_sem.prove_equivalent(prog, prog)
        port_sem.fusion_report(prog)
    assert port_ir.COLUMN_STATS["builds"] == 0
    assert port_sem.SEM_STATS["analyses"] == 0
    assert port_sem.SEM_STATS["proofs"] == 0
    assert port_sem.SEM_STATS["analysis_hits"] >= 2
    assert port_sem.SEM_STATS["proof_hits"] >= 2


# ---------------------------------------------------------------------------
# The differential leg: verdicts agree with execution, and with the
# reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(30))
def test_sem_agrees_with_execution_and_the_reference(seed):
    rng = np.random.default_rng(seed)
    prog = _build_program(rng, 1 + seed % 24)
    mut = _mutate(prog, rng)
    (r, p), (rm, pm) = crossed(prog), crossed(mut)

    got = port_sem.fusion_report(p)
    assert report_key(got) == report_key(ref_sem.fusion_report(r))
    assert got.verdict != port_sem.DIFFERENT
    assert port_sem.prove_equivalent(p, p).verdict != port_sem.DIFFERENT
    assert port_sem.summarize(p) == ref_sem.summarize(r)
    assert port_sem.semantic_findings(p) == ref_sem.semantic_findings(r)

    rep = port_sem.prove_equivalent(p, pm)
    assert report_key(rep) == report_key(ref_sem.prove_equivalent(r, rm))
    if rep.verdict == port_sem.DIFFERENT:
        assert rep.witness is not None
        assert port_sem.check_witness(p, pm, rep.witness, device="cpu")
    elif rep.verdict == port_sem.EQUIVALENT:
        for _ in range(2):
            bits = rng.integers(0, 2**32, (p.num_rows, p.words),
                                dtype=np.uint32)
            sa, ra = port_isa.run_on_bits(p, bits, device="cpu")
            sb, rb = port_isa.run_on_bits(pm, bits, device="cpu")
            for f in ("bits", "mig_top", "mig_bot", "dcc"):
                assert torch.equal(getattr(sa, f), getattr(sb, f)), f
            assert len(ra) == len(rb)
            for x, y in zip(ra, rb):
                assert torch.equal(x, y)
