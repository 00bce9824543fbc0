"""The rowops row entries (``bitwise_rows``, ``shift_rows``: one launch per
fused segment or one-hop row on the card, in place on the slot state) on
the CPU, where they run their plain versions.

- The plain versions against the reference's own composition of the same
  rows (``repro.core.pim.isa.shift_row_words`` and ``maj3_words``, the
  migration masks and last hop of ``repro/core/pim/exec.py``) on seeded
  rows, at 1 and 3 slots, for every alias pattern the executor produces: a
  MAJ whose destination is a source, a TRA onto its own operands, a NOT
  in place, a NOT to the DCC row only, and a shift whose source is its
  destination.
- ``execute(..., use_kernels=True)`` on the CPU against the reference's
  ``execute`` on programs that hit each alias, on batched states and on the
  bit-plane VM's recorded routines.
- The executor issues no torch op outside the two entries for fused MAJ,
  NOT and shift segments and residual SHIFT, TRA and NOT-to-DCC rows.

Rows cross as uint32 numpy arrays, int32 bit patterns on the port's side.
Tolerance: exact equality everywhere (float32 meter fields as bit
patterns).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pim as ref  # noqa: E402
from repro.core.bitplane import PimVM as RefVM  # noqa: E402
from repro.core.bitplane import arith as ref_arith  # noqa: E402
from repro.core.bitplane import gf as ref_gf  # noqa: E402
from repro.core.pim import exec as ref_exec  # noqa: E402
from repro.core.pim import ir as ref_ir  # noqa: E402
from repro.core.pim import isa as ref_isa  # noqa: E402
from repro.core.pim import state as ref_state  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pim as port  # noqa: E402
from repro_torch.core.pim import exec as port_exec  # noqa: E402
from repro_torch.core.pim import ir as port_ir  # noqa: E402
from repro_torch.core.pim.compile import SegScan, SegShiftRun  # noqa: E402
from repro_torch.kernels.rowops import ops  # noqa: E402
from repro_torch.kernels.rowops import ref as plain  # noqa: E402

R, W = 12, 8


def state_rows(slots, seed, rows=R, words=W):
    return np.random.default_rng(seed).integers(
        0, 2**32, (slots, rows, words), dtype=np.uint32)


def to_port(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def from_port(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def ref_bitwise_rows(bits, op, srcs, dsts, side):
    """The reference's row math (``maj3_words``, ``~``, ...) per slot."""
    rows = [jnp.asarray(bits[:, s]) for s in srcs]
    m = {"not": lambda: ~rows[0], "and": lambda: rows[0] & rows[1],
         "or": lambda: rows[0] | rows[1], "xor": lambda: rows[0] ^ rows[1],
         "maj": lambda: ref_isa.maj3_words(*rows)}[op]()
    out = bits.copy()
    for d in dsts:
        out[:, d] = np.asarray(m)
    return out, (np.asarray(m) if side else None)


def ref_shift_rows(bits, src, dst, delta, k):
    """The reference executor's lowering of a k-hop chain: a (k-1)-column
    shift, the last hop's migration rows, their merge one column on."""
    y = ref_isa.shift_row_words(jnp.asarray(bits[:, src]), delta * (k - 1))
    even, odd = (jnp.uint32(ref_state.EVEN_MASK),
                 jnp.uint32(ref_state.ODD_MASK))
    mt = y & (even if delta > 0 else odd)
    mb = y & (odd if delta > 0 else even)
    out = bits.copy()
    out[:, dst] = np.asarray(ref_exec._shift1(mt, delta)
                             | ref_exec._shift1(mb, delta))
    return out, np.asarray(mt), np.asarray(mb)


# (op, sources, destinations, side): the executor's alias patterns
BITWISE_CASES = [
    ("maj", (0, 1, 2), (9, 10, 11, 3), False),     # SegMaj, disjoint
    ("maj", (0, 1, 2), (9, 10, 11, 1), False),     # SegMaj, dst is b
    ("maj", (9, 1, 2), (9, 10, 11, 0), False),     # a is T0
    ("maj", (4, 5, 6), (4, 5, 6), False),          # TRA onto its operands
    ("maj", (4, 4, 6), (4, 4, 6), False),          # TRA, a repeated row
    ("not", (7,), (7,), True),                     # SegNot in place + DCC
    ("not", (7,), (8,), True),                     # SegNot out of place
    ("not", (7,), (), True),                       # NOT2DCC: DCC only
    ("and", (2, 3), (2,), False),
    ("or", (2, 3), (3,), False),
    ("xor", (2, 3), (5,), True),
]


@pytest.mark.parametrize("slots", [1, 3])
@pytest.mark.parametrize("case", BITWISE_CASES, ids=str)
def test_bitwise_rows_matches_reference_composition(slots, case):
    op, srcs, dsts, side = case
    bits = state_rows(slots, 11 + len(srcs) + 7 * len(dsts))
    exp, exp_side = ref_bitwise_rows(bits, op, srcs, dsts, side)
    for fn in (plain.ref_bitwise_rows, ops.bitwise_rows):
        got = to_port(bits)
        out = fn(got, op, srcs, dsts, side)
        assert np.array_equal(from_port(got), exp)
        if side:
            assert out.shape == (slots, W)
            assert np.array_equal(from_port(out), exp_side)
            # the side row is a new tensor, not a view of the state
            out.fill_(0)
            assert np.array_equal(from_port(got), exp)
        else:
            assert out is None


# (src, dst, delta, k): in place at k 1, 5 and 40, out of place, both
# directions, k - 1 at and beyond 32·W
SHIFT_CASES = [(s, d, delta, k)
               for s, d in ((3, 3), (3, 4), (4, 3))
               for delta in (1, -1)
               for k in (1, 5, 40, 32 * W, 32 * W + 1, 32 * W + 9)]


@pytest.mark.parametrize("slots", [1, 3])
@pytest.mark.parametrize("case", SHIFT_CASES, ids=str)
def test_shift_rows_matches_reference_composition(slots, case):
    src, dst, delta, k = case
    bits = state_rows(slots, 40 + k % 17)
    exp, exp_mt, exp_mb = ref_shift_rows(bits, src, dst, delta, k)
    for fn in (plain.ref_shift_rows, ops.shift_rows):
        got = to_port(bits)
        mt, mb = fn(got, src, dst, delta, k)
        assert np.array_equal(from_port(got), exp)
        assert np.array_equal(from_port(mt), exp_mt)
        assert np.array_equal(from_port(mb), exp_mb)


def test_shift_rows_is_one_shift_by_k():
    """The destination is the source shifted k columns (the masks split
    y's bits, and zero-filled shifts compose), which the kernel computes
    directly."""
    bits = to_port(state_rows(2, 5))
    for delta in (1, -1):
        for k in (1, 2, 31, 32, 33, 100):
            got = bits.clone()
            plain.ref_shift_rows(got, 0, 1, delta, k)
            assert torch.equal(got[:, 1],
                               plain.ref_shift_cols(bits[:, 0], delta * k))


def test_row_entries_check_their_inputs_and_launch_nothing_here():
    bits = to_port(state_rows(2, 1))
    ops.reset_launches()
    with pytest.raises(TypeError):
        ops.bitwise_rows(bits.to(torch.int64), "not", (0,), (1,))
    with pytest.raises(ValueError, match="B, R, W"):
        ops.bitwise_rows(bits[0], "not", (0,), (1,))
    with pytest.raises(ValueError, match="source rows"):
        ops.bitwise_rows(bits, "maj", (0, 1), (2,))
    with pytest.raises(ValueError, match="1-4 rows"):
        ops.bitwise_rows(bits, "not", (0,))
    with pytest.raises(ValueError, match="1-4 rows"):
        ops.bitwise_rows(bits, "not", (0,), (1, 2, 3, 4, 5))
    with pytest.raises(ValueError, match="row 12"):
        ops.bitwise_rows(bits, "not", (0,), (R,))
    with pytest.raises(ValueError):
        ops.bitwise_rows(bits, "nand", (0, 1), (2,))
    with pytest.raises(ValueError, match="delta"):
        ops.shift_rows(bits, 0, 1, 2, 1)
    with pytest.raises(ValueError, match="k >= 1"):
        ops.shift_rows(bits, 0, 1, 1, 0)
    with pytest.raises(ValueError, match="row -1"):
        ops.shift_rows(bits, -1, 1, 1, 1)
    with pytest.raises(ValueError):
        ops.shift_rows(torch.zeros((1, 2, 4), dtype=torch.int32,
                                   device="meta"), 0, 1, 1, 1)
    ops.bitwise_rows(bits, "maj", (0, 1, 2), (0, 1, 2, 3))
    ops.shift_rows(bits, 0, 0, 1, 3)
    assert all(v == 0 for d in (ops.LAUNCHES, ops.ROWS_BY_OP,
                                ops.SHIFT_ROUTES) for v in d.values())


# ---------------------------------------------------------------------------
# The executor on programs that hit each alias, against the reference
# ---------------------------------------------------------------------------

ROWS, WORDS = 32, 8


def alias_program(rng):
    """Every alias the row entries see, recorded with the reference's
    builder: MAJ idioms writing a source, NOT pairs in place, fused shift
    chains and one-hop shifts in place and out of place, TRA, a lone
    NOT-to-DCC."""
    b = ref_ir.ProgramBuilder(ROWS, WORDS)
    b.issue().reserve_control_rows()
    b.write_row(0, rng.integers(0, 2**32, (WORDS,), dtype=np.uint32))
    b.ambit_maj(0, 1, 2, 0)                   # SegMaj, dst = a
    b.ambit_maj(3, 4, 5, 5)                   # SegMaj, dst = c
    b.ambit_and(6, 7, 7)
    b.ambit_not(8, 8)                         # SegNot in place
    b.ambit_xor(1, 2, 1)
    b.shift_k(9, 9, 40)                       # SegShiftRun in place
    b.shift_k(10, 10, -33)
    b.shift_k(11, 12, 37)                     # out of place
    b.shift_k(12, 12, 32 * WORDS + 2)         # in place, shifted out
    b.shift(13, 13, 1).shift(13, 13, -1)      # one-hop rows in place
    b.shift_k(14, 14, 5).shift_k(14, 15, -3)  # residual chains
    b.tra(16, 17, 18).tra(16, 16, 19)         # TRA, a repeated row
    b.not_to_dcc(15).rowclone(15, 20)         # lone NOT2DCC
    b.dcc_to(21)
    b.read_row(0)
    b.read_row(21)
    return b.build()


def assert_equal_to_reference(r, p, r_reads, p_reads):
    got = convert.to_numpy(p)
    for f in ("bits", "mig_top", "mig_bot", "dcc"):
        assert np.array_equal(np.asarray(getattr(r, f)), got[f]), f
    for f in ("time_ns", "e_act", "e_pre", "e_refresh", "e_burst",
              "e_background"):
        assert np.asarray(getattr(r.meter, f), np.float32).view(np.uint32) \
            == getattr(p.meter, f).numpy().view(np.uint32), f
    for f in ("n_act", "n_pre", "n_aap", "n_shift", "n_tra", "n_refresh"):
        assert int(getattr(r.meter, f)) == int(getattr(p.meter, f)), f
    assert len(r_reads) == len(p_reads)
    for x, y in zip(r_reads, p_reads):
        assert np.array_equal(np.asarray(x), from_port(y))


def fresh_states(bits):
    r = ref.reserve_control_rows(ref.make_subarray(
        ROWS, WORDS, jnp.asarray(bits)))
    p = port.reserve_control_rows(port.make_subarray(ROWS, WORDS, bits,
                                                     device="cpu"))
    return r, p


@pytest.mark.parametrize("seed", range(3))
def test_execute_alias_program_matches_reference(seed):
    rng = np.random.default_rng(500 + seed)
    prog = alias_program(rng)
    pp = port.PimProgram.from_trace(prog.to_trace())
    kinds = {type(s).__name__ for s in port.compile_program(pp).segments}
    assert {"SegMaj", "SegNot", "SegShiftRun", "SegScan"} <= kinds
    r0, p0 = fresh_states(rng.integers(0, 2**32, (ROWS, WORDS),
                                       dtype=np.uint32))
    r = ref_exec.execute(prog, r0)
    for use_kernels in (True, False):
        p = port.execute(pp, p0, use_kernels=use_kernels)
        assert_equal_to_reference(r.state, p.state, r.reads, p.reads)


def test_execute_alias_program_on_a_batch_matches_reference():
    """Three slots in one run of the port's runner (one row-entry call per
    segment for the batch) against the reference slot by slot."""
    rng = np.random.default_rng(9)
    prog = alias_program(rng)
    pp = port.PimProgram.from_trace(prog.to_trace())
    slots = [rng.integers(0, 2**32, (ROWS, WORDS), dtype=np.uint32)
             for _ in range(3)]
    states = [fresh_states(b) for b in slots]
    batch = port.SubarrayState(
        bits=torch.stack([p.bits for _, p in states]),
        mig_top=torch.stack([p.mig_top for _, p in states]),
        mig_bot=torch.stack([p.mig_bot for _, p in states]),
        dcc=torch.stack([p.dcc for _, p in states]),
        meter=port.CostMeter.zeros("cpu", shape=(3,)))
    out = port.execute(pp, batch, use_kernels=True)
    for s, (r0, _) in enumerate(states):
        r = ref_exec.execute(prog, r0)
        p = out.state.map(lambda t, s=s: t[s])
        assert_equal_to_reference(r.state, p, r.reads,
                                  [x[s] for x in out.reads])


VM_ROUTINES = {
    "add_ripple": lambda vm, a, b: ref_arith.add_ripple(vm, a, b),
    "mul_shift_add": lambda vm, a, b: ref_arith.mul_shift_add(vm, a, b),
    "gf_mul": lambda vm, a, b: ref_gf.gf_mul(vm, a, b),
    "mixcolumns": lambda vm, a, b: ref_gf.mixcolumns(vm, a),
}


@pytest.mark.parametrize("name", sorted(VM_ROUTINES))
def test_execute_vm_routines_match_reference(name):
    """A bit-plane routine as the VM records it (loads, masks, the routine,
    a read), run by both executors from the same state."""
    vm = RefVM(width=8, num_rows=96, words=4)
    rng = np.random.default_rng(len(name))
    a = vm.load(rng.integers(0, 256, vm.lanes))
    b = vm.load(rng.integers(0, 256, vm.lanes))
    out = VM_ROUTINES[name](vm, a, b)
    vm._builder.read_row(out)
    prog = vm.take_recorded()
    pp = port.PimProgram.from_trace(prog.to_trace())
    bits = np.random.default_rng(3).integers(0, 2**32, (96, 4),
                                             dtype=np.uint32)
    r0 = ref.reserve_control_rows(ref.make_subarray(96, 4,
                                                    jnp.asarray(bits)))
    p0 = port.reserve_control_rows(port.make_subarray(96, 4, bits,
                                                      device="cpu"))
    r = ref_exec.execute(prog, r0)
    p = port.execute(pp, p0, use_kernels=True)
    assert_equal_to_reference(r.state, p.state, r.reads, p.reads)


# ---------------------------------------------------------------------------
# Dispatch: one row-entry call per segment or row, and no torch op besides
# ---------------------------------------------------------------------------

def test_executor_issues_no_op_outside_the_row_entries():
    """Every fused MAJ, NOT and shift segment and every residual SHIFT, TRA
    and NOT-to-DCC row is one call of a row entry, and the executor
    dispatches no torch op of its own around them (no row slice, gather,
    copy or mask): on the card each is exactly one launch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    b = port.ProgramBuilder(ROWS, WORDS)
    b.issue()
    b.ambit_maj(0, 1, 2, 0).ambit_maj(3, 4, 5, 6)
    b.ambit_not(7, 7).ambit_not(7, 8)
    b.shift_k(9, 9, 40).shift_k(10, 11, -35)
    b.shift_k(12, 12, 3).shift(12, 13, -1)
    b.tra(14, 15, 16).not_to_dcc(14).tra(17, 18, 19)
    prog = b.build()
    compiled = port.compile_program(prog)
    segs = compiled.segments
    rows = [op for seg in segs if isinstance(seg, SegScan) for op in seg.ops]
    kinds = {type(seg).__name__ for seg in segs}
    assert kinds == {"SegMaj", "SegNot", "SegShiftRun", "SegScan"}
    assert {op.op for op in rows} == {port_ir.OP_SHIFT, port_ir.OP_TRA,
                                      port_ir.OP_NOT2DCC}
    expected = sum(not isinstance(seg, SegScan) for seg in segs) + len(rows)
    shifts = (sum(isinstance(seg, SegShiftRun) for seg in segs)
              + sum(op.op == port_ir.OP_SHIFT for op in rows))
    assert (expected, shifts) == (13, 6)

    calls, outside = [], []
    inside = [False]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not inside[0]:
                outside.append(str(func))
            return func(*args, **(kwargs or {}))

    def counted(fn):
        def wrapper(*args, **kwargs):
            calls.append(fn.__name__)
            inside[0] = True
            try:
                return fn(*args, **kwargs)
            finally:
                inside[0] = False
        return wrapper

    st = port.reserve_control_rows(port.make_subarray(
        ROWS, WORDS, state_rows(1, 2, ROWS, WORDS)[0], device="cpu"))
    bits = st.bits.unsqueeze(0).clone()
    mt, mb, dcc = (t.unsqueeze(0) for t in (st.mig_top, st.mig_bot, st.dcc))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "bitwise_rows", counted(ops.bitwise_rows))
        mp.setattr(ops, "shift_rows", counted(ops.shift_rows))
        with Count():
            got = port_exec._run_segments(compiled, bits, mt, mb, dcc, None)
    assert outside == []
    assert len(calls) == expected
    assert calls.count("shift_rows") == shifts
    eager, _ = port.run_program(st, prog)          # the eager ISA's rows
    for x, y in zip((bits,) + got[:3], (eager.bits, eager.mig_top,
                                        eager.mig_bot, eager.dcc)):
        assert torch.equal(x[0], y)


def test_row_entries_on_the_card_go_to_the_kernel(monkeypatch):
    """What a CUDA state takes: the kernel library with the rows as base
    pointers and the slot stride, one count per launch, never the plain
    version; a shift beyond 32·W clamped; an in-place row above the
    cluster's reach through a scratch row."""
    from types import SimpleNamespace

    calls = []

    class Lib:
        def rowops_bitwise_rows(self, *args):
            calls.append(("bitwise_rows", args))
            return 0

        def rowops_shift_rows(self, *args):
            calls.append(("shift_rows", args))
            return 0

        def rowops_shift_rows_cluster_words(self):
            return 8

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA state reached the plain version")

    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    monkeypatch.setattr(ops, "_lib", lambda: Lib())
    monkeypatch.setattr(ops._ref, "ref_bitwise_rows", plain)
    monkeypatch.setattr(ops._ref, "ref_shift_rows", plain)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    ops.shift_rows_cluster_words.cache_clear()
    ops.reset_launches()
    bits = torch.zeros((2, 6, 8), dtype=torch.int32)
    p, row, stride = bits.data_ptr(), 32, 48
    dcc = ops.bitwise_rows(bits, "not", (1,), (2,), side=True)
    ops.bitwise_rows(bits, "maj", (0, 1, 2), (3, 4, 5, 0))
    ops.bitwise_rows(bits, "not", (4,), side=True)
    mt, mb = ops.shift_rows(bits, 3, 3, -1, 5)
    ops.shift_rows(bits, 0, 1, 1, 10**9)
    assert calls[0] == ("bitwise_rows", (
        p + row, p + row, p + row, p + 2 * row, None, None, None, 1,
        dcc.data_ptr(), 2, 8, stride, 0, 7))
    assert calls[1][1][:8] == (p, p + row, p + 2 * row, p + 3 * row,
                               p + 4 * row, p + 5 * row, p, 4)
    assert calls[1][1][8] is None and calls[1][1][12] == 4
    assert calls[2][1][3:8] == (None, None, None, None, 0)
    assert calls[3] == ("shift_rows", (
        p + 3 * row, p + 3 * row, stride, mt.data_ptr(), mb.data_ptr(), None,
        2, 8, 4, 0, 7))
    assert calls[4][1][8:10] == (32 * 8, 1)
    assert ops.LAUNCHES["bitwise_rows"] == 3
    assert ops.LAUNCHES["shift_rows"] == 2
    assert ops.ROWS_BY_OP == {"not": 2, "and": 0, "or": 0, "xor": 0, "maj": 1}
    assert ops.SHIFT_ROUTES == {"out_of_place": 1, "in_place": 1,
                                "scratch": 0}
    wide = torch.zeros((1, 3, 12), dtype=torch.int32)    # above 8 words
    ops.shift_rows(wide, 2, 2, 1, 1)
    assert calls[5][1][5] is not None and ops.SHIFT_ROUTES["scratch"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        ops.bitwise_rows(bits.transpose(0, 1), "not", (0,), (1,))
    with pytest.raises(ValueError, match="contiguous"):
        ops.shift_rows(bits.transpose(0, 1), 0, 1, 1, 1)
    assert len(calls) == 6
    ops.shift_rows_cluster_words.cache_clear()
    ops.reset_launches()
