"""Parity of the port's bit-plane layer (``PimVM`` with ``arith``, ``gf``
and ``rs``) with the JAX reference, on the CPU.

The same routine runs on the reference's ``PimVM`` and on the port's
(``device="cpu"``), with the same operands made by numpy from a seed, on
single-bank, eager, lane-sharded (2 and 4 banks) and async-host VMs at 2 to
8 words per row. Tolerance: exact everywhere — equal program digests,
reads and integer counts; ``time_ns``, ``energy_nj``, ``setup_energy_nj``
and ``host_overlap_ns`` equal as float32 bit patterns.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.bitplane import PimVM as RefVM  # noqa: E402
from repro.core.bitplane import arith as ref_arith  # noqa: E402
from repro.core.bitplane import gf as ref_gf  # noqa: E402
from repro.core.bitplane import layout as ref_layout  # noqa: E402
from repro.core.bitplane import rs as ref_rs  # noqa: E402
from repro_torch.core.bitplane import PimVM as PortVM  # noqa: E402
from repro_torch.core.bitplane import arith, gf, layout, rs  # noqa: E402

REF = (RefVM, ref_arith, ref_gf, ref_rs)
PORT = (lambda *a, **k: PortVM(*a, device="cpu", **k), arith, gf, rs)


def f32_bits(x) -> int:
    return int(np.float32(x).view(np.uint32))


def _routine(name):
    """``run(vm, arith, gf, rs, rng) -> output registers``."""
    def two(vm, rng):
        return (vm.load(rng.integers(0, 256, vm.lanes)),
                vm.load(rng.integers(0, 256, vm.lanes)))

    def msgs(vm, rng, k=3):
        return [vm.load(rng.integers(0, 256, vm.lanes)) for _ in range(k)]

    return {
        "add_ripple": lambda vm, A, G, R, rng: [
            A.add_ripple(vm, *two(vm, rng))],
        "add_kogge_stone": lambda vm, A, G, R, rng: [
            A.add_kogge_stone(vm, *two(vm, rng))],
        "mul_shift_add": lambda vm, A, G, R, rng: [
            A.mul_shift_add(vm, *two(vm, rng))],
        "xtime": lambda vm, A, G, R, rng: [G.xtime(vm, two(vm, rng)[0])],
        "gf_mul": lambda vm, A, G, R, rng: [G.gf_mul(vm, *two(vm, rng))],
        "gf_mul_const": lambda vm, A, G, R, rng: [G.gf_mul_const(
            vm, two(vm, rng)[0], 0x1D, poly=G.RS_POLY)],
        "mixcolumns": lambda vm, A, G, R, rng: [
            G.mixcolumns(vm, two(vm, rng)[0])],
        "rs_encode": lambda vm, A, G, R, rng: R.rs_encode(vm, msgs(vm, rng),
                                                          2),
        "rs_syndromes": lambda vm, A, G, R, rng: R.rs_syndromes(
            vm, msgs(vm, rng), 2),
    }[name]


def run_both(name, seed=0, **vm_kw):
    """The routine on both VMs: per package, (digest of the recorded
    stream or None for eager, reads, counts, float32 meter bits)."""
    out = []
    for make, A, G, R in (REF, PORT):
        vm = make(width=8, num_rows=96, **vm_kw)
        regs = _routine(name)(vm, A, G, R, np.random.default_rng(seed))
        digest = None if vm.eager else vm._builder.build().digest
        reads = vm.read_many(regs)
        meters = [f32_bits(m) for m in (vm.time_ns, vm.energy_nj,
                                        vm.setup_energy_nj,
                                        vm.host_overlap_ns)]
        out.append((digest, reads, vm.counts(), meters))
    return out


def assert_same(ref, port):
    (rd, rr, rc, rm), (pd, pr, pc, pm) = ref, port
    assert rd == pd, "program digests differ"
    assert len(rr) == len(pr)
    for a, b in zip(rr, pr):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert rc == pc
    assert rm == pm, f"float32 meters differ: {rm} != {pm}"


ROUTINES = ["add_ripple", "add_kogge_stone", "mul_shift_add", "xtime",
            "gf_mul", "gf_mul_const", "mixcolumns", "rs_encode",
            "rs_syndromes"]


@pytest.mark.parametrize("name", ROUTINES)
def test_single_bank_matches_reference(name):
    words = {"mul_shift_add": 2, "gf_mul": 2}.get(name, 4)
    assert_same(*run_both(name, seed=1, words=words))


@pytest.mark.parametrize("name", ["add_ripple", "xtime", "mixcolumns",
                                  "rs_syndromes"])
def test_eager_matches_reference(name):
    assert_same(*run_both(name, seed=2, words=2, eager=True))


@pytest.mark.parametrize("name,n_banks,async_host,words", [
    ("add_ripple", 2, False, 4), ("gf_mul_const", 2, False, 8),
    ("rs_encode", 2, True, 4), ("add_kogge_stone", 4, True, 8),
    ("xtime", 4, False, 4), ("mixcolumns", 4, True, 4),
    ("rs_syndromes", 4, True, 8)])
def test_sharded_matches_reference(name, n_banks, async_host, words):
    assert_same(*run_both(name, seed=3, words=words, n_banks=n_banks,
                          async_host=async_host))


def test_multi_flush_async_pipeline_matches_reference():
    """The case study's async pipeline at a small size: per chunk, loads +
    RS encode + one ``read_many`` flush; the wall clock and hidden host
    time accumulate over flushes as float32 tensors."""
    out = []
    for make, _, _, R in (REF, PORT):
        rng = np.random.default_rng(7)
        vm = make(width=8, num_rows=96, words=4, n_banks=2, async_host=True)
        pars = []
        for _ in range(3):
            regs = [vm.load(rng.integers(0, 256, vm.lanes))
                    for _ in range(3)]
            par = R.rs_encode(vm, regs, 2)
            pars.append(np.stack(vm.read_many(par)))
            vm.free(*regs, *par)
        out.append((np.stack(pars), [f32_bits(m) for m in (
            vm.time_ns, vm.energy_nj, vm.host_overlap_ns)]))
    (rp, rm), (pp, pm) = out
    assert np.array_equal(rp, pp) and rm == pm
    assert pm[2] != 0                   # the async engine hid host time


def test_take_recorded_matches_reference():
    progs = []
    for make, A, _, _ in (REF, PORT):
        vm = make(width=4, num_rows=64, words=2)
        rng = np.random.default_rng(4)
        a = vm.load(rng.integers(0, 16, vm.lanes))
        A.add_ripple(vm, a, vm.mask(0b0101))
        progs.append(vm.take_recorded())
        assert len(vm._builder) == 0
    assert progs[0].digest == progs[1].digest
    assert progs[0].to_trace() == progs[1].to_trace()


def test_aes_xtime_cost_matches_reference():
    exp = ref_gf.aes_xtime_cost(vm_words=4)
    got = gf.aes_xtime_cost(vm_words=4, device="cpu")
    assert got["bytes"] == exp["bytes"]
    for k in ("time_ns", "energy_nj"):
        assert f32_bits(got[k]) == f32_bits(exp[k]), k


@pytest.mark.parametrize("width,words", [(1, 2), (4, 3), (8, 2), (16, 4),
                                         (32, 2)])
def test_layout_matches_reference(width, words):
    rng = np.random.default_rng(width)
    n = words * 32 // width
    vals = rng.integers(0, 1 << width, n, dtype=np.uint64)
    row = layout.pack_elements(vals, width, words)
    assert row.dtype == np.uint32
    assert np.array_equal(row, np.asarray(
        ref_layout.pack_elements(vals, width, words)))
    back = layout.unpack_elements(torch.from_numpy(row.view(np.int32)),
                                  width, n)
    assert np.array_equal(back, vals)
    for fn in ("lsb_mask", "msb_mask", "interior_mask", "full_mask"):
        assert np.array_equal(getattr(layout, fn)(width, words), np.asarray(
            getattr(ref_layout, fn)(width, words))), fn


def test_oracles_match_reference():
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, 256, 64), rng.integers(0, 256, 64)
    assert np.array_equal(arith.ref_add(a, b, 8), ref_arith.ref_add(a, b, 8))
    assert np.array_equal(arith.ref_mul(a, b, 8), ref_arith.ref_mul(a, b, 8))
    for poly in (gf.AES_POLY, gf.RS_POLY):
        assert np.array_equal(gf.ref_xtime(a, poly), ref_gf.ref_xtime(a, poly))
        assert np.array_equal(gf.ref_gf_mul(a, b, poly),
                              ref_gf.ref_gf_mul(a, b, poly))
    st = rng.integers(0, 256, (16, 4))
    assert np.array_equal(gf.ref_mixcolumns(st), ref_gf.ref_mixcolumns(st))
    for n_par in (2, 4):
        assert rs.generator_poly(n_par) == ref_rs.generator_poly(n_par)
    msg = rng.integers(0, 256, (8, 32))
    par = rs.ref_rs_encode(msg, 4)
    assert np.array_equal(par, ref_rs.ref_rs_encode(msg, 4))
    cw = np.concatenate([msg.astype(np.uint64), par[::-1]], axis=0)
    assert not rs.ref_rs_syndromes(cw, 4).any()
    cw[3, 7] ^= 0x40
    assert np.array_equal(rs.ref_rs_syndromes(cw, 4),
                          ref_rs.ref_rs_syndromes(cw, 4))


def test_vm_checks_its_options():
    with pytest.raises(NotImplementedError, match="A8"):
        PortVM(width=8, words=2, verify=True, device="cpu")
    with pytest.raises(AssertionError):
        PortVM(width=8, words=2, async_host=True, device="cpu")
    with pytest.raises(AssertionError):
        PortVM(width=8, words=4, n_banks=2, eager=True, device="cpu")
    vm = PortVM(width=8, words=4, n_banks=2, device="cpu")
    with pytest.raises(AssertionError):
        vm.take_recorded()
