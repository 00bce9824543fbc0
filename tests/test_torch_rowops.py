"""The port's rowops wrappers (plain torch versions on the CPU) against the
reference's Pallas kernels in interpret mode, on the same numpy inputs.

Rows cross as uint32 numpy arrays: the port sees them as int32 bit
patterns through a dtype view. Tolerance: exact equality everywhere (the
meter fold compares float32 bit patterns).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.pim import compile as ref_compile  # noqa: E402
from repro.core.pim import isa as ref_isa  # noqa: E402
from repro.kernels.rowops import ops as ref_ops  # noqa: E402
from repro_torch.core.pim import isa as port_isa  # noqa: E402
from repro_torch.kernels.rowops import ops as port_ops  # noqa: E402
from repro_torch.kernels.rowops import ref as port_ref  # noqa: E402


def rand_rows(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, shape,
                                                dtype=np.uint32)


def to_port(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def from_port(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


SHAPES = [(8, 64), (16, 128)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", ["not", "and", "or", "xor", "maj"])
def test_bitwise_matches_pallas(shape, op):
    a, b, c = (rand_rows(shape, s) for s in (1, 2, 3))
    exp = np.asarray(ref_ops.bitwise(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(c), op=op, interpret=True))
    got = port_ops.bitwise(to_port(a), to_port(b), to_port(c), op=op)
    assert got.dtype == torch.int32
    assert np.array_equal(from_port(got), exp)


# The last four shifts reach |k| >= 32·W (everything shifted out), which the
# Pallas kernel guards and the reference's plain ref.py does not.
@pytest.mark.parametrize("k", [0, 1, -1, 3, 31, 32, -32, 33, -33, 100, -100,
                               2047, -2047, 32 * 64 - 1, -(32 * 64 - 1),
                               32 * 64, -32 * 64, 32 * 64 + 5, 10**6])
def test_shift_cols_matches_pallas(k):
    x = rand_rows((8, 64), abs(k) & 0xFF)
    exp = np.asarray(ref_ops.shift_cols(jnp.asarray(x), k, interpret=True))
    got = port_ops.shift_cols(to_port(x), k)
    assert np.array_equal(from_port(got), exp)


@pytest.mark.parametrize("delta", [1, -1, 5, -5, 31, -31, 32, -32, 45, -45,
                                   32 * 8, -32 * 8])
def test_shift_row_words_matches_reference(delta):
    row = rand_rows((3, 8), 7)
    exp = np.asarray(ref_isa.shift_row_words(jnp.asarray(row), delta))
    got = port_isa.shift_row_words(to_port(row), delta)
    assert np.array_equal(from_port(got), exp)


def test_plain_versions_launch_nothing():
    port_ops.reset_launches()
    x = to_port(rand_rows((4, 16), 0))
    port_ops.shift_cols(x, 5)
    port_ops.bitwise(x, x, x, op="maj")
    port_ops.meter_fold(torch.zeros((3, 6)), torch.zeros((3, 6), dtype=torch.int32),
                        torch.zeros((1, 6)), torch.zeros((1, 6), dtype=torch.int32))
    assert all(v == 0 for v in port_ops.LAUNCHES.values())
    assert all(v == 0 for v in port_ops.LAUNCHES_BY_OP.values())


def test_wrappers_check_their_inputs():
    x = to_port(rand_rows((4, 16), 0))
    with pytest.raises(TypeError):
        port_ops.shift_cols(x.to(torch.int64), 1)
    with pytest.raises(ValueError):
        port_ops.bitwise(x, x[:2], op="and")
    with pytest.raises(ValueError):
        port_ops.bitwise(x, op="and")
    with pytest.raises(ValueError):
        port_ops.shift_cols(torch.zeros((4, 16), dtype=torch.int32,
                                        device="meta"), 1)


@pytest.mark.parametrize("m,b", [(0, 1), (1, 3), (257, 2), (1000, 5)])
def test_meter_fold_matches_reference_fold(m, b):
    """The port's fold against the reference's barrier-pinned XLA fold and
    against a Python loop of float32 adds, bit for bit."""
    rng = np.random.default_rng(m + b)
    f_tab = (rng.random((m, 6)) * 10.0 ** rng.integers(-7, 3, (m, 6))
             ).astype(np.float32)
    i_tab = rng.integers(0, 9, (m, 6)).astype(np.int32)
    f0 = (rng.random((b, 6)) * 1e4).astype(np.float32)
    i0 = rng.integers(0, 1000, (b, 6)).astype(np.int32)
    ff, fi = port_ops.meter_fold(torch.from_numpy(f_tab),
                                 torch.from_numpy(i_tab),
                                 torch.from_numpy(f0), torch.from_numpy(i0))
    for s in range(b):
        rf, ri = ref_compile._fold_tables(jnp.asarray(f_tab),
                                          jnp.asarray(i_tab),
                                          jnp.asarray(f0[s]),
                                          jnp.asarray(i0[s]))
        assert np.array_equal(ff[s].numpy().view(np.uint32),
                              np.asarray(rf).view(np.uint32))
        assert np.array_equal(fi[s].numpy(), np.asarray(ri))
        acc = f0[s].copy()
        for r in range(m):
            acc = (acc + f_tab[r]).astype(np.float32)
        assert np.array_equal(ff[s].numpy().view(np.uint32),
                              acc.view(np.uint32))


@pytest.mark.parametrize("m,b", [(1, 1), (300, 3), (4001, 2)])
def test_meter_fold_int_columns_wrap(m, b):
    """Int increments near 2**31 (and negative ones), so that every column
    sum wraps past 2**31 many times: the port's fold (its plain version
    here; on the card a tree of wrap-around uint32 adds, in another order)
    equals the reference's ``_fold_tables`` and the exact sum mod 2**32."""
    rng = np.random.default_rng(90 + m)
    f_tab = rng.random((m, 6)).astype(np.float32)
    i_tab = rng.integers(-2**31, 2**31, (m, 6), dtype=np.int64)
    i_tab[: m // 2] = rng.integers(2**31 - 9, 2**31, (m // 2, 6))
    i_tab = i_tab.astype(np.int32)
    f0 = rng.random((b, 6)).astype(np.float32)
    i0 = rng.integers(-2**31, 2**31, (b, 6), dtype=np.int64).astype(np.int32)
    _, fi = port_ops.meter_fold(torch.from_numpy(f_tab),
                                torch.from_numpy(i_tab),
                                torch.from_numpy(f0), torch.from_numpy(i0))
    exact = (i0.astype(np.int64) + i_tab.astype(np.int64).sum(0)) % 2**32
    assert np.array_equal(fi.numpy().view(np.uint32), exact.astype(np.uint32))
    for s in range(b):
        _, ri = ref_compile._fold_tables(jnp.asarray(f_tab),
                                         jnp.asarray(i_tab),
                                         jnp.asarray(f0[s]),
                                         jnp.asarray(i0[s]))
        assert np.array_equal(fi[s].numpy(), np.asarray(ri))


def test_plain_shift_guards_full_row():
    x = to_port(rand_rows((2, 4), 1))
    assert not port_ref.ref_shift_cols(x, 32 * 4).any()
    assert not port_ref.ref_shift_cols(x, -32 * 4 - 1).any()


WIDTHS = [1, 2, 4, 8, 16, 32]


@pytest.mark.parametrize("width", WIDTHS)
def test_ripple_add_matches_pallas(width):
    """The port's ripple_add (its plain version on the CPU) against the
    reference's Pallas kernel in interpret mode and its jnp oracle, and
    against lane-wise addition mod 2**width; all exact."""
    a, b = rand_rows((8, 64), 20 + width), rand_rows((8, 64), 40 + width)
    got = from_port(port_ops.ripple_add(to_port(a), to_port(b), width=width))
    exp = np.asarray(ref_ops.ripple_add(jnp.asarray(a), jnp.asarray(b),
                                        width=width, interpret=True))
    assert np.array_equal(got, exp)
    assert np.array_equal(got, np.asarray(ref_ops.ref_ripple_add(
        jnp.asarray(a), jnp.asarray(b), width)))
    mask = (1 << width) - 1
    shifts = np.arange(0, 32, width, dtype=np.uint64)
    lanes = lambda x: (x.astype(np.uint64)[..., None] >> shifts) & mask
    assert np.array_equal(lanes(got), (lanes(a) + lanes(b)) & mask)


def lane_add(a: torch.Tensor, b: torch.Tensor, width: int) -> torch.Tensor:
    """What the CUDA kernel computes per word, in torch int32 bit patterns:
    with H the lanes' top bits, ``((a & ~H) + (b & ~H)) ^ ((a ^ b) & H)``.
    The low bits of each lane add with their carry stopping in the cleared
    top bit; the top bit is that carry ^ a's ^ b's. int32 addition wraps
    in torch as uint32 addition does."""
    top = port_ref._as_int32(
        (0xFFFFFFFF // ((1 << width) - 1)) << (width - 1) & 0xFFFFFFFF)
    return ((a & ~top) + (b & ~top)) ^ ((a ^ b) & top)


@pytest.mark.parametrize("width", WIDTHS)
def test_ripple_add_lane_identity(width):
    """The kernel's one masked add per word equals the S/C iteration of
    the plain version and the reference's Pallas kernel in interpret mode,
    on random words and on words whose carries run to each lane's top bit
    (all-ones lanes plus one, 0x7F... plus one)."""
    a, b = rand_rows((8, 64), 80 + width), rand_rows((8, 64), 90 + width)
    lanes = 32 // width
    ones = np.uint32(0xFFFFFFFF)
    low = np.uint32(sum(((1 << (width - 1)) - 1) << (e * width)
                        for e in range(lanes)))
    one = np.uint32(sum(1 << (e * width) for e in range(lanes)))
    a[0], b[0] = ones, one                   # every lane: all ones + 1
    a[1], b[1] = low, one                    # every lane: 0x7F.. + 1
    a[2], b[2] = ones, ones
    got = lane_add(to_port(a), to_port(b), width)
    assert torch.equal(got, port_ref.ref_ripple_add(to_port(a), to_port(b),
                                                    width))
    exp = np.asarray(ref_ops.ripple_add(jnp.asarray(a), jnp.asarray(b),
                                        width=width, interpret=True))
    assert np.array_equal(from_port(got), exp)
    if width > 1:     # all ones + 1 wraps each lane to 0
        assert not from_port(got)[0].any()
    assert np.array_equal(from_port(got)[1], np.full(64, low + one))


@pytest.mark.parametrize("width", WIDTHS)
def test_ripple_add_is_word_local(width):
    """The plain version's S/C iteration is word-local: per word, ``(c <<
    1) & interior`` in place of the cross-word ``shift_cols(c, +1) &
    interior`` (the bit carried across a word lands on an element's bit 0,
    which the mask clears), so a kernel may add each word alone. Numpy
    uint32 math against the plain version."""
    a, b = rand_rows((5, 33), 60 + width), rand_rows((5, 33), 70 + width)
    interior = np.uint32(port_ref._interior_mask(width))
    s, c = a ^ b, a & b
    for _ in range(width - 1):
        cs = (c << np.uint32(1)) & interior
        c, s = s & cs, s ^ cs
    got = port_ref.ref_ripple_add(to_port(a), to_port(b), width)
    assert np.array_equal(from_port(got), s)


def test_fused_adder_equals_composed_primitives():
    a, b = to_port(rand_rows((8, 64), 10)), to_port(rand_rows((8, 64), 11))
    assert torch.equal(port_ops.ripple_add(a, b, width=8),
                       port_ref.composed_ripple_add(
                           a, b, 8, bitwise=port_ops.bitwise,
                           shift_cols=port_ops.shift_cols))


def test_interior_mask_matches_reference():
    from repro.kernels.rowops import ref as ref_rowops_ref
    for width in WIDTHS:
        assert port_ref._interior_mask(width) == \
            ref_rowops_ref._interior_mask(width)
    with pytest.raises(AssertionError):
        port_ref._interior_mask(3)


def test_ripple_add_checks_its_inputs():
    x = to_port(rand_rows((4, 16), 0))
    port_ops.reset_launches()
    for width in (0, 3, 5, 64):
        with pytest.raises(ValueError, match="divide 32"):
            port_ops.ripple_add(x, x, width=width)
    with pytest.raises(TypeError):
        port_ops.ripple_add(x.to(torch.int64), x, width=8)
    with pytest.raises(ValueError):
        port_ops.ripple_add(x, x[:2], width=8)
    port_ops.ripple_add(x, x, width=8)
    assert port_ops.LAUNCHES["ripple_add"] == 0
