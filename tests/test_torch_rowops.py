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


def test_plain_shift_guards_full_row():
    x = to_port(rand_rows((2, 4), 1))
    assert not port_ref.ref_shift_cols(x, 32 * 4).any()
    assert not port_ref.ref_shift_cols(x, -32 * 4 - 1).any()
