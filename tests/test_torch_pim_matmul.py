"""The port's bit-plane matmul (its plain torch version on the CPU) against
the reference's Pallas kernel in interpret mode and its oracles, on the
same numpy inputs.

Tolerances are the reference tests' own: rel < 2e-2 of max |y| against the
oracle (``tests/test_kernels_pim_matmul.py``); the quantizer, the planes
and the plane identity are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.pim_matmul import ops as ref_ops  # noqa: E402
from repro.kernels.pim_matmul import ref as jref  # noqa: E402
from repro_torch.kernels.pim_matmul import ops as port_ops  # noqa: E402
from repro_torch.kernels.pim_matmul import ref as port_ref  # noqa: E402

REL = 2e-2


def make(mkn, seed=0):
    m, k, n = mkn
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def rel_err(got, exp):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float(np.max(np.abs(got - exp)) / (np.max(np.abs(exp)) + 1e-9))


def both_quantized(w, bits):
    """The reference's codes and scales, and the port's, from one w."""
    wi, sc = ref_ops.quantize(jnp.asarray(w), bits)
    pwi, psc = port_ops.quantize(torch.from_numpy(w), bits)
    return (wi, sc), (pwi, psc)


SHAPES = [(8, 128, 128), (16, 256, 128), (64, 512, 256), (128, 1024, 128)]


@pytest.mark.parametrize("mkn", SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mode", ["shift_add", "dequant"])
def test_plain_matches_pallas(mkn, bits, mode):
    x, w = make(mkn)
    (wi, sc), (pwi, psc) = both_quantized(w, bits)
    xj = jnp.asarray(x, jnp.bfloat16)
    exp = np.asarray(ref_ops.pim_matmul(xj, wi, sc, mode=mode, bits=bits,
                                        bk=min(512, mkn[1]), interpret=True))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = port_ops.pim_matmul(xt, pwi, psc, mode=mode, bits=bits)
    assert got.dtype == torch.float32 and tuple(got.shape) == exp.shape
    rel = rel_err(got.numpy(), exp)
    assert rel < REL, f"rel {rel} vs the Pallas kernel (bound {REL})"
    oracle = np.asarray(jref.ref_pim_matmul_planes(xj, wi, sc, bits))
    rel = rel_err(got.numpy(), oracle)
    assert rel < REL, f"rel {rel} vs ref_pim_matmul_planes (bound {REL})"


# Shapes the Pallas kernel refuses (no block divides them) but the model's
# linears may have: held against the reference's plane oracle.
@pytest.mark.parametrize("mkn", [(5, 96, 40), (1, 33, 300), (37, 130, 70)])
@pytest.mark.parametrize("bits", [4, 8])
def test_plain_ragged_shapes_match_oracle(mkn, bits):
    x, w = make(mkn, seed=1)
    (wi, sc), (pwi, psc) = both_quantized(w, bits)
    oracle = np.asarray(jref.ref_pim_matmul_planes(
        jnp.asarray(x, jnp.bfloat16), wi, sc, bits))
    for mode in ("shift_add", "dequant"):
        got = port_ops.pim_matmul(torch.from_numpy(x).to(torch.bfloat16),
                                  pwi, psc, mode=mode, bits=bits)
        rel = rel_err(got.numpy(), oracle)
        assert rel < REL, f"{mode}: rel {rel} (bound {REL})"


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_matches_reference_exactly(bits):
    _, w = make((1, 256, 64), seed=5)
    (wi, sc), (pwi, psc) = both_quantized(w, bits)
    assert pwi.dtype == torch.int8 and psc.dtype == torch.float32
    assert np.array_equal(pwi.numpy(), np.asarray(wi))
    assert np.array_equal(psc.numpy().view(np.int32),
                          np.asarray(sc).view(np.int32))


@pytest.mark.parametrize("bits", [4, 8])
def test_planes_and_coeffs_match_reference(bits):
    rng = np.random.default_rng(4)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    w = rng.integers(lo, hi + 1, (64, 32)).astype(np.int8)
    assert port_ref.plane_coeffs(bits) == jref.plane_coeffs(bits)
    acc = torch.zeros((64, 32))
    for coeff, plane, jplane in zip(port_ref.plane_coeffs(bits),
                                    port_ref.ref_planes(torch.from_numpy(w),
                                                        bits),
                                    jref.ref_planes(jnp.asarray(w), bits)):
        assert np.array_equal(plane.numpy(), np.asarray(jplane))
        acc = acc + coeff * plane
    assert torch.equal(acc.to(torch.int32), torch.from_numpy(w).int())


@pytest.mark.parametrize("bits", [4, 8])
def test_oracles_match_reference(bits):
    x, w = make((16, 256, 64), seed=6)
    (wi, sc), (pwi, psc) = both_quantized(w, bits)
    xt = torch.from_numpy(x)
    for port_fn, ref_fn in ((port_ref.ref_pim_matmul, jref.ref_pim_matmul),
                            (port_ref.ref_pim_matmul_planes,
                             jref.ref_pim_matmul_planes)):
        got = port_fn(xt, pwi, psc, bits).numpy()
        exp = np.asarray(ref_fn(jnp.asarray(x), wi, sc, bits))
        rel = rel_err(got, exp)
        assert rel < 1e-5, f"{port_fn.__name__}: rel {rel} (float32 sums)"


@pytest.mark.parametrize("bits", [4, 8])
def test_modes_agree(bits):
    """shift_add and dequant are the same math — must agree tightly
    (the reference's bound, 1e-2 of max |y|)."""
    x, w = make((32, 256, 128), seed=3)
    _, (pwi, psc) = both_quantized(w, bits)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    y1 = port_ops.pim_matmul(xt, pwi, psc, mode="shift_add", bits=bits)
    y2 = port_ops.pim_matmul(xt, pwi, psc, mode="dequant", bits=bits)
    assert float((y1 - y2).abs().max()) < 1e-2 * float(y2.abs().max())


def test_float32_inputs():
    x, w = make((16, 256, 128))
    (wi, sc), (pwi, psc) = both_quantized(w, 4)
    got = port_ops.pim_matmul(torch.from_numpy(x), pwi, psc,
                              mode="shift_add", bits=4)
    exp = np.asarray(ref_ops.pim_matmul(jnp.asarray(x), wi, sc,
                                        mode="shift_add", bits=4, bk=256,
                                        interpret=True))
    rel = rel_err(got.numpy(), exp)
    assert rel < 0.05, f"rel {rel} (the reference's float32 bound 0.05)"


def test_pim_linear_leading_dims_and_dtype():
    x, w = make((6, 64, 48), seed=7)
    _, (pwi, psc) = both_quantized(w, 4)
    xt = torch.from_numpy(x).to(torch.bfloat16).reshape(2, 3, 64)
    y = port_ops.pim_linear(xt, pwi, psc, mode="shift_add", bits=4)
    assert y.shape == (2, 3, 48) and y.dtype == torch.bfloat16
    flat = port_ops.pim_matmul(xt.reshape(6, 64), pwi, psc, bits=4)
    assert torch.equal(y.reshape(6, 48), flat.to(torch.bfloat16))


def test_wrapper_rejects_bad_operands():
    x = torch.zeros((4, 8), dtype=torch.bfloat16)
    wi = torch.zeros((8, 3), dtype=torch.int8)
    sc = torch.ones(3)
    with pytest.raises(ValueError, match="mode"):
        port_ops.pim_matmul(x, wi, sc, mode="planes")
    with pytest.raises(ValueError, match="bits"):
        port_ops.pim_matmul(x, wi, sc, bits=3)
    with pytest.raises(ValueError, match="do not fit"):
        port_ops.pim_matmul(x, wi[:7], sc)
    with pytest.raises(TypeError, match="int8"):
        port_ops.pim_matmul(x, wi.to(torch.int32), sc)
