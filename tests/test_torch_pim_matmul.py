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


# route(): the tensor cores take bf16 X with M >= TC_MIN_M, K % 8 == 0 and
# N % 16 == 0; everything else stays on the CUDA-core kernel.
@pytest.mark.parametrize("m,k,n,dtype,expected", [
    (port_ops.TC_MIN_M, 2560, 9728, torch.bfloat16, "tensor_core"),
    (port_ops.TC_MIN_M + 1, 2560, 9728, torch.bfloat16, "tensor_core"),
    (512, 9728, 2560, torch.bfloat16, "tensor_core"),
    (65, 136, 272, torch.bfloat16, "tensor_core"),
    (200, 1032, 9728, torch.bfloat16, "tensor_core"),
    (128, 8, 16, torch.bfloat16, "tensor_core"),
    (port_ops.TC_MIN_M - 1, 2560, 9728, torch.bfloat16, "cuda_core"),
    (4, 2560, 9728, torch.bfloat16, "cuda_core"),
    (8, 9728, 2560, torch.bfloat16, "cuda_core"),
    (512, 2560, 9728, torch.float32, "cuda_core"),
    (128, 2564, 9728, torch.bfloat16, "cuda_core"),    # K % 8 == 4
    (128, 2560, 9720, torch.bfloat16, "cuda_core"),    # N % 16 == 8
    (130, 520, 96, torch.bfloat16, "tensor_core"),
    (130, 520, 104, torch.bfloat16, "cuda_core"),
])
def test_route_rule(m, k, n, dtype, expected):
    assert port_ops.route(m, k, n, dtype) == expected


@pytest.mark.parametrize("bits", [4, 8])
def test_planes_rebuild_every_int8_code(bits):
    """The identity the kernels rely on: for every int8 code,
    sum_b c_b * bit_b equals its low ``bits`` bits read as two's
    complement, and every c_b * bit is exact in bf16."""
    codes = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    low = codes.to(torch.int32) & ((1 << bits) - 1)
    signed = torch.where(low >= 1 << (bits - 1), low - (1 << bits), low)
    acc = torch.zeros(256, dtype=torch.float32)
    for coeff, plane in zip(port_ref.plane_coeffs(bits),
                            port_ref.ref_planes(codes[None, :], bits)):
        term = coeff * plane[0]
        assert torch.equal(term.to(torch.bfloat16).to(torch.float32), term)
        acc = acc + term
    assert torch.equal(acc.to(torch.int32), signed)
    if bits == 8:
        assert torch.equal(signed, codes.to(torch.int32))


def _bf16_bits(value: float) -> int:
    return int(torch.tensor([value], dtype=torch.bfloat16)
               .view(torch.int16).to(torch.int32)[0]) & 0xFFFF


@pytest.mark.parametrize("bits", [4, 8])
def test_packed_plane_fragments_are_exact(bits):
    """The tensor-core kernel's integer arithmetic, in numpy: two codes
    sign-extended into the halves of a word (prmt), plane b taken as
    ``(v & (0x10001 << b)) * (bf16(c_b) >> b)``; each half must be the bf16
    of c_b * bit_b of its code, for every pair of int8 codes."""
    lo, hi = np.meshgrid(np.arange(-128, 128), np.arange(-128, 128))
    v = ((lo.astype(np.int64) & 0xFFFF) | ((hi.astype(np.int64) & 0xFFFF)
                                           << 16)).astype(np.uint64)
    for b, coeff in enumerate(port_ref.plane_coeffs(bits)):
        c_bits = _bf16_bits(coeff)
        assert c_bits == ((0x8000 if b == bits - 1 else 0)
                          | ((127 + b) << 7))
        assert c_bits % (1 << b) == 0
        frag = ((v & np.uint64(0x00010001 << b))
                * np.uint64(c_bits >> b)) & np.uint64(0xFFFFFFFF)
        for half, code in ((frag & np.uint64(0xFFFF), lo),
                           (frag >> np.uint64(16), hi)):
            bit = (code >> b) & 1
            expect = np.where(bit == 1, c_bits, 0)
            assert np.array_equal(half.astype(np.int64), expect)


class _FakeLib:
    """Records which C entries a card call reaches; launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append(name)
            return 1 if name.endswith("splits") else 0
        return call


@pytest.mark.parametrize("m,dtype,entries,which", [
    (512, torch.bfloat16, ["pim_matmul_tc_splits", "pim_matmul_tc"],
     "tensor_core"),
    (port_ops.TC_MIN_M, torch.bfloat16,
     ["pim_matmul_tc_splits", "pim_matmul_tc"], "tensor_core"),
    (4, torch.bfloat16, ["pim_matmul_splits", "pim_matmul"], "cuda_core"),
    (512, torch.float32, ["pim_matmul_splits", "pim_matmul"], "cuda_core"),
])
def test_card_calls_take_their_route(monkeypatch, m, dtype, entries, which):
    """A card call goes to the C entries of its route, counted once in
    LAUNCHES and once in ROUTES; reset_launches clears both."""
    from types import SimpleNamespace

    lib = _FakeLib()
    monkeypatch.setattr(port_ops, "_on_card", lambda x: True)
    monkeypatch.setattr(port_ops, "_lib", lambda: lib)
    monkeypatch.setattr(port_ops, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    port_ops.reset_launches()
    x = torch.zeros((m, 32), dtype=dtype)
    port_ops.pim_matmul(x, torch.zeros((32, 48), dtype=torch.int8),
                        torch.ones(48))
    assert lib.calls == entries
    assert port_ops.LAUNCHES["pim_matmul"] == 1
    assert port_ops.ROUTES == {"tensor_core": int(which == "tensor_core"),
                               "cuda_core": int(which == "cuda_core")}
    port_ops.reset_launches()
    assert port_ops.ROUTES == {"tensor_core": 0, "cuda_core": 0}
    assert port_ops.LAUNCHES["pim_matmul"] == 0
