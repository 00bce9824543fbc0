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


# route(): bf16 X with K % 8 == 0 and N % 16 == 0 takes the tensor-core
# kernel at M >= TC_MIN_M and the swapped-operand kernel below it;
# everything else stays on the CUDA-core kernel.
@pytest.mark.parametrize("m,k,n,dtype,expected", [
    (port_ops.TC_MIN_M, 2560, 9728, torch.bfloat16, "tensor_core"),
    (port_ops.TC_MIN_M + 1, 2560, 9728, torch.bfloat16, "tensor_core"),
    (512, 9728, 2560, torch.bfloat16, "tensor_core"),
    (65, 136, 272, torch.bfloat16, "tensor_core"),
    (200, 1032, 9728, torch.bfloat16, "tensor_core"),
    (128, 8, 16, torch.bfloat16, "tensor_core"),
    (port_ops.TC_MIN_M - 1, 2560, 9728, torch.bfloat16, "swap_ab"),
    (4, 2560, 9728, torch.bfloat16, "swap_ab"),
    (8, 9728, 2560, torch.bfloat16, "swap_ab"),
    (512, 2560, 9728, torch.float32, "cuda_core"),
    (128, 2564, 9728, torch.bfloat16, "cuda_core"),    # K % 8 == 4
    (128, 2560, 9720, torch.bfloat16, "cuda_core"),    # N % 16 == 8
    (130, 520, 96, torch.bfloat16, "tensor_core"),
    (130, 520, 104, torch.bfloat16, "cuda_core"),
    (1, 8, 16, torch.bfloat16, "swap_ab"),
    (4, 2564, 9728, torch.bfloat16, "cuda_core"),      # K % 8 == 4
    (4, 2560, 9720, torch.bfloat16, "cuda_core"),      # N % 16 == 8
    (4, 2560, 9728, torch.float32, "cuda_core"),
    (15, 9728, 2560, torch.float32, "cuda_core"),
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


def _prmt(a, b, sel):
    """PTX prmt.b32 (default mode) on numpy uint64 words."""
    src = [(a >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)] + \
          [(b >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)]
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint64(8 * i)
    return out


def _bf16_pair(lo, hi):
    """Two float arrays as the bf16 halves of a word (round to nearest)."""
    h = torch.from_numpy(np.stack([lo, hi], -1).astype(np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    return (h[..., 0] | (h[..., 1] << 16)).astype(np.uint64)


def _halves(word):
    """The bf16 halves of words, as float32 arrays."""
    bits = np.stack([word & np.uint64(0xFFFF), word >> np.uint64(16)], -1)
    return torch.from_numpy(bits.astype(np.int16)).view(
        torch.bfloat16).float().numpy()


def _swap_a_fragments(w_step, mode, bits):
    """The swapped-operand kernel's A fragments, replayed for one k16 step:
    ``w_step`` (16, 128) int8 codes (k rows, a block's 128 columns).
    Returns (32 lanes, 8 tiles, planes, 4 registers) words. Lane (g, t)
    reads 16 codes at column 16g of k rows 2t, 2t+1, 2t+8, 2t+9 as four
    little-endian words; tile j's A rows g and g + 8 are bytes 2j and
    2j + 1 of them (word j // 2)."""
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    rows = np.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], 1)   # (32, 4)
    codes = w_step.view(np.uint8).astype(np.uint64)
    cols = 16 * g[:, None] + np.arange(16)[None, :]                 # (32, 16)
    # words[lane, r, q]: row r's word q
    byte = codes[rows[:, :, None], cols[:, None, :]]    # (32, 4, 16)
    words = sum(byte[:, :, i::4] << np.uint64(8 * i) for i in range(4))
    planes = [None] if mode == "dequant" else list(range(bits))
    out = np.zeros((32, 8, len(planes), 4), np.uint64)
    for j in range(8):
        q, lo = j >> 1, 2 * (j & 1)
        w0, w1, w8, w9 = (words[:, r, q] for r in range(4))
        for p, b in enumerate(planes):
            if b is None:        # code_frag: bytes as int8, to bf16
                def frag(a, c, i):
                    sa = ((a >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(
                        np.uint8).view(np.int8)
                    sc = ((c >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(
                        np.uint8).view(np.int8)
                    return _bf16_pair(sa, sc)
                regs = [frag(w0, w1, lo), frag(w0, w1, lo + 1),
                        frag(w8, w9, lo), frag(w8, w9, lo + 1)]
            else:                # prmt, then plane_frag
                sel_g, sel_g8 = lo | (4 + lo) << 8, (lo + 1) | (5 + lo) << 8
                c_bits = _bf16_bits(port_ref.plane_coeffs(bits)[b])
                regs = [((v & np.uint64(0x00010001 << b))
                         * np.uint64(c_bits >> b)) & np.uint64(0xFFFFFFFF)
                        for v in (_prmt(w0, w1, sel_g), _prmt(w0, w1, sel_g8),
                                  _prmt(w8, w9, sel_g), _prmt(w8, w9, sel_g8))]
            out[:, j, p] = np.stack(regs, 1)
    return out


def _swap_column(j, row):
    """The block column of A row ``row`` of m16 tile ``j``."""
    return 16 * (row % 8) + 2 * j + row // 8


@pytest.mark.parametrize("mode,bits", [("shift_add", 4), ("shift_add", 8),
                                       ("dequant", 8)])
def test_swap_fragments_are_the_planes_of_w_transposed(mode, bits):
    """The swapped-operand kernel's A fragments, built from each lane's
    word reads, equal the bf16 planes of Wᵀ exactly under its column
    permutation (m16n8k16 layout: a0 row g, k 2t/2t+1; a1 row g+8; a2 row
    g, k 2t+8/2t+9; a3 row g+8), for every int8 code."""
    rng = np.random.default_rng(11)
    w_step = rng.integers(-128, 128, (16, 128)).astype(np.int8)
    frags = _swap_a_fragments(w_step, mode, bits)
    if mode == "dequant":
        want = [w_step.astype(np.float32)]
    else:
        want = [c * p.numpy() for c, p in zip(
            port_ref.plane_coeffs(bits),
            port_ref.ref_planes(torch.from_numpy(w_step), bits))]
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(8):
            for p, plane in enumerate(want):
                halves = _halves(frags[lane, j, p])          # (4, 2)
                for r, (row, k0) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                               (g, 2 * t + 8),
                                               (g + 8, 2 * t + 8))):
                    n = _swap_column(j, row)
                    assert halves[r, 0] == plane[k0, n]
                    assert halves[r, 1] == plane[k0 + 1, n]


@pytest.mark.parametrize("mf", [1, 2])
def test_swap_outputs_cover_the_block_once(mf):
    """The C fragments' map back to out[m][n] (tile j, batch fragment f,
    register c of lane (g, t): column row -> n by the A permutation, batch
    8f + 2t + c % 2) covers a block's 128 columns x 8·MF rows exactly once,
    and the lane's float4 stores (row 2t: acc[2i][f][0], acc[2i][f][2],
    acc[2i+1][f][0], acc[2i+1][f][2] at columns 16g + 4i..) agree with
    it."""
    seen = np.zeros((8 * mf, 128), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        place = {}
        for j in range(8):
            for f in range(mf):
                for c in range(4):
                    row = g + 8 * (c // 2)
                    m, n = 8 * f + 2 * t + c % 2, _swap_column(j, row)
                    seen[m, n] += 1
                    place[(j, f, c)] = (m, n)
        for f in range(mf):
            for i in range(4):
                for h in range(2):
                    stored = [(2 * i, f, h), (2 * i, f, 2 + h),
                              (2 * i + 1, f, h), (2 * i + 1, f, 2 + h)]
                    for e, key in enumerate(stored):
                        assert place[key] == (8 * f + 2 * t + h,
                                              16 * g + 4 * i + e)
    assert (seen == 1).all()


def test_swap_replay_matches_plain():
    """The swapped-operand kernel replayed in numpy over a few k16 steps
    (A fragments as the kernel builds them, B fragments as 32-bit pairs of
    X, an m16n8k16 product per plane and tile into one float32
    accumulator) against the plain version: rel < 1e-5 (float32 sums in
    another order)."""
    rng = np.random.default_rng(12)
    m, k, bits = 5, 48, 4
    w = rng.integers(-128, 128, (k, 128)).astype(np.int8)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        torch.bfloat16)
    xb = np.zeros((8, k), np.float32)
    xb[:m] = x.float().numpy()
    acc = np.zeros((8, 128), np.float64)       # (batch row, column)
    for s in range(k // 16):
        frags = _swap_a_fragments(w[16 * s:16 * s + 16], "shift_add", bits)
        for j in range(8):
            for p in range(bits):
                a = np.zeros((16, 16), np.float32)
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    h = _halves(frags[lane, j, p])
                    a[g, 2 * t:2 * t + 2] = h[0]
                    a[g + 8, 2 * t:2 * t + 2] = h[1]
                    a[g, 2 * t + 8:2 * t + 10] = h[2]
                    a[g + 8, 2 * t + 8:2 * t + 10] = h[3]
                prod = a @ xb[:, 16 * s:16 * s + 16].T     # (16 rows, 8)
                for row in range(16):
                    acc[:, _swap_column(j, row)] += prod[row]
    exp = port_ref.ref_pim_matmul_raw(x, torch.from_numpy(w), mode="shift_add",
                                      bits=bits).numpy()
    assert rel_err(acc[:m], exp) < 1e-5


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
    (4, torch.bfloat16, ["pim_matmul_swap_splits", "pim_matmul_swap"],
     "swap_ab"),
    (512, torch.float32, ["pim_matmul_splits", "pim_matmul"], "cuda_core"),
    (port_ops.TC_MIN_M - 1, torch.bfloat16,
     ["pim_matmul_swap_splits", "pim_matmul_swap"], "swap_ab"),
    (4, torch.float32, ["pim_matmul_splits", "pim_matmul"], "cuda_core"),
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
    assert port_ops.ROUTES == {r: int(r == which)
                               for r in ("tensor_core", "swap_ab",
                                         "cuda_core")}
    port_ops.reset_launches()
    assert port_ops.ROUTES == {"tensor_core": 0, "swap_ab": 0,
                               "cuda_core": 0}
    assert port_ops.LAUNCHES["pim_matmul"] == 0
