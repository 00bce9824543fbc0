"""The port's kernels on the card against their plain versions, at ragged
shapes and options that ``chip_smoke.py``'s full-width run does not reach
(``ripple_add`` at every width, ``meter_fold`` at every table size and
special value, ``pim_matmul`` and ``flash_attn`` on each of their routes,
odd and random sizes), the smoke-size serving path on the card against
the CPU, and ``greedy_generate``'s CUDA graphs (one replay per call, the
eager loop's tokens and launches, a bounded cache per model) at the smoke
size and at Qwen3-4B's full width with 2 layers.

Needs a CUDA card and ``nvcc`` (the kernels build at first use); every test
here skips elsewhere. It imports nothing of JAX, so on the card machine it
runs without the repository's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: ripple_add, exact; meter_fold, exact float32 and int32 bits,
except that a NaN is compared as a NaN (the card's add returns the
canonical NaN, numpy's on the host keeps an operand's payload);
pim_matmul, 1e-4 of max |y| (kernel and plain version compute the same
float32 function, summing in another order); flash, abs 2e-5 in
float32 (the reference tests' bound) and 1e-2 of max |plain| in bf16 (both
sides compute in float32 from the same bf16 inputs and round the output,
so they differ by about one bf16 ulp of the largest output, at most 2^-7
of it; the tensor-core route also rounds P to bf16, which moves an output
by at most 2^-9 of max |v|); logits, 2e-2 of max |logit| (the bound the
CPU tests hold the bf16 model to).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attn import ref as fref  # noqa: E402
from repro_torch.kernels.pim_matmul import ops as pm  # noqa: E402
from repro_torch.kernels.pim_matmul import ref as pref  # noqa: E402
from repro_torch.kernels.rowops import ops as rops  # noqa: E402
from repro_torch.kernels.rowops import ref as rref  # noqa: E402
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402,E501
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve.engine import greedy_generate  # noqa: E402

pytestmark = pytest.mark.cuda

PIM_REL = 1e-4
FLASH_F32_ABS = 2e-5
FLASH_BF16_REL = 1e-2
LOGITS_REL = 2e-2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs on the card machine")
    return torch.device("cuda")


def flash_bound(exp, scale=1.0):
    """The flash bound for an output whose plain version is ``exp``: abs
    2e-5 (times ``scale``) in float32, 1e-2 of max |exp| in bf16."""
    if exp.dtype == torch.float32:
        return FLASH_F32_ABS * scale
    return FLASH_BF16_REL * float(exp.float().abs().max())


def rel_err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


# (M, K, N). The CUDA-core kernel (float32 X everywhere; bf16 X with
# unaligned rows): every tile it picks (M <= 4, <= 8, 32-row for 8-bit
# shift_add, 64-row), with and without the K split, ragged everywhere. The
# tensor-core kernel (bf16 X from M = TC_MIN_M = 17 on): M at the
# threshold, both Qwen3-4B prefill shapes, M, N and K ragged against its
# 128 x 128 x 32 tiles, with and without its K split; then bf16 shapes that
# stay on the CUDA cores because K % 8 != 0 or N % 16 != 0. The swapped
# kernel (bf16 X, M 1-16): both Qwen3-4B decode shapes (K split 3 and 13
# ways), M 1, 4, 8, 9, 15 and 16 (one and two n8 fragments), K an odd
# number of 8-row halves of its k16 steps, N ragged against its 128-column
# strips (and below one strip), with and without the K split.
PIM_SHAPES = [(1, 33, 300), (5, 96, 40), (8, 200, 257), (9, 64, 64),
              (37, 130, 70), (130, 520, 96), (3, 4096, 17),
              (16, 64, 48), (17, 136, 144), (512, 2560, 9728),
              (512, 9728, 2560), (65, 136, 272), (200, 1032, 9728),
              (128, 260, 64), (128, 256, 40),
              (4, 2560, 9728), (4, 9728, 2560), (1, 72, 144),
              (8, 1032, 272), (15, 520, 400), (16, 4104, 48)]


@pytest.mark.parametrize("mkn", PIM_SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("mode", ["shift_add", "dequant"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pim_matmul_kernel_matches_plain(card, mkn, bits, mode, dtype):
    m, k, n = mkn
    gen = torch.Generator(device=card).manual_seed(m * 1000 + n)
    x = torch.randn((m, k), generator=gen, device=card).to(dtype)
    w_int, scales = pm.quantize(
        torch.randn((k, n), generator=gen, device=card), bits)
    pm.reset_launches()
    got = pm.pim_matmul(x, w_int, scales, mode=mode, bits=bits)
    assert pm.ROUTES[pm.route(m, k, n, dtype)] == 1
    exp = pref.ref_pim_matmul_raw(x, w_int, mode=mode, bits=bits) \
        * scales[None, :]
    rel = rel_err(got, exp)
    assert rel <= PIM_REL, f"rel {rel:.3e} (bound {PIM_REL})"


@pytest.mark.parametrize("mkn,dtype,route", [
    ((6, 70, 33), torch.float32, "cuda_core"),
    ((128, 72, 48), torch.bfloat16, "tensor_core"),
    ((4, 72, 48), torch.bfloat16, "swap_ab"),
])
def test_pim_matmul_codes_beyond_the_bits(card, mkn, dtype, route):
    """int8 codes outside the 4-bit range: shift_add reads their low 4 bits
    as two's complement, dequant the code itself — as the Pallas kernel —
    on either route."""
    m, k, n = mkn
    rng = np.random.default_rng(3)
    w_int = torch.as_tensor(rng.integers(-128, 128, (k, n)),
                            dtype=torch.int8, device=card)
    x = torch.as_tensor(rng.normal(size=(m, k)), dtype=torch.float32,
                        device=card).to(dtype)
    scales = torch.ones(n, device=card)
    assert pm.route(m, k, n, dtype) == route
    for mode in ("shift_add", "dequant"):
        got = pm.pim_matmul(x, w_int, scales, mode=mode, bits=4)
        exp = pref.ref_pim_matmul_raw(x, w_int, mode=mode, bits=4)
        assert rel_err(got, exp) <= PIM_REL, mode


def test_pim_matmul_routes(card):
    """A prefill-shaped call takes the tensor cores, a decode-shaped bf16
    one the swapped operands, a decode-shaped float32 one the CUDA cores:
    one count each in ROUTES, three in LAUNCHES."""
    gen = torch.Generator(device=card).manual_seed(5)
    w_int, scales = pm.quantize(
        torch.randn((256, 512), generator=gen, device=card), 4)
    pm.reset_launches()
    for m, dtype in ((512, torch.bfloat16), (4, torch.bfloat16),
                     (4, torch.float32)):
        x = torch.randn((m, 256), generator=gen, device=card).to(dtype)
        pm.pim_matmul(x, w_int, scales)
    assert pm.ROUTES == {"tensor_core": 1, "swap_ab": 1, "cuda_core": 1}
    assert pm.LAUNCHES["pim_matmul"] == 3
    # contiguous views 2 bytes past 16-byte alignment: the tensor-core and
    # swapped kernels' 16-byte loads take an aligned copy of them
    for m, which in ((63, "tensor_core"), (4, "swap_ab")):
        buf = torch.randn(1 + m * 256, generator=gen, device=card).to(
            torch.bfloat16)
        x = buf[1:].view(m, 256)
        assert x.is_contiguous() and x.data_ptr() % 16
        assert pm.route(m, 256, 512, x.dtype) == which
        got = pm.pim_matmul(x, w_int, scales)
        exp = pref.ref_pim_matmul_raw(x, w_int, mode="shift_add", bits=4) \
            * scales[None, :]
        assert rel_err(got, exp) <= PIM_REL
    assert pm.ROUTES == {"tensor_core": 2, "swap_ab": 2, "cuda_core": 1}


@pytest.mark.parametrize("mkn,splits", [
    ((4, 9728, 2560), None), ((4, 2560, 9728), None), ((3, 200, 272), 1),
    ((3, 200, 272), 2), ((3, 200, 272), 7), ((12, 200, 272), 40),
    ((12, 4104, 128), 64)])
def test_pim_matmul_swap_splits_are_ordered(card, mkn, splits):
    """The swapped kernel at its own and at forced K split counts (40 and
    64: more splits than k16 steps at K 200, so some are empty) against
    the plain version, and bit for bit the same twice: the splits are
    added in a fixed order, with no atomics."""
    m, k, n = mkn
    gen = torch.Generator(device=card).manual_seed(k + n)
    x = torch.randn((m, k), generator=gen, device=card).to(torch.bfloat16)
    w_int, scales = pm.quantize(
        torch.randn((k, n), generator=gen, device=card), 4)
    exp = pref.ref_pim_matmul_raw(x, w_int, mode="shift_add", bits=4) \
        * scales[None, :]
    outs = [pm._launch(x, w_int, scales, torch.empty((m, n), device=card),
                       "shift_add", 4, "swap_ab", splits) for _ in range(2)]
    assert rel_err(outs[0], exp) <= PIM_REL
    assert torch.equal(outs[0], outs[1])


# (B, Sq, Sk, KV, G, dh, window, invalid keys at the end of each row)
FLASH_SHAPES = [(2, 16, 37, 2, 2, 16, 8, 3), (2, 70, 70, 2, 3, 64, None, 0),
                (1, 5, 33, 1, 4, 32, None, 4), (3, 1, 100, 4, 2, 128, None, 9),
                (1, 40, 96, 2, 4, 128, 24, 0)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(card, shape, dtype):
    B, Sq, Sk, KV, G, dh, window, invalid = shape
    gen = torch.Generator(device=card).manual_seed(Sq * 100 + Sk)
    q = torch.randn((B, Sq, KV, G, dh), generator=gen, device=card).to(dtype)
    k = torch.randn((B, Sk, KV, dh), generator=gen, device=card).to(dtype)
    v = torch.randn((B, Sk, KV, dh), generator=gen, device=card).to(dtype)
    pos_q = torch.arange(Sk - Sq, Sk, dtype=torch.int32, device=card)
    pos_k = torch.arange(Sk, dtype=torch.int32, device=card).repeat(B, 1)
    if invalid:
        pos_k[:, Sk - invalid:] = -1
        v[:, Sk - invalid:] = 1e4        # poisoned: must weigh nothing
    got = fa.flash_attention(q, k, v, pos_q, pos_k, window=window)
    exp = fref.ref_flash_attention(q, k, v, pos_q, pos_k, window=window)
    err = float((got.float() - exp.float()).abs().max())
    assert err < flash_bound(exp), f"max abs err {err}"


# (B, Sq, Sk, KV, G, dk, dv, window, invalid keys at the end of each row):
# the shapes chip_smoke.py times (Qwen3-4B decode, MLA decode,
# recurrentgemma's 256-wide heads under a window, MLA prefill), scaled in
# Sk, then odd sizes: dk, dv not multiples of 8 (element loads, padded
# columns), dv > dk, 1-wide heads, the 576 limit
ROUTE_SHAPES = [(4, 1, 144, 8, 4, 128, 128, None, 8),
                (4, 1, 2048, 1, 16, 576, 512, None, 7),
                (2, 1, 300, 1, 10, 256, 256, 64, 0),
                (2, 32, 32, 4, 1, 192, 128, None, 0),
                (2, 3, 45, 2, 4, 20, 12, 8, 2),
                (1, 1, 70, 3, 5, 24, 16, None, 5),
                (2, 2, 33, 2, 3, 1, 1, None, 1),
                (1, 5, 40, 1, 4, 36, 100, 16, 0),
                (1, 1, 9, 2, 7, 576, 576, None, 0),
                (1, 20, 50, 1, 1, 44, 300, None, 3)]


def flash_operands(shape, dtype, seed):
    B, Sq, Sk, KV, G, dk, dv, window, invalid = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, KV, G, dk), generator=gen, device="cuda")
    k = torch.randn((B, Sk, KV, dk), generator=gen, device="cuda")
    v = torch.randn((B, Sk, KV, dv), generator=gen, device="cuda")
    pos_q = torch.arange(Sk - Sq - invalid, Sk - invalid, dtype=torch.int32,
                         device="cuda")
    pos_k = torch.arange(Sk, dtype=torch.int32, device="cuda").repeat(B, 1)
    if invalid:
        pos_k[:, Sk - invalid:] = -1
        v[:, Sk - invalid:] = 1e4        # poisoned: must weigh nothing
    return [t.to(dtype) for t in (q, k, v)] + [pos_q, pos_k]


def launch_route(q, k, v, pos_q, pos_k, window, which, splits=None):
    out = torch.empty(q.shape[:-1] + v.shape[-1:], dtype=q.dtype,
                      device=q.device)
    return fa._launch(q, k, v, pos_q, pos_k, out, window,
                      q.shape[-1] ** -0.5, which, splits)


def tc_takes(dtype, dk, dv):
    """Whether the tensor-core route takes these operands (else it must
    raise)."""
    return dtype == torch.bfloat16 and max(dk, dv) <= fa.TC_MAX_HEAD_DIM


@pytest.mark.parametrize("shape", ROUTE_SHAPES)
@pytest.mark.parametrize("which", ["tiled", "split_kv", "tensor_core"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_routes_match_plain(card, shape, which, dtype):
    """Each route, forced, against the plain version, dv != dk included;
    the tensor-core route takes bf16 up to TC_MAX_HEAD_DIM and raises for
    float32 or wider heads (no fallback)."""
    q, k, v, pos_q, pos_k = flash_operands(shape, dtype, sum(shape[:7]))
    window = shape[7]
    if which == "tensor_core" and not tc_takes(dtype, shape[5], shape[6]):
        with pytest.raises(ValueError, match="tensor_core"):
            launch_route(q, k, v, pos_q, pos_k, window, which)
        return
    got = launch_route(q, k, v, pos_q, pos_k, window, which)
    exp = fref.ref_flash_attention(q, k, v, pos_q, pos_k, window=window)
    assert got.shape == exp.shape
    err = float((got.float() - exp.float()).abs().max())
    assert err < flash_bound(exp), f"max abs err {err}"


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 40])
def test_flash_split_counts_and_rings(card, splits):
    """The split route at forced split counts (40: more than the key tiles,
    so some splits hold no slot) over a ring cache with unsorted kpos, a
    window, a batch row that sees no key and a K/V view that is not 16-byte
    aligned (the element-load path)."""
    B, Sc, KV, G, dh, pos, window = 3, 100, 2, 4, 64, 250, 90
    gen = torch.Generator(device="cuda").manual_seed(splits)
    q = torch.randn((B, 1, KV, G, dh), generator=gen, device=card)
    kbuf = torch.randn(1 + B * Sc * KV * dh, generator=gen, device=card)
    k = kbuf[1:].view(B, Sc, KV, dh)
    assert k.is_contiguous() and k.data_ptr() % 16
    v = torch.randn((B, Sc, KV, dh), generator=gen, device=card)
    pk = torch.full((B, Sc), -1, dtype=torch.int32)
    for b in range(B - 1):
        for p in range(pos - b - Sc + 1, pos - b + 1):
            pk[b, p % Sc] = p
    pk = pk.to(card)                      # batch row B - 1: no key written
    v[pk < 0] = 1e4
    pos_q = torch.tensor([pos], dtype=torch.int32, device=card)
    exp = fref.ref_flash_attention(q, k, v, pos_q, pk, window=window)
    for view in (k, k.clone()):
        got = launch_route(q, view, v, pos_q, pk, window, "split_kv",
                           splits)
        err = float((got - exp).abs().max())
        assert err < flash_bound(exp), f"max abs err {err}"


@pytest.mark.parametrize("seed", range(8))
def test_flash_routes_random_shapes(card, seed):
    """All routes on random sizes (head sizes 1-576 with dv apart from dk,
    shuffled and invalid key positions, a batch row with no key, windows,
    forced split counts, K off 16-byte alignment) against the plain
    version; the split route twice on the same inputs gives the same bits
    (the merge adds the splits in a fixed order, no atomics). The float32
    bound is 2e-5 times the output's size once that exceeds 1: a row that
    sees no key averages the poisoned 1e4 values, and float32 carries
    those sums to ~1e-3."""
    rng = np.random.default_rng(seed)
    dims = [1, 4, 12, 16, 20, 36, 64, 128, 192, 256, 300, 512, 576]
    for case in range(15):
        B, KV = int(rng.choice([1, 2, 3])), int(rng.choice([1, 2, 8]))
        G, Sq = int(rng.choice([1, 2, 4, 10, 16])), int(rng.choice([1, 1, 3]))
        Sk = int(rng.choice([1, 5, 33, 64, 65, 300, 1000]))
        dk, dv = int(rng.choice(dims)), int(rng.choice(dims))
        window = [None, None, 3, 40][int(rng.integers(4))]
        dtype = [torch.float32, torch.bfloat16][int(rng.integers(2))]
        splits = [None, 1, 3, 50][int(rng.integers(4))]
        gen = torch.Generator(device=card).manual_seed(seed * 100 + case)
        q = torch.randn((B, Sq, KV, G, dk), generator=gen, device=card)
        kbuf = torch.randn(1 + B * Sk * KV * dk, generator=gen, device=card)
        k = (kbuf[1:] if rng.random() < 0.3 else kbuf[:-1]).view(
            B, Sk, KV, dk)
        v = torch.randn((B, Sk, KV, dv), generator=gen, device=card)
        last = int(rng.integers(Sk + 3))
        pos_q = torch.arange(last - Sq + 1, last + 1, dtype=torch.int32,
                             device=card)
        pos_k = torch.as_tensor(rng.permutation(Sk), dtype=torch.int32,
                                device=card).repeat(B, 1)
        pos_k[pos_k > last + 1] = -1
        if B > 1:
            pos_k[-1] = -1
        v[pos_k < 0] = 1e4
        q, k, v = (t.to(dtype) for t in (q, k, v))
        exp = fref.ref_flash_attention(q, k, v, pos_q, pos_k, window=window)
        bound = flash_bound(exp, max(1.0, float(exp.float().abs().max())))
        for which in ("split_kv", "tiled", "tensor_core"):
            if which == "tensor_core" and not tc_takes(dtype, dk, dv):
                with pytest.raises(ValueError, match="tensor_core"):
                    launch_route(q, k, v, pos_q, pos_k, window, which)
                continue
            got = launch_route(q, k, v, pos_q, pos_k, window, which, splits)
            err = float((got.float() - exp.float()).abs().max())
            assert err <= bound, (case, which, err)
            if which == "split_kv":
                again = launch_route(q, k, v, pos_q, pos_k, window, which,
                                     splits)
                assert torch.equal(got, again), case


# (B, Sq, Sk, KV, G, dk, dv, window, shift): prefill shapes on the
# tensor-core route, the key positions shifted up by ``shift`` so that the
# first queries see no key (their blocks walk every tile again)
TC_SHAPES = [(2, 130, 130, 2, 4, 128, 128, None, 0),
             (1, 300, 300, 2, 4, 128, 128, None, 0),
             (2, 100, 100, 2, 4, 128, 128, None, 20),
             (1, 70, 200, 1, 10, 256, 256, 64, 90),
             (2, 64, 64, 2, 16, 192, 128, None, 30),
             (1, 150, 150, 3, 1, 64, 64, 40, 0)]


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_flash_tensor_core_skips_and_second_pass(card, shape):
    """The tensor-core route at causal prefill shapes: skipped key tiles
    (rows that see few keys) and rows that see no key, whose blocks walk
    every tile again so those rows average V over all slots, against the
    plain version; the call counts one tensor_core launch."""
    B, Sq, Sk, KV, G, dk, dv, window, shift = shape
    gen = torch.Generator(device="cuda").manual_seed(Sq + Sk + shift)
    q, k, v = (torch.randn(s, generator=gen, device=card).to(torch.bfloat16)
               for s in ((B, Sq, KV, G, dk), (B, Sk, KV, dk),
                         (B, Sk, KV, dv)))
    pos_q = torch.arange(Sq, dtype=torch.int32, device=card)
    pos_k = (torch.arange(Sk, dtype=torch.int32, device=card)
             + shift).repeat(B, 1)
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, pos_q, pos_k, window=window)
    assert fa.ROUTES == {"tiled": 0, "split_kv": 0, "tensor_core": 1}
    exp = fref.ref_flash_attention(q, k, v, pos_q, pos_k, window=window)
    err = float((got.float() - exp.float()).abs().max())
    assert err < flash_bound(exp), f"max abs err {err}"
    if shift:
        blind = int(min(shift, Sq))       # queries 0 .. shift - 1
        mean = v.float().mean(dim=1)      # (B, KV, dv)
        want = mean[:, None, :, None, :].expand(B, blind, KV, G, dv)
        assert torch.allclose(got[:, :blind].float(), want, rtol=1e-2,
                              atol=1e-2)


@pytest.mark.parametrize("m", [5, 64])
def test_pim_matmul_casts_scales_and_strides(card, m):
    """bf16 scales, float32 scales that do not start on 16 bytes and
    non-contiguous X or W give the float32 contiguous call's result, on
    both bf16 routes (M 5: the swapped operands; 64: tensor cores)."""
    gen = torch.Generator(device=card).manual_seed(m)
    w_int, scales = pm.quantize(
        torch.randn((64, 48), generator=gen, device=card), 4)
    x = torch.randn((m, 64), generator=gen, device=card).to(torch.bfloat16)
    sb = scales.to(torch.bfloat16)
    exp = pm.pim_matmul(x, w_int, sb.float())
    assert torch.equal(pm.pim_matmul(x, w_int, sb), exp)
    xt = x.T.contiguous().T
    wt = w_int.T.contiguous().T
    assert not xt.is_contiguous() and not wt.is_contiguous()
    exp = pm.pim_matmul(x, w_int, scales)
    assert torch.equal(pm.pim_matmul(xt, w_int, scales), exp)
    assert torch.equal(pm.pim_matmul(x, wt, scales), exp)
    shifted = torch.cat([torch.zeros(1, device=card), scales])[1:]
    assert shifted.data_ptr() % 16
    assert torch.equal(pm.pim_matmul(x, w_int, shifted), exp)


def test_launch_counts_and_refusals(card):
    pm.reset_launches()
    fa.reset_launches()
    x = torch.zeros((4, 8), dtype=torch.bfloat16, device=card)
    w = torch.zeros((8, 3), dtype=torch.int8, device=card)
    pm.pim_matmul(x, w, torch.ones(3, device=card))
    q = torch.zeros((1, 2, 1, 2, 16), device=card)
    k = torch.zeros((1, 3, 1, 16), device=card)
    pos = torch.arange(3, dtype=torch.int32, device=card)
    fa.flash_attention(q, k, k, pos[1:], pos)
    assert pm.LAUNCHES["pim_matmul"] == 1 and fa.LAUNCHES["flash_attn"] == 1
    assert fa.ROUTES == {"tiled": 0, "split_kv": 1, "tensor_core": 0}
    with pytest.raises(ValueError, match="576"):
        fa.flash_attention(torch.zeros((1, 2, 1, 2, 640), device=card),
                           torch.zeros((1, 3, 1, 640), device=card),
                           torch.zeros((1, 3, 1, 24), device=card),
                           pos[1:], pos)
    assert pm.LAUNCHES["pim_matmul"] == 1 and fa.LAUNCHES["flash_attn"] == 1


@pytest.mark.parametrize("arch,overrides", [
    ("qwen3-4b", {}), ("yi-34b", {}), ("qwen2.5-32b", {}),
    ("starcoder2-7b", {}),
    ("qwen3-4b", {"quant": "pim_w4", "quant_mode": "shift_add"}),
    ("qwen3-4b", {"quant": "pim_w8", "quant_mode": "dequant"}),
])
def test_smoke_lm_card_matches_cpu(card, arch, overrides):
    """greedy_generate on the card; the same weights and tokens
    teacher-forced on the card and on the CPU (starcoder2's prompt is past
    its window, so its cache is a ring)."""
    cfg = get_config(arch, smoke=True, **overrides)
    model = init_params(cfg, 5)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)), dtype=torch.int32, device=card)
    toks = greedy_generate(cfg, model, {"tokens": prompt}, max_new_tokens=5)
    assert toks.shape == (2, 5) and toks.device.type == "cuda"

    def forced(model, prompt, toks, device):
        lg, caches = prefill(cfg, model, {"tokens": prompt}, 29,
                             device=device)
        out = [lg.cpu()]
        for t in range(4):
            lg, caches = decode_step(cfg, model,
                                     {"tokens": toks[:, t:t + 1]}, 24 + t,
                                     caches, device=device)
            out.append(lg.cpu())
        return out

    on_card = forced(model, prompt, toks, None)
    assert torch.equal(toks[:, 0].cpu(),
                       torch.argmax(on_card[0][:, 0], -1).int())
    on_cpu = forced(model.to("cpu"), prompt.cpu(), toks.cpu(), "cpu")
    for t, (a, b) in enumerate(zip(on_card, on_cpu)):
        rel = rel_err(a, b)
        assert rel < LOGITS_REL, f"step {t}: rel {rel:.3e}"


@pytest.mark.parametrize("width", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("shape", [(512, 2048), (37, 2048), (3, 5), (1, 1)])
def test_ripple_add_kernel_matches_plain(card, width, shape):
    """Every width; ragged row counts and widths, and an odd word count
    (the one-word-per-thread kernel); exact."""
    gen = torch.Generator(device=card).manual_seed(width * 7 + shape[0])
    a, b = (torch.randint(-2**31, 2**31, shape, generator=gen,
                          dtype=torch.int64, device=card).to(torch.int32)
            for _ in range(2))
    got = rops.ripple_add(a, b, width=width)
    assert torch.equal(got, rref.ref_ripple_add(a, b, width))
    assert torch.equal(got.cpu(), rref.ref_ripple_add(a.cpu(), b.cpu(),
                                                      width))


def test_ripple_add_unaligned_rows(card):
    """Contiguous views that start 260 bytes in: a multiple of four words
    but not 16-byte aligned, so the one-word-per-thread kernel runs."""
    x = torch.randint(-2**31, 2**31, (2, 9, 65), dtype=torch.int64,
                      device=card).to(torch.int32)
    a, b = x[0, 1:], x[1, 1:]
    assert a.is_contiguous() and a.data_ptr() % 16 and a.numel() % 4 == 0
    got = rops.ripple_add(a, b, width=8)
    assert torch.equal(got, rref.ref_ripple_add(a, b, 8))


def test_ripple_add_launch_count_and_refusals(card):
    rops.reset_launches()
    x = torch.ones((4, 64), dtype=torch.int32, device=card)
    rops.ripple_add(x, x, width=8)
    assert rops.LAUNCHES["ripple_add"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        rops.ripple_add(x.T, x.T, width=8)
    with pytest.raises(TypeError):
        rops.ripple_add(x.float(), x.float(), width=8)
    with pytest.raises(ValueError, match="divide 32"):
        rops.ripple_add(x, x, width=3)
    assert rops.LAUNCHES["ripple_add"] == 1
    empty = torch.empty((0, 64), dtype=torch.int32, device=card)
    assert rops.ripple_add(empty, empty, width=8).shape == (0, 64)
    assert rops.LAUNCHES["ripple_add"] == 1


@pytest.mark.parametrize("width", [1, 2, 4, 8, 16, 32])
def test_ripple_add_carries_to_the_top_bit(card, width):
    """Lanes whose carry runs through every bit: all ones + 1 (wraps to 0),
    0x7F.. + 1 (carries into the top bit), all ones + all ones; exact."""
    lanes = 32 // width
    one = sum(1 << (e * width) for e in range(lanes))
    low = sum(((1 << (width - 1)) - 1) << (e * width) for e in range(lanes))
    words = np.array([[0xFFFFFFFF, one], [low, one], [0xFFFFFFFF,
                                                      0xFFFFFFFF]],
                     dtype=np.uint32).view(np.int32)
    a = torch.as_tensor(np.repeat(words[:, :1], 64, 1), device=card)
    b = torch.as_tensor(np.repeat(words[:, 1:], 64, 1), device=card)
    got = rops.ripple_add(a, b, width=width)
    assert torch.equal(got, rref.ref_ripple_add(a, b, width))
    assert torch.equal(got.cpu(), rref.ref_ripple_add(a.cpu(), b.cpu(),
                                                      width))


def fold_inputs(m, slots, nf, ni, seed):
    """Tables with the values a meter can meet: a -0.0 start (slot 0, field
    0) met by +0.0 and -0.0 increments, denormal increments, signed normals
    over ten decades and, with six fields or more, +inf, -inf and NaN
    increments and denormal starts; int increments over the whole int32
    range, so that every int sum wraps past 2**31. On the card."""
    rng = np.random.default_rng(seed)
    f_tab = (rng.random((m, nf)) * 10.0 ** rng.integers(-7, 3, (m, nf))
             * np.where(rng.random((m, nf)) < 0.3, -1, 1)).astype(np.float32)
    f0 = (rng.random((slots, nf)) * 1e4).astype(np.float32)
    f0[0, 0] = -0.0
    f_tab[: m // 3, 0] = np.where(rng.random(m // 3) < 0.5, -0.0, 0.0)
    tiny = (rng.random(m) * 2.0**-126).astype(np.float32)
    if nf < 6:
        f_tab[m // 3: m // 2, 0] = tiny[m // 3: m // 2]
    else:
        f_tab[:, 4] = tiny
        f0[:, 4] = (rng.random(slots) * 2.0**-126).astype(np.float32)
        if m >= 4:
            f_tab[m // 2, 1] = np.inf
            f_tab[m // 3, 2] = np.nan
            f_tab[m // 4, 3] = -np.inf
            f_tab[m // 2, 3] = np.inf        # -inf + inf: NaN from there on
            f_tab[m - 1, 5] = -np.inf
    i_tab = rng.integers(-2**31, 2**31, (m, ni), dtype=np.int64)
    i0 = rng.integers(-2**31, 2**31, (slots, ni), dtype=np.int64)
    return [torch.as_tensor(x, device="cuda") for x in
            (f_tab, i_tab.astype(np.int32), f0, i0.astype(np.int32))]


def same_bits(got, exp):
    """Equal bit patterns; a NaN matches any NaN."""
    got, exp = got.cpu(), exp.cpu()
    if not got.is_floating_point():
        return torch.equal(got, exp)
    nan = torch.isnan(exp)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got.view(torch.int32)[~nan],
                            exp.view(torch.int32)[~nan]))


@pytest.mark.parametrize("m", [0, 1, 255, 256, 257, 4001, 20000])
@pytest.mark.parametrize("slots", [1, 3, 64])
@pytest.mark.parametrize("nf,ni", [(6, 6), (1, 0)])
def test_meter_fold_kernel_matches_plain(card, m, slots, nf, ni):
    """The cost meter's shape (6 + 6 fields) and sequential_sum's (1 + 0),
    tables shorter than, equal to and past one staged tile, onto 1 to 64
    slots; exact, in one launch per call."""
    f_tab, i_tab, f0, i0 = fold_inputs(m, slots, nf, ni, m + 7 * slots + nf)
    rops.reset_launches()
    ff, fi = rops.meter_fold(f_tab, i_tab, f0, i0)
    assert rops.LAUNCHES["meter_fold"] == 1
    ef, ei = rref.ref_meter_fold(f_tab.cpu(), i_tab.cpu(), f0.cpu(), i0.cpu())
    assert same_bits(ff, ef) and same_bits(fi, ei)
    if nf == 6 and m >= 4:
        assert torch.isnan(ff[:, 2]).all() and torch.isnan(ff[:, 3]).all()


def test_meter_fold_other_shapes_and_unaligned_ints(card):
    """Field counts beside 6 and 1 (the generic instance), a float-only and
    an int-only fold, and an int table that does not start on 16 bytes
    (read a word at a time); exact."""
    for m, slots, nf, ni in ((1001, 65, 3, 5), (300, 2, 16, 16),
                             (513, 4, 2, 0), (700, 5, 0, 7)):
        f_tab, i_tab, f0, i0 = fold_inputs(m, slots, max(nf, 1), ni, m)
        f_tab, f0 = f_tab[:, :nf].contiguous(), f0[:, :nf].contiguous()
        got = rops.meter_fold(f_tab, i_tab, f0, i0)
        exp = rref.ref_meter_fold(f_tab.cpu(), i_tab.cpu(), f0.cpu(),
                                  i0.cpu())
        assert same_bits(got[0], exp[0]) and same_bits(got[1], exp[1]), m
    f_tab, i_tab, f0, i0 = fold_inputs(1001, 64, 6, 6, 3)
    shifted = torch.cat([i_tab.new_zeros(1), i_tab.flatten()])[1:]
    i_tab = shifted.view(1001, 6)
    assert i_tab.data_ptr() % 16 and i_tab.is_contiguous()
    got = rops.meter_fold(f_tab, i_tab, f0, i0)
    exp = rref.ref_meter_fold(f_tab.cpu(), i_tab.cpu(), f0.cpu(), i0.cpu())
    assert same_bits(got[0], exp[0]) and same_bits(got[1], exp[1])


def test_meter_fold_launch_count_and_refusals(card):
    rops.reset_launches()
    f_tab, i_tab, f0, i0 = fold_inputs(40, 2, 6, 6, 1)
    rops.meter_fold(f_tab, i_tab, f0, i0)
    assert rops.LAUNCHES["meter_fold"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        rops.meter_fold(f_tab.T.contiguous().T, i_tab, f0, i0)
    with pytest.raises(TypeError):
        rops.meter_fold(f_tab.double(), i_tab, f0, i0)
    with pytest.raises(RuntimeError, match="CUDA error"):
        rops.meter_fold(torch.zeros((3, 17), device=card),
                        torch.zeros((3, 0), dtype=torch.int32, device=card),
                        torch.zeros((1, 17), device=card),
                        torch.zeros((1, 0), dtype=torch.int32, device=card))
    empty = rops.meter_fold(f_tab, i_tab, f0[:0], i0[:0])
    assert empty[0].shape == (0, 6) and empty[1].shape == (0, 6)
    assert rops.LAUNCHES["meter_fold"] == 1


# ---------------------------------------------------------------------------
# The executor's row entries: bitwise_rows and shift_rows, in place on a
# (B, R, W) state, against their plain versions on the same state, exact
# ---------------------------------------------------------------------------

ROWS_R = 12
ROW_WIDTHS = [1, 3, 2048, 65536]
# (op, sources, destinations, side): every alias pattern of the executor
ROW_CASES = [
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


def state_on(card, slots, rows, words, seed, offset=0):
    """A contiguous (slots, rows, words) int32 state from a seed, starting
    ``offset`` words into its storage."""
    x = torch.randint(-2**31, 2**31, (offset + slots * rows * words,),
                      dtype=torch.int64, generator=torch.Generator()
                      .manual_seed(seed)).to(torch.int32).to(card)
    return x[offset:].view(slots, rows, words)


def rows_agree(card_fn, plain_fn, bits):
    """Run the kernel on ``bits`` and the plain version on a copy; the
    states and every returned row must be equal."""
    exp_bits = bits.clone()
    got = card_fn(bits)
    exp = plain_fn(exp_bits)
    torch.cuda.synchronize()
    assert torch.equal(bits, exp_bits)
    got = got if isinstance(got, tuple) else (got,)
    exp = exp if isinstance(exp, tuple) else (exp,)
    for g, e in zip(got, exp):
        assert (g is None) == (e is None)
        if g is not None:
            assert g.device.type == "cuda" and torch.equal(g, e)


@pytest.mark.parametrize("slots", [1, 64])
@pytest.mark.parametrize("words", ROW_WIDTHS)
@pytest.mark.parametrize("case", ROW_CASES, ids=str)
def test_bitwise_rows_kernel_matches_plain(card, slots, words, case):
    op, srcs, dsts, side = case
    bits = state_on(card, slots, ROWS_R, words, seed=words + slots)
    rows_agree(lambda b: rops.bitwise_rows(b, op, srcs, dsts, side),
               lambda b: rref.ref_bitwise_rows(b, op, srcs, dsts, side),
               bits)


@pytest.mark.parametrize("offset,words,srcs,dsts", [
    (1, 2048, (0, 1, 2), (9, 10, 11, 0)),    # every row 4 bytes off
    (0, 2050, (0, 1, 2), (9, 10, 11, 1)),    # odd rows 8 bytes off
    (0, 6, (0, 2, 4), (6, 8, 10, 2)),        # aligned: one vector + 2 words
    (0, 7, (0, 4, 8), (4, 8, 1, 2)),         # scalar throughout
])
def test_bitwise_rows_unaligned_rows_and_tails(card, offset, words, srcs,
                                               dsts):
    for slots in (1, 5):
        bits = state_on(card, slots, ROWS_R, words, seed=3, offset=offset)
        rows_agree(lambda b: rops.bitwise_rows(b, "maj", srcs, dsts),
                   lambda b: rref.ref_bitwise_rows(b, "maj", srcs, dsts),
                   bits)
        rows_agree(lambda b: rops.bitwise_rows(b, "not", srcs[:1],
                                               dsts[:1], True),
                   lambda b: rref.ref_bitwise_rows(b, "not", srcs[:1],
                                                   dsts[:1], True),
                   bits)


def shift_ks(words):
    return [1, 2, 31, 32, 33, 999, 32 * words, 32 * words + 1,
            32 * words + 40]


@pytest.mark.parametrize("slots", [1, 64])
@pytest.mark.parametrize("words", ROW_WIDTHS)
@pytest.mark.parametrize("which_k", range(9))
def test_shift_rows_kernel_matches_plain(card, slots, words, which_k):
    """Both directions, in place and out of place (source above and below
    the destination), k at word and row edges and beyond 32·W."""
    k = shift_ks(words)[which_k]
    bits = state_on(card, slots, 6, words, seed=which_k)
    for delta in (1, -1):
        for src, dst in ((2, 2), (2, 3), (3, 2)):
            rows_agree(lambda b: rops.shift_rows(b, src, dst, delta, k),
                       lambda b: rref.ref_shift_rows(b, src, dst, delta, k),
                       bits)


@pytest.mark.parametrize("words,route", [
    (8192, "in_place"),          # one block per row
    (8193, "in_place"),          # a cluster of 2
    (65536, "in_place"),         # the cluster route's longest row: 8 blocks
    (65540, "scratch"),          # above it: scratch row and a copy
    (65536 + 8192 + 3, "scratch"),
])
def test_shift_rows_cluster_limit_and_scratch_route(card, words, route):
    assert rops.shift_rows_cluster_words() == 65536
    for slots in (1, 3):
        bits = state_on(card, slots, 3, words, seed=words)
        for delta, k in ((1, 1), (-1, 1), (1, 32 * 8192 + 7),
                         (-1, 32 * 4096 + 31), (1, 999)):
            rops.reset_launches()
            rows_agree(lambda b: rops.shift_rows(b, 1, 1, delta, k),
                       lambda b: rref.ref_shift_rows(b, 1, 1, delta, k),
                       bits)
            assert rops.LAUNCHES["shift_rows"] == 1
            assert rops.SHIFT_ROUTES[route] == 1
        rops.reset_launches()
        rows_agree(lambda b: rops.shift_rows(b, 0, 2, 1, 40),
                   lambda b: rref.ref_shift_rows(b, 0, 2, 1, 40), bits)
        assert rops.SHIFT_ROUTES["out_of_place"] == 1


def test_row_entries_launch_counts_and_refusals(card):
    rops.reset_launches()
    bits = torch.zeros((2, 8, 64), dtype=torch.int32, device=card)
    dcc = rops.bitwise_rows(bits, "not", (0,), (0,), side=True)
    assert dcc.shape == (2, 64) and bool((dcc == -1).all())
    rops.bitwise_rows(bits, "maj", (0, 1, 2), (3, 4, 5, 6))
    mt, mb = rops.shift_rows(bits, 0, 0, 1, 5)
    assert mt.shape == mb.shape == (2, 64)
    assert rops.LAUNCHES["bitwise_rows"] == 2
    assert rops.LAUNCHES["shift_rows"] == 1
    assert rops.ROWS_BY_OP["not"] == 1 and rops.ROWS_BY_OP["maj"] == 1
    assert rops.SHIFT_ROUTES["in_place"] == 1
    assert rops.LAUNCHES["bitwise"] == rops.LAUNCHES["shift_cols"] == 0
    strided = bits.transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        rops.bitwise_rows(strided, "not", (0,), (1,))
    with pytest.raises(ValueError, match="contiguous"):
        rops.shift_rows(strided, 0, 1, 1, 1)
    with pytest.raises(TypeError):
        rops.shift_rows(bits.float(), 0, 1, 1, 1)
    assert rops.LAUNCHES["bitwise_rows"] == 2
    assert rops.LAUNCHES["shift_rows"] == 1
    empty = torch.zeros((0, 8, 64), dtype=torch.int32, device=card)
    assert rops.shift_rows(empty, 0, 0, 1, 3)[0].shape == (0, 64)
    assert rops.bitwise_rows(empty, "not", (0,), side=True).shape == (0, 64)
    assert rops.LAUNCHES["bitwise_rows"] == 2


@pytest.mark.parametrize("slots", [1, 3])
def test_executor_row_entries_card_matches_cpu(card, slots):
    """A program with every alias of the row entries through execute() on
    the card (one launch per segment and row) and on the CPU."""
    from repro_torch.core import pim
    rows, words = 32, 2048
    b = pim.ProgramBuilder(rows, words)
    b.issue().reserve_control_rows()
    b.ambit_maj(0, 1, 2, 0).ambit_xor(3, 4, 3).ambit_not(5, 5)
    b.shift_k(6, 6, 40).shift_k(7, 8, -999).shift_k(9, 9, 3)
    b.shift(10, 10, -1).tra(11, 12, 13).not_to_dcc(14).rowclone(14, 15)
    b.dcc_to(16)
    b.read_row(0)
    b.read_row(16)
    prog = b.build()
    bits = np.random.default_rng(slots).integers(
        0, 2**32, (slots, rows, words), dtype=np.uint32)
    out = {}
    for dev in ("cpu", card):
        st = pim.reserve_control_rows(pim.SubarrayState(
            bits=torch.from_numpy(bits.view(np.int32)).to(dev),
            mig_top=torch.zeros((slots, words), dtype=torch.int32,
                                device=dev),
            mig_bot=torch.zeros((slots, words), dtype=torch.int32,
                                device=dev),
            dcc=torch.zeros((slots, words), dtype=torch.int32, device=dev),
            meter=pim.CostMeter.zeros(dev, shape=(slots,))))
        rops.reset_launches()
        out[str(dev)] = pim.execute(prog, st)
        launches = dict(rops.LAUNCHES)
    got, exp = out["cuda"], out["cpu"]
    for f in ("bits", "mig_top", "mig_bot", "dcc"):
        assert torch.equal(getattr(got.state, f).cpu(),
                           getattr(exp.state, f))
    assert all(torch.equal(x.cpu(), y) for x, y in zip(got.reads, exp.reads))
    assert launches["bitwise_rows"] == 8 and launches["shift_rows"] == 6
    assert launches["bitwise"] == launches["shift_cols"] == 0


# ---------------------------------------------------------------------------
# greedy_generate as one CUDA-graph replay per call
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["smoke", "2 layers"])
def served(card, request):
    """Qwen3-4B pim_w4 shift_add with weights from a seed: the smoke size,
    and the full width at 2 layers."""
    cut = {"n_layers": 2} if request.param == "2 layers" else {}
    cfg = get_config("qwen3-4b", smoke=not cut, quant="pim_w4",
                     quant_mode="shift_add", **cut)
    return cfg, init_params(cfg, 7)


def prompt_on(card, cfg, seed, batch=2, length=24):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, length)), dtype=torch.int32, device=card)


def eager_loop(cfg, model, prompt, toks):
    """The eager loop, teacher-forced with ``toks``: prefill and one decode
    step per token but the last. Returns each step's logits and their
    argmax chain (B, n) int32."""
    s, n = prompt.shape[1], toks.shape[1]
    lg, caches = prefill(cfg, model, {"tokens": prompt}, s + n)
    logits = [lg]
    for t in range(n - 1):
        lg, caches = decode_step(cfg, model, {"tokens": toks[:, t:t + 1]},
                                 s + t, caches)
        logits.append(lg)
    chain = torch.stack([torch.argmax(lg[:, 0, :cfg.vocab_size], -1)
                         for lg in logits], dim=1).to(torch.int32)
    return logits, chain


def test_generate_graph_is_the_eager_argmax_chain(served, card):
    """Each call is one replay (DECODE_STATS 1) whose tokens are the eager
    loop's argmax chain bit for bit: the same launches on the same
    operands."""
    cfg, model = served
    prompt = prompt_on(card, cfg, 1)
    for _ in range(2):                    # the capture's call, a replay
        engine.DECODE_STATS["dispatches"] = 0
        toks = greedy_generate(cfg, model, {"tokens": prompt},
                               max_new_tokens=6)
        assert engine.DECODE_STATS["dispatches"] == 1
        assert toks.shape == (2, 6) and toks.dtype == torch.int32
        assert torch.equal(toks, eager_loop(cfg, model, prompt, toks)[1])


def test_generate_graph_dispatch_counts(served, card):
    """One dispatch per call for 1 and 5 tokens, none for zero tokens."""
    cfg, model = served
    prompt = prompt_on(card, cfg, 2)
    engine.DECODE_STATS["dispatches"] = 0
    for n, total in ((5, 1), (5, 2), (1, 3), (0, 3), (1, 4)):
        out = greedy_generate(cfg, model, {"tokens": prompt},
                              max_new_tokens=n)
        assert out.shape == (2, n)
        assert engine.DECODE_STATS["dispatches"] == total
    assert torch.equal(out, greedy_generate(
        cfg, model, {"tokens": prompt}, max_new_tokens=5)[:, :1])


def test_generate_graph_calls_keep_their_tokens(served, card):
    """Two prompts through one signature's graph: each call gets its own
    tokens, and the second does not overwrite the first's result."""
    cfg, model = served
    model.generate_graphs.clear()
    p1, p2 = prompt_on(card, cfg, 3), prompt_on(card, cfg, 4)
    out1 = greedy_generate(cfg, model, {"tokens": p1}, max_new_tokens=5)
    kept = out1.clone()
    out2 = greedy_generate(cfg, model, {"tokens": p2}, max_new_tokens=5)
    assert len(model.generate_graphs) == 1
    assert torch.equal(out1, kept)
    assert torch.equal(out1, eager_loop(cfg, model, p1, out1)[1])
    assert torch.equal(out2, eager_loop(cfg, model, p2, out2)[1])
    assert not torch.equal(out1, out2)


def test_generate_graphs_per_signature_bounded_and_freed(card):
    """A new signature captures a new graph; a model keeps MAX_GRAPHS (4)
    signatures, the least recently used dropped first, and its graphs die
    with it."""
    import gc
    import weakref
    assert engine.MAX_GRAPHS == 4
    cfg = get_config("qwen3-4b", smoke=True)
    model = init_params(cfg, 8)
    prompt = prompt_on(card, cfg, 5)
    graphs = model.generate_graphs
    refs = {}
    for n in range(1, 7):
        greedy_generate(cfg, model, {"tokens": prompt}, max_new_tokens=n)
        assert len(graphs) == min(n, 4)
        refs[n] = weakref.ref(next(reversed(graphs.values())).graph)

    def alive():
        gc.collect()
        return [n for n, r in refs.items() if r() is not None]

    assert alive() == [3, 4, 5, 6]
    greedy_generate(cfg, model, {"tokens": prompt}, max_new_tokens=3)
    greedy_generate(cfg, model, {"tokens": prompt[:1]}, max_new_tokens=3)
    # (batch, max_new_tokens) of each signature, the most recent last
    assert [(k[1], k[4]) for k in graphs] == [(2, 5), (2, 6), (2, 3), (1, 3)]
    assert alive() == [3, 5, 6]
    del model, graphs
    assert alive() == []


def test_generate_graph_temperature_is_the_cpu_sampler(served, card):
    """Temperature sampling in the graph: the caller's generator draws u
    for every step before the replay; the CPU sampler on the same u and
    the eager loop's logits gives the same tokens, and the same seed the
    same tokens again."""
    cfg, model = served
    prompt = prompt_on(card, cfg, 6)
    n, temp = 5, 1.3
    runs = [greedy_generate(
        cfg, model, {"tokens": prompt}, max_new_tokens=n, temperature=temp,
        generator=torch.Generator(device=card).manual_seed(3))
        for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    u = torch.empty((n, 2, cfg.vocab_size), device=card).uniform_(
        generator=torch.Generator(device=card).manual_seed(3))
    logits, chain = eager_loop(cfg, model, prompt, runs[0])
    t = torch.tensor(temp, dtype=torch.float32)
    cpu = torch.stack([engine._sample(cfg, lg.cpu(), t, u[i].cpu())
                       for i, lg in enumerate(logits)], dim=1)
    assert torch.equal(runs[0].cpu(), cpu)
    assert not torch.equal(runs[0], chain)


def test_generate_graph_launches_per_call(served, card):
    """Launch counts and routes are the eager loop's per call: a capture
    counts nothing, each replay adds what its graph captured, and the
    first call adds the warm-up's eager prefill and decode step."""
    cfg, model = served
    model.generate_graphs.clear()
    prompt = prompt_on(card, cfg, 7)
    n = 4

    def counted(fn):
        pm.reset_launches()
        fa.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, (dict(pm.LAUNCHES), dict(pm.ROUTES), dict(fa.LAUNCHES),
                     dict(fa.ROUTES))

    def generate():
        return greedy_generate(cfg, model, {"tokens": prompt},
                               max_new_tokens=n)

    captured = dict(pm.CAPTURED), dict(fa.CAPTURED)
    toks, first = counted(generate)
    _, warm = counted(lambda: eager_loop(cfg, model, prompt, toks[:, :2]))
    _, loop = counted(lambda: eager_loop(cfg, model, prompt, toks))
    _, replay = counted(generate)
    assert replay == loop
    assert first == tuple({k: loop[i][k] + warm[i][k] for k in loop[i]}
                          for i in range(4))
    L = cfg.n_layers
    assert loop[0] == {"pim_matmul": 3 * L * n}
    assert loop[2] == {"flash_attn": L * n}
    assert {k: v - captured[0][k] for k, v in pm.CAPTURED.items()} \
        == loop[1]
    assert {k: v - captured[1][k] for k, v in fa.CAPTURED.items()} \
        == loop[3]


# ---------------------------------------------------------------------------
# The static verifier's gates, the serving front end and Table 4 on the card
# ---------------------------------------------------------------------------

import glob  # noqa: E402
import os  # noqa: E402

import pim_serve_scenarios as serve_sc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pim as tpim  # noqa: E402
from repro_torch.core.pim import exec as tpim_exec  # noqa: E402
from repro_torch.core.pim import lint as tlint  # noqa: E402

LINT_FIXTURES = sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "fixtures", "lint", "*.trace")))


def _state_np(state):
    return {k: v.tolist() for k, v in convert.to_numpy(state).items()}


def _reads_np(reads):
    return [r.cpu().numpy().view(np.uint32).tolist()
            if isinstance(r, torch.Tensor) else np.asarray(r).tolist()
            for r in reads]


def _run_gate(gate, text, device):
    """One verify=True gate over a fixture's stream on ``device``: the
    gate's verdict and, when it passes, what the run produced."""
    layout = tpim.from_trace_device(text)
    prog = layout[0][0]
    cfg = tpim.DeviceConfig(channels=1, ranks=1, banks_per_rank=len(layout),
                            subarrays=len(layout[0]), num_rows=prog.num_rows,
                            words=prog.words)
    nested = [list(b) for b in layout]

    def fresh():
        return tpim.make_subarray(prog.num_rows, prog.words, device=device)

    runs = {
        "execute": lambda: tpim_exec.execute(prog, fresh(), verify=True),
        "make_runner": lambda: tpim_exec.make_runner(prog, verify=True)(
            fresh()),
        "run_program": lambda: tpim.run_program(fresh(), prog, verify=True),
        "schedule": lambda: tpim.schedule(
            tpim.make_device(cfg, device=device), nested, verify=True),
        "schedule_pipeline": lambda: tpim.schedule_pipeline(
            tpim.make_device(cfg, device=device), [nested, nested],
            verify=True),
        "schedule_workload": lambda: tpim.schedule_workload(
            tpim.make_device(cfg, device=device),
            [tpim.Phase.repeat(nested, 2)], verify=True),
    }
    try:
        out = runs[gate]()
    except tlint.LintError as e:
        return ("LintError", sorted({d.code for d in e.report.errors}))
    if gate == "run_program":
        return ("ok", _state_np(out[0]), _reads_np(out[1]))
    if gate in ("execute", "make_runner"):
        return ("ok", _state_np(out.state), _reads_np(out.reads))
    state = _state_np(out.state)
    if gate == "schedule_workload":
        out = out.phases[0]         # reads and walls live on the phase
    return ("ok", state, serve_sc.plain(out.reads),
            out.wall_ns.cpu().numpy().tolist())


def _gate_cases():
    """(gate, fixture): the single-subarray gates take the one-bank
    fixtures, the schedulers every fixture."""
    out = []
    for path in LINT_FIXTURES:
        with open(path) as f:
            single = f.readline().rstrip().endswith("banks=1")
        for gate in ("execute", "make_runner", "run_program", "schedule",
                     "schedule_pipeline", "schedule_workload"):
            if single or gate.startswith("schedule"):
                out.append(pytest.param(gate, path, id=f"{gate}-"
                                        f"{os.path.basename(path)}"))
    return out


@pytest.mark.parametrize("gate, path", _gate_cases())
def test_verify_gates_on_the_card_match_the_cpu(card, gate, path):
    with open(path) as f:
        text = f.read()
    got = _run_gate(gate, text, card)
    assert got == _run_gate(gate, text, "cpu")
    name = os.path.basename(path)
    if name in ("pim103.trace", "pim104.trace", "pim106.trace") or (
            name == "pim302.trace" and gate.startswith("schedule")):
        assert got[0] == "LintError"
    if name == "clean_maj.trace":
        assert got[0] == "ok"


@pytest.mark.parametrize("name", sorted(serve_sc.SCENARIOS))
def test_serve_front_on_the_card_matches_the_cpu(card, name):
    got = []
    for kit in (serve_sc.port_kit(card), serve_sc.port_kit("cpu")):
        kit.pim.reset_stats()
        got.append(serve_sc.SCENARIOS[name](kit))
    assert got[0] == got[1]


def test_serve_front_runs_the_row_kernels_on_the_card(card):
    kit = serve_sc.port_kit(card)
    rops.reset_launches()
    serve_sc.SCENARIOS["run_pipelines_recurring_windows_single_dispatch"](
        kit)
    torch.cuda.synchronize()
    assert rops.LAUNCHES["meter_fold"] > 0
    assert rops.ROWS_BY_OP["maj"] > 0
    assert rops.LAUNCHES["shift_cols"] == rops.LAUNCHES["bitwise"] == 0


@pytest.mark.parametrize("pct, paper, bound", [(0.0, 0.0, 0.0),
                                               (5.0, 0.005, 0.004),
                                               (10.0, 0.14, 0.04),
                                               (20.0, 0.30, 0.06)])
def test_shift_failure_rate_on_the_card_within_table4(card, pct, paper,
                                                      bound):
    g = torch.Generator(device=card)
    g.manual_seed(7)
    r = tpim.shift_failure_rate(pct, 100_000, generator=g, device=card)
    assert r.device.type == "cuda" and r.dtype == torch.float32
    assert tpim.PAPER_TABLE4[pct] == paper
    assert abs(float(r) - paper) <= bound
