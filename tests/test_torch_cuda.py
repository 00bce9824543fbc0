"""The port's kernels on the card against their plain versions, at ragged
shapes and options that ``chip_smoke.py``'s full-width run does not reach
(``ripple_add`` at every width, ``meter_fold`` at every table size and
special value, ``pim_matmul`` and ``flash_attn`` on each of their routes,
odd and random sizes), the smoke-size serving path on the card against
the CPU, and ``greedy_generate``'s CUDA graphs (one replay per call, the
eager loop's tokens and launches, a bounded cache per model) at the smoke
size and at Qwen3-4B's full width with 2 layers; then the MoE, MLA and
frontend families (``-k families``) and the recurrent ones (``-k
recurrent``: falcon-mamba-7b and recurrentgemma-2b at the smoke size,
recurrentgemma-2b at full width with 5 layers, the ring's wrap); the PIM
schedule on a 64-slot device, card against CPU bit for bit, and
``xla_sum`` at every length to 256; and training (``-k train``): the
flash forward's log-sum-exp on every route, one pass's gradients card
against CPU at the smoke size and at Qwen3-4B's full width with 1 layer, a
training step card against CPU, serving unchanged after training; and
training's loop (``-k train_loop``): a resumed run bit for bit against an
uninterrupted one, checkpoints of CUDA bf16 and int8 tensors, a restore
under a captured ``greedy_generate`` graph; the refresh count at refresh
cycles past half the interval (``-k "refresh_count or long_refresh"``)
and flash at 32,768 positions (``-k flash_32k``).

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


@pytest.mark.parametrize("mkn", [(17, 72, 48), (40, 264, 144),
                                 (130, 1032, 272)])
@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("mode,bits", [("shift_add", 8), ("dequant", 4),
                                       ("dequant", 8)])
def test_pim_matmul_tensor_core_w8_and_dequant(card, mkn, splits, mode,
                                               bits):
    """The tensor-core route in the modes the serving path reaches only
    through Qwen3-4B's pim_w8 and dequant configs, at small shapes ragged
    against its tiles, with its K split forced 1-3 ways, against the plain
    version; twice on the same inputs, the same bits."""
    m, k, n = mkn
    gen = torch.Generator(device=card).manual_seed(m + k + n + splits)
    x = torch.randn((m, k), generator=gen, device=card).to(torch.bfloat16)
    w_int, scales = pm.quantize(
        torch.randn((k, n), generator=gen, device=card), bits)
    exp = pref.ref_pim_matmul_raw(x, w_int, mode=mode, bits=bits) \
        * scales[None, :]
    pm.reset_launches()
    outs = [pm._launch(x, w_int, scales, torch.empty((m, n), device=card),
                       mode, bits, "tensor_core", splits) for _ in range(2)]
    assert pm.ROUTES["tensor_core"] == 2
    assert pm.KINDS == {(mode, bits): 2}
    rel = rel_err(outs[0], exp)
    assert rel <= PIM_REL, f"rel {rel:.3e} (bound {PIM_REL})"
    assert torch.equal(outs[0], outs[1])


# (B, Sq, Sk, KV, window, last query position, ring): odd query groups
# (G 5, 7, 9: yi-34b's 7, qwen2.5-32b's 5, starcoder2-7b's 9) on a causal
# prefill under a window, several decode rows over a wrapped ring (slot j
# holds the latest position p <= last with p = j mod Sk, unsorted), and
# one decode row over the ring at the window's edge
ODD_G_SHAPES = [(2, 150, 150, 2, 40, 149, False),
                (2, 3, 100, 2, 100, 250, True),
                (1, 1, 96, 2, 96, 300, True)]


@pytest.mark.parametrize("shape", ODD_G_SHAPES)
@pytest.mark.parametrize("which", ["split_kv", "tensor_core"])
@pytest.mark.parametrize("g", [5, 7, 9])
def test_flash_odd_groups_window_and_ring(card, shape, which, g):
    """Both bf16 routes at odd G, whose row blocks (row s·G + g) straddle
    query positions, at the causal skip and the window's lower edge,
    against the plain version."""
    B, Sq, Sk, KV, window, last, ring = shape
    gen = torch.Generator(device=card).manual_seed(g * 100 + Sq)
    q, k, v = (torch.randn(sh, generator=gen, device=card).to(torch.bfloat16)
               for sh in ((B, Sq, KV, g, 128), (B, Sk, KV, 128),
                          (B, Sk, KV, 128)))
    pos_q = torch.arange(last - Sq + 1, last + 1, dtype=torch.int32,
                         device=card)
    slots = torch.arange(Sk, dtype=torch.int32, device=card)
    pos_k = (last - torch.remainder(last - slots, Sk) if ring
             else slots).repeat(B, 1)
    got = launch_route(q, k, v, pos_q, pos_k, window, which)
    exp = fref.ref_flash_attention(q, k, v, pos_q, pos_k, window=window)
    err = float((got.float() - exp.float()).abs().max())
    assert err < flash_bound(exp), f"max abs err {err}"


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_flash_32k_against_chunked_plain(card, phase):
    """Qwen3-4B's heads at 32,768 positions (batch 1): prefill over 32,752
    causal tokens on the tensor-core route, decode at position 32,766 over
    a 32,768-slot cache (the last slot unwritten) on the split route, each
    against the plain version taken over 1,024 queries at a time (all at
    once its float32 scores would take 137 GB), each query row within 1e-2
    of its own max |plain| (a late row's outputs, ~sqrt(e / 32k), are
    hundreds of times smaller than row 0's)."""
    prefill = phase == "prefill"
    sq, sk = (32752, 32752) if prefill else (1, 32768)
    last = sq - 1 if prefill else 32766
    gen = torch.Generator(device=card).manual_seed(sq)
    q, k, v = (torch.randn(sh, generator=gen, device=card).to(torch.bfloat16)
               for sh in ((1, sq, 8, 4, 128), (1, sk, 8, 128),
                          (1, sk, 8, 128)))
    pos_q = torch.arange(last - sq + 1, last + 1, dtype=torch.int32,
                         device=card)
    pos_k = torch.arange(sk, dtype=torch.int32, device=card)
    pos_k[last + 1:] = -1
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, pos_q, pos_k)
    assert fa.ROUTES["tensor_core" if prefill else "split_kv"] == 1
    exp = torch.cat([fref.ref_flash_attention(q[:, i:i + 1024], k, v,
                                              pos_q[i:i + 1024], pos_k)
                     for i in range(0, sq, 1024)], dim=1)
    diff = (got.float() - exp.float()).abs()
    row_max = exp.float().abs().amax(dim=(2, 3, 4), keepdim=True)
    share = float((diff / (FLASH_BF16_REL * row_max)).max())
    assert torch.isfinite(got.float()).all()
    assert share < 1, (f"max abs err {float(diff.max())}, {share:.3f} of "
                       "the per-row bound")


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
    ("starcoder2-7b", {"quant": "pim_w4", "quant_mode": "shift_add"}),
    ("yi-34b", {"n_heads": 14, "n_kv_heads": 2}),
    ("qwen2.5-32b", {"n_heads": 10, "n_kv_heads": 2}),
    ("starcoder2-7b", {"n_heads": 18, "n_kv_heads": 2}),
])
def test_smoke_lm_card_matches_cpu(card, arch, overrides):
    """greedy_generate on the card; the same weights and tokens
    teacher-forced on the card and on the CPU (starcoder2's prompt is past
    its window, so its cache is a ring; starcoder2 pim_w4 runs its GELU
    MLP's biases after the bit-plane products; 14, 10 and 18 query heads
    on 2 kv heads are the odd groups G = 7, 5 and 9 of yi-34b,
    qwen2.5-32b and starcoder2-7b)."""
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
import importlib  # noqa: E402
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


def test_serve_front_runs_the_row_kernels_on_the_card(card, fresh_graphs):
    # the PIM graphs dropped: the scenario's first calls run eagerly, where
    # the wrappers count their launches (a graph's replay moves no count)
    kit = serve_sc.port_kit(card)
    rops.reset_launches()
    serve_sc.SCENARIOS["run_pipelines_recurring_windows_single_dispatch"](
        kit)
    torch.cuda.synchronize()
    assert rops.LAUNCHES["meter_fold"] > 0
    assert rops.ROWS_BY_OP["maj"] > 0
    assert rops.LAUNCHES["shift_cols"] == rops.LAUNCHES["bitwise"] == 0


def _wide_layout(cfg, rng):
    """64 slots of six random streams (payloads of their own per slot,
    about a tenth idle) and three cross-bank COPYs."""
    from repro_torch.core.pim.ir import ProgramBuilder

    def stream():
        b = ProgramBuilder(cfg.num_rows, cfg.words)
        b.issue()
        for kind in rng.choice(("write", "xor", "chain", "maj", "not",
                                "read", "tra"), int(rng.integers(3, 12))):
            r = [int(x) for x in rng.choice(cfg.num_rows - 8, 4,
                                            replace=False)]
            if kind == "write":
                b.write_row(r[0], rng.integers(0, 2**32, (cfg.words,),
                                               dtype=np.uint32))
            elif kind == "xor":
                b.ambit_xor(r[0], r[1], r[2])
            elif kind == "chain":
                b.shift_k(r[0], r[1], int(rng.choice([-1, 1]))
                          * int(rng.integers(2, 50)))
            elif kind == "maj":
                b.ambit_maj(*r)
            elif kind == "not":
                b.ambit_not(r[0], r[1])
            elif kind == "read":
                b.read_row(r[0])
            else:
                b.tra(r[0], r[1], r[2])
        return b.build()

    pool = [stream() for _ in range(6)]
    flat = []
    for _ in range(cfg.n_slots):
        p = pool[int(rng.integers(len(pool)))]
        flat.append(None if rng.random() < 0.1 else p.with_payloads(
            [rng.integers(0, 2**32, q.shape, dtype=np.uint32)
             for q in p.payloads]))
    moves = [((int(rng.integers(cfg.n_banks)), int(rng.integers(2)), j),
              (int(rng.integers(cfg.n_banks)), int(rng.integers(2)), 20 + j))
             for j in range(3)]
    return tpim.gather_rows(cfg, moves, flat)


def test_schedule_on_a_64_slot_device_card_matches_cpu(card):
    """``paper_device(32, 32, 8, subarrays=2)``: three steps (sync with
    COPY drains, async, async refreshed) and a 3-step pipeline; states,
    reads, per-step wall and energy (summed in XLA's order by
    ``compile.xla_sum``, from adds of slices and the meter fold) equal
    to the CPU's, bit for bit."""
    cfg = tpim.paper_device(32, 32, 8, subarrays=2)
    rng = np.random.default_rng(64)
    layouts = [_wide_layout(cfg, rng) for _ in range(3)]
    flags = ({}, {"async_host": True}, {"async_host": True, "refresh": True})
    got = {}
    for where in ("cpu", card):
        dev = tpim.make_device(cfg, device=where)
        out = []
        for lay, fl in zip(layouts, flags):
            r = tpim.schedule(dev, lay, **fl)
            dev = r.state
            out.append((float(r.wall_ns), float(r.energy_nj),
                        r.host_overlap_ns,
                        [_reads_np(x) for x in r.reads]))
        pipe = tpim.schedule_pipeline(dev, layouts[0], n_steps=3,
                                      async_host=True)
        out.append((pipe.wall_ns.cpu().numpy().view(np.uint32).tolist(),
                    pipe.energy_nj.cpu().numpy().view(np.uint32).tolist(),
                    pipe.total_wall_ns, pipe.host_overlap_ns))
        got[str(where)] = (out, _state_np(pipe.state))
    assert got["cpu"] == got[str(card)]


@pytest.mark.parametrize("fused", [False, True])
def test_xla_sum_card_matches_cpu(card, fused):
    """``xla_sum`` at every length from 1 to 256 and at 1,100 (two window
    levels): the card's bits are the CPU's."""
    from repro_torch.core.pim.compile import xla_sum
    rng = np.random.default_rng(int(fused))
    for n in list(range(1, 257)) + [1100]:
        x = (rng.choice([-1, 1], n) * np.exp2(rng.uniform(-8, 10, n))) \
            .astype(np.float32)
        cpu = xla_sum(torch.from_numpy(x), fused=fused)
        on_card = xla_sum(torch.from_numpy(x).to(card), fused=fused)
        assert on_card.device.type == "cuda"
        assert same_bits(on_card.cpu(), cpu), n


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


# ---------------------------------------------------------------------------
# The MoE, MLA and frontend families on the card
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402

from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import ffn as tffn  # noqa: E402

FAMILY_CASES = {
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {}),
    "deepseek-v2-lite-16b-pim_w4": ("deepseek-v2-lite-16b",
                                    {"quant": "pim_w4"}),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
    "qwen3-moe-30b-a3b-gather": ("qwen3-moe-30b-a3b", {"impl": "gather"}),
    "llava-next-mistral-7b-pim_w4": ("llava-next-mistral-7b",
                                     {"quant": "pim_w4"}),
}


def family_config(arch, smoke=True, impl=None, **overrides):
    cfg = get_config(arch, smoke=smoke, **overrides)
    if impl is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=impl))
    return cfg


def family_inputs(cfg, seed, device, batch=2, length=24):
    """Seeded prompt inputs on ``device``: tokens (and a vision model's
    patches) or an audio model's frames."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frame_embeds": torch.as_tensor(rng.normal(
            size=(batch, length, cfg.d_model)), dtype=torch.float32,
            device=device)}
    out = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (batch, length)), dtype=torch.int32,
        device=device)}
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = torch.as_tensor(rng.normal(
            size=(batch, cfg.n_patches, cfg.d_model)), dtype=torch.float32,
            device=device)
    return out


def family_forced(cfg, model, inputs, steps, device):
    """Prefill and one decode step per entry of ``steps`` ((B, 1) tokens
    or (B, 1, D) frames): each step's logits on the CPU."""
    n = inputs[next(iter(inputs))].shape[1] + (
        cfg.n_patches if cfg.frontend == "vision_patches" else 0)
    key = "frame_embeds" if cfg.frontend == "audio_frames" else "tokens"
    lg, caches = prefill(cfg, model, inputs, n + len(steps), device=device)
    out = [lg.cpu()]
    for t, x in enumerate(steps):
        lg, caches = decode_step(cfg, model, {key: x}, n + t, caches,
                                 device=device)
        out.append(lg.cpu())
    return out


def moe_input(cfg, seed, device, tokens=128):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((2, tokens // 2, cfg.d_model), generator=g)
    return x.to(device=device, dtype=torch.bfloat16 if cfg.dtype ==
                "bfloat16" else torch.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-30b-a3b"])
def test_families_moe_ffn_card_matches_cpu(card, arch, impl, dtype):
    """moe_ffn on the card, with no host synchronisation (the sync debug
    mode raises on one), against the CPU on the same weights and inputs:
    float32 within PIM_REL, bf16 within the logits' bound; the aux loss
    within float32 rounding. Two dispatch chunks."""
    cfg = family_config(arch, impl=impl, dtype=dtype)
    model = init_params(cfg, 3)
    ffn = model.layers[0].ffn
    x = moe_input(cfg, 4, card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = tffn.moe_ffn(cfg, ffn, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ffn.to("cpu")
    y_cpu, aux_cpu = tffn.moe_ffn(cfg, ffn, x.cpu())
    bound = PIM_REL if dtype == "float32" else LOGITS_REL
    assert rel_err(y, y_cpu) < bound
    assert abs(float(aux) - float(aux_cpu)) <= 1e-5 * abs(float(aux_cpu))


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_families_moe_ffn_graph_replays_bit_for_bit(card, impl):
    """moe_ffn captured in a CUDA graph and replayed on new inputs equals
    the eager call on them bit for bit: no data-dependent shape, no host
    sync, no atomic-ordered float adds."""
    cfg = family_config("qwen3-moe-30b-a3b", impl=impl)
    ffn = init_params(cfg, 5).layers[0].ffn
    static = moe_input(cfg, 6, card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tffn.moe_ffn(cfg, ffn, static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _ = tffn.moe_ffn(cfg, ffn, static)
    for seed in (7, 8):
        x = moe_input(cfg, seed, card)
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tffn.moe_ffn(cfg, ffn, x)[0])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_families_mla_card_matches_cpu(card, dtype):
    """mla_train at 128 positions (bf16: the flash kernel's tensor-core
    route at dk 24 / dv 16; float32: tiled) and mla_decode (split over the
    keys at dk 40 / dv 32) on the card against the CPU; the decode writes
    the same cache entries."""
    cfg = family_config("deepseek-v2-lite-16b", dtype=dtype)
    model = init_params(cfg, 6)
    p = model.layers[0].attn
    x = moe_input(cfg, 9, card, tokens=256)[:1]
    pos = torch.arange(128, dtype=torch.int32, device=card)
    fa.reset_launches()
    out, (ckv, krope) = tattn.mla_train(cfg, p, x, pos)
    torch.cuda.synchronize()
    assert fa.ROUTES["tensor_core" if dtype == "bfloat16" else "tiled"] == 1
    cache = tattn.mla_init_cache(cfg, 1, 130, card)
    cache["ckv"][:, :128], cache["krope"][:, :128] = ckv, krope
    cache["kpos"][:, :128] = pos
    x1 = x[:, :1] * 0.5
    dec, cache = tattn.mla_decode(cfg, p, x1, 128, cache)
    assert fa.ROUTES["split_kv"] == 1
    p.to("cpu")
    out_c, (ckv_c, _) = tattn.mla_train(cfg, p, x.cpu(), pos.cpu())
    cache_c = {k: v.cpu().clone() for k, v in cache.items()}
    cache_c["kpos"][:, 128] = -1
    dec_c, cache_c = tattn.mla_decode(cfg, p, x1.cpu(), 128, cache_c)
    bound = PIM_REL if dtype == "float32" else LOGITS_REL
    assert rel_err(out, out_c) < bound and rel_err(ckv, ckv_c) < bound
    assert rel_err(dec, dec_c) < bound
    assert torch.equal(cache["kpos"].cpu(), cache_c["kpos"])


class RouterLog:
    """The router probabilities (on the host) of every ``moe_ffn`` call
    made inside the ``with`` block, in call order."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.orig = tffn.moe_ffn

        def record(cfg, p, x):
            logits = x.reshape(-1, x.shape[-1]).float() @ p.router
            self.calls.append(torch.softmax(logits, -1).cpu())
            return self.orig(cfg, p, x)

        tffn.moe_ffn = record
        return self

    def __exit__(self, *exc):
        tffn.moe_ffn = self.orig


def routing_flips(cfg, ref, got, S):
    """Tokens whose top-k experts differ between two teacher-forced runs
    (prefill of S positions, then decode steps): request, position, MoE
    layer, the reference's margin (k-th less (k+1)-th probability) and
    k-th probability, and whether an earlier flip reaches it."""
    if cfg.moe is None:
        return []
    K, n_moe = cfg.moe.top_k, cfg.n_layers - cfg.moe.first_k_dense
    flips = []
    for i, (a, b) in enumerate(zip(ref, got)):
        step, layer = divmod(i, n_moe)
        top = a.topk(K + 1, dim=-1)
        sa = top.indices[:, :K].sort(-1).values
        sb = b.topk(K, dim=-1).indices.sort(-1).values
        for row in (sa != sb).any(-1).nonzero().flatten().tolist():
            req, pos = divmod(row, S) if step == 0 else (row, S + step - 1)
            flips.append(dict(
                request=req, position=pos, layer=layer,
                margin=float(top.values[row, K - 1] - top.values[row, K]),
                p_k=float(top.values[row, K - 1])))
    for f in flips:
        f["follows"] = any(g["request"] == f["request"]
                           and g["position"] <= f["position"]
                           and g["layer"] < f["layer"] for g in flips)
    return flips


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_families_generate_graph_is_the_eager_argmax_chain(card, case):
    """Each new family's greedy_generate at the smoke size: one replay per
    call (DECODE_STATS 1), its tokens the eager loop's argmax chain bit for
    bit (llava: the patches a static input of the graph, positions after
    them), and the card's teacher-forced logits within the bound of the
    CPU's on the requests no routing flip reaches; a flip that follows no
    earlier one has a reference (CPU) margin within the bound of its k-th
    probability, and is named in the message."""
    arch, kw = FAMILY_CASES[case]
    cfg = family_config(arch, **kw)
    model = init_params(cfg, 7)
    for seed in (1, 2):                    # the capture's call, a replay
        inputs = family_inputs(cfg, seed, card)
        engine.DECODE_STATS["dispatches"] = 0
        toks = greedy_generate(cfg, model, inputs, max_new_tokens=5)
        assert engine.DECODE_STATS["dispatches"] == 1
        assert toks.shape == (2, 5) and toks.dtype == torch.int32
        with RouterLog() as card_log:
            forced = family_forced(cfg, model, inputs,
                                   [toks[:, t:t + 1] for t in range(4)],
                                   None)
        chain = torch.stack([lg[:, 0].argmax(-1) for lg in forced],
                            dim=1).to(torch.int32)
        assert torch.equal(toks.cpu(), chain)
    assert len(model.generate_graphs) == 1
    with RouterLog() as cpu_log:
        on_cpu = family_forced(cfg, model.to("cpu"),
                               {k: v.cpu() for k, v in inputs.items()},
                               [toks[:, t:t + 1].cpu() for t in range(4)],
                               "cpu")
    S = 24 + (cfg.n_patches if cfg.frontend == "vision_patches" else 0)
    flips = routing_flips(cfg, cpu_log.calls, card_log.calls, S)
    assert all(f["follows"] or f["margin"] <= LOGITS_REL * f["p_k"]
               for f in flips), flips
    for t, (a, b) in enumerate(zip(forced, on_cpu)):
        rows = [r for r in range(2) if not any(
            f["request"] == r and f["position"] <= S - 1 + t for f in flips)]
        if rows:
            assert rel_err(a[rows], b[rows]) < LOGITS_REL, \
                f"step {t} on requests {rows}; flips {flips}"


def test_families_audio_card_matches_cpu(card):
    """musicgen through prefill and teacher-forced decode_step on seeded
    frames (greedy_generate raises for it, as the reference's does): the
    card's per-codebook logits within the bound of the CPU's."""
    cfg = get_config("musicgen-medium", smoke=True)
    model = init_params(cfg, 8)
    inputs = family_inputs(cfg, 3, card)
    frames = family_inputs(cfg, 4, card, length=4)["frame_embeds"]
    steps = [frames[:, t:t + 1] for t in range(4)]
    with pytest.raises(ValueError, match="frame_embeds"):
        greedy_generate(cfg, model, inputs, max_new_tokens=2)
    fa.reset_launches()
    on_card = family_forced(cfg, model, inputs, steps, None)
    # prefill's 24 rows per pair and each decode step's one: split_kv
    assert fa.ROUTES["split_kv"] == 5 * cfg.n_layers
    assert on_card[0].shape == (2, 1, cfg.n_codebooks, cfg.vocab_size)
    on_cpu = family_forced(cfg, model.to("cpu"),
                           {k: v.cpu() for k, v in inputs.items()},
                           [s.cpu() for s in steps], "cpu")
    for t, (a, b) in enumerate(zip(on_card, on_cpu)):
        assert rel_err(a, b) < LOGITS_REL, f"step {t}"


# ---------------------------------------------------------------------------
# The recurrent families on the card
# ---------------------------------------------------------------------------

RECURRENT_CASES = {
    "falcon-mamba-7b": ("falcon-mamba-7b", True, {}),
    "recurrentgemma-2b": ("recurrentgemma-2b", True, {}),
    "recurrentgemma-2b-pim_w4": ("recurrentgemma-2b", True,
                                 {"quant": "pim_w4"}),
    # full width, 5 layers: one (rec, rec, attn) block and the 2-layer tail
    "recurrentgemma-2b-pim_w4-full-width": ("recurrentgemma-2b", False,
                                            {"quant": "pim_w4",
                                             "n_layers": 5}),
}


def forced(cfg, model, prompt, toks, device=None):
    """The eager loop teacher-forced with ``toks`` on ``device`` (the card
    unless "cpu"): each step's logits and their argmax chain."""
    s, n = prompt.shape[1], toks.shape[1]
    lg, caches = prefill(cfg, model, {"tokens": prompt}, s + n,
                         device=device)
    logits = [lg]
    for t in range(n - 1):
        lg, caches = decode_step(cfg, model, {"tokens": toks[:, t:t + 1]},
                                 s + t, caches, device=device)
        logits.append(lg)
    chain = torch.stack([torch.argmax(lg[:, 0, :cfg.vocab_size], -1)
                         for lg in logits], dim=1).to(torch.int32)
    return logits, chain


def recurrent_counts(cfg, passes):
    """Launches per route of prefill and ``passes - 1`` decode steps: each
    quantized FFN linear (3 per layer, GeGLU) one pim_matmul, each full
    block's attention one flash_attn; an SSM model neither. pim_matmul's
    also by (route, K, N): w1 and w3 at (d_model, d_ff), w2 at (d_ff,
    d_model)."""
    n = 3 * cfg.n_layers if cfg.quant and cfg.rglru is not None else 0
    pat = cfg.rglru.pattern if cfg.rglru is not None else ()
    a = cfg.n_layers // len(pat) * pat.count("attn") if pat else 0
    D, F = cfg.d_model, cfg.d_ff
    shapes = {(route, *kn): count * per
              for route, per in (("tensor_core", 1), ("swap_ab", passes - 1))
              for kn, count in (((D, F), 2 * n // 3), ((F, D), n // 3))
              if count * per}
    return ({"pim_matmul": n * passes},
            {"tensor_core": n, "swap_ab": n * (passes - 1), "cuda_core": 0},
            {"flash_attn": a * passes},
            {"tiled": 0, "split_kv": a * (passes - 1), "tensor_core": a},
            shapes)


@pytest.mark.parametrize("case", list(RECURRENT_CASES))
def test_recurrent_generate_graph_is_the_eager_argmax_chain(card, case):
    """greedy_generate of a recurrent family: one replay per call
    (DECODE_STATS 1) whose tokens are the eager loop's argmax chain bit for
    bit, its launches per route (and pim_matmul's per shape) those of
    prefill and the decode steps, and
    the card's teacher-forced logits within the bound of the CPU's. The
    prompt of 40 positions is over two of the smoke size's 16-step scan
    chunks, with padding."""
    arch, smoke, kw = RECURRENT_CASES[case]
    cfg = get_config(arch, smoke=smoke, **kw)
    model = init_params(cfg, 7)
    n = 5
    for seed in (1, 2):                    # the capture's call, a replay
        prompt = prompt_on(card, cfg, seed, length=40)
        engine.DECODE_STATS["dispatches"] = 0
        pm.reset_launches()
        fa.reset_launches()
        toks = greedy_generate(cfg, model, {"tokens": prompt},
                               max_new_tokens=n)
        torch.cuda.synchronize()
        assert engine.DECODE_STATS["dispatches"] == 1
        if seed == 2:
            assert (dict(pm.LAUNCHES), dict(pm.ROUTES), dict(fa.LAUNCHES),
                    dict(fa.ROUTES), dict(pm.SHAPES)) \
                == recurrent_counts(cfg, n)
        logits, chain = forced(cfg, model, prompt, toks)
        assert toks.shape == (2, n) and torch.equal(toks, chain)
    assert len(model.generate_graphs) == 1
    model.to("cpu")
    on_cpu, _ = forced(cfg, model, prompt.cpu(), toks.cpu(), "cpu")
    for t, (a, b) in enumerate(zip(logits, on_cpu)):
        assert rel_err(a, b) < LOGITS_REL, f"step {t}"


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_recurrent_decode_writes_state_in_place(card, arch):
    """decode_step on the card writes each layer's recurrent state into the
    caches' tensors it was given (no new tensors), as on the CPU."""
    cfg = get_config(arch, smoke=True)
    model = init_params(cfg, 9)
    prompt = prompt_on(card, cfg, 3)
    _, caches = prefill(cfg, model, {"tokens": prompt}, 30)
    key = "stack" if cfg.ssm is not None else "tail"
    h, conv = caches[key]["h"], caches[key]["conv"]
    before = h.clone()
    _, out = decode_step(cfg, model, {"tokens": prompt[:, :1]}, 24, caches)
    assert out[key]["h"] is h and out[key]["conv"] is conv
    assert not torch.equal(h, before)


def test_recurrent_ring_wraps_on_the_card(card):
    """recurrentgemma at the smoke size (window 16): 30 new tokens after an
    8-token prompt, so the attention's 16-slot ring wraps; the replay's
    tokens are the eager chain bit for bit (bf16), and in float32 the
    card's logits over the wrap are within PIM_REL of the CPU's."""
    cfg = get_config("recurrentgemma-2b", smoke=True)
    model = init_params(cfg, 10)
    prompt = prompt_on(card, cfg, 4, length=8)
    toks = greedy_generate(cfg, model, {"tokens": prompt},
                           max_new_tokens=30)
    _, chain = forced(cfg, model, prompt, toks)
    assert torch.equal(toks, chain)
    cfg32 = get_config("recurrentgemma-2b", smoke=True, dtype="float32")
    model32 = init_params(cfg32, 10)
    _, caches = prefill(cfg32, model32, {"tokens": prompt}, 38)
    assert caches["blocks"]["sub2"]["k"].shape[2] == 16
    logits, _ = forced(cfg32, model32, prompt, toks)
    on_cpu, _ = forced(cfg32, model32.to("cpu"), prompt.cpu(), toks.cpu(),
                       "cpu")
    for t, (a, b) in enumerate(zip(logits, on_cpu)):
        assert rel_err(a, b) < PIM_REL, f"step {t}"


# ---------------------------------------------------------------------------
# Training's gradient path on the card (``-k train``)
# ---------------------------------------------------------------------------

import copy  # noqa: E402

from repro_torch.convert import lm_params_to_numpy  # noqa: E402
from repro_torch.models import loss_fn, trainable  # noqa: E402
from repro_torch.models.transformer import tree_leaves  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import (init_train_state, make_train_step,  # noqa: E402,E501
                               trainable_params)

LSE_ABS = 1e-3      # chip_smoke.py's FLASH_LSE_ABS
GRAD_REL = 2e-2


@pytest.mark.parametrize("shape", ROUTE_SHAPES[:6])
@pytest.mark.parametrize("which", ["tiled", "split_kv", "tensor_core"])
def test_train_flash_lse_on_every_route(card, shape, which):
    """Each route writes the log-sum-exp through its pointer, as the plain
    version computes it (bf16 inputs; float32 on the tiled and split
    routes too), and the same output as without it."""
    B, Sq, Sk, KV, G, dk, dv, window, invalid = shape
    if which == "tensor_core" and max(dk, dv) > fa.TC_MAX_HEAD_DIM:
        pytest.skip("the tensor-core route takes dk, dv <= 256")
    for dtype in ((torch.bfloat16,) if which == "tensor_core"
                  else (torch.bfloat16, torch.float32)):
        q, k, v, pos_q, pos_k = flash_operands(shape, dtype, 3)
        base = launch_route(q, k, v, pos_q, pos_k, window, which)
        out = torch.empty_like(base)
        lse = torch.full((B, KV, G, Sq), float("nan"), device=card)
        fa._launch(q, k, v, pos_q, pos_k, out, window, dk ** -0.5, which,
                   lse=lse)
        exp_out, exp_lse = fref.ref_flash_attention(
            q, k, v, pos_q, pos_k, window=window, return_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(out, base), (which, dtype)
        assert float((lse - exp_lse).abs().max()) < LSE_ABS, (which, dtype)
        err = float((out.float() - exp_out.float()).abs().max())
        assert err < flash_bound(exp_out), (which, dtype, err)


def test_train_flash_lse_keeps_serving_launches(card):
    """``return_lse`` counts in LSE_ROUTES beside ROUTES; without it the
    serving call is what it was: one launch, no log-sum-exp."""
    q, k, v, pos_q, pos_k = flash_operands(ROUTE_SHAPES[3], torch.bfloat16,
                                           4)
    fa.reset_launches()
    a = fa.flash_attention(q, k, v, pos_q, pos_k)
    b, lse = fa.flash_attention(q, k, v, pos_q, pos_k, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and lse.dtype == torch.float32
    assert fa.LAUNCHES["flash_attn"] == 2
    assert sum(fa.LSE_ROUTES.values()) == 1


def _grads(model, cfg, batch):
    trainable(model)
    loss, _ = loss_fn(cfg, model, {k: v.to(model.device)
                                   for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), dict(tree_leaves(lm_params_to_numpy(
        model, grads=True)))


def _train_batch(cfg, b, s, seed=0):
    tok = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)), dtype=torch.long)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


@pytest.mark.parametrize("overrides,layers", [
    ({"quant": "pim_w4", "quant_mode": "shift_add"}, None),
    ({"quant": "pim_w4", "quant_mode": "dequant"}, None),
    ({}, None),
    ({"quant": "pim_w4", "quant_mode": "shift_add"}, 1)])
def test_train_grads_card_match_cpu(card, overrides, layers):
    """One pass's loss and every gradient leaf, card against the CPU port,
    at the smoke size and (layers 1) at Qwen3-4B's full width: the
    autograd flash and ``PimMatmul`` backwards on the card."""
    smoke = layers is None
    cfg = get_config("qwen3-4b", smoke=smoke, **overrides,
                     **({} if smoke else {"n_layers": layers}))
    cpu_model = init_params(cfg, 2, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(card)
    batch = _train_batch(cfg, 2, 32 if smoke else 64)
    pm.reset_launches()
    fa.reset_launches()
    lc, gc_ = _grads(card_model, cfg, batch)
    lp, gp = _grads(cpu_model, cfg, batch)
    if cfg.quant:      # per linear: forward, recompute, dx (and acc)
        per = 4 if cfg.quant_mode == "shift_add" else 3
        assert pm.LAUNCHES["pim_matmul"] == per * 3 * cfg.n_layers
    assert sum(fa.LSE_ROUTES.values()) == 2 * cfg.n_layers
    assert abs(lc - lp) / abs(lp) < GRAD_REL
    assert set(gc_) == set(gp)
    for key, ref in gp.items():
        err = float(abs(gc_[key] - ref).max() / (abs(ref).max() + 1e-30))
        assert err < GRAD_REL, (key, err)


def test_train_step_card_matches_cpu(card):
    """One ``make_train_step`` step at the smoke size (pim_w4), card
    against CPU: loss, grad norm and the updated params within the
    microbatch bound 5e-2; nothing skipped."""
    cfg = get_config("qwen3-4b", smoke=True, quant="pim_w4")
    cpu_model = init_params(cfg, 3, device="cpu")
    card_model = copy.deepcopy(cpu_model).to(card)
    batch = _train_batch(cfg, 4, 32, seed=1)
    out = {}
    for where, model in (("card", card_model), ("cpu", cpu_model)):
        step = make_train_step(cfg, AdamWConfig(lr=1e-3), lambda s: 1.0)
        m = step(model, init_train_state(model),
                 {k: v.to(model.device) for k, v in batch.items()})
        out[where] = (float(m["loss"]), float(m["grad_norm"]),
                      float(m["skipped"]), [p.detach().float().cpu()
                                            for p in trainable_params(model)])
    (lc, nc, sc, pc), (lp, np_, sp, pp) = out["card"], out["cpu"]
    assert sc == sp == 0.0
    assert abs(lc - lp) / abs(lp) < GRAD_REL
    assert abs(nc - np_) / np_ < GRAD_REL
    assert max(float((a - b).abs().max()) for a, b in zip(pc, pp)) < 5e-2


def test_train_serving_unchanged_and_head_refreshed(card):
    """Under no_grad the served call's routes and launches are as before
    training (no log-sum-exp, no backward product), and after a step the
    float32 head holds the trained embedding at the same address."""
    cfg = get_config("qwen3-4b", smoke=True, quant="pim_w4")
    model = init_params(cfg, 4)
    prompt = {"tokens": torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)), dtype=torch.int32, device=card)}

    def serve_counts():
        pm.reset_launches()
        fa.reset_launches()
        greedy_generate(cfg, model, prompt, max_new_tokens=5)
        torch.cuda.synchronize()
        return (dict(pm.ROUTES), dict(fa.ROUTES), dict(fa.LSE_ROUTES))

    greedy_generate(cfg, model, prompt, max_new_tokens=5)     # capture
    before = serve_counts()
    head = model.head_f32.data_ptr()
    step = make_train_step(cfg, AdamWConfig(lr=1e-2), lambda s: 1.0)
    step(model, init_train_state(model),
         {k: v.to(card) for k, v in _train_batch(cfg, 2, 24).items()})
    assert model.head_f32.data_ptr() == head
    assert torch.equal(model.head_f32, model.embed.detach().float())
    after = serve_counts()
    assert before == after and not any(after[2].values())


# ---------------------------------------------------------------------------
# Training's loop and checkpoints on the card (``-k train_loop``)
# ---------------------------------------------------------------------------

import os  # noqa: E402

from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.models.transformer import param_tree  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402


def _ckpt_arrays(d, step):
    with np.load(os.path.join(d, f"step_{step:08d}", "host0.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("overrides", [{"quant": "pim_w4"}, {}],
                         ids=["pim_w4", "bf16"])
def test_train_loop_resume_on_the_card(card, overrides, tmp_path):
    """As chip_smoke.py's phase 22 at the smoke size: 4 uninterrupted steps
    against 2 steps, then a resume to 4, every trainable leaf, moment and
    the step counter bit for bit (the port's kernels and the step sum in a
    fixed order; no atomics)."""
    cfg = get_config("qwen3-4b", smoke=True, **overrides)
    kw = dict(batch=4, seq=32, log=lambda *a: None)
    d1, d2 = str(tmp_path / "once"), str(tmp_path / "resumed")
    m1, h1 = train_loop(cfg, steps=4, ckpt_dir=d1, **kw)
    train_loop(cfg, steps=2, ckpt_dir=d2, **kw)
    m2, h2 = train_loop(cfg, steps=4, ckpt_dir=d2, **kw)
    assert m1.device.type == "cuda" and len(h2["loss"]) == 2
    assert h1["loss"][2:] == h2["loss"]
    a, b = _ckpt_arrays(d1, 4), _ckpt_arrays(d2, 4)
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    for x, y in zip(trainable_params(m1), trainable_params(m2)):
        assert torch.equal(x.detach(), y.detach())


def test_train_loop_checkpoint_of_cuda_tensors(card, tmp_path):
    """CUDA bf16 (NaN, inf, -0, subnormals among them) and int8 tensors
    saved and restored into CUDA tensors, and into CPU ones, bit for
    bit."""
    d = str(tmp_path)
    bits = torch.as_tensor(np.random.default_rng(0).integers(
        -2**15, 2**15, (64, 33)), dtype=torch.int16)
    bits[0, :6] = torch.tensor([0x7FC0, 0x7F80, -128, 0, -32768, 1],
                               dtype=torch.int16)
    bf = bits.view(torch.bfloat16).to(card)
    codes = torch.randint(-128, 128, (3, 17, 5), dtype=torch.int8,
                          device=card)
    tree = {"bf": bf, "layers": checkpoint.Stacked([bf, bf * 2]),
            "codes": codes, "step": torch.tensor(9, dtype=torch.int32,
                                                 device=card)}
    checkpoint.save(d, 1, tree)
    for where in (card, torch.device("cpu")):
        dst = {"bf": torch.zeros_like(bf, device=where),
               "layers": checkpoint.Stacked([torch.zeros_like(bf,
                                                               device=where)
                                             for _ in range(2)]),
               "codes": torch.zeros_like(codes, device=where),
               "step": torch.zeros((), dtype=torch.int32, device=where)}
        checkpoint.restore(d, 1, dst)
        assert torch.equal(dst["bf"].view(torch.int16).cpu(), bits)
        for got, want in zip(dst["layers"].tensors, (bf, bf * 2)):
            assert torch.equal(got.view(torch.int16).cpu(),
                               want.view(torch.int16).cpu())
        assert torch.equal(dst["codes"].cpu(), codes.cpu())
        assert int(dst["step"]) == 9 and dst["bf"].device.type == where.type


def test_train_loop_restore_keeps_the_captured_graph(card, tmp_path):
    """``restore`` copies into the model in place: a ``greedy_generate``
    graph captured before it replays (no new capture) with the restored
    weights, and gives the tokens of a model built with them."""
    cfg = get_config("qwen3-4b", smoke=True)
    donor = init_params(cfg, 11)
    checkpoint.save(str(tmp_path), 1, checkpoint.train_state(
        donor, init_train_state(donor)))
    model = init_params(cfg, 12)
    prompt = {"tokens": torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)), dtype=torch.int32, device=card)}
    before = greedy_generate(cfg, model, prompt, max_new_tokens=6)
    (graph,) = model.generate_graphs.values()
    ptrs = [t.data_ptr() for t in trainable_params(model)]
    checkpoint.restore(str(tmp_path), 1, checkpoint.train_state(
        model, init_train_state(model)), model=model)
    engine.DECODE_STATS["dispatches"] = 0
    after = greedy_generate(cfg, model, prompt, max_new_tokens=6)
    assert engine.DECODE_STATS["dispatches"] == 1
    assert list(model.generate_graphs.values()) == [graph]
    assert [t.data_ptr() for t in trainable_params(model)] == ptrs
    assert torch.equal(model.head_f32, model.embed.detach().float())
    want = greedy_generate(cfg, donor, prompt, max_new_tokens=6)
    assert torch.equal(after, want) and not torch.equal(before, after)
    for (_, a), (_, b) in zip(tree_leaves(param_tree(model)),
                              tree_leaves(param_tree(donor))):
        for x, y in zip(*((v if isinstance(v, list) else [v])
                          for v in (a, b))):
            assert torch.equal(x.detach(), y.detach())


# ---------------------------------------------------------------------------
# The sharded path (-k sharded): each process group in processes of its own
# ---------------------------------------------------------------------------

_SHARDED_PSUM = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.cuda.set_device(rank % torch.cuda.device_count())
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim.grad_compress import psum_compressed
f32 = np.float32
gs = [(np.random.default_rng(r).standard_normal((96, 160)) * (1 + r))
      .astype(f32) for r in range(world)]
rs = [(np.random.default_rng(50 + r).standard_normal((96, 160)) * 0.01)
      .astype(f32) for r in range(world)]
mesh = make_host_mesh()
ok = []
for case in ("none", "residual"):
    gf = [g + r for g, r in zip(gs, rs)] if case == "residual" else gs
    sc = [np.maximum(np.abs(g).max(), f32(1e-12)) / f32(127.0) for g in gf]
    codes = [np.clip(np.round(g / s), -127, 127).astype(np.int8)
             .astype(f32) for g, s in zip(gf, sc)]
    smax = max(sc)
    total = sum(np.round(c * (s / smax)).astype(np.int32)
                for c, s in zip(codes, sc)).astype(f32) * smax
    res = gf[rank] - codes[rank] * sc[rank]
    for group in (None, (mesh, "model")):
        t, r = psum_compressed(
            torch.from_numpy(gs[rank]).cuda(), group,
            torch.from_numpy(rs[rank]).cuda() if case == "residual"
            else None)
        ok.append(bool(np.array_equal(t.cpu().numpy(), total)
                       and np.array_equal(r.cpu().numpy(), res)))
json.dump(ok, open(out, "w"))
dist.destroy_process_group()
"""

_SHARDED_RESTORE = r"""
import json, sys
import numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.ckpt import checkpoint
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params
from repro_torch.train.step import opt_layout, trainable_params
d, out = sys.argv[1], sys.argv[2]
cfg = get_config("qwen3-4b", smoke=True, quant="pim_w4")
mesh = make_host_mesh()
model = init_params(cfg, 3)
p_shard, _ = sharding.param_shardings(cfg, mesh, model)
sharding.distribute_model(model, mesh, p_shard)
ps = trainable_params(model)
layout = opt_layout(model)
skeleton = checkpoint.train_state(model, {"mu": ps, "nu": ps, "step": 0})
zero = lambda t: {k: zero(v) if isinstance(v, dict) else 0
                  for k, v in t.items()}
skeleton["opt"] = {"mu": zero(layout["mu"]), "nu": zero(layout["nu"]),
                   "step": 0}
tree, _ = checkpoint.restore(d, 1, skeleton, shardings={
    "opt": sharding.opt_shardings(mesh, layout, p_shard)})
got = {}
for k, v in checkpoint._flatten(tree).items():
    ts = v.tensors if isinstance(v, checkpoint.Stacked) else [v]
    assert all(t.device.type == "cuda" and hasattr(t, "full_tensor")
               for t in ts), k
    full = torch.stack([t.full_tensor() for t in ts])
    full = full if isinstance(v, checkpoint.Stacked) else full[0]
    if full.dtype == torch.bfloat16:
        full = full.view(torch.int16)
    got[k] = full.detach().cpu().numpy()
np.savez(out, **{k.replace("/", "__"): v for k, v in got.items()})
"""


def _sharded_run(code, *args):
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_sharded_psum_compressed_over_nccl(card, tmp_path):
    """``psum_compressed`` over NCCL, a rank per card, with the default
    group and with a host mesh's "model" dim: each rank's total and
    residual equal numpy's computation of the reference's formula bit for
    bit, with and without a residual."""
    import json
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    n = torch.cuda.device_count()
    outs = [tmp_path / f"rank{r}.json" for r in range(n)]
    procs = [_sharded_run(_SHARDED_PSUM, r, n, port, o)
             for r, o in enumerate(outs)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    for o in outs:
        assert json.loads(o.read_text()) == [True] * 4


def test_sharded_restore_on_the_card(card, tmp_path):
    """A checkpoint of the smoke-size pim_w4 model's training state
    restored onto ``make_host_mesh()`` (one NCCL rank) with
    ``param_shardings``' and ``opt_shardings``' placements: every leaf a
    DTensor on the card, gathered bit for bit."""
    cfg = get_config("qwen3-4b", smoke=True, quant="pim_w4")
    donor = init_params(cfg, 4, device="cpu")
    opt = init_train_state(donor)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for t in opt["mu"] + opt["nu"]:
            t.copy_(torch.randn(t.shape, generator=gen))
    opt["step"] = torch.tensor(3, dtype=torch.int32)
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 1, checkpoint.train_state(donor, opt))
    out = tmp_path / "got.npz"
    p = _sharded_run(_SHARDED_RESTORE, d, out)
    _, err = p.communicate(timeout=300)
    assert p.returncode == 0, err[-3000:]
    got = dict(np.load(out).items())
    want = _ckpt_arrays(d, 1)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.array_equal(got[k].view(w.dtype), w), k


# ---------------------------------------------------------------------------
# The PIM path's CUDA graphs (-k pim_graph): each entry's warm call one
# replay, bit for bit against its eager first call and the CPU
# ---------------------------------------------------------------------------

from repro_torch.core.pim import graphs as tgraphs  # noqa: E402

# the package re-exports schedule() the function, shadowing the module
tsched = importlib.import_module("repro_torch.core.pim.schedule")

GRAPH_CFG = dict(num_rows=32, words=64)


def _bits32(x):
    """float32 tensors as their bit patterns, every other leaf as is."""
    if isinstance(x, torch.Tensor):
        a = x.detach().cpu().numpy()
        return (a.view(np.uint32) if a.dtype == np.float32 else a).tolist()
    if isinstance(x, float):
        return np.float32(x).view(np.uint32).item()
    return x


def _tree_bits(x):
    if isinstance(x, (tuple, list)):
        return [_tree_bits(y) for y in x]
    return _bits32(x)


def _state_bits(state):
    return {k: _bits32(torch.from_numpy(np.asarray(v)))
            for k, v in convert.to_numpy(state).items()}


def _sched_obs(r):
    """Everything a schedule()/schedule_pipeline() result carries."""
    return (_state_bits(r.state), _bits32(r.wall_ns), _bits32(r.energy_nj),
            serve_sc.plain(r.reads), _bits32(r.host_overlap_ns),
            r.bus_ns, r.copy_ns)


def _workload_obs(r):
    return (_state_bits(r.state), r.order, [
        (_bits32(p.wall_ns), _bits32(p.energy_nj), serve_sc.plain(p.reads),
         _bits32(p.host_overlap_ns), _bits32(p.boundary_credit_ns))
        for p in r.phases])


def _exec_obs(r):
    return (_state_bits(r.state), _tree_bits(r.reads))


def _graph_layouts(cfg, seed):
    """Three step layouts: partial stream groups with per-slot payloads,
    host reads, a cross-bank COPY drain (one of them a dependent chain) and
    an idle slot."""
    rng = np.random.default_rng(seed)
    R, W = cfg.num_rows, cfg.words
    out = []
    for k in range(3):
        host = tpim.ProgramBuilder(R, W).issue()
        host.write_row(20, np.zeros(W, np.uint32)).shift_k(20, 21, 40 + k)
        host.read_row(21)
        host.ambit_xor(0, 1, 2).read_row(2)
        host = host.build()
        flat = []
        for slot in range(cfg.n_slots):
            kind = slot % 4
            if kind == 0:
                flat.append(tpim.ProgramBuilder(R, W).issue()
                            .shift_k(0, 1, -7 - k).tra(3, 4, 5).build())
            elif kind == 1:
                flat.append(host.with_payloads([rng.integers(
                    0, 2**32, (W,), dtype=np.uint32)]))
            elif kind == 2:
                flat.append(tpim.xor_reduce_program(R, W, [0, 1, 2], 3))
            else:
                flat.append(None)
        nb = cfg.n_banks
        moves = [((b, 0, 1), ((b + 1) % nb, 1, 30)) for b in range(nb)]
        moves += [((0, 1, 30), (1, 0, 31)), ((1, 0, 31), (2, 1, 29))]
        out.append(tpim.gather_rows(cfg, moves, flat))
    return out


def _graph_device(cfg, where, seed=5):
    dev = tpim.make_device(cfg, device=where)
    dev.banks.bits[:, :-2] = torch.from_numpy(np.random.default_rng(
        seed).integers(0, 2**32, (cfg.n_slots, cfg.num_rows - 2, cfg.words),
                       dtype=np.uint32).view(np.int32)).to(where)
    return dev


@pytest.fixture
def fresh_graphs(card):
    tgraphs._entries.clear()
    tgraphs._seen.clear()
    yield
    tgraphs._entries.clear()
    tgraphs._seen.clear()


def _three_calls(setup, call, obs, card):
    """``call(setup(where))`` on the CPU, then three times on the card
    (eager, capture, replay): each card call equals the CPU's; the first
    call's result is unchanged after the others; the warm call grows no
    trace. Returns the warm call's ``cudaGraphLaunch`` and kernel-launch
    calls in the profiler (``setup`` runs outside its window)."""
    want = obs(call(setup("cpu")))
    first = call(setup(card))
    got_first = obs(first)
    assert got_first == want
    assert obs(call(setup(card))) == want
    args = setup(card)
    torch.cuda.synchronize()
    tpim.reset_stats()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        warm = call(args)
        torch.cuda.synchronize()
    assert obs(warm) == want
    assert obs(first) == got_first
    assert tpim_exec.RUNNER_STATS["traces"] == 0
    launches = {e.key: e.count for e in prof.key_averages()}
    kernels = sum(v for k, v in launches.items()
                  if k in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    return launches.get("cudaGraphLaunch", 0), kernels


def _subarray(where, seed):
    st = tpim.make_subarray(32, 64, device=where)
    st.bits[:] = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2**32, (32, 64), dtype=np.uint32).view(np.int32)).to(where)
    return st


@pytest.mark.parametrize("refresh", [False, True])
def test_pim_graph_execute_replays(card, fresh_graphs, refresh):
    b = tpim.ProgramBuilder(32, 64).issue().write_row(
        0, np.arange(64, dtype=np.uint32)).shift_k(0, 1, 300).ambit_xor(
        1, 2, 3).ambit_not(3, 4).tra(5, 6, 7)
    b.read_row(4)
    prog = b.build()
    assert _three_calls(
        lambda where: _subarray(where, 1),
        lambda st: tpim.execute(prog, st, refresh=refresh),
        _exec_obs, card) == (1, 0)


def test_pim_graph_caller_state_is_never_written(card, fresh_graphs):
    prog = tpim.shift_workload_program(20, 32, 64)
    st = _subarray(card, 2)
    before = _state_bits(st)
    outs = [tpim.execute(prog, st) for _ in range(3)]
    assert _state_bits(st) == before
    assert all(_exec_obs(o) == _exec_obs(outs[0]) for o in outs)
    assert outs[1].state.bits.data_ptr() != outs[2].state.bits.data_ptr()


@pytest.mark.parametrize("refresh", [False, True])
def test_pim_graph_pipeline_and_workload_runners(card, fresh_graphs,
                                                 refresh):
    progs = [tpim.shift_workload_program(n, 32, 64) for n in (3, 9)]
    b = tpim.ProgramBuilder(32, 64).issue().write_row(
        4, np.zeros(64, np.uint32)).ambit_xor(4, 5, 6)
    b.read_row(6)
    progs.append(b.build())
    pays = torch.from_numpy(np.random.default_rng(2).integers(
        0, 2**32, (5, 1, 64), dtype=np.uint32).view(np.int32))

    def pipe(args):
        st, xs = args
        return tpim.make_pipeline_runner(progs[2], refresh=refresh)(st,
                                                                    xs[2])

    def workload(args):
        st, xs = args
        return tpim.make_workload_runner(progs, refresh=refresh)(st, xs)

    def setup(where):
        xs = (torch.zeros((2, 0, 64), dtype=torch.int32),
              torch.zeros((3, 0, 64), dtype=torch.int32), pays)
        return _subarray(where, 3), tuple(x.to(where) for x in xs)

    def obs(out):
        st, reads = out
        return _state_bits(st), _tree_bits(reads)

    assert _three_calls(setup, pipe, obs, card) == (1, 0)
    assert _three_calls(setup, workload, obs, card) == (1, 0)


@pytest.mark.parametrize("flags", [{}, {"async_host": True},
                                   {"async_host": True, "refresh": True}],
                         ids=["sync", "async", "async-refresh"])
def test_pim_graph_schedule_replays(card, fresh_graphs, flags):
    cfg = tpim.paper_device(4, subarrays=2, **GRAPH_CFG)
    layouts = _graph_layouts(cfg, 7)

    def call(dev):
        out = []
        for lay in layouts:
            r = tpim.schedule(dev, lay, **flags)
            dev = r.state
            out.append(r)
        return out

    graphs, kernels = _three_calls(
        lambda where: _graph_device(cfg, where), call,
        lambda rs: [_sched_obs(r) for r in rs], card)
    assert (graphs, kernels) == (3, 0)
    assert tsched.SCHED_STATS["dispatches"] == 3


def _long_refresh(frac):
    """The default timing with tRFC = ``frac``·tREFI."""
    t = tpim.DEFAULT_TIMING
    return dataclasses.replace(t, tRFC=frac * t.tREFI)


def _refresh_busy(cfg, seed):
    """Seeded busy times from 0 to 10^12 ns, each count below 2^30."""
    rng = np.random.default_rng(seed)
    busy = (rng.random(20000) * 10.0 ** rng.integers(0, 12, 20000)
            ).astype(np.float32)
    return torch.from_numpy(busy[busy / (cfg.tREFI - cfg.tRFC) < 2.0 ** 30])


@pytest.mark.parametrize("frac", [0.6, 0.78, 0.95])
def test_refresh_count_long_cycles_eager_and_captured(card, frac):
    """``refresh_events`` on the card at a refresh cycle past half its
    interval (once refused there): eagerly, and captured in a CUDA graph
    and replayed on other busy times, equal to the CPU's loop."""
    cfg = _long_refresh(frac)
    a, b = _refresh_busy(cfg, 20), _refresh_busy(cfg, 21)
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    assert torch.equal(tpim.refresh_events(a.to(card), cfg).cpu(),
                       tpim.refresh_events(a, cfg))
    static = a.to(card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tpim.refresh_events(static, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tpim.refresh_events(static, cfg)
    static.copy_(b)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), tpim.refresh_events(b, cfg))


@pytest.mark.parametrize("frac", [1.0, 1.2])
def test_refresh_count_without_fixed_point_refused_on_card(card, frac):
    with pytest.raises(ValueError, match="tRFC < tREFI"):
        tpim.refresh_events(torch.ones(4, device=card), _long_refresh(frac))


@pytest.mark.parametrize("banks", [4, 16])
def test_pim_graph_schedule_long_refresh_cycle(card, fresh_graphs, banks):
    """Refreshed ``schedule()`` steps at tRFC = 0.6·tREFI: eager, captured
    and replayed on the card, each equal to the CPU bit for bit; on 8
    slots and on 32, where the step's energy sum takes XLA's fused lanes
    (``xla_sum(..., fused=True)`` at 15-32 slots), which once copied a
    host scalar inside the capture."""
    cfg = tpim.paper_device(banks, subarrays=2, timing=_long_refresh(0.6),
                            **GRAPH_CFG)
    layouts = _graph_layouts(cfg, 7)

    def call(dev):
        out = []
        for lay in layouts:
            r = tpim.schedule(dev, lay, async_host=True, refresh=True)
            dev = r.state
            out.append(r)
        return out

    assert _three_calls(lambda where: _graph_device(cfg, where), call,
                        lambda rs: [_sched_obs(r) for r in rs], card) \
        == (3, 0)


@pytest.mark.parametrize("flags", [{}, {"async_host": True, "refresh": True}],
                         ids=["sync", "async-refresh"])
def test_pim_graph_schedule_pipeline_replays(card, fresh_graphs, flags):
    cfg = tpim.paper_device(4, subarrays=2, **GRAPH_CFG)
    lay = _graph_layouts(cfg, 8)[0]
    rng = np.random.default_rng(9)
    steps = [[p.with_payloads([rng.integers(0, 2**32, q.shape,
                                            dtype=np.uint32)
                               for q in p.payloads]) if p is not None
              else None for p in lay] for _ in range(4)]

    def setup(where):
        # an async step first: the pipeline starts from its credit
        return tpim.schedule(_graph_device(cfg, where), lay,
                             async_host=True).state

    assert _three_calls(
        setup, lambda dev: tpim.schedule_pipeline(dev, steps, **flags),
        _sched_obs, card) == (1, 0)
    assert tsched.SCHED_STATS["dispatches"] == 1


def _graph_phases(cfg):
    lays = _graph_layouts(cfg, 11)
    return [tpim.Phase.repeat(lays[0], 3, async_host=True),
            tpim.Phase.repeat(lays[1], 2, async_host=False),
            tpim.Phase(steps=(lays[2], lays[2]), async_host=True)]


@pytest.mark.parametrize("order", [None, (0, 2, 1, 0, 2, 1, 0)])
def test_pim_graph_schedule_workload_replays(card, fresh_graphs, order):
    cfg = tpim.paper_device(4, subarrays=2, **GRAPH_CFG)
    phases = _graph_phases(cfg)
    graphs, kernels = _three_calls(
        lambda where: _graph_device(cfg, where),
        lambda dev: tpim.schedule_workload(dev, phases, order=order,
                                           refresh=True),
        _workload_obs, card)
    n = 1 if order is None else len(order)
    assert (graphs, kernels) == (n, 0)
    assert tsched.SCHED_STATS["dispatches"] == n


def test_pim_graph_first_order_call_captures_nothing(card, fresh_graphs):
    """A one-off interleaved workload runs eagerly throughout, even where
    one of its phases' plans already ran once (through ``schedule()``): it
    captures nothing, and equals the CPU. Its second call captures."""
    cfg = tpim.paper_device(4, subarrays=2, **GRAPH_CFG)
    phases = _graph_phases(cfg)
    order = (0, 2, 1, 0, 2, 1, 0)

    def call(where):
        return tpim.schedule_workload(_graph_device(cfg, where), phases,
                                      order=order, refresh=True)

    want = _workload_obs(call("cpu"))
    tpim.schedule(_graph_device(cfg, card), phases[0].steps[0],
                  async_host=True, refresh=True)
    tpim.reset_stats()
    assert _workload_obs(call(card)) == want
    assert not tgraphs._entries
    assert _workload_obs(call(card)) == want
    assert sum(isinstance(e, tgraphs._Graph)
               for e in tgraphs._entries.values()) == 3


def test_pim_graph_two_plans_alternate(card, fresh_graphs):
    cfg = tpim.paper_device(4, subarrays=2, **GRAPH_CFG)
    lays = _graph_layouts(cfg, 12)[:2]

    def run(where):
        dev, out = _graph_device(cfg, where), []
        for k in range(6):
            r = tpim.schedule(dev, lays[k % 2], async_host=True)
            dev = r.state
            out.append(_sched_obs(r))
        return out

    assert run(card) == run("cpu")


def test_pim_graph_chunks_past_the_node_limit(card, fresh_graphs,
                                              monkeypatch):
    cfg = tpim.paper_device(4, subarrays=2, **GRAPH_CFG)
    lay = _graph_layouts(cfg, 13)[1]

    def run(where):
        return tpim.schedule_pipeline(_graph_device(cfg, where), lay,
                                      n_steps=7, async_host=True)

    want = _sched_obs(run("cpu"))
    assert _sched_obs(run(card)) == want          # eager
    monkeypatch.setattr(tgraphs, "_MAX_NODES", 1)
    assert _sched_obs(run(card)) == want          # one-step graph captured
    tpim.reset_stats()
    assert _sched_obs(run(card)) == want
    assert tsched.SCHED_STATS["dispatches"] == 7      # one step per chunk
    assert tpim_exec.RUNNER_STATS["traces"] == 0


def test_pim_graph_capture_failure_raises(card, fresh_graphs, monkeypatch):
    prog = tpim.shift_workload_program(5, 32, 64)
    st = _subarray(card, 4)
    tpim.execute(prog, st)                        # the eager first call
    real = tpim_exec.fold_tables

    def syncing(*args):
        out = real(*args)
        float(out[0].sum())                       # waits on the host
        return out

    monkeypatch.setattr(tpim_exec, "fold_tables", syncing)
    with pytest.raises(RuntimeError):
        tpim.execute(prog, st)
    monkeypatch.undo()
    # the failed capture handed the pool back: the next one captures
    cpu = _subarray("cpu", 4)
    for _ in range(2):
        assert _exec_obs(tpim.execute(prog, st)) == _exec_obs(
            tpim.execute(prog, cpu))
    assert any(isinstance(e, tgraphs._Graph)
               for e in tgraphs._entries.values())


def test_pim_graph_cache_is_bounded_and_freed(card, fresh_graphs,
                                              monkeypatch):
    import gc
    cfg = tpim.paper_device(4, subarrays=2, num_rows=512, words=2048)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    lays = _graph_layouts(cfg, 14)
    dev = tpim.make_device(cfg, device=card)
    for _ in range(3):
        for lay in lays:
            dev = tpim.schedule(dev, lay).state
    held = [e for e in tgraphs._entries.values()
            if isinstance(e, tgraphs._Graph)]
    assert len(held) == 3
    monkeypatch.setattr(tgraphs, "_MAX_BYTES", 2 * held[0].nbytes + 1)
    del held
    for lay in lays:
        dev = tpim.schedule(dev, lay).state
    assert sum(isinstance(e, tgraphs._Graph)
               for e in tgraphs._entries.values()) <= 2
    del dev
    tgraphs._entries.clear()
    tgraphs._seen.clear()
    tsched._workload_fast_cache.clear()
    tsched._payload_cache_clear()
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - base < 0.1e9
