"""The port's LM kernels on the card against their plain versions, at ragged
shapes and options that ``chip_smoke.py``'s full-width run does not reach,
and the smoke-size serving path on the card against the CPU.

Needs a CUDA card and ``nvcc`` (the kernels build at first use); every test
here skips elsewhere. It imports nothing of JAX, so on the card machine it
runs without the repository's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: pim_matmul, 1e-4 of max |y| (kernel and plain version compute
the same float32 function, summing in another order); flash, abs 2e-5 in
float32 and 0.05 for bf16 (the reference tests' bounds); logits, 2e-2 of
max |logit| (the bound the CPU tests hold the bf16 model to).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attn import ref as fref  # noqa: E402
from repro_torch.kernels.pim_matmul import ops as pm  # noqa: E402
from repro_torch.kernels.pim_matmul import ref as pref  # noqa: E402
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402,E501
from repro_torch.serve.engine import greedy_generate  # noqa: E402

pytestmark = pytest.mark.cuda

PIM_REL = 1e-4
FLASH_ABS = {torch.float32: 2e-5, torch.bfloat16: 0.05}
LOGITS_REL = 2e-2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs on the card machine")
    return torch.device("cuda")


def rel_err(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / (b.abs().max() + 1e-9))


# (M, K, N): every tile the kernel picks (M <= 4, <= 8, 32-row for 8-bit
# shift_add, 64-row), with and without the K split, ragged everywhere
PIM_SHAPES = [(1, 33, 300), (5, 96, 40), (8, 200, 257), (9, 64, 64),
              (37, 130, 70), (130, 520, 96), (3, 4096, 17)]


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
    got = pm.pim_matmul(x, w_int, scales, mode=mode, bits=bits)
    exp = pref.ref_pim_matmul_raw(x, w_int, mode=mode, bits=bits) \
        * scales[None, :]
    rel = rel_err(got, exp)
    assert rel <= PIM_REL, f"rel {rel:.3e} (bound {PIM_REL})"


def test_pim_matmul_codes_beyond_the_bits(card):
    """int8 codes outside the 4-bit range: shift_add reads their low 4 bits
    as two's complement, dequant the code itself — as the Pallas kernel."""
    rng = np.random.default_rng(3)
    w_int = torch.as_tensor(rng.integers(-128, 128, (70, 33)),
                            dtype=torch.int8, device=card)
    x = torch.as_tensor(rng.normal(size=(6, 70)), dtype=torch.float32,
                        device=card)
    scales = torch.ones(33, device=card)
    for mode in ("shift_add", "dequant"):
        got = pm.pim_matmul(x, w_int, scales, mode=mode, bits=4)
        exp = pref.ref_pim_matmul_raw(x, w_int, mode=mode, bits=4)
        assert rel_err(got, exp) <= PIM_REL, mode


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
    assert err < FLASH_ABS[dtype], f"max abs err {err}"


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
    with pytest.raises(ValueError, match="contiguous"):
        pm.pim_matmul(torch.zeros((8, 4), dtype=torch.bfloat16,
                                  device=card).T, w,
                      torch.ones(3, device=card))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(torch.zeros((1, 2, 1, 2, 24), device=card),
                           torch.zeros((1, 3, 1, 24), device=card),
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
