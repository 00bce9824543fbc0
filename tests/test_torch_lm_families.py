"""The port's MoE, MLA and frontend families (deepseek-v2-lite-16b,
qwen3-moe-30b-a3b, llava-next-mistral-7b, musicgen-medium) against the JAX
reference, on the CPU, at the smoke sizes.

Weights are the reference's ``init_params`` pytrees, carried across by
``convert.lm_params_from_numpy``; inputs come from numpy with a seed.

Tolerances:

- modules on identical inputs (``moe_ffn`` in both impls, ``mla_train``,
  ``mla_decode``): float32 within F32_MODULE_REL = 1e-5 of max |y|
  (float32 rounding: the two packages sum products and combines in other
  orders); bf16 within REL = 2e-2 of max |y| (their bf16 products agree
  bit for bit, but XLA's logistic and torch's silu round a third of the
  experts' hidden units an ulp apart, 2^-8 of each, and ``w2`` sums
  them: 6e-3 to 8e-3 of max |y| at these seeds);
- ``sinusoidal_pos_emb``: within 1e-6 + position · 2^-22 (the packages'
  float32 ``exp`` may put a frequency an ulp apart, which moves the angle
  by position · 2^-23 of itself); ``embed_inputs`` bit for bit but for
  that, plus one ulp of the model's dtype where the sum is rounded;
- whole models: logits within REL = 2e-2 of max |logit| in bf16 and
  F32_REL = 1e-4 in float32 (no quantized linears), as the dense family's
  tests (``tests/test_torch_lm_serve.py``) hold them;
- decode against prefill: the reference's own bounds
  (``tests/test_decode_consistency.py``), 1e-4 and deepseek's 3e-2, in
  float32; in bf16 REL (deepseek 3e-2), as the dense family's test does.

A routing flip: the two packages round bf16 ops in other places, so the
router's inputs differ by about an ulp and a top-k choice whose margin
lies inside that rounding can differ. Both packages' router logits are
recorded at every MoE call; a token whose port top-k set differs from the
reference's is a flip. Every flip must have a reference margin (k-th less
(k+1)-th probability) within the case's tolerance of the k-th
probability, and is reported with its request, position, layer and margin;
a request's logits and greedy tokens are held from the first position on
that no flip of that request reaches (attention mixes a request's earlier
positions into its later ones, never another request's).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import decode_step as jax_decode  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models import common as pcommon  # noqa: E402
from repro_torch.models import ffn as pffn  # noqa: E402
from repro_torch.models import (decode_step, init_caches, init_params,  # noqa: E402,E501
                                prefill)
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.serve.engine import DECODE_STATS, greedy_generate  # noqa: E402,E501

REL = 2e-2
F32_REL = 1e-4
F32_MODULE_REL = 1e-5
# tests/test_decode_consistency.py's bounds: deepseek's absorbed MLA decode
# reorders float32 state; every other family 1e-4
DECODE_TOL = {"deepseek-v2-lite-16b": 3e-2}
FAMILIES = ["deepseek-v2-lite-16b", "qwen3-moe-30b-a3b",
            "llava-next-mistral-7b", "musicgen-medium"]
MOE = ["deepseek-v2-lite-16b", "qwen3-moe-30b-a3b"]
CASES = {
    **{a: (a, {}) for a in FAMILIES},
    **{f"{a}-f32": (a, dict(dtype="float32")) for a in FAMILIES},
    "deepseek-v2-lite-16b-pim_w4": ("deepseek-v2-lite-16b",
                                    dict(quant="pim_w4",
                                         quant_mode="shift_add")),
    "llava-next-mistral-7b-pim_w4": ("llava-next-mistral-7b",
                                     dict(quant="pim_w4",
                                          quant_mode="shift_add")),
}
B, PROMPT, STEPS = 2, 24, 4
CPU = "cpu"


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def prompt_inputs(cfg, seed=0, batch=B, length=PROMPT):
    """numpy prompt inputs: tokens (with the patches of a vision model) or
    an audio model's frame embeddings, from a seed."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frame_embeds": rng.normal(
            size=(batch, length, cfg.d_model)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (batch, length)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        out["patch_embeds"] = rng.normal(
            size=(batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def prompt_positions(cfg):
    return PROMPT + (cfg.n_patches if cfg.frontend == "vision_patches"
                     else 0)


class RouterLog:
    """Both packages' router logits at every ``moe_ffn`` call, in call
    order (prefill's layers, then each decode step's)."""

    def __init__(self):
        self.jax, self.port = [], []

    def patch(self, mp):
        jorig, porig = jffn.moe_ffn, pffn.moe_ffn

        def jrec(cfg, p, x):
            logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) \
                @ p["router"]
            jax.debug.callback(lambda lg: self.jax.append(np.asarray(lg)),
                               logits, ordered=True)
            return jorig(cfg, p, x)

        def prec(cfg, p, x):
            self.port.append((x.reshape(-1, x.shape[-1]).to(torch.float32)
                              @ p.router).numpy())
            return porig(cfg, p, x)

        mp.setattr(jffn, "moe_ffn", jrec)
        mp.setattr(pffn, "moe_ffn", prec)


def router_flips(cfg, log: RouterLog, tol):
    """Each flip as (request, position, MoE layer, reference top-k, port
    top-k, reference margin, k-th probability); a call's rows are the
    prefill's (B, positions) or one decode step's B."""
    if cfg.moe is None:
        return []
    K = cfg.moe.top_k
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    S = prompt_positions(cfg)
    assert len(log.jax) == len(log.port) == n_moe * (STEPS + 1)
    flips = []
    for call, (jl, pl) in enumerate(zip(log.jax, log.port)):
        step, layer = divmod(call, n_moe)
        probs = np.asarray(jax.nn.softmax(jnp.asarray(jl), axis=-1))
        ref = np.argsort(-probs, axis=-1, kind="stable")
        got = np.argsort(-pl, axis=-1, kind="stable")[:, :K]
        for row in range(jl.shape[0]):
            if set(ref[row, :K]) == set(got[row]):
                continue
            b, t = divmod(row, S) if step == 0 else (row, S + step - 1)
            pk, pk1 = probs[row, ref[row, K - 1]], probs[row, ref[row, K]]
            flips.append(dict(request=b, position=t, layer=layer,
                              reference=sorted(ref[row, :K].tolist()),
                              port=sorted(got[row].tolist()),
                              margin=float(pk - pk1), p_k=float(pk),
                              bound=float(tol * pk)))
    # a flip moves its token's output, which reaches later layers at that
    # position and after it: a flip downstream of another follows from it
    for f in flips:
        f["follows"] = any(
            g["request"] == f["request"] and g["position"] <= f["position"]
            and g["layer"] < f["layer"] for g in flips)
    return flips


def held(case, step):
    """The requests whose logits at ``step`` (0: the prompt's last
    position) no routing flip reaches."""
    last = case["prompt_positions"] - 1 + step
    hit = {f["request"] for f in case["flips"] if f["position"] <= last}
    return [b for b in range(B) if b not in hit]


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One configuration through both packages: prefill logits, then STEPS
    teacher-forced decode steps on the JAX greedy tokens (an audio model:
    on seeded frames), with both packages' router logits recorded."""
    arch, overrides = CASES[request.param]
    jcfg = jconfigs.get_config(arch, smoke=True, **overrides)
    pcfg = pconfigs.get_config(arch, smoke=True, **overrides)
    params = jax_init(jcfg, jax.random.PRNGKey(1))
    model = lm_params_from_numpy(pcfg, to_numpy(params), device=CPU)
    inputs = prompt_inputs(jcfg)
    S = prompt_positions(jcfg)
    max_len = S + STEPS + 1
    audio = jcfg.frontend == "audio_frames"
    frames = np.random.default_rng(9).normal(
        size=(B, STEPS, jcfg.d_model)).astype(np.float32)
    log = RouterLog()
    with pytest.MonkeyPatch.context() as mp:
        log.patch(mp)
        j_pre = jax.jit(lambda p, b: jax_prefill(jcfg, p, b, max_len))
        j_dec = jax.jit(lambda p, x, pos, c: jax_decode(jcfg, p, x, pos, c))
        lg, jc = j_pre(params, {k: jnp.asarray(v) for k, v in inputs.items()})
        jax_logits = [np.asarray(lg)]
        step_inputs = []
        for t in range(STEPS):
            if audio:
                x = {"frame_embeds": frames[:, t:t + 1]}
            else:
                x = {"tokens": np.argmax(jax_logits[-1].reshape(B, -1),
                                         axis=-1).astype(np.int32)[:, None]}
            step_inputs.append(x)
            lg, jc = j_dec(params, {k: jnp.asarray(v) for k, v in x.items()},
                           jnp.int32(S + t), jc)
            jax_logits.append(np.asarray(lg))
        jax.effects_barrier()

        plg, pc = prefill(pcfg, model, inputs, max_len, device=CPU)
        port_logits = [plg.numpy()]
        for t in range(STEPS):
            plg, pc = decode_step(pcfg, model, step_inputs[t], S + t, pc,
                                  device=CPU)
            port_logits.append(plg.numpy())
    tol = F32_REL if overrides.get("dtype") == "float32" else REL
    out = dict(name=request.param, arch=arch, cfg=pcfg, jcfg=jcfg, tol=tol,
               inputs=inputs, prompt_positions=S, jax_logits=jax_logits,
               port_logits=port_logits, flips=router_flips(jcfg, log, tol),
               model=model, params=params, max_len=max_len)
    if not audio:
        out["jax_tokens"] = np.stack(
            [np.argmax(lg.reshape(B, -1), axis=-1) for lg in jax_logits],
            axis=1)                                    # (B, STEPS + 1)
        out["port_tokens"] = greedy_generate(
            pcfg, model, inputs, max_new_tokens=STEPS + 1,
            max_cache_len=max_len, device=CPU).numpy()
    return out


def say_flips(case):
    return "; ".join(
        f"request {f['request']} position {f['position']} MoE layer "
        f"{f['layer']}: reference top-k {f['reference']}, port {f['port']}, "
        f"reference margin {f['margin']:.3e} (k-th probability "
        f"{f['p_k']:.3e})" + (", after an earlier flip" if f["follows"]
                              else "")
        for f in case["flips"]) or "no routing flip"


def test_routing_flips_lie_inside_the_rounding(case):
    """A flip that follows no earlier one is a top-k choice whose reference
    margin is within the case's tolerance of the k-th probability; the
    report names each flip."""
    print(f"{case['name']}: {say_flips(case)}")
    wide = [f for f in case["flips"]
            if not f["follows"] and not f["margin"] <= f["bound"]]
    assert not wide, f"{case['name']}: flips beyond rounding: {wide}"


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_logits_match(case, step):
    """Prefill (step 0) and each teacher-forced decode step, on the
    requests no routing flip reaches."""
    exp, got = case["jax_logits"][step], case["port_logits"][step]
    assert got.shape == exp.shape
    rows = held(case, step)
    if not rows:
        return
    rel = rel_err(got[rows], exp[rows])
    assert rel < case["tol"], (
        f"{case['name']}: step {step} rel {rel:.3e} (bound {case['tol']}) "
        f"on requests {rows}; {say_flips(case)}")


def test_greedy_tokens_match(case):
    """Equal wherever the JAX top-2 margin exceeds 2 × tolerance, on the
    requests and steps no routing flip reaches; past the first step whose
    margin is within it, the two generations may part. An audio model is
    not served by ``greedy_generate``: there each codebook's argmax of the
    teacher-forced logits is held the same way."""
    audio = case["cfg"].frontend == "audio_frames"
    n_rows = case["cfg"].n_codebooks if audio else 1
    if audio:
        got = np.stack([lg.reshape(B, n_rows, -1).argmax(-1)
                        for lg in case["port_logits"]], axis=1)
        exp = np.stack([lg.reshape(B, n_rows, -1).argmax(-1)
                        for lg in case["jax_logits"]], axis=1)
    else:
        got = case["port_tokens"][..., None]
        exp = case["jax_tokens"][..., None]
        assert case["port_tokens"].dtype == np.int32
    assert got.shape == exp.shape == (B, STEPS + 1, n_rows)
    for b in range(B):
        for c in range(n_rows):
            for t in range(STEPS + 1):
                if b not in held(case, t):
                    break
                lg = np.asarray(case["jax_logits"][t], np.float64).reshape(
                    B, n_rows, -1)
                top2 = np.sort(lg[b, c])[-2:]
                margin = top2[1] - top2[0]
                bound = 2 * case["tol"] * np.max(np.abs(lg))
                if margin <= bound:
                    break
                assert got[b, t, c] == exp[b, t, c], (
                    f"{case['name']}: request {b} token {t} codebook {c}: "
                    f"{got[b, t, c]} != {exp[b, t, c]} with margin "
                    f"{margin:.3e} > {bound:.3e}")


# ---------------------------------------------------------------------------
# Modules on identical inputs
# ---------------------------------------------------------------------------

def module_bound(dtype):
    return F32_MODULE_REL if dtype == "float32" else REL


def first_moe(arch, dtype, **moe):
    """The reference's first MoE layer's FFN params and the port's copy."""
    jcfg = jconfigs.get_config(arch, smoke=True, dtype=dtype)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **moe))
    pcfg = pconfigs.get_config(arch, smoke=True, dtype=dtype)
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe,
                                                             **moe))
    params = to_numpy(jax_init(jcfg, jax.random.PRNGKey(4)))
    model = lm_params_from_numpy(pcfg, params, device=CPU)
    jp = jax.tree.map(lambda a: a[0], params["stack"]["ffn"])
    return jcfg, pcfg, jp, model.layers[0].ffn


def moe_input(cfg, seed, batch=2, seq=32):
    x = np.random.default_rng(seed).normal(
        size=(batch, seq, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x, jcommon.dtype_of(cfg)), \
        torch.from_numpy(x).to(pcommon.dtype_of(cfg))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference(arch, impl, dtype):
    """moe_ffn on identical inputs and weights: y and the aux loss. Two
    chunks of dispatch (64 tokens each)."""
    jcfg, pcfg, jp, pp = first_moe(arch, dtype, impl=impl)
    jx, px = moe_input(jcfg, 11, seq=64)
    jy, jaux = jax.jit(lambda p, x: jffn.moe_ffn(jcfg, p, x))(jp, jx)
    py, paux = pffn.moe_ffn(pcfg, pp, px)
    assert py.dtype == pcommon.dtype_of(pcfg) and py.shape == px.shape
    rel = rel_err(f32(py), f32(jy))
    assert rel < module_bound(dtype), f"rel {rel:.3e}"
    assert abs(float(paux) - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("arch", MOE)
def test_moe_gather_equals_einsum(arch):
    """The forward-only counterpart of tests/test_moe_impls.py's gather
    against einsum, in bf16 as there: the same outputs (within float32
    rounding of the combine, which a bf16 ulp exceeds) and aux."""
    jcfg, pcfg, _, pp = first_moe(arch, "bfloat16")
    _, px = moe_input(jcfg, 3)
    ye, aux_e = pffn.moe_ffn(pcfg, pp, px)
    pcfg_g = dataclasses.replace(pcfg, moe=dataclasses.replace(
        pcfg.moe, impl="gather"))
    yg, aux_g = pffn.moe_ffn(pcfg_g, pp, px)
    assert rel_err(f32(yg), f32(ye)) < F32_MODULE_REL
    assert float(aux_e) == float(aux_g)


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_capacity_drops_are_bounded(impl):
    """A tiny capacity factor drops tokens; the layer and the model still
    run, their outputs finite, and the drops are the reference's."""
    jcfg, pcfg, jp, pp = first_moe("qwen3-moe-30b-a3b", "float32",
                                   impl=impl, capacity_factor=0.25)
    jx, px = moe_input(jcfg, 4, seq=64)
    py, _ = pffn.moe_ffn(pcfg, pp, px)
    jy, _ = jffn.moe_ffn(jcfg, jp, jx)
    assert bool(torch.isfinite(py).all())
    assert rel_err(py.numpy(), f32(jy)) < F32_MODULE_REL
    dropped = np.asarray(jnp.all(jy == 0, axis=-1)).sum()
    assert dropped > 0        # capacity 4 per expert, 16 slots asked
    model = init_params(pcfg, 1, device=CPU)
    tokens = prompt_inputs(pcfg, 4, length=64)
    logits, _ = prefill(pcfg, model, tokens, 64, device=CPU)
    assert bool(torch.isfinite(logits).all())


def test_moe_aux_loss_at_balance():
    """The Switch load-balance term E·Σ f·p is ≥ 1 at perfect balance;
    on random routing it stays ≥ 0.9, as the reference's test asserts."""
    jcfg, pcfg, _, pp = first_moe("qwen3-moe-30b-a3b", "float32")
    _, px = moe_input(jcfg, 5, seq=64)
    _, aux = pffn.moe_ffn(pcfg, pp, px)
    assert float(aux) / pcfg.moe.router_aux_weight >= 0.9


@pytest.mark.parametrize("chunk", [1, 4, 64, 4096])
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_capacity_rounding(arch, smoke, chunk):
    cfg = pconfigs.get_config(arch, smoke=smoke)
    c = pffn._capacity(chunk, cfg)
    assert c == jffn._capacity(chunk, jconfigs.get_config(arch, smoke=smoke))
    assert c % 4 == 0 and c >= chunk * cfg.moe.top_k / cfg.moe.n_experts


def mla_case(dtype):
    jcfg = jconfigs.get_config("deepseek-v2-lite-16b", smoke=True,
                               dtype=dtype)
    pcfg = pconfigs.get_config("deepseek-v2-lite-16b", smoke=True,
                               dtype=dtype)
    params = to_numpy(jax_init(jcfg, jax.random.PRNGKey(6)))
    model = lm_params_from_numpy(pcfg, params, device=CPU)
    jp = jax.tree.map(lambda a: a[0], params["stack"]["attn"])
    return jcfg, pcfg, jp, model.layers[0].attn


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mla_train_matches_reference(dtype):
    """The non-absorbed path: the output and the cache entries (c_kv,
    k_rope)."""
    jcfg, pcfg, jp, pp = mla_case(dtype)
    jx, px = moe_input(jcfg, 7, seq=24)
    pos = np.arange(24, dtype=np.int32)
    jout, (jc, jr) = jax.jit(lambda p, x: jattn.mla_train(
        jcfg, p, x, jnp.asarray(pos)))(jp, jx)
    pout, (pc, pr) = pattn.mla_train(pcfg, pp, px, torch.from_numpy(pos))
    for got, exp in ((pout, jout), (pc, jc), (pr, jr)):
        assert tuple(got.shape) == exp.shape
        rel = rel_err(f32(got), f32(exp))
        assert rel < module_bound(dtype), f"rel {rel:.3e}"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mla_decode_matches_reference(dtype):
    """The absorbed path on one cache given to both: the output and the
    updated cache (the new slot written, the rest unchanged)."""
    jcfg, pcfg, jp, pp = mla_case(dtype)
    m = jcfg.mla
    rng = np.random.default_rng(8)
    Sc, pos = 16, 9
    cache = {"ckv": rng.normal(size=(2, Sc, m.kv_lora_rank)),
             "krope": rng.normal(size=(2, Sc, m.qk_rope_head_dim))}
    kpos = np.full((2, Sc), -1, np.int32)
    kpos[:, :pos] = np.arange(pos)
    jcache = {k: jnp.asarray(v, jcommon.dtype_of(jcfg))
              for k, v in cache.items()}
    jcache["kpos"] = jnp.asarray(kpos)
    pcache = {k: torch.from_numpy(f32(v).copy()).to(
        pcommon.dtype_of(pcfg)) for k, v in jcache.items() if k != "kpos"}
    pcache["kpos"] = torch.from_numpy(kpos.copy())
    jx, px = moe_input(jcfg, 9, seq=1)
    jout, jnew = jax.jit(lambda p, x, c: jattn.mla_decode(
        jcfg, p, x, pos, c))(jp, jx, jcache)
    pout, pnew = pattn.mla_decode(pcfg, pp, px, pos, pcache)
    rel = rel_err(f32(pout), f32(jout))
    assert rel < module_bound(dtype), f"rel {rel:.3e}"
    assert np.array_equal(pnew["kpos"].numpy(), np.asarray(jnew["kpos"]))
    for k in ("ckv", "krope"):
        assert rel_err(f32(pnew[k]), f32(jnew[k])) < module_bound(dtype)


def sinusoid_bound(pos):
    return 1e-6 + np.asarray(pos, np.float64)[..., None] * 2.0 ** -22


def test_sinusoidal_pos_emb_matches_reference():
    pos = np.array([0, 1, 7, 100, 143, 1000, 4095, 32767], np.int32)
    for d in (64, 1536):
        got = pcommon.sinusoidal_pos_emb(torch.from_numpy(pos), d)
        exp = np.asarray(jcommon.sinusoidal_pos_emb(jnp.asarray(pos), d))
        assert got.dtype == torch.float32 and tuple(got.shape) == exp.shape
        assert np.all(np.abs(got.numpy() - exp) <= sinusoid_bound(pos))
        assert np.array_equal(got[0].numpy(), exp[0])


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "musicgen-medium"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embed_inputs_match_reference(arch, dtype):
    """The vision patches as a prefix (n_prefix = n_patches), bit for
    bit, and the audio frames plus sinusoidal positions, within the
    sinusoid's bound and an ulp of the model's dtype."""
    jcfg = jconfigs.get_config(arch, smoke=True, dtype=dtype)
    pcfg = pconfigs.get_config(arch, smoke=True, dtype=dtype)
    params = jax_init(jcfg, jax.random.PRNGKey(2))
    model = lm_params_from_numpy(pcfg, to_numpy(params), device=CPU)
    inputs = prompt_inputs(jcfg, 3, length=12)
    jx, jpos, jn = jtf.embed_inputs(
        jcfg, params, {k: jnp.asarray(v) for k, v in inputs.items()})
    px, ppos, pn = ptf.embed_inputs(pcfg, model, inputs)
    assert pn == jn == (jcfg.n_patches if arch.startswith("llava") else 0)
    assert np.array_equal(ppos.numpy(), np.asarray(jpos))
    assert px.dtype == pcommon.dtype_of(pcfg)
    got, exp = f32(px), f32(jx)
    if arch.startswith("llava"):
        assert np.array_equal(got, exp)
    else:
        ulp = np.abs(exp) * (2.0 ** -8 if dtype == "bfloat16" else 0.0)
        assert np.all(np.abs(got - exp) <= sinusoid_bound(jpos) + ulp)


# ---------------------------------------------------------------------------
# Decode against prefill, configurations, weights and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_prefill(arch, dtype):
    """prefill(S−1) + decode_step(S−1) reproduces prefill(S)'s logits (the
    port's own weights) within the reference's bounds: 1e-4 and
    deepseek's 3e-2 in float32; REL and deepseek's 3e-2 in bf16."""
    cfg = pconfigs.get_config(arch, smoke=True, dtype=dtype)
    model = init_params(cfg, 1, device=CPU)
    S = 32
    inputs = prompt_inputs(cfg, 0, length=S)
    key = "frame_embeds" if cfg.frontend == "audio_frames" else "tokens"
    pre = dict(inputs, **{key: inputs[key][:, :-1]})
    last = {key: inputs[key][:, -1:]}
    total = prompt_positions(cfg) - PROMPT + S
    full, _ = prefill(cfg, model, inputs, total, device=CPU)
    _, caches = prefill(cfg, model, pre, total, device=CPU)
    dec, _ = decode_step(cfg, model, last, total - 1, caches, device=CPU)
    tol = DECODE_TOL.get(arch, F32_REL if dtype == "float32" else REL)
    rel = rel_err(dec.numpy(), full.numpy())
    assert rel < tol, f"rel {rel:.3e} (bound {tol})"


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_from_empty_caches_matches_prefill(arch):
    """init_caches gives each stack empty caches (kpos −1); decoding the
    first input into them reproduces a one-position prefill (float32)."""
    cfg = pconfigs.get_config(arch, smoke=True, dtype="float32")
    if cfg.frontend == "vision_patches":
        cfg = dataclasses.replace(cfg, frontend=None)
    model = init_params(cfg, 3, device=CPU)
    caches = init_caches(cfg, 2, 8, CPU)
    n_head = cfg.moe.first_k_dense if cfg.moe is not None else 0
    assert sorted(caches) == (["dense_head", "stack"] if n_head
                              else ["stack"])
    for name, n in (("dense_head", n_head), ("stack", cfg.n_layers - n_head)):
        for v in caches.get(name, {}).values():
            assert v.shape[:3] == (n, 2, 8)
    inputs = prompt_inputs(cfg, 5, length=1)
    dec, caches = decode_step(cfg, model, inputs, 0, caches, device=CPU)
    assert bool((caches["stack"]["kpos"][:, :, 0] == 0).all())
    assert bool((caches["stack"]["kpos"][:, :, 1:] == -1).all())
    full, _ = prefill(cfg, model, inputs, 8, device=CPU)
    rel = rel_err(dec.numpy(), full.numpy())
    assert rel < F32_REL, f"rel {rel:.3e}"


@pytest.mark.parametrize("arch", FAMILIES)
def test_param_count(arch):
    """The port's model holds the reference's leaves, element for element,
    and the analytic count is within the reference test's 6 %."""
    cfg = pconfigs.get_config(arch, smoke=True)
    model = init_params(cfg, 0, device=CPU)
    port = sum(p.numel() for p in model.parameters())
    ref = sum(x.size for x in jax.tree.leaves(jax_init(
        jconfigs.get_config(arch, smoke=True), jax.random.PRNGKey(2))))
    assert port == ref
    assert abs(port - cfg.n_params()) / port < 0.06


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "llava-next-mistral-7b"])
def test_conversion_keeps_codes_and_scales_exactly(arch):
    """pim_w4: the quantized dense head layer's FFN and every shared
    expert (deepseek), every FFN (llava), codes int8 and scales float32
    bit for bit; the router float32 and the experts in the model's dtype."""
    jcfg = jconfigs.get_config(arch, smoke=True, quant="pim_w4")
    params = to_numpy(jax_init(jcfg, jax.random.PRNGKey(2)))
    model = lm_params_from_numpy(pconfigs.get_config(
        arch, smoke=True, quant="pim_w4"), params, device=CPU)
    pairs = []
    if "dense_head_layers" in params:
        for i, layer in enumerate(model.dense_head_layers):
            pairs.append((layer.ffn, params["dense_head_layers"]["ffn"], i))
        for i, layer in enumerate(model.layers):
            pairs.append((layer.ffn.shared, params["stack"]["ffn"]["shared"],
                          i))
            assert layer.ffn.router.dtype == torch.float32
            assert np.array_equal(layer.ffn.router.numpy(),
                                  params["stack"]["ffn"]["router"][i])
            assert layer.ffn.w1.dtype == torch.bfloat16
    else:
        pairs = [(layer.ffn, params["stack"]["ffn"], i)
                 for i, layer in enumerate(model.layers)]
    for dense, ref, i in pairs:
        for name in ("w1", "w2", "w3"):
            lin = getattr(dense, name)
            assert lin.w_int.dtype == torch.int8
            assert np.array_equal(lin.w_int.numpy(), ref[name]["w_int"][i])
            assert np.array_equal(lin.scales.numpy().view(np.int32),
                                  ref[name]["scales"][i].view(np.int32))


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_needs_cuda_unless_asked_for_cpu(arch, monkeypatch):
    """Each family builds on the CPU when asked, with the reference's
    stacks; without a card, the default device raises."""
    cfg = pconfigs.get_config(arch, smoke=True)
    model = init_params(cfg, 0, device=CPU)
    assert model.device.type == "cpu"
    n_head = cfg.moe.first_k_dense if cfg.moe is not None else 0
    assert len(model.dense_head_layers) == n_head
    assert len(model.layers) == cfg.n_layers - n_head
    kinds = {type(layer.ffn).__name__ for layer in model.layers}
    assert kinds == {"MoEFFN" if cfg.moe is not None else "DenseFFN"}
    assert {type(layer.attn).__name__ for layer in model.layers} \
        == {"MLA" if cfg.mla is not None else "GQA"}
    if cfg.frontend == "audio_frames":
        assert tuple(model.heads.shape) == (cfg.n_codebooks, cfg.d_model,
                                            cfg.vocab_size)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, 0)


def test_audio_generate_raises_where_the_reference_does():
    """musicgen: zero tokens is the empty result in both packages; at one
    and two tokens the reference's decode loop feeds tokens to a model
    that takes frame_embeds (KeyError), and the port raises before any
    work."""
    jcfg = jconfigs.get_config("musicgen-medium", smoke=True)
    pcfg = pconfigs.get_config("musicgen-medium", smoke=True)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(pcfg, to_numpy(params), device=CPU)
    inputs = prompt_inputs(jcfg, 1, length=8)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    assert jengine.greedy_generate(jcfg, params, jin,
                                   max_new_tokens=0).shape == (B, 0)
    out = greedy_generate(pcfg, model, inputs, max_new_tokens=0, device=CPU)
    assert out.shape == (B, 0) and out.dtype == torch.int32
    for n in (1, 2):
        with pytest.raises(KeyError, match="frame_embeds"):
            jengine.greedy_generate(jcfg, params, jin, max_new_tokens=n)
        DECODE_STATS["dispatches"] = 0
        with pytest.raises(ValueError, match="frame_embeds"):
            greedy_generate(pcfg, model, inputs, max_new_tokens=n,
                            device=CPU)
        assert DECODE_STATS["dispatches"] == 0


def test_vision_generate_counts_the_patches():
    """A vision-patch prompt takes n_patches + tokens positions: the
    default cache holds them and the generated tokens, and the tokens are
    the eager argmax chain of prefill and decode steps at those
    positions."""
    cfg = pconfigs.get_config("llava-next-mistral-7b", smoke=True,
                              dtype="float32")
    model = init_params(cfg, 2, device=CPU)
    inputs = prompt_inputs(cfg, 6, length=5)
    out = greedy_generate(cfg, model, inputs, max_new_tokens=4, device=CPU)
    S = cfg.n_patches + 5
    lg, caches = prefill(cfg, model, inputs, S + 4, device=CPU)
    chain = [lg.argmax(-1)]
    for t in range(3):
        lg, caches = decode_step(cfg, model, {"tokens": chain[-1]}, S + t,
                                 caches, device=CPU)
        chain.append(lg.argmax(-1))
    assert torch.equal(out, torch.cat(chain, dim=1).to(torch.int32))
    assert caches["stack"]["k"].shape[2] == min(S + 4, cfg.sliding_window)
