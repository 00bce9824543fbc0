"""The port's dense LM serving path (prefill → decode_step →
greedy_generate) against the JAX reference, on the CPU.

Weights are the reference's ``init_params`` pytree, carried across by
``convert.lm_params_from_numpy``; prompts come from numpy with a seed. On
the CPU the port runs its kernels' plain versions.

Tolerance: the logits of the bf16 model agree within REL = 2e-2 of
max |logit|. The two packages round bf16 matmuls and elementwise ops in
different places (about one bf16 ulp per op); in float32 the same
comparison holds to F32_REL = 1e-4, which checks the semantics without that
rounding. (A quantized linear casts its input to bf16 in both packages, so
the float32 cases have no quantized linears.) Greedy tokens must be equal
wherever the reference's top-2 margin exceeds twice the tolerance. The JAX tokens are the argmax of the JAX
logits, which is what the reference's ``greedy_generate`` samples.
"""
import dataclasses
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import decode_step as jax_decode  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import (decode_step, init_caches, init_params,  # noqa: E402,E501
                                prefill)
from repro_torch.serve import engine  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fa  # noqa: E402
from repro_torch.kernels.pim_matmul import ops as pm  # noqa: E402
from repro_torch.serve.engine import DECODE_STATS, greedy_generate  # noqa: E402,E501

REL = 2e-2
F32_REL = 1e-4
DENSE = ["qwen3-4b", "yi-34b", "qwen2.5-32b", "starcoder2-7b"]
CASES = {
    "qwen3-4b": ("qwen3-4b", {}),
    "yi-34b": ("yi-34b", {}),
    "qwen2.5-32b": ("qwen2.5-32b", {}),
    "starcoder2-7b": ("starcoder2-7b", {}),        # prompt > window: ring
    "qwen3-4b-pim_w4-shift_add": ("qwen3-4b", dict(quant="pim_w4",
                                                   quant_mode="shift_add")),
    "qwen3-4b-pim_w4-dequant": ("qwen3-4b", dict(quant="pim_w4",
                                                 quant_mode="dequant")),
    "qwen3-4b-pim_w8-shift_add": ("qwen3-4b", dict(quant="pim_w8",
                                                   quant_mode="shift_add")),
    "qwen3-4b-pim_w8-dequant": ("qwen3-4b", dict(quant="pim_w8",
                                                 quant_mode="dequant")),
    # LayerNorm, the GELU MLP and its biases under pim_linear; the ring
    "starcoder2-7b-pim_w4-shift_add": ("starcoder2-7b", dict(
        quant="pim_w4", quant_mode="shift_add")),
    # odd query groups: G = 7, 5 (with the QKV bias) and 9 (with the ring)
    "yi-34b-g7": ("yi-34b", dict(n_heads=14, n_kv_heads=2)),
    "qwen2.5-32b-g5": ("qwen2.5-32b", dict(n_heads=10, n_kv_heads=2)),
    "starcoder2-7b-g9": ("starcoder2-7b", dict(n_heads=18, n_kv_heads=2)),
    "qwen3-4b-f32": ("qwen3-4b", dict(dtype="float32")),
    "starcoder2-7b-f32": ("starcoder2-7b", dict(dtype="float32")),
}
B, PROMPT, STEPS = 2, 24, 4
CPU = "cpu"


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One configuration run through both packages: prefill logits, then
    STEPS teacher-forced decode steps on the JAX greedy tokens."""
    arch, overrides = CASES[request.param]
    jcfg = jconfigs.get_config(arch, smoke=True, **overrides)
    pcfg = pconfigs.get_config(arch, smoke=True, **overrides)
    params = jax_init(jcfg, jax.random.PRNGKey(1))
    model = lm_params_from_numpy(pcfg, to_numpy(params), device=CPU)
    prompt = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    max_len = PROMPT + STEPS + 1

    j_pre = jax.jit(lambda p, t: jax_prefill(jcfg, p, {"tokens": t},
                                             max_len))
    j_dec = jax.jit(lambda p, t, pos, c: jax_decode(jcfg, p, {"tokens": t},
                                                    pos, c))
    lg, jc = j_pre(params, jnp.asarray(prompt))
    jax_logits = [np.asarray(lg)]
    for t in range(STEPS):
        tok = jnp.argmax(lg.reshape(B, -1), axis=-1).astype(jnp.int32)
        lg, jc = j_dec(params, tok[:, None], jnp.int32(PROMPT + t), jc)
        jax_logits.append(np.asarray(lg))
    jax_tokens = np.stack([np.argmax(lg.reshape(B, -1), axis=-1)
                           for lg in jax_logits], axis=1)   # (B, STEPS+1)

    plg, pc = prefill(pcfg, model, {"tokens": prompt}, max_len, device=CPU)
    port_logits = [plg.numpy()]
    for t in range(STEPS):
        plg, pc = decode_step(pcfg, model,
                              {"tokens": jax_tokens[:, t:t + 1]},
                              PROMPT + t, pc, device=CPU)
        port_logits.append(plg.numpy())
    port_tokens = greedy_generate(pcfg, model, {"tokens": prompt},
                                  max_new_tokens=STEPS + 1,
                                  max_cache_len=max_len, device=CPU).numpy()
    tol = F32_REL if overrides.get("dtype") == "float32" else REL
    return dict(name=request.param, cfg=pcfg, tol=tol, jax_logits=jax_logits,
                port_logits=port_logits, jax_tokens=jax_tokens,
                port_tokens=port_tokens)


def test_prefill_logits_match(case):
    exp, got = case["jax_logits"][0], case["port_logits"][0]
    assert got.shape == exp.shape
    rel = rel_err(got, exp)
    assert rel < case["tol"], (f"{case['name']}: prefill rel {rel:.3e} "
                               f"(bound {case['tol']})")


def test_decode_logits_match(case):
    for t in range(1, STEPS + 1):
        exp, got = case["jax_logits"][t], case["port_logits"][t]
        rel = rel_err(got, exp)
        assert rel < case["tol"], (f"{case['name']}: decode step {t} rel "
                                   f"{rel:.3e} (bound {case['tol']})")


def test_greedy_tokens_match(case):
    """Equal wherever the JAX top-2 margin exceeds 2 × tolerance; past the
    first step whose margin is within it, the two generations may part."""
    got, exp = case["port_tokens"], case["jax_tokens"]
    assert got.shape == exp.shape and got.dtype == np.int32
    for b in range(B):
        for t in range(STEPS + 1):
            lg = np.asarray(case["jax_logits"][t], np.float64).reshape(B, -1)
            top2 = np.sort(lg[b])[-2:]
            margin = top2[1] - top2[0]
            bound = 2 * case["tol"] * np.max(np.abs(lg))
            if margin <= bound:
                break
            assert got[b, t] == exp[b, t], (
                f"{case['name']}: request {b} token {t}: {got[b, t]} != "
                f"{exp[b, t]} with margin {margin:.3e} > {bound:.3e}")


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.5])
def test_gumbel_sampler_matches_numpy(case, temperature):
    """The port's sampler on the JAX package's logits, fed a fixed u, is
    argmax(logits / T − log(−log u)) computed in numpy (argmax for T = 0):
    what the reference's ``jax.random.categorical`` computes."""
    cfg, V = case["cfg"], case["cfg"].vocab_size
    rng = np.random.default_rng(5)
    for lg in case["jax_logits"]:
        lg = np.array(lg, np.float32)
        u = rng.random((B, V), dtype=np.float32)
        exp = lg.reshape(B, -1)[:, :V]
        t = None
        if temperature:
            exp = exp / np.float32(temperature) - np.log(-np.log(u))
            t = torch.tensor(temperature, dtype=torch.float32)
        got = engine._sample(cfg, torch.from_numpy(lg), t,
                             torch.from_numpy(u))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.argmax(exp, axis=-1))


# ---------------------------------------------------------------------------
# Configurations and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_are_the_reference(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(pconfigs.get_config(arch, smoke=smoke)) \
            == dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_every_config_builds(arch):
    """Every configuration builds at the smoke size on the CPU, from a seed
    (``init_params``) and from the reference's weights
    (``lm_params_from_numpy``), with the same parameters: names, shapes
    and dtypes."""
    cfg = pconfigs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    ours = init_params(cfg, 0, device=CPU)
    params = to_numpy(jax.jit(lambda k: jax_init(jcfg, k))(
        jax.random.PRNGKey(0)))
    theirs = lm_params_from_numpy(cfg, params, device=CPU)

    def shapes(model):
        return {k: (tuple(v.shape), v.dtype) for k, v in
                list(model.named_parameters()) + list(model.named_buffers())}

    assert shapes(ours) == shapes(theirs)
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert sum(v.numel() for v in theirs.parameters()) + sum(
        b.numel() for n, b in theirs.named_buffers()
        if not n.endswith("_f32")) == n_ref


def test_conversion_keeps_codes_and_scales_exactly():
    cfg = jconfigs.get_config("qwen3-4b", smoke=True, quant="pim_w4")
    params = to_numpy(jax_init(cfg, jax.random.PRNGKey(2)))
    model = lm_params_from_numpy(pconfigs.get_config(
        "qwen3-4b", smoke=True, quant="pim_w4"), params, device=CPU)
    for i, layer in enumerate(model.layers):
        for name in ("w1", "w2", "w3"):
            lin = getattr(layer.ffn, name)
            ref = params["stack"]["ffn"][name]
            assert lin.w_int.dtype == torch.int8
            assert np.array_equal(lin.w_int.numpy(), ref["w_int"][i])
            assert np.array_equal(lin.scales.numpy().view(np.int32),
                                  ref["scales"][i].view(np.int32))
        wq = np.asarray(params["stack"]["attn"]["wq"][i], np.float32)
        assert np.array_equal(layer.attn.wq.float().numpy(), wq)
    assert np.array_equal(model.embed.float().numpy(),
                          np.asarray(params["embed"], np.float32))


# ---------------------------------------------------------------------------
# Decode against prefill, and the ring cache (the port's own weights)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_prefill(arch, dtype):
    """prefill(S−1 tokens) + decode_step(token S−1) reproduces the logits
    of prefill(S tokens): within 1e-4 in float32 (the reference's bound),
    and within REL in bf16, where the two paths' matmuls round at other
    rows and shapes."""
    cfg = pconfigs.get_config(arch, smoke=True, dtype=dtype)
    model = init_params(cfg, 1, device=CPU)
    S = 32
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, S))
    full, _ = prefill(cfg, model, {"tokens": tokens}, S, device=CPU)
    _, caches = prefill(cfg, model, {"tokens": tokens[:, :-1]}, S,
                        device=CPU)
    dec, _ = decode_step(cfg, model, {"tokens": tokens[:, -1:]}, S - 1,
                         caches, device=CPU)
    tol = F32_REL if dtype == "float32" else REL
    rel = rel_err(dec.numpy(), full.numpy())
    assert rel < tol, f"rel {rel:.3e} (bound {tol})"


def test_decode_from_empty_caches_matches_prefill():
    """init_caches gives every layer an empty cache (kpos −1); decoding the
    first token into it reproduces a one-token prefill (float32, the
    reference's bound)."""
    cfg = pconfigs.get_config("qwen2.5-32b", smoke=True, dtype="float32")
    model = init_params(cfg, 3, device=CPU)
    caches = init_caches(cfg, 2, 8, CPU)
    stack = caches["stack"]
    assert stack["k"].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads,
                                cfg.head_dim)
    assert bool((stack["kpos"] == -1).all())
    tokens = np.array([[5], [7]], np.int32)
    dec, caches = decode_step(cfg, model, {"tokens": tokens}, 0, caches,
                              device=CPU)
    assert bool((caches["stack"]["kpos"][:, :, 0] == 0).all())
    assert bool((caches["stack"]["kpos"][:, :, 1:] == -1).all())
    full, _ = prefill(cfg, model, {"tokens": tokens}, 8, device=CPU)
    rel = rel_err(dec.numpy(), full.numpy())
    assert rel < F32_REL, f"rel {rel:.3e} (bound {F32_REL})"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sliding_window_ring_cache_wraps(dtype):
    """Decode far past the window: ring slots must overwrite correctly
    (the reference's bound for attention archs, 3e-2, in bf16)."""
    cfg = pconfigs.get_config("starcoder2-7b", smoke=True, dtype=dtype)
    model = init_params(cfg, 2, device=CPU)
    W = cfg.sliding_window
    total = W * 2 + 5
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (2, total))
    full, _ = prefill(cfg, model, {"tokens": tokens}, total, device=CPU)
    _, caches = prefill(cfg, model, {"tokens": tokens[:, :W]}, total,
                        device=CPU)
    assert caches["stack"]["k"].shape[2] == W
    logits = None
    for t in range(W, total):
        logits, caches = decode_step(cfg, model,
                                     {"tokens": tokens[:, t:t + 1]}, t,
                                     caches, device=CPU)
    tol = F32_REL if dtype == "float32" else 3e-2
    rel = rel_err(logits.numpy(), full.numpy())
    assert rel < tol, f"rel {rel:.3e} (bound {tol})"


# ---------------------------------------------------------------------------
# Serving engine behaviours (the reference's tests/test_serve_engine.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    cfg = pconfigs.get_config("qwen3-4b", smoke=True)
    return cfg, init_params(cfg, 0, device=CPU)


def prompts(cfg, batch, seq):
    return {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)}


def test_temperature_sampling_differs_but_valid(served):
    cfg, model = served
    p = prompts(cfg, 2, 16)
    greedy = greedy_generate(cfg, model, p, max_new_tokens=12, device=CPU)
    hot = greedy_generate(cfg, model, p, max_new_tokens=12, temperature=1.5,
                          generator=torch.Generator().manual_seed(7),
                          device=CPU)
    assert hot.shape == greedy.shape and hot.dtype == torch.int32
    assert int(hot.max()) < cfg.vocab_size and int(hot.min()) >= 0
    assert not torch.equal(greedy, hot)


def test_temperature_sampling_repeats_for_a_seed(served):
    """Temperature tokens are valid, differ from greedy, and are the same
    for two generators with the same seed (u is drawn from the caller's
    generator, all steps at once)."""
    cfg, model = served
    p = prompts(cfg, 2, 16)
    greedy = greedy_generate(cfg, model, p, max_new_tokens=10, device=CPU)
    runs = [greedy_generate(cfg, model, p, max_new_tokens=10,
                            temperature=0.9,
                            generator=torch.Generator().manual_seed(11),
                            device=CPU) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab_size
    assert not torch.equal(runs[0], greedy)


def test_decode_loop_is_single_dispatch(served):
    """The reference's single dispatch per call: on the card one CUDA-graph
    replay (tests/test_torch_cuda.py); on the CPU the loop is eager and
    DECODE_STATS counts its decode_step calls, max_new_tokens − 1. Greedy
    decode is deterministic."""
    cfg, model = served
    p = prompts(cfg, 2, 16)
    out1 = greedy_generate(cfg, model, p, max_new_tokens=8, device=CPU)
    DECODE_STATS["dispatches"] = 0
    out2 = greedy_generate(cfg, model, p, max_new_tokens=8, device=CPU)
    assert DECODE_STATS["dispatches"] == 7
    assert out1.shape == (2, 8)
    assert torch.equal(out1, out2)
    DECODE_STATS["dispatches"] = 0
    greedy_generate(cfg, model, p, max_new_tokens=1, device=CPU)
    assert DECODE_STATS["dispatches"] == 0


@pytest.mark.parametrize("ops,name", [(pm, "pim_matmul"),
                                      (fa, "flash_attn")])
def test_captured_launches_count_at_replay(ops, name, monkeypatch):
    """While a CUDA graph is captured a wrapper's launch runs nothing: it
    counts in CAPTURED, not in LAUNCHES or ROUTES, and each replay adds
    what the graph captured."""
    which = next(iter(ops.ROUTES))
    ops.reset_launches()
    captured = dict(ops.CAPTURED)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    ops._count(which)
    ops._count(which)
    assert ops.LAUNCHES[name] == 0 and sum(ops.ROUTES.values()) == 0
    assert ops.CAPTURED[which] == captured[which] + 2
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    ops._count(which)
    routes = {k: v - captured[k] for k, v in ops.CAPTURED.items()}
    for _ in range(3):
        ops.count_replay(routes)
    assert ops.LAUNCHES[name] == 7 and ops.ROUTES[which] == 7
    ops.reset_launches()


def test_pim_matmul_counts_launches_by_shape(monkeypatch):
    """pim_matmul also counts each launch by (route, K, N): a launch at once
    in SHAPES, a captured one in CAPTURED_SHAPES, which each replay adds."""
    pm.reset_launches()
    captured = dict(pm.CAPTURED_SHAPES)
    pm._count("swap_ab", (64, 192))
    assert pm.SHAPES == {("swap_ab", 64, 192): 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    pm._count("tensor_core", (192, 64))
    pm._count("tensor_core", (192, 64))
    pm._count("tensor_core", (64, 192))
    assert pm.SHAPES == {("swap_ab", 64, 192): 1}
    shapes = {k: v - captured.get(k, 0)
              for k, v in pm.CAPTURED_SHAPES.items()
              if v != captured.get(k, 0)}
    assert shapes == {("tensor_core", 192, 64): 2,
                      ("tensor_core", 64, 192): 1}
    for _ in range(2):
        pm.count_replay({"tensor_core": 3}, shapes)
    assert pm.SHAPES == {("swap_ab", 64, 192): 1,
                         ("tensor_core", 192, 64): 4,
                         ("tensor_core", 64, 192): 2}
    assert pm.ROUTES["tensor_core"] == 6
    pm.reset_launches()
    assert pm.SHAPES == {}


def test_pim_matmul_counts_launches_by_kind(monkeypatch):
    """pim_matmul also counts each launch by the (mode, bits) its kernel
    was given: a launch at once in KINDS, a captured one in CAPTURED_KINDS,
    which each replay adds; reset_launches clears KINDS."""
    pm.reset_launches()
    captured = dict(pm.CAPTURED_KINDS)
    pm._count("swap_ab", (64, 192), ("dequant", 8))
    assert pm.KINDS == {("dequant", 8): 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    pm._count("tensor_core", (192, 64), ("shift_add", 8))
    pm._count("tensor_core", (64, 192), ("shift_add", 8))
    assert pm.KINDS == {("dequant", 8): 1}
    kinds = {k: v - captured.get(k, 0)
             for k, v in pm.CAPTURED_KINDS.items()
             if v != captured.get(k, 0)}
    assert kinds == {("shift_add", 8): 2}
    for _ in range(3):
        pm.count_replay({"tensor_core": 2}, None, kinds)
    assert pm.KINDS == {("dequant", 8): 1, ("shift_add", 8): 6}
    pm.reset_launches()
    assert pm.KINDS == {}


@pytest.mark.parametrize("overrides", [
    dict(quant="pim_w8", quant_mode="dequant"),
    dict(quant="pim_w4", quant_mode="shift_add")])
def test_pim_matmul_kernel_gets_the_config_kind(monkeypatch, overrides):
    """What reaches the kernel is the config's mode and bits: the model's
    quantized linears, taken to the launch on the CPU with the launch
    watched, give one launch per linear, each of the config's (mode,
    bits)."""
    cfg = pconfigs.get_config("starcoder2-7b", smoke=True, **overrides)
    model = init_params(cfg, 0, device=CPU)
    seen = []
    monkeypatch.setattr(pm, "_on_card", lambda x: True)
    monkeypatch.setattr(pm, "_launch", lambda x, w, s, out, mode, bits,
                        which, splits=None: seen.append((mode, bits))
                        or out.zero_())
    prefill(cfg, model, prompts(cfg, 1, 8), 8, device=CPU)
    assert seen == [(cfg.quant_mode, cfg.quant_bits)] * (2 * cfg.n_layers)


def test_moving_the_model_drops_its_graphs(served):
    """The graphs hold the weights' addresses: to() and casts drop them."""
    cfg, _ = served
    model = init_params(cfg, 0, device=CPU)
    assert len(model.generate_graphs) == 0
    model.generate_graphs["signature"] = object()
    model.to(CPU)
    assert len(model.generate_graphs) == 0


def test_batch_requests_independent(served):
    """Request i's output must not depend on what else is in the batch."""
    cfg, model = served
    p = prompts(cfg, 3, 16)
    full = greedy_generate(cfg, model, p, max_new_tokens=6, device=CPU)
    solo = greedy_generate(cfg, model, {"tokens": p["tokens"][1:2]},
                           max_new_tokens=6, device=CPU)
    assert torch.equal(full[1:2], solo)


def test_generate_respects_cache_budget(served):
    cfg, model = served
    out = greedy_generate(cfg, model, prompts(cfg, 1, 8), max_new_tokens=4,
                          max_cache_len=16, device=CPU)
    assert out.shape == (1, 4)


def test_zero_new_tokens_returns_empty(served, monkeypatch):
    """max_new_tokens=0 is an empty (B, 0) int32 result, with no prefill or
    decode run and no dispatch counted."""
    cfg, model = served

    def refuse(*args, **kwargs):
        raise AssertionError("no prefill or decode for zero tokens")

    monkeypatch.setattr(engine, "prefill", refuse)
    monkeypatch.setattr(engine, "decode_step", refuse)
    DECODE_STATS["dispatches"] = 0
    out = greedy_generate(cfg, model, prompts(cfg, 3, 8), max_new_tokens=0,
                          device=CPU)
    assert out.shape == (3, 0) and out.dtype == torch.int32
    assert DECODE_STATS["dispatches"] == 0


def test_one_new_token_edge(served):
    """A single token comes from prefill sampling alone and must match the
    first column of a longer generation."""
    cfg, model = served
    p = prompts(cfg, 2, 8)
    one = greedy_generate(cfg, model, p, max_new_tokens=1, device=CPU)
    assert one.shape == (2, 1)
    more = greedy_generate(cfg, model, p, max_new_tokens=4, device=CPU)
    assert torch.equal(one, more[:, :1])


def test_negative_new_tokens_rejected(served):
    cfg, model = served
    with pytest.raises(ValueError, match="max_new_tokens"):
        greedy_generate(cfg, model, prompts(cfg, 1, 8), max_new_tokens=-1,
                        device=CPU)


def test_serve_cli_runs_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        serve_cli.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "4", "--max-new",
                        "3"])
    lines = out.getvalue().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["req0", "req1"]
