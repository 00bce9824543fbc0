"""The port's recurrent families, falcon-mamba-7b (SSM) and
recurrentgemma-2b (the RG-LRU hybrid), against the JAX reference on the
CPU at the smoke sizes.

Weights are the reference's ``init_params`` pytrees, carried across by
``convert.lm_params_from_numpy``; inputs come from numpy with a seed.

Tolerances:

- modules on identical inputs (``mamba_train``, ``rglru_train`` below one
  scan chunk, at one and across chunks with padding, S = 37 at
  ``scan_chunk`` 16; ``mamba_decode``, ``rglru_decode``): float32 within
  F32_MODULE_REL = 1e-5 of max |y| (and of max |h| for the state; the
  port's scan adds in sequence order, the reference's in its associative
  scan's tree order), bf16 within REL = 2e-2 (the packages round bf16
  products and elementwise ops in other places); the conv state, which
  is a slice of the in-projection, within the same bounds;
- whole models: logits within REL = 2e-2 of max |logit| in bf16 and
  F32_REL = 1e-4 in float32 (no quantized linears), as the other
  families' tests hold them; recurrentgemma in bf16 within REC_BF16_REL
  (below);
- decode against prefill: the reference's own bound for both families,
  DECODE_REL = 3e-2 (``tests/test_decode_consistency.py``), in bf16; in
  float32 F32_REL;
- the ring wrap (recurrentgemma decoding 2W + 5 steps past a W-token
  prefill): the reference's RING_REL = 8e-2 against prefill, and the
  port's logits at every step against the reference's within F32_REL in
  float32 and REC_RING_REL in bf16.

recurrentgemma's bf16 bounds. At the smoke size its logits are small (max
|logit| about 0.43) and a one-ulp difference anywhere in the stack grows
through its gated recurrences, norms and GeGLUs to a few 1e-2 of max
|logit|. The reference itself shows it: rounding its GeGLU's ``gelu``
once instead of after each bf16 op moves its own logits by 2.10e-2 over
prefill and 4 steps and by 3.36e-2 over the ring run
(``test_reference_moves_with_its_gelu_rounding``). So REL cannot be held
by any implementation that does not reproduce XLA's op-by-op rounding and
its float32 transcendentals. The port's readings at SEED are 2.46e-2
(bf16) and 2.33e-2 (pim_w4) over prefill and 4 steps, and 3.82e-2 over
the ring run; the bounds are fixed above them, REC_BF16_REL = 3e-2 and
REC_RING_REL = 5e-2. Where the bf16 and float32 islands are placed, which
a noise-sized bound cannot see, ``test_dtype_placement_matches_reference``
holds exactly: every product's operand dtypes in the reference's order.
The float32 cases hold the same models to F32_REL.
"""
import functools
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import decode_step as jax_decode  # noqa: E402
from repro.models import init_caches as jax_init_caches  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import (decode_step, init_caches, init_params,  # noqa: E402,E501
                                prefill)
from repro_torch.models import rglru as prg  # noqa: E402
from repro_torch.models import ssm as pssm  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.serve.engine import DECODE_STATS, greedy_generate  # noqa: E402,E501

REL = 2e-2
F32_REL = 1e-4
F32_MODULE_REL = 1e-5
DECODE_REL = 3e-2
RING_REL = 8e-2
REC_BF16_REL = 3e-2
REC_RING_REL = 5e-2
ARCHS = ["falcon-mamba-7b", "recurrentgemma-2b"]
PIM_W4 = dict(quant="pim_w4", quant_mode="shift_add")
# the reference's init_params seed of every test's weights
SEED = 1
CASES = {
    "falcon-mamba-7b": ("falcon-mamba-7b", {}),
    "falcon-mamba-7b-f32": ("falcon-mamba-7b", dict(dtype="float32")),
    "recurrentgemma-2b": ("recurrentgemma-2b", {}),
    "recurrentgemma-2b-f32": ("recurrentgemma-2b", dict(dtype="float32")),
    "recurrentgemma-2b-pim_w4": ("recurrentgemma-2b", PIM_W4),
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


def tokens(cfg, seed, length, batch=B):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, length)).astype(np.int32)


def configs(arch, **overrides):
    return (jconfigs.get_config(arch, smoke=True, **overrides),
            pconfigs.get_config(arch, smoke=True, **overrides))


def converted(arch, seed, **overrides):
    """(reference config, port config, reference params as numpy, the
    port's model on the CPU), made once per arguments: no test changes a
    model."""
    return _converted(arch, seed, tuple(sorted(overrides.items())))


@functools.lru_cache(maxsize=None)
def _converted(arch, seed, overrides):
    jcfg, pcfg = configs(arch, **dict(overrides))
    params = to_numpy(jax.jit(lambda k: jax_init(jcfg, k))(
        jax.random.PRNGKey(seed)))
    return jcfg, pcfg, params, lm_params_from_numpy(pcfg, params,
                                                    device=CPU)


# ---------------------------------------------------------------------------
# Modules on identical inputs
# ---------------------------------------------------------------------------

def module_bound(dtype):
    return F32_MODULE_REL if dtype == "float32" else REL


def first_mix(arch, dtype):
    """The reference's first recurrent mixer's params (numpy) and the
    port's copy: falcon-mamba's layer 0, recurrentgemma's block 0 sub 0."""
    jcfg, pcfg, params, model = converted(arch, SEED, dtype=dtype)
    if arch == "falcon-mamba-7b":
        return jcfg, pcfg, jax.tree.map(
            lambda a: a[0], params["stack"]["mix"]), model.layers[0].mix
    return jcfg, pcfg, jax.tree.map(
        lambda a: a[0], params["blocks"]["sub0"]["mix"]), \
        model.blocks[0][0].mix


def module_input(cfg, seed, seq):
    x = np.random.default_rng(seed).normal(
        size=(B, seq, cfg.d_model)).astype(np.float32)
    dt = jnp.dtype(cfg.dtype)
    return jnp.asarray(x, dt), torch.from_numpy(x).to(
        getattr(torch, cfg.dtype))


TRAIN = {"falcon-mamba-7b": (jssm.mamba_train, pssm.mamba_train),
         "recurrentgemma-2b": (jrg.rglru_train, prg.rglru_train)}
DECODE = {"falcon-mamba-7b": (jssm.mamba_decode, pssm.mamba_decode),
          "recurrentgemma-2b": (jrg.rglru_decode, prg.rglru_decode)}


@pytest.mark.parametrize("seq", [8, 16, 37])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_matches_reference(arch, dtype, seq):
    """mamba_train / rglru_train at scan_chunk 16: S below one chunk, one
    chunk, and three chunks with 11 identity-padded steps. The output, the
    final state h and the conv state."""
    jcfg, pcfg, jp, pp = first_mix(arch, dtype)
    assert jcfg.ssm is None or jcfg.ssm.scan_chunk == 16
    assert jcfg.rglru is None or jcfg.rglru.scan_chunk == 16
    jx, px = module_input(jcfg, 11, seq)
    jfn, pfn = TRAIN[arch]
    jy, jst = jax.jit(lambda p, x: jfn(jcfg, p, x))(jp, jx)
    py, pst = pfn(pcfg, pp, px)
    assert py.dtype == px.dtype and py.shape == px.shape
    assert pst["h"].dtype == torch.float32
    assert tuple(pst["conv"].shape) == jst["conv"].shape
    bound = module_bound(dtype)
    for what, got, exp in (("y", py, jy), ("h", pst["h"], jst["h"]),
                           ("conv", pst["conv"], jst["conv"])):
        rel = rel_err(f32(got), f32(exp))
        assert rel < bound, f"{what}: rel {rel:.3e} (bound {bound})"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dtype):
    """mamba_decode / rglru_decode from the state of a 37-step prefill (the
    reference's, carried across), two steps: the output and the state,
    which the port writes in place into the tensors it was given."""
    jcfg, pcfg, jp, pp = first_mix(arch, dtype)
    jx, _ = module_input(jcfg, 12, 37)
    _, jst = jax.jit(lambda p, x: TRAIN[arch][0](jcfg, p, x))(jp, jx)
    pst = {k: torch.from_numpy(np.array(f32(v))).to(
        torch.float32 if k == "h" else getattr(torch, pcfg.dtype))
        for k, v in jst.items()}
    given = dict(pst)
    jfn, pfn = DECODE[arch]
    jdec = jax.jit(lambda p, x, s: jfn(jcfg, p, x, s))
    bound = module_bound(dtype)
    for step in range(2):
        jx1, px1 = module_input(jcfg, 13 + step, 1)
        jy, jst = jdec(jp, jx1, jst)
        py, pst = pfn(pcfg, pp, px1, pst)
        assert all(pst[k] is given[k] for k in given)
        for what, got, exp in (("y", py, jy), ("h", pst["h"], jst["h"]),
                               ("conv", pst["conv"], jst["conv"])):
            rel = rel_err(f32(got), f32(exp))
            assert rel < bound, (f"step {step} {what}: rel {rel:.3e} "
                                 f"(bound {bound})")


# the products and float32-or-bf16 elementwise functions whose dtypes the
# placement test compares: the reference's jaxpr primitives, and the
# port's torch functions under the same names
JAX_OPS = {"dot_general": "dot", "exp": "exp", "sqrt": "sqrt",
           "logistic": "logistic", "tanh": "tanh"}
TORCH_OPS = {"matmul": "dot", "__matmul__": "dot", "einsum": "dot",
             "exp": "exp", "exp_": "exp", "sqrt": "sqrt",
             "sigmoid": "logistic", "silu": "logistic", "gelu": "tanh"}


def jax_ops(fn, *args):
    """(name, operand dtypes) of each JAX_OPS primitive in ``fn``'s jaxpr,
    in order, nested jaxprs (jit, scan, custom_jvp) included."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            name = JAX_OPS.get(eqn.primitive.name)
            if name:
                out.append((name, tuple(str(v.aval.dtype)
                                        for v in eqn.invars)))
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else (v,):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                        walk(sub.jaxpr)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


class TorchOps(TorchFunctionMode):
    """(name, tensor operand dtypes) of each TORCH_OPS call, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = TORCH_OPS.get(getattr(func, "__name__", ""))
        if name:
            operands = args[1:] if name == "dot" and func is torch.einsum \
                else args
            self.ops.append((name, tuple(
                str(t.dtype).removeprefix("torch.") for t in operands
                if isinstance(t, torch.Tensor))))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("step", ["train", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dtype_placement_matches_reference(arch, step):
    """The bf16 model's float32 islands sit where the reference's do: every
    product (matmul, einsum) with the reference's operand dtypes, in its
    order, and exp, sqrt, sigmoid/silu and gelu's tanh on the dtypes the
    reference runs them on. Train at S = 8, one scan chunk, so that the
    reference's chunk body, traced once, lines up with the port's loop."""
    jcfg, pcfg, jp, pp = first_mix(arch, "bfloat16")
    if step == "train":
        jx, px = module_input(jcfg, 11, 8)
        jfn, pfn = TRAIN[arch]
        expected = jax_ops(lambda p, x: jfn(jcfg, p, x), jp, jx)
        with TorchOps() as seen:
            pfn(pcfg, pp, px)
    else:
        jx, _ = module_input(jcfg, 12, 8)
        _, jst = jax.jit(lambda p, x: TRAIN[arch][0](jcfg, p, x))(jp, jx)
        pst = {k: torch.from_numpy(np.array(f32(v))).to(
            torch.float32 if k == "h" else torch.bfloat16)
            for k, v in jst.items()}
        jx1, px1 = module_input(jcfg, 13, 1)
        jfn, pfn = DECODE[arch]
        expected = jax_ops(lambda p, x, s: jfn(jcfg, p, x, s), jp, jx1, jst)
        with TorchOps() as seen:
            pfn(pcfg, pp, px1, pst)
    dots = [o for o in expected if o[0] == "dot"]
    assert {("dot", ("float32", "float32")),
            ("dot", ("bfloat16", "bfloat16"))} <= set(dots)
    assert [o for o in seen.ops if o[0] == "dot"] == dots
    # the reference's softplus and log_sigmoid add exps of their own, so
    # the elementwise functions are held as sets
    assert {o for o in seen.ops if o[0] != "dot"} == {
        o for o in expected if o[0] != "dot"}


def test_scan_inplace_is_the_sequential_recurrence():
    """scan_inplace against the recurrence written out in float64."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 1.0, (2, 9, 3, 4)).astype(np.float32)
    b = rng.normal(size=(2, 9, 3, 4)).astype(np.float32)
    h0 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    out = pssm.scan_inplace(torch.from_numpy(a), torch.from_numpy(b.copy()),
                            torch.from_numpy(h0)).numpy()
    h = h0.astype(np.float64)
    for t in range(9):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(out[:, t], h, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Whole models against the reference
# ---------------------------------------------------------------------------

def jax_forced(jcfg, params, prompt, max_len, feed=None, steps=STEPS):
    """The reference's prefill and ``steps`` decode steps, fed ``feed``
    (B, steps) or its own argmax chain: (logits per step, caches)."""
    j_pre = jax.jit(lambda p, t: jax_prefill(jcfg, p, {"tokens": t},
                                             max_len))
    j_dec = jax.jit(lambda p, t, pos, c: jax_decode(jcfg, p, {"tokens": t},
                                                    pos, c))
    S = prompt.shape[1]
    lg, jc = j_pre(params, jnp.asarray(prompt))
    logits = [np.asarray(lg)]
    for t in range(steps):
        tok = (jnp.argmax(lg.reshape(prompt.shape[0], -1), axis=-1)[:, None]
               if feed is None else jnp.asarray(feed[:, t:t + 1]))
        lg, jc = j_dec(params, tok.astype(jnp.int32), jnp.int32(S + t), jc)
        logits.append(np.asarray(lg))
    return logits, jc


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One configuration through both packages: prefill logits, then STEPS
    teacher-forced decode steps on the JAX greedy tokens, and the port's
    greedy_generate."""
    arch, overrides = CASES[request.param]
    jcfg, pcfg, params, model = converted(arch, SEED, **overrides)
    prompt = tokens(jcfg, 0, PROMPT)
    max_len = PROMPT + STEPS + 1
    jax_logits, jc = jax_forced(jcfg, params, prompt, max_len)
    jax_tokens = np.stack([np.argmax(lg.reshape(B, -1), axis=-1)
                           for lg in jax_logits], axis=1)
    tol = (F32_REL if pcfg.dtype == "float32" else
           REC_BF16_REL if arch == "recurrentgemma-2b" else REL)

    plg, pc = prefill(pcfg, model, {"tokens": prompt}, max_len, device=CPU)
    port_logits = [plg.numpy()]
    for t in range(STEPS):
        plg, pc = decode_step(pcfg, model,
                              {"tokens": jax_tokens[:, t:t + 1]},
                              PROMPT + t, pc, device=CPU)
        port_logits.append(plg.numpy())
    DECODE_STATS["dispatches"] = 0
    port_tokens = greedy_generate(pcfg, model, {"tokens": prompt},
                                  max_new_tokens=STEPS + 1,
                                  max_cache_len=max_len, device=CPU).numpy()
    dispatches = DECODE_STATS["dispatches"]
    return dict(name=request.param, cfg=pcfg, tol=tol,
                jax_logits=jax_logits, port_logits=port_logits,
                jax_tokens=jax_tokens, port_tokens=port_tokens,
                dispatches=dispatches, jax_caches=to_numpy(jc),
                port_caches=pc)


def test_logits_match_per_step(case):
    for t, (exp, got) in enumerate(zip(case["jax_logits"],
                                       case["port_logits"])):
        assert got.shape == exp.shape and got.dtype == np.float32
        rel = rel_err(got, exp)
        assert rel < case["tol"], (
            f"{case['name']}: step {t} rel {rel:.3e} (bound "
            f"{case['tol']:.3e})")


def test_caches_keep_the_reference_layout(case):
    """The decode caches after the steps: the reference's stacks, keys,
    shapes and dtypes (bf16 entries as bf16, the recurrent state float32),
    the state within the case's bound of the reference's."""
    jc, pc = case["jax_caches"], case["port_caches"]
    assert set(jc) == set(pc)
    flat_j = jax.tree_util.tree_flatten_with_path(jc)[0]
    for path, exp in flat_j:
        got = pc
        for k in path:
            got = got[k.key]
        assert tuple(got.shape) == exp.shape, path
        assert str(got.dtype).split(".")[-1] == str(exp.dtype), path
        if path[-1].key == "h":
            rel = rel_err(f32(got), np.asarray(exp, np.float32))
            assert rel < case["tol"], (path, rel)


def test_greedy_tokens_match(case):
    """Equal wherever the JAX top-2 margin exceeds 2 × tolerance; past the
    first step whose margin is within it, the two generations may part.
    On the CPU the loop counts one dispatch per decode step."""
    got, exp = case["port_tokens"], case["jax_tokens"]
    assert got.shape == exp.shape and got.dtype == np.int32
    assert case["dispatches"] == STEPS
    for b in range(B):
        for t in range(STEPS + 1):
            lg = np.asarray(case["jax_logits"][t], np.float64).reshape(B, -1)
            top2 = np.sort(lg[b])[-2:]
            if top2[1] - top2[0] <= 2 * case["tol"] * np.max(np.abs(lg)):
                break
            assert got[b, t] == exp[b, t], (
                f"{case['name']}: request {b} token {t}: {got[b, t]} != "
                f"{exp[b, t]}")


# ---------------------------------------------------------------------------
# Decode against prefill, empty caches, the ring wrap (the port's weights)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch, dtype):
    """prefill(S − 1 tokens) + decode_step(token S − 1) reproduces the
    logits of prefill(S tokens), S = 32 (two scan chunks): the reference's
    3e-2 in bf16, F32_REL in float32."""
    cfg = pconfigs.get_config(arch, smoke=True, dtype=dtype)
    model = init_params(cfg, 1, device=CPU)
    S = 32
    toks = tokens(cfg, 0, S)
    full, _ = prefill(cfg, model, {"tokens": toks}, S, device=CPU)
    _, caches = prefill(cfg, model, {"tokens": toks[:, :-1]}, S,
                        device=CPU)
    dec, _ = decode_step(cfg, model, {"tokens": toks[:, -1:]}, S - 1,
                         caches, device=CPU)
    tol = F32_REL if dtype == "float32" else DECODE_REL
    rel = rel_err(dec.numpy(), full.numpy())
    assert rel < tol, f"rel {rel:.3e} (bound {tol})"


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_empty_caches_matches_prefill(arch):
    """init_caches: zero recurrent state (and empty attention slots);
    decoding the first token into them reproduces a one-token prefill, in
    float32."""
    cfg = pconfigs.get_config(arch, smoke=True, dtype="float32")
    model = init_params(cfg, 3, device=CPU)
    caches = init_caches(cfg, B, 8, CPU)
    jcaches = jax_init_caches(
        jconfigs.get_config(arch, smoke=True, dtype="float32"), B, 8)
    assert jax.tree.map(lambda a: a.shape, jcaches) == jax.tree.map(
        lambda t: tuple(t.shape), caches)
    toks = np.array([[5], [7]], np.int32)
    dec, _ = decode_step(cfg, model, {"tokens": toks}, 0, caches, device=CPU)
    full, _ = prefill(cfg, model, {"tokens": toks}, 8, device=CPU)
    rel = rel_err(dec.numpy(), full.numpy())
    assert rel < F32_REL, f"rel {rel:.3e} (bound {F32_REL})"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ring_cache_wraps(dtype):
    """recurrentgemma decodes 2W + 5 positions past a W-token prefill, so
    its attention ring (W = 16 slots) wraps twice: the last logits within
    the reference's RING_REL (bf16) of a full prefill, and every step's
    logits within F32_REL (float32) or REC_RING_REL (bf16) of the
    reference's on the same weights and tokens."""
    jcfg, pcfg, params, model = converted("recurrentgemma-2b", SEED,
                                          dtype=dtype)
    W = pcfg.sliding_window
    total = 2 * W + 5
    toks = tokens(pcfg, 0, total)
    full, _ = prefill(pcfg, model, {"tokens": toks}, total, device=CPU)
    logits, caches = prefill(pcfg, model, {"tokens": toks[:, :W]}, total,
                             device=CPU)
    assert caches["blocks"]["sub2"]["k"].shape[2] == W
    port = [logits.numpy()]
    for t in range(W, total):
        logits, caches = decode_step(pcfg, model,
                                     {"tokens": toks[:, t:t + 1]}, t,
                                     caches, device=CPU)
        port.append(logits.numpy())
    ref, _ = jax_forced(jcfg, params, toks[:, :W], total, feed=toks[:, W:],
                        steps=total - W)
    step_tol = F32_REL if dtype == "float32" else REC_RING_REL
    worst = max(rel_err(a, b) for a, b in zip(port, ref))
    assert worst < step_tol, (f"port vs reference rel {worst:.3e} (bound "
                              f"{step_tol:.3e})")
    tol = F32_REL if dtype == "float32" else RING_REL
    rel = rel_err(logits.numpy(), full.numpy())
    assert rel < tol, f"rel {rel:.3e} (bound {tol})"


@pytest.mark.parametrize("run,bound", [("steps", REC_BF16_REL),
                                       ("ring", REC_RING_REL)])
def test_reference_moves_with_its_gelu_rounding(monkeypatch, run, bound):
    """The witness for recurrentgemma's bf16 bounds: the reference against
    itself with one change, its ``gelu`` computed in float32 and rounded
    once instead of after each bf16 op, over the whole-model case's run
    (prefill and STEPS teacher-forced steps) and the ring run (2W + 5
    steps). Its logits move past REL (2.10e-2 and 3.36e-2 at SEED), so REL
    is below the reference's own rounding noise, and the port's fixed
    bound stays within twice that move."""
    jcfg, pcfg, params, _ = converted("recurrentgemma-2b", SEED)
    if run == "steps":
        toks = tokens(jcfg, 0, PROMPT)
        args = (toks, PROMPT + STEPS + 1)
        ref, _ = jax_forced(jcfg, params, *args)
        feed = np.stack([np.argmax(lg.reshape(B, -1), axis=-1)
                         for lg in ref], axis=1)
        kw = dict(feed=feed)
    else:
        W = pcfg.sliding_window
        total = 2 * W + 5
        toks = tokens(jcfg, 0, total)
        args = (toks[:, :W], total)
        kw = dict(feed=toks[:, W:], steps=total - W)
        ref, _ = jax_forced(jcfg, params, *args, **kw)
    gelu = jax.nn.gelu
    monkeypatch.setattr(jax.nn, "gelu", lambda x, approximate=True: gelu(
        x.astype(jnp.float32), approximate).astype(x.dtype))
    moved, _ = jax_forced(jcfg, params, *args, **kw)
    shift = max(rel_err(a, b) for a, b in zip(moved, ref))
    assert REL < shift < bound < 2 * shift, (
        f"{run}: the reference moves {shift:.3e} (REL {REL}, bound "
        f"{bound})")


# ---------------------------------------------------------------------------
# Short prompts, conversion, the layout, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_short_prompt_state_and_decode(arch, length):
    """A prompt shorter than d_conv − 1 = 3 leaves a conv state of fewer
    rows, as the reference's prefill does (its first decode step then
    fails); the port's decode raises a ValueError that names the cause.
    One new token needs no decode step and is served."""
    jcfg, pcfg, params, model = converted(arch, SEED)
    toks = tokens(pcfg, 1, length)
    _, jc = jax.eval_shape(lambda p: jax_prefill(
        jcfg, p, {"tokens": jnp.asarray(toks)}, max_cache_len=8), params)
    _, caches = prefill(pcfg, model, {"tokens": toks}, 8, device=CPU)
    key = "stack" if arch == "falcon-mamba-7b" else "tail"
    assert tuple(caches[key]["conv"].shape) == jc[key]["conv"].shape
    assert caches[key]["conv"].shape[2] == 1
    with pytest.raises(ValueError, match="conv state"):
        decode_step(pcfg, model, {"tokens": toks[:, :1]}, length, caches,
                    device=CPU)
    out = greedy_generate(pcfg, model, {"tokens": toks}, max_new_tokens=1,
                          device=CPU)
    assert out.shape == (B, 1)
    with pytest.raises(ValueError, match="conv state"):
        greedy_generate(pcfg, model, {"tokens": toks}, max_new_tokens=2,
                        device=CPU)


@pytest.mark.parametrize("arch", ARCHS)
def test_conversion_keeps_float32_leaves(arch):
    """The reference's float32 leaves stay float32 in a bf16 model, bit for
    bit; the rest take bf16, as the reference's are."""
    _, _, params, model = converted(arch, SEED, **PIM_W4)
    if arch == "falcon-mamba-7b":
        pairs = [(params["stack"]["mix"], layer.mix, i)
                 for i, layer in enumerate(model.layers)]
        f32_names = ("dt_bias", "A_log", "D")
    else:
        pairs = [(params["blocks"]["sub1"]["mix"], block[1].mix, i)
                 for i, block in enumerate(model.blocks)]
        pairs += [(params["tail"]["mix"], sub.mix, i)
                  for i, sub in enumerate(model.tail)]
        f32_names = ("b_a", "b_x", "lam")
        assert model.blocks[0][0].mlp.w1.quantized
    for ref, mod, i in pairs:
        for name, leaf in ref.items():
            got = getattr(mod, name)
            exp = np.asarray(leaf[i])
            want = torch.float32 if name in f32_names else torch.bfloat16
            assert got.dtype == want, name
            assert str(exp.dtype) == str(want).split(".")[-1], name
            assert np.array_equal(f32(got), exp.astype(np.float32)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_of_the_model(arch):
    """falcon-mamba: its layers in ``layers``; recurrentgemma at the smoke
    size's 5 layers: one (rec, rec, attn) block and a 2-layer rec tail, as
    the reference's ``_hybrid_layout`` splits them."""
    cfg = pconfigs.get_config(arch, smoke=True)
    model = init_params(cfg, 0, device=CPU)
    if arch == "falcon-mamba-7b":
        assert len(model.layers) == cfg.n_layers and not model.blocks
        assert all(isinstance(m, ptf.MambaLayer) for m in model.layers)
        return
    assert ptf._hybrid_layout(cfg) == (1, 2) and not model.layers
    kinds = [type(s.mix).__name__ for s in model.blocks[0]]
    assert kinds == ["RGLRU", "RGLRU", "GQA"]
    assert [type(s.mix).__name__ for s in model.tail] == ["RGLRU"] * 2
    with pytest.raises(ValueError, match="leading"):
        ptf._hybrid_layout(pconfigs.get_config(
            arch, smoke=True, rglru=cfg.rglru.__class__(
                lru_width=64, pattern=("attn", "rec", "rec"))))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(arch):
    out = io.StringIO()
    with redirect_stdout(out):
        serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "4", "--max-new",
                        "3"])
    lines = out.getvalue().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["req0", "req1"]
