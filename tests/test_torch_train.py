"""Training's gradient path in the port against the JAX reference, on the
CPU: the losses and every gradient leaf (``models.loss_fn`` under
autograd against ``repro.models.loss_fn`` under ``jax.grad``), the flash
attention backward, the optimizer, schedules and compression, one
``make_train_step`` step, and the counterparts of the reference's
``tests/test_train_and_ckpt.py`` training tests.

Weights are the reference's ``init_params`` pytree carried across by
``convert.lm_params_from_numpy``; gradients come back by
``convert.lm_params_to_numpy(grads=True)`` and are compared leaf by leaf.
Inputs come from numpy with a seed (``tests/util.py::make_inputs``).

Tolerances:
- the ten smoke configurations with float32 overrides: loss within 1e-5,
  each gradient leaf within 1e-4 of its max |ref|; the two MoE configs'
  gradients within 5e-2, because the reference's dispatch casts the
  expert inputs to bf16 even in float32 (``ffn.moe_ffn``), so their
  cotangents are bf16 sums that the two frameworks round apart (measured
  1.9e-3 and 5.1e-3);
- bf16 (``qwen3-4b`` and its ``pim_w4`` linears in both modes, which cast
  their input to bf16 in both packages): loss within 2e-2, leaves within
  5e-2 of max |ref|;
- flash against the naive path: 1e-4 of max |naive| (the reference test's
  bound);
- AdamW, the schedules and compression: float32 rounding;
- the step: the reference's own bounds where a step's sign-like update
  (Adam's first step is about lr·sign(g)) meets grads that differ at
  float32 rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.models import loss_fn as jax_loss  # noqa: E402
from repro.models.attention import chunked_attention as jax_attention  # noqa: E402,E501
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro.train.step import init_train_state as jax_init_state  # noqa: E402,E501
from repro.train.step import make_train_step as jax_make_step  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.convert import (lm_params_from_numpy,  # noqa: E402
                                 lm_params_to_numpy)
from repro_torch.models import (loss_fn, param_tree, prefill,  # noqa: E402
                                trainable)
from repro_torch.models.attention import chunked_attention  # noqa: E402
from repro_torch.optim import adamw, grad_compress  # noqa: E402
from repro_torch.optim.schedule import constant, warmup_cosine  # noqa: E402
from repro_torch.train import (init_train_state, make_train_step,  # noqa: E402,E501
                               train_loop, trainable_params)

from util import make_inputs  # noqa: E402

CPU = "cpu"
ARCHS = ["qwen3-4b", "yi-34b", "qwen2.5-32b", "starcoder2-7b",
         "deepseek-v2-lite-16b", "qwen3-moe-30b-a3b",
         "llava-next-mistral-7b", "musicgen-medium", "falcon-mamba-7b",
         "recurrentgemma-2b"]
MOE = {"deepseek-v2-lite-16b", "qwen3-moe-30b-a3b"}
F32_LOSS, F32_GRAD, MOE_GRAD = 1e-5, 1e-4, 5e-2
BF16_LOSS, BF16_GRAD = 2e-2, 5e-2


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def np_batch(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def configs(arch, **overrides):
    return (jconfigs.get_config(arch, smoke=True, **overrides),
            pconfigs.get_config(arch, smoke=True, **overrides))


def leaves_by_path(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(k.key for k in path): np.asarray(leaf, np.float32)
            for path, leaf in flat}


def ref_loss_and_grads(jcfg, params, batch):
    train, frozen = jadamw.partition(jax.tree.map(jnp.asarray, params))
    (loss, _), grads = jax.value_and_grad(
        lambda t: jax_loss(jcfg, jadamw.merge(t, frozen), batch),
        has_aux=True)(train)
    return float(loss), leaves_by_path(grads)


def port_loss_and_grads(pcfg, params, batch):
    model = lm_params_from_numpy(pcfg, params, device=CPU)
    trainable(model)
    loss, _ = loss_fn(pcfg, model, np_batch(batch))
    loss.backward()
    return float(loss.detach()), leaves_by_path(
        lm_params_to_numpy(model, grads=True))


def assert_grads_close(ref, got, bound):
    assert set(got) == set(ref)
    for key, r in ref.items():
        err = np.max(np.abs(got[key] - r)) / (np.max(np.abs(r)) + 1e-30)
        assert err < bound, f"{key}: {err:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Each smoke configuration with float32 overrides: the loss and every
    trainable leaf's gradient, the int8 codes excluded in both."""
    jcfg, pcfg = configs(arch, dtype="float32")
    params = to_numpy(jax_init(jcfg, jax.random.PRNGKey(1)))
    batch = make_inputs(jcfg, 2, 32, seed=3)
    r_loss, r_grads = ref_loss_and_grads(jcfg, params, batch)
    p_loss, p_grads = port_loss_and_grads(pcfg, params, batch)
    assert abs(p_loss - r_loss) < F32_LOSS
    assert_grads_close(r_grads, p_grads, MOE_GRAD if arch in MOE
                       else F32_GRAD)


@pytest.mark.parametrize("overrides", [
    {}, {"quant": "pim_w4", "quant_mode": "shift_add"},
    {"quant": "pim_w4", "quant_mode": "dequant"}],
    ids=["bf16", "pim_w4-shift_add", "pim_w4-dequant"])
def test_bf16_and_quantized_grads_match_reference(overrides):
    """qwen3-4b in bf16, dense and with pim_w4 linears in both modes: the
    quantized linears' float32 scales train, their codes do not."""
    jcfg, pcfg = configs("qwen3-4b", **overrides)
    params = to_numpy(jax_init(jcfg, jax.random.PRNGKey(1)))
    batch = make_inputs(jcfg, 2, 32, seed=3)
    r_loss, r_grads = ref_loss_and_grads(jcfg, params, batch)
    p_loss, p_grads = port_loss_and_grads(pcfg, params, batch)
    assert abs(p_loss - r_loss) < BF16_LOSS
    if overrides:
        assert any(k.endswith("scales") for k in p_grads)
        assert not any(k.endswith("w_int") for k in p_grads)
    assert_grads_close(r_grads, p_grads, BF16_GRAD)


def test_quantized_linear_keeps_its_transposed_codes():
    """A pim_w4 model's backward builds each linear's transposed codes
    once (the dx product's operand) and reuses them at the next step."""
    _, pcfg = configs("qwen3-4b", quant="pim_w4")
    params = to_numpy(jax_init(jconfigs.get_config(
        "qwen3-4b", smoke=True, quant="pim_w4"), jax.random.PRNGKey(0)))
    model = lm_params_from_numpy(pcfg, params, device=CPU)
    trainable(model)
    batch = np_batch(make_inputs(pcfg, 2, 16, seed=1))
    lin = model.layers[0].ffn.w1
    assert getattr(lin, "w_int_t", None) is None
    loss_fn(pcfg, model, batch)[0].backward()
    first = lin.w_int_t
    assert torch.equal(first, lin.w_int.T)
    loss_fn(pcfg, model, batch)[0].backward()
    assert lin.w_int_t is first
    assert "w_int_t" not in model.state_dict()


# ---------------------------------------------------------------------------
# Flash attention's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 16])
def test_flash_grads_match_naive(window):
    """Counterpart of ``tests/test_flash_attention.py::
    test_gradients_match_naive``: the autograd flash path against the
    naive online-softmax path differentiated by autograd."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 32, 2, 2, 8)).astype(np.float32)
    k = rng.normal(size=(2, 32, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 32, 2, 8)).astype(np.float32)
    pos = torch.arange(32, dtype=torch.int32)

    def grads(impl):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        o = chunked_attention(*ts, pos, pos, window=window, q_chunk=8,
                              k_chunk=16, impl=impl)
        torch.sum(o * o).backward()
        return [t.grad for t in ts]

    for a, b in zip(grads("flash"), grads("naive")):
        assert float((a - b).abs().max() / (b.abs().max() + 1e-9)) < 1e-4


def test_flash_grads_match_reference_vjp():
    """The port's flash backward against the reference's custom VJP
    (``models/flash.py``) on the same inputs, ring positions included."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 16, 2, 3, 8)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 8)).astype(np.float32)
    pos_q = np.arange(8, 24, dtype=np.int32)
    pos_k = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    pos_k[1, 3] = -1
    ref = jax.grad(lambda q, k, v: jnp.sum(jax_attention(
        q, k, v, jnp.asarray(pos_q), jnp.asarray(pos_k), q_chunk=8,
        k_chunk=8, impl="flash") ** 2), argnums=(0, 1, 2))(q, k, v)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = chunked_attention(*ts, torch.from_numpy(pos_q),
                          torch.from_numpy(pos_k), q_chunk=8, k_chunk=8,
                          impl="flash")
    torch.sum(o ** 2).backward()
    for t, r in zip(ts, ref):
        r = np.asarray(r)
        assert np.max(np.abs(t.grad.numpy() - r)) / np.max(np.abs(r)) < 1e-4


def test_flash_forward_returns_the_reference_lse():
    """The plain version's log-sum-exp is the reference forward's
    ``m + log(max(l, 1e-30))``, a row that sees no key included."""
    from repro.models.flash import _fwd_impl
    from repro_torch.kernels.flash_attn import ops as fa
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 8, 2, 2, 16)).astype(np.float32)
    k = rng.normal(size=(1, 8, 2, 16)).astype(np.float32)
    pos_q = np.arange(8, dtype=np.int32) - 1        # the first sees nothing
    pos_k = np.arange(8, dtype=np.int32)[None]
    _, lse = _fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                       jnp.asarray(pos_q, jnp.float32),
                       jnp.asarray(pos_k, jnp.float32), None, 0.25, 4, 4)
    out, got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(k),
                                  torch.from_numpy(pos_q),
                                  torch.from_numpy(pos_k), scale=0.25,
                                  return_lse=True)
    assert got.shape == (1, 2, 2, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(lse), rtol=1e-6,
                               atol=1e-5)
    assert torch.equal(out, fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
        torch.from_numpy(pos_q), torch.from_numpy(pos_k), scale=0.25))


# ---------------------------------------------------------------------------
# Optimizer, schedules, compression
# ---------------------------------------------------------------------------

def test_adamw_matches_reference():
    """Two AdamW steps on the same params and grads (a bf16 and a float32
    leaf, one grad past the clip): params, moments, step, grad norm."""
    rng = np.random.default_rng(4)
    ps = [rng.normal(size=(16, 8)).astype(np.float32),
          rng.normal(size=(5,)).astype(np.float32)]
    gs = [rng.normal(size=(16, 8)).astype(np.float32) * 0.3,
          rng.normal(size=(5,)).astype(np.float32) * 2]
    cfg = jadamw.AdamWConfig(lr=1e-2)
    jp = {"a": jnp.asarray(ps[0], jnp.bfloat16), "b": jnp.asarray(ps[1])}
    jg = {"a": jnp.asarray(gs[0], jnp.bfloat16), "b": jnp.asarray(gs[1])}
    js = jadamw.init_state(jp)
    tp = [torch.tensor(ps[0]).to(torch.bfloat16), torch.tensor(ps[1])]
    tg = [torch.tensor(gs[0]).to(torch.bfloat16), torch.tensor(gs[1])]
    ts = adamw.init_state(tp)
    pcfg = adamw.AdamWConfig(lr=1e-2)
    for lr_scale in (0.5, 1.0):
        jp, js, jm = jadamw.apply_updates(jp, jg, js, cfg, lr_scale)
        tp, ts, tm = adamw.apply_updates(tp, tg, ts, pcfg, lr_scale)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for i, k in enumerate(("a", "b")):
            np.testing.assert_allclose(ts["mu"][i].numpy(),
                                       np.asarray(js["mu"][k]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(ts["nu"][i].numpy(),
                                       np.asarray(js["nu"][k]), rtol=1e-5,
                                       atol=1e-9)
            np.testing.assert_allclose(
                tp[i].to(torch.float32).numpy(),
                np.asarray(jp[k], np.float32), rtol=1e-6, atol=1e-6)
        assert tp[0].dtype == torch.bfloat16
        assert int(ts["step"]) == int(js["step"])


def test_schedules_match_reference():
    for step in (0, 1, 5, 10, 11, 37, 50, 99, 100, 150):
        got = warmup_cosine(step, warmup_steps=10, total_steps=100)
        exp = jsched.warmup_cosine(step, warmup_steps=10, total_steps=100)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(exp), rtol=2e-7)
    assert float(constant(torch.tensor(3), value=0.25)) == float(
        jsched.constant(3, value=0.25))


def test_lr_schedule_shape():
    """Counterpart of the reference's ``test_lr_schedule_shape``."""
    s = [float(warmup_cosine(i, warmup_steps=10, total_steps=100))
         for i in (0, 5, 10, 50, 100)]
    assert s[0] == 0.0 and s[1] == pytest.approx(0.5)
    assert s[2] == pytest.approx(1.0)
    assert s[2] > s[3] > s[4] >= 0.1 - 1e-6


def test_compress_matches_reference():
    """Codes (round half to even) and scales exact, residuals at float32
    rounding, with and without an incoming residual; ties included."""
    rng = np.random.default_rng(5)
    g = rng.normal(size=(300,)).astype(np.float32)
    g[:4] = [127.0, 0.5, 1.5, -2.5]                 # scale 1: exact ties
    r = (rng.normal(size=(300,)) * 1e-2).astype(np.float32)
    for res in (None, r):
        jc, js, jr = jgc.compress(jnp.asarray(g), None if res is None
                                  else jnp.asarray(res))
        tc, ts, tr = grad_compress.compress(
            torch.from_numpy(g), None if res is None
            else torch.from_numpy(res))
        assert np.array_equal(tc.numpy(), np.asarray(jc))
        assert float(ts) == float(js)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    codes, scales, resid = grad_compress.compress_tree(
        [torch.from_numpy(g), torch.from_numpy(r)])
    back = grad_compress.decompress_tree(codes, scales)
    assert len(back) == 2 and back[0].dtype == torch.float32


def test_grad_compression_error_feedback():
    """Counterpart of the reference's
    ``test_grad_compression_error_feedback``."""
    rng = np.random.default_rng(0)
    g = torch.tensor(rng.normal(size=(256,)), dtype=torch.float32)
    codes, scale, resid = grad_compress.compress(g)
    back = grad_compress.decompress(codes, scale)
    assert float((back - g).abs().max()) <= float(scale) * 0.5 + 1e-7
    assert float(((back + resid) - g).abs().max()) < 1e-6


# ---------------------------------------------------------------------------
# The training step
# ---------------------------------------------------------------------------

CFG_ARCH = "qwen3-4b"
STACKS = ("stack/", "blocks/", "tail/", "dense_head_layers/")


def fresh(seed, **overrides):
    """Reference params (numpy) and the port's model built from them."""
    jcfg, pcfg = configs(CFG_ARCH, **overrides)
    params = to_numpy(jax_init(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, pcfg, params, lm_params_from_numpy(pcfg, params,
                                                    device=CPU)


def port_tree_of(model, lists):
    """Per-tensor lists (trainable_params order) laid on the reference's
    trainable tree paths, stacked per leaf."""
    out, i = {}, 0
    for path, ts in trainable(model):
        arrs = [t.detach().to(torch.float32).numpy()
                for t in lists[i:i + len(ts)]]
        out[path] = np.stack(arrs) if path.startswith(STACKS) else arrs[0]
        i += len(ts)
    return out


def test_train_step_matches_reference():
    """One ``make_train_step`` step (float32 overrides, lr 1e-2, warmup
    cosine) against the reference's: metrics, step, moments within 1e-4 of
    max |ref| (they are (1 − b) g and (1 − b) g²), params within the
    reference's microbatch bound 5e-2 (Adam's first step moves a leaf by
    about lr·sign(g), which flips where a grad is near zero)."""
    jcfg, pcfg, params, model = fresh(1, dtype="float32")
    batch = make_inputs(jcfg, 4, 32, seed=2)
    sched = dict(warmup_steps=2, total_steps=10)
    train, frozen, opt = jax_init_state(jcfg, jax.tree.map(jnp.asarray,
                                                           params))
    jstep = jax_make_step(jcfg, jadamw.AdamWConfig(lr=1e-2),
                          lambda s: jsched.warmup_cosine(s, **sched))
    opt = dict(opt, step=jnp.asarray(1, jnp.int32))   # lr_scale 0.5
    jt, jo, jm = jstep(train, frozen, opt, batch)

    popt = init_train_state(model)
    popt["step"] = torch.tensor(1, dtype=torch.int32)
    pstep = make_train_step(pcfg, adamw.AdamWConfig(lr=1e-2),
                            lambda s: warmup_cosine(s, **sched))
    pm = pstep(model, popt, np_batch(batch))
    for k in ("loss", "ce_loss", "grad_norm", "lr_scale"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5)
    assert float(pm["skipped"]) == float(jm["skipped"]) == 0.0
    assert int(popt["step"]) == int(jo["step"]) == 2
    for key, lists in (("mu", popt["mu"]), ("nu", popt["nu"])):
        ref = leaves_by_path(jo[key])
        got = port_tree_of(model, lists)
        assert_grads_close(ref, got, 1e-4)
    ref = leaves_by_path(jt)
    got = port_tree_of(model, trainable_params(model))
    for key, r in ref.items():
        assert np.max(np.abs(got[key] - r)) < 5e-2, key


def test_loss_decreases():
    """Counterpart of the reference's ``test_loss_decreases``: 20 steps of
    ``train_loop`` (batch 8, 64 tokens of the synthetic stream, lr 1e-3)
    on the CPU."""
    pcfg = pconfigs.get_config(CFG_ARCH, smoke=True)
    _, hist = train_loop(pcfg, steps=20, batch=8, seq=64,
                         opt_cfg=adamw.AdamWConfig(lr=1e-3),
                         log=lambda *a: None, device=CPU)
    assert np.mean(hist["loss"][-5:]) < np.mean(hist["loss"][:5])
    assert hist["skipped"] == 0


def test_nan_guard_skips_poisoned_step():
    """Counterpart of the reference's ``test_nan_guard_skips_poisoned_step``:
    a NaN mask skips the step and leaves params, moments and the step
    counter as they were; a clean batch then steps."""
    _, pcfg, _, model = fresh(0)
    opt = init_train_state(model)
    step = make_train_step(pcfg, adamw.AdamWConfig(), lambda s: 1.0)
    batch = np_batch(make_inputs(pcfg, 4, 32))
    batch["mask"] = np.ones(batch["labels"].shape, np.float32)
    poisoned = dict(batch, mask=batch["mask"] * np.float32("nan"))
    before = [t.detach().clone() for t in trainable_params(model)]
    m1 = step(model, opt, poisoned)
    assert float(m1["skipped"]) == 1.0
    for a, b in zip(trainable_params(model), before):
        assert torch.equal(a.detach(), b)
    assert int(opt["step"]) == 0
    assert all(float(m.abs().max()) == 0.0 for m in opt["mu"])
    m2 = step(model, opt, batch)
    assert float(m2["skipped"]) == 0.0 and int(opt["step"]) == 1


def test_microbatching_matches_full_batch():
    """Counterpart of the reference's
    ``test_microbatching_matches_full_batch``: loss within 5e-3, params
    within 5e-2; the microbatches add their grads in float32 buffers."""
    _, pcfg, params, m1 = fresh(1)
    m2 = lm_params_from_numpy(pcfg, params, device=CPU)
    batch = np_batch(make_inputs(pcfg, 8, 32))
    out = []
    for model, mb in ((m1, 1), (m2, 2)):
        opt = init_train_state(model)
        step = make_train_step(pcfg, adamw.AdamWConfig(lr=1e-2),
                               lambda s: 1.0, microbatches=mb)
        out.append(float(step(model, opt, batch)["loss"]))
    assert abs(out[0] - out[1]) < 5e-3
    diffs = [float((a.detach().float() - b.detach().float()).abs().max())
             for a, b in zip(trainable_params(m1), trainable_params(m2))]
    assert max(diffs) < 5e-2


def test_compressed_step_carries_its_residual():
    """``compress=True``: the step runs on the int8-rounded grads and
    keeps the rounding error as the next step's residual."""
    _, pcfg, _, model = fresh(0)
    opt = init_train_state(model, compress=True)
    step = make_train_step(pcfg, adamw.AdamWConfig(lr=1e-3),
                           lambda s: 1.0, compress=True)
    batch = np_batch(make_inputs(pcfg, 4, 32))
    m = step(model, opt, batch)
    assert float(m["skipped"]) == 0.0 and int(opt["step"]) == 1
    assert len(opt["residual"]) == len(opt["mu"])
    assert any(float(r.abs().max()) > 0 for r in opt["residual"])


def test_trained_model_serves_its_trained_weights():
    """After a step the float32 serving head holds the trained embedding
    (refreshed in place), and prefill's logits equal those of a model
    rebuilt from the trained parameters through ``convert``."""
    jcfg, pcfg, _, model = fresh(0)
    head = model.head_f32
    step = make_train_step(pcfg, adamw.AdamWConfig(lr=1e-2), lambda s: 1.0)
    step(model, init_train_state(model),
         np_batch(make_inputs(pcfg, 4, 32)))
    assert model.head_f32 is head
    assert torch.equal(model.head_f32, model.embed.detach().float())
    rebuilt = lm_params_from_numpy(pcfg, lm_params_to_numpy(model),
                                   device=CPU)
    prompt = np_batch(make_inputs(pcfg, 2, 12, seed=5, labels=False))
    a, _ = prefill(pcfg, model, prompt, 16, device=CPU)
    b, _ = prefill(pcfg, rebuilt, prompt, 16, device=CPU)
    assert torch.equal(a, b)
    tree = param_tree(model)
    assert set(tree) == set(lm_params_to_numpy(rebuilt))
