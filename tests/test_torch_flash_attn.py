"""The port's flash-attention forward (its plain torch version on the CPU)
against the reference's Pallas kernel in interpret mode, per batch element,
and the port's ``chunked_attention`` against the reference's, on the same
numpy inputs.

The port takes the models' layout — q (B, Sq, KV, G, dh), k/v
(B, Sk, KV, dh), pos_k (B, Sk) — and the Pallas kernel one batch element,
q (KV·G, Sq, dh), k/v (KV, Sk, dh). Tolerances are the reference tests'
own (``tests/test_kernels_flash_attn.py``): abs < 2e-5 in float32, 0.05 for
bf16 inputs against the float32 oracle, and a poisoned invalid slot that
moves nothing (< 1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn import flash_attention as pallas_flash  # noqa: E402,E501
from repro.kernels.flash_attn import ref_flash_attention as jax_oracle  # noqa: E402,E501
from repro.models.attention import chunked_attention as jax_chunked  # noqa: E402,E501
from repro_torch.kernels.flash_attn import ops as port_ops  # noqa: E402
from repro_torch.kernels.flash_attn import ref as fref  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402

F32_ABS = 2e-5
BF16_ABS = 0.05


def make(B, KV, G, Sq, Sk, dh, seed=0, invalid=0):
    """Model-layout inputs; the last ``invalid`` keys of batch row b are
    marked −1 from slot Sk − invalid − b on (rows differ)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, KV, G, dh)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, dh)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, dh)).astype(np.float32)
    pq = np.arange(Sk - Sq, Sk, dtype=np.int32)
    pk = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    for b in range(B):
        if invalid:
            pk[b, max(0, Sk - invalid - b):Sk - b] = -1
    return q, k, v, pq, pk


def per_head(q, k, v, b):
    """Batch element ``b`` in the Pallas kernel's layout."""
    _, Sq, KV, G, dh = q.shape
    qh = q[b].transpose(1, 2, 0, 3).reshape(KV * G, Sq, dh)
    return qh, k[b].transpose(1, 0, 2), v[b].transpose(1, 0, 2)


def from_heads(out, KV, G):
    """(KV·G, Sq, dh) back to (Sq, KV, G, dh)."""
    H, Sq, dh = out.shape
    return out.reshape(KV, G, Sq, dh).transpose(2, 0, 1, 3)


def pallas_reference(q, k, v, pq, pk, window=None, dtype=jnp.float32,
                     bq=16, bk=32):
    outs = []
    for b in range(q.shape[0]):
        qh, kh, vh = per_head(q, k, v, b)
        o = pallas_flash(jnp.asarray(qh, dtype), jnp.asarray(kh, dtype),
                         jnp.asarray(vh, dtype), jnp.asarray(pq),
                         jnp.asarray(pk[b]), window=window, bq=bq, bk=bk,
                         interpret=True)
        outs.append(from_heads(np.asarray(o.astype(jnp.float32)),
                               q.shape[2], q.shape[3]))
    return np.stack(outs)


def port(q, k, v, pq, pk, window=None, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    out = port_ops.flash_attention(*t, torch.from_numpy(pq),
                                   torch.from_numpy(pk), window=window)
    assert out.dtype == dtype and tuple(out.shape) == q.shape
    return out.to(torch.float32).numpy()


@pytest.mark.parametrize("B,KV,G,Sq,Sk,dh", [
    (2, 2, 2, 64, 64, 16),
    (1, 8, 1, 64, 64, 16),      # MHA
    (2, 1, 4, 32, 96, 16),      # MQA + longer keys than queries
    (1, 2, 3, 128, 128, 32),
])
@pytest.mark.parametrize("window", [None, 32])
def test_plain_matches_pallas(B, KV, G, Sq, Sk, dh, window):
    q, k, v, pq, pk = make(B, KV, G, Sq, Sk, dh, seed=KV * G)
    exp = pallas_reference(q, k, v, pq, pk, window)
    got = port(q, k, v, pq, pk, window)
    err = float(np.max(np.abs(got - exp)))
    assert err < F32_ABS, f"max abs err {err} (bound {F32_ABS})"


def test_bf16_inputs():
    q, k, v, pq, pk = make(2, 2, 2, 64, 64, 16, seed=3)
    got = port(q, k, v, pq, pk, dtype=torch.bfloat16)
    exp = np.stack([from_heads(np.asarray(jax_oracle(
        *map(jnp.asarray, per_head(q, k, v, b)), jnp.asarray(pq),
        jnp.asarray(pk[b]))), 2, 2) for b in range(2)])
    err = float(np.max(np.abs(got - exp)))
    assert err < BF16_ABS, f"max abs err {err} (bound {BF16_ABS})"


def test_invalid_slots_ignored():
    q, k, v, pq, pk = make(2, 2, 1, 16, 32, 16, seed=4)
    pk[:, 5] = -1
    v_poison = v.copy()
    v_poison[:, 5] = 1e4
    a = port(q, k, v, pq, pk)
    b = port(q, k, v_poison, pq, pk)
    assert float(np.max(np.abs(a - b))) < 1e-5
    exp = pallas_reference(q, k, v_poison, pq, pk, bq=8, bk=16)
    err = float(np.max(np.abs(b - exp)))
    assert err < F32_ABS, f"max abs err {err} (bound {F32_ABS})"


@pytest.mark.parametrize("window", [None, 8])
def test_decode_shape_with_invalid_slots(window):
    """Sq = 1 against a cache whose rows hold −1 slots (and Sk = 40, not a
    multiple of the kernel's key tile)."""
    q, k, v, _, pk = make(3, 2, 4, 1, 40, 16, seed=8, invalid=6)
    pq = np.array([33], np.int32)
    got = port(q, k, v, pq, pk, window)
    exp = pallas_reference(q, k, v, pq, pk, window, bq=1, bk=8)
    err = float(np.max(np.abs(got - exp)))
    assert err < F32_ABS, f"max abs err {err} (bound {F32_ABS})"


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("window", [None, 16])
def test_chunked_attention_matches_reference(impl, window):
    """The models' entry, both impls, against the reference's scan (its
    naive impl) with 2-D key positions and invalid slots."""
    q, k, v, pq, pk = make(2, 2, 2, 32, 48, 16, seed=11, invalid=5)
    exp = np.asarray(jax_chunked(
        *map(jnp.asarray, (q, k, v, pq, pk)), window=window, q_chunk=16,
        k_chunk=16, impl="naive"))
    got = chunked_attention(
        *map(torch.from_numpy, (q, k, v, pq, pk)), window=window,
        q_chunk=16, k_chunk=16, impl=impl).numpy()
    err = float(np.max(np.abs(got - exp)))
    assert err < F32_ABS, f"max abs err {err} (bound {F32_ABS})"


def test_wrapper_rejects_bad_operands():
    q, k, v, pq, pk = (torch.from_numpy(a)
                       for a in make(1, 2, 2, 4, 8, 16))
    with pytest.raises(ValueError, match="do not fit"):
        port_ops.flash_attention(q, k, v, pq[:3], pk)
    with pytest.raises(TypeError, match="share"):
        port_ops.flash_attention(q, k.to(torch.bfloat16), v, pq, pk)
    with pytest.raises(ValueError, match="no keys"):
        port_ops.flash_attention(q, k[:, :0], v[:, :0], pq, pk[:, :0])
    with pytest.raises(ValueError, match="dv"):    # v's slots differ
        port_ops.flash_attention(q, k, v[:, :7], pq, pk)


# (B, KV, G, Sq, Sk, dk, dv): value heads narrower than key heads, as in
# MLA (dk 192 / dv 128 at prefill, 576 / 512 at decode)
VALUE_WIDTHS = [(1, 2, 2, 8, 8, 16, 8), (2, 1, 4, 16, 24, 24, 16),
                (2, 2, 3, 12, 20, 20, 12)]


@pytest.mark.parametrize("shape", VALUE_WIDTHS)
@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("ref_impl", ["flash", "naive"])
def test_chunked_attention_value_width(shape, impl, ref_impl):
    """dv != dk through the models' entry, both impls, against the
    reference's chunked_attention (both impls): (B, Sq, KV, G, dv) out,
    within 1e-5 in float32."""
    B, KV, G, Sq, Sk, dk, dv = shape
    rng = np.random.default_rng(dk * 100 + dv)
    q = rng.normal(size=(B, Sq, KV, G, dk)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, dk)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, dv)).astype(np.float32)
    pq = np.arange(Sk - Sq, Sk, dtype=np.int32)
    pk = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    pk[-1, 1] = -1
    exp = np.asarray(jax_chunked(
        *map(jnp.asarray, (q, k, v, pq, pk)), q_chunk=4, k_chunk=4,
        impl=ref_impl))
    got = chunked_attention(*map(torch.from_numpy, (q, k, v, pq, pk)),
                            q_chunk=4, k_chunk=4, impl=impl).numpy()
    assert got.shape == (B, Sq, KV, G, dv) == exp.shape
    err = float(np.max(np.abs(got - exp)))
    assert err < 1e-5, f"max abs err {err}"


def ring_cache(B, Sc, pos, seed):
    """kpos of a ring of Sc slots after writing positions 0..pos at slot
    p % Sc, batch row b holding b fewer tokens: unsorted, −1 where
    nothing was written."""
    pk = np.full((B, Sc), -1, np.int32)
    for b in range(B):
        for p in range(max(0, pos - b - Sc + 1), pos - b + 1):
            pk[b, p % Sc] = p
    return pk


# (name, B, KV, G, Sq, Sk, dk, dv, window, splits)
SPLIT_CASES = [
    ("one split", 2, 2, 4, 1, 37, 16, 16, None, 1),
    ("two splits", 2, 2, 4, 1, 37, 16, 8, None, 2),
    ("three splits, window", 2, 1, 4, 1, 40, 24, 16, 8, 3),
    ("seven splits", 3, 2, 2, 1, 50, 16, 16, None, 7),
    ("more splits than slots", 2, 2, 4, 1, 5, 16, 12, None, 9),
    ("rows of several queries", 2, 2, 4, 4, 33, 20, 12, 16, 3),
    ("ring cache, window", 3, 1, 10, 1, 16, 16, 16, 16, 3),
    ("ring cache, short window", 3, 1, 4, 1, 16, 8, 8, 5, 4),
    ("a row that sees no key", 2, 2, 4, 1, 24, 16, 16, None, 5),
    ("poisoned unseen values", 2, 2, 4, 1, 30, 16, 16, 12, 4),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_split_kv_plain_matches_plain(case):
    """The split route's algorithm (partial (m, l, acc) per contiguous
    range of slots, merged in order) equals plain masked softmax: split
    counts 1, 2, 3, 7 and more than there are slots; windows; ring caches
    with unsorted kpos; a row that sees no key (which averages V over all
    slots); unseen slots whose V is poisoned."""
    name, B, KV, G, Sq, Sk, dk, dv, window, splits = case
    rng = np.random.default_rng(len(name))
    q = rng.normal(size=(B, Sq, KV, G, dk)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, dk)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, dv)).astype(np.float32)
    pos = 40 if "ring" in name else Sk - 1
    pq = np.arange(pos - Sq + 1, pos + 1, dtype=np.int32)
    if "ring" in name:
        pk = ring_cache(B, Sk, pos, 0)
    else:
        pk = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
        pk[:, Sk - 3:] = -1
    if "sees no key" in name:
        pk[1] = -1                    # batch row 1: every slot unseen
    if "poisoned" in name:
        v[pk < 0] = 1e4
        v[:, :pos - window + 1] = 1e4      # outside the window
    t = [torch.from_numpy(a) for a in (q, k, v, pq, pk)]
    exp = fref.ref_flash_attention(*t, window=window)
    got = fref.split_kv_flash_attention(*t, splits=splits, window=window)
    assert got.shape == (B, Sq, KV, G, dv)
    err = float((got - exp).abs().max())
    assert err < 1e-5, f"max abs err {err}"
    if "sees no key" in name:
        mean = t[2][1].mean(dim=0)                         # (KV, dv)
        assert torch.allclose(got[1], mean[None, :, None, :].expand_as(
            got[1]), atol=1e-5)
    if "poisoned" in name:
        assert float(got.abs().max()) < 10.0


N_SPLIT = port_ops.SPLIT_MAX_ROWS
N_TC = port_ops.TC_MAX_HEAD_DIM
BF16, F32 = torch.bfloat16, torch.float32
# (Sq, G, dtype, dk, dv, route)
ROUTE_CASES = [
    (1, 4, F32, 128, 128, "split_kv"), (1, 16, BF16, 128, 128, "split_kv"),
    (1, N_SPLIT, F32, 128, 128, "split_kv"),
    (1, N_SPLIT + 1, F32, 128, 128, "tiled"), (128, 4, F32, 128, 128, "tiled"),
    (128, 1, F32, 128, 128, "tiled"),
    (1, 16, BF16, 576, 512, "split_kv"),          # MLA decode
    (1, N_SPLIT + 1, BF16, 128, 128, "tensor_core"),
    (128, 4, BF16, 128, 128, "tensor_core"),      # Qwen3-4B prefill
    (128, 16, BF16, 192, 128, "tensor_core"),     # MLA prefill
    (128, 10, BF16, N_TC, N_TC, "tensor_core"),   # recurrentgemma prefill
    (128, 4, BF16, 36, 100, "tensor_core"),
    (128, 4, BF16, N_TC + 1, 128, "tiled"), (128, 4, BF16, 64, N_TC + 8,
                                             "tiled"),
    (128, 16, BF16, 576, 512, "tiled"), (128, 4, F32, 64, 64, "tiled"),
]


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_route_rule(case):
    """Up to SPLIT_MAX_ROWS query rows per (batch, kv head) pair take the
    split route (every decode of the repo's configs: Sq 1, G <= 16); more
    take the tensor-core one in bf16 with dk, dv <= TC_MAX_HEAD_DIM
    (prefill), else the tiled one (float32, wider heads)."""
    sq, g, dtype, dk, dv, expected = case
    assert port_ops.route(sq, g, dtype, dk, dv) == expected
    assert set(port_ops.ROUTES) == {"tiled", "split_kv", "tensor_core"}


@pytest.mark.parametrize("dtype,dk,dv", [(F32, 64, 64), (BF16, N_TC + 1, 64),
                                         (BF16, 64, 576)])
def test_tensor_core_route_refuses(dtype, dk, dv):
    """Forced onto the tensor-core route, float32 or a head size above
    TC_MAX_HEAD_DIM raises before any library is built: no fallback."""
    q = torch.zeros((1, 2, 1, 64, dk), dtype=dtype)
    k = torch.zeros((1, 8, 1, dk), dtype=dtype)
    v = torch.zeros((1, 8, 1, dv), dtype=dtype)
    pos = torch.arange(8, dtype=torch.int32)
    out = torch.empty((1, 2, 1, 64, dv), dtype=dtype)
    with pytest.raises(ValueError, match="tensor_core"):
        port_ops._launch(q, k, v, pos[-2:], pos[None], out, None, 0.1,
                         "tensor_core")


@pytest.mark.parametrize("dk,dv", [(16, 16), (64, 64), (128, 128),
                                   (192, 128), (256, 256), (576, 512)])
def test_config_head_sizes_on_cpu(dk, dv):
    """Every head size of the repo's configs goes through flash_attention
    on the CPU and equals the reference's chunked_attention (its plain
    scan, which takes dv != dk) on the same inputs, within 1e-5."""
    rng = np.random.default_rng(dk + dv)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((1, 2, 1, 2, dk), (1, 6, 1, dk), (1, 6, 1, dv)))
    pq = np.array([4, 5], np.int32)
    pk = np.arange(6, dtype=np.int32)[None, :]
    got = port_ops.flash_attention(*map(torch.from_numpy,
                                        (q, k, v, pq, pk))).numpy()
    assert got.shape == (1, 2, 1, 2, dv)
    exp = np.asarray(jax_chunked(*map(jnp.asarray, (q, k, v, pq, pk)),
                                 impl="naive"))
    err = float(np.max(np.abs(got - exp)))
    assert err < 1e-5, f"max abs err {err}"


def tc_inputs(B, KV, G, Sq, Sk, dk, dv, *, seed, ring=False, late_keys=0,
              empty_batch_row=False):
    """bf16 model-layout inputs, causal prefill positions (queries at the
    last Sq positions); ``ring``: Sk slots of a ring after position Sk +
    40 (unsorted kpos, −1 where nothing was written); ``late_keys``: key
    positions shifted up, so the first queries see no key;
    ``empty_batch_row``: the last batch row has no valid key. V at −1
    slots is poisoned."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((B, Sq, KV, G, dk), (B, Sk, KV, dk), (B, Sk, KV, dv)))
    last = Sk + 40 if ring else Sk - 1
    pq = np.arange(last - Sq + 1, last + 1, dtype=np.int32)
    if ring:
        pk = ring_cache(B, Sk, last, seed)
    else:
        pk = np.tile(np.arange(Sk, dtype=np.int32) + late_keys, (B, 1))
        pk[:, Sk - 3:] = -1
    if empty_batch_row:
        pk[-1] = -1
    v[pk < 0] = 1e4
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    return t + [torch.from_numpy(pq), torch.from_numpy(pk)]


@pytest.mark.parametrize("G", [1, 4, 10])
@pytest.mark.parametrize("window", [None, 40])
def test_tensor_core_plain_matches_pallas(G, window):
    """The tensor-core route's algorithm (tiles of 64 keys, blocks of 64
    rows skipping unseen tiles, P in bf16) against the reference's Pallas
    kernel in interpret mode on the same bf16 inputs, at the reference's
    bf16 tolerance: causal prefill, Sq = Sk = 130 (three key tiles, the
    last ragged; up to 21 row blocks)."""
    rng = np.random.default_rng(G * 7 + (window or 0))
    B, KV, Sq, Sk, dh = 2, 2, 130, 130, 16
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((B, Sq, KV, G, dh), (B, Sk, KV, dh), (B, Sk, KV, dh)))
    q, k, v = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
               for a in (q, k, v))
    pq = np.arange(Sq, dtype=np.int32)
    pk = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    exp = pallas_reference(q, k, v, pq, pk, window, dtype=jnp.bfloat16,
                           bq=256, bk=512)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = fref.tensor_core_flash_attention(
        *t, torch.from_numpy(pq), torch.from_numpy(pk), window=window)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == q.shape
    err = float(np.max(np.abs(got.float().numpy() - exp)))
    assert err < BF16_ABS, f"max abs err {err} (bound {BF16_ABS})"


# (name, B, KV, G, Sq, Sk, dk, dv, window, options of tc_inputs)
TC_CASES = [
    ("causal prefill, G 4", 2, 2, 4, 130, 130, 32, 32, None, {}),
    ("G 1", 2, 3, 1, 150, 150, 16, 16, None, {}),
    ("G 10", 1, 1, 10, 70, 140, 32, 32, None, {}),
    ("window", 2, 1, 4, 200, 200, 16, 16, 50, {}),
    ("dv != dk", 2, 2, 4, 96, 96, 48, 24, None, {}),
    ("dv > dk, Sk not a multiple of 64", 1, 2, 4, 20, 150, 16, 40, None, {}),
    ("ring cache, unsorted positions, window", 2, 1, 10, 30, 100, 16, 16,
     64, {"ring": True}),
    ("a row that sees no key", 2, 2, 4, 100, 100, 16, 16, None,
     {"late_keys": 20}),
    ("a batch row with no key", 3, 1, 4, 40, 90, 16, 16, 30,
     {"empty_batch_row": True}),
]


@pytest.mark.parametrize("case", TC_CASES, ids=[c[0] for c in TC_CASES])
def test_tensor_core_plain_matches_plain(case):
    """The tensor-core route's algorithm against plain masked softmax on
    the same bf16 inputs, within 1e-2 of max |plain| (the card's bf16
    bound: rounding P to bf16 moves an output by at most 2^-9 of max |v|);
    with tile skipping equal bit for bit to the full walk when every row
    sees a key; a row that sees no key averages V over all Sk slots (the
    block walks every tile again)."""
    name, B, KV, G, Sq, Sk, dk, dv, window, opts = case
    t = tc_inputs(B, KV, G, Sq, Sk, dk, dv, seed=len(name), **opts)
    exp = fref.ref_flash_attention(*t, window=window)
    got = fref.tensor_core_flash_attention(*t, window=window)
    full = fref.tensor_core_flash_attention(*t, window=window, skip=False)
    assert got.shape == exp.shape == (B, Sq, KV, G, dv)
    assert got.dtype == torch.bfloat16
    err = float((got.float() - exp.float()).abs().max())
    bound = 1e-2 * float(exp.float().abs().max())
    assert err < bound, f"max abs err {err} (bound {bound:.3e})"
    _, _, _, pq, pk = t
    seen = (pk[:, None, :] >= 0) & (pk[:, None, :] <= pq[None, :, None])
    if window is not None:
        seen &= (pq[None, :, None] - pk[:, None, :]) < window
    blind = ~seen.any(-1)                               # (B, Sq)
    if not bool(blind.any()):
        assert torch.equal(got, full)
    else:
        assert "no key" in name
        mean = t[2].float().mean(dim=1)                 # (B, KV, dv)
        want = mean[:, None, :, None, :].expand(B, Sq, KV, G, dv)
        sel = blind[:, :, None, None, None].expand_as(want)
        assert torch.allclose(got.float()[sel], want[sel], rtol=1e-2)
        assert torch.equal(got, full)
