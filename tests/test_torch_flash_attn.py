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
