"""The port's data pipeline (``repro_torch.data``) against the JAX
package's: counterparts of ``tests/test_sharding_and_data.py``'s data
tests, and every batch bit-equal (same arrays, same dtypes) to
``repro.data.pipeline.make_batch``'s for the token, vision-patch and
audio-frame frontends, shards included.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data.synthetic import SyntheticTokens as JSyntheticTokens  # noqa: E402,E501
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.data import Prefetcher, SyntheticTokens, make_batch  # noqa: E402,E501

ARCHS = ["qwen3-4b", "llava-next-mistral-7b", "musicgen-medium"]


def cfg(arch="qwen3-4b"):
    return pconfigs.get_config(arch, smoke=True)


def assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


def test_stream_deterministic_and_stateless():
    s = SyntheticTokens(1000, seed=3)
    a = s.block(1000, 128)
    b = np.concatenate([s.block(1000, 64), s.block(1064, 64)])
    assert np.array_equal(a, b)


@pytest.mark.parametrize("vocab,seed,start,length", [
    (1000, 3, 1000, 128), (151936, 0, 0, 1025), (2, 7, 511, 3),
    (32000, 11, 2**33, 600)])
def test_stream_equals_the_reference(vocab, seed, start, length):
    a = SyntheticTokens(vocab, seed=seed).block(start, length)
    b = JSyntheticTokens(vocab, seed=seed).block(start, length)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_make_batch_resume_equivalence():
    b1 = make_batch(cfg(), batch=4, seq=32, step=7)
    b2 = make_batch(cfg(), batch=4, seq=32, step=7)
    assert_batches_equal(b1, b2)


def test_make_batch_shards_disjoint_and_consistent():
    full = make_batch(cfg(), batch=8, seq=32, step=3)
    lo = make_batch(cfg(), batch=8, seq=32, step=3, lo=0, hi=4)
    hi = make_batch(cfg(), batch=8, seq=32, step=3, lo=4, hi=8)
    assert np.array_equal(full["tokens"],
                          np.concatenate([lo["tokens"], hi["tokens"]]))


def test_labels_are_shifted_inputs():
    b = make_batch(cfg(), batch=2, seq=32, step=0)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_separator_positions_masked():
    b = make_batch(cfg(), batch=4, seq=600, step=0)
    assert (b["mask"] == (b["labels"] != 0)).all()
    assert (b["mask"] == 0).sum() > 0               # doc_len=512 < 600


def test_prefetcher_orders_steps():
    pf = Prefetcher(lambda s: make_batch(cfg(), batch=2, seq=16, step=s),
                    start_step=5)
    try:
        for expect in (5, 6, 7):
            step, batch = pf.get()
            assert step == expect
            assert_batches_equal(batch, make_batch(cfg(), batch=2, seq=16,
                                                   step=expect))
    finally:
        pf.close()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("step,seed,lo,hi", [
    (0, 0, 0, None), (3, 0, 0, 4), (3, 0, 4, 8), (17, 5, 2, 7)])
def test_batches_equal_the_reference(arch, step, seed, lo, hi):
    """Tokens, labels, masks, patch and frame embeddings: the reference's
    arrays bit for bit, with their dtypes, whole and sharded."""
    seq = 40 if arch == "llava-next-mistral-7b" else 24
    kw = dict(batch=8, seq=seq, step=step, seed=seed, lo=lo, hi=hi)
    got = make_batch(pconfigs.get_config(arch, smoke=True), **kw)
    ref = jpipeline.make_batch(jconfigs.get_config(arch, smoke=True), **kw)
    assert_batches_equal(got, ref)
    assert all(isinstance(v, np.ndarray) for v in got.values())
