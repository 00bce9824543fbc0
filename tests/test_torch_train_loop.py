"""The port's training loop (``repro_torch.train.loop.train_loop``) and CLI
(``repro_torch.launch.train``) on the CPU: counterparts of
``tests/test_train_and_ckpt.py``'s resume tests, bit for bit; the loop
against the reference's ``train_loop`` on the same weights and data; a
failed step retried; a preempted run resumed; the CLI's ``done:`` line.

Bounds of the comparison with the reference (float32 overrides, 3 steps,
the reference's ``init_params`` weights carried across by
``convert.lm_params_from_numpy``): those of
``test_torch_train.py::test_train_step_matches_reference``, the loss
within rtol 1e-5 per step and every trainable leaf within 5e-2 (Adam's
update is about lr·sign(g) per step, which flips where a grad is near
zero). Measured on the CPU: the losses within 1.7e-7 relative, the
leaves within 1.1e-6 (``stack/attn/wv``).
"""
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.loop import train_loop as jax_train_loop  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy  # noqa: E402,E501
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.transformer import param_tree, tree_leaves  # noqa: E402,E501
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import loop as loop_mod  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

CFG = pconfigs.get_config("qwen3-4b", smoke=True)
CPU = "cpu"
quiet = lambda *a: None  # noqa: E731


def run(steps, d=None, every=50, **kw):
    return train_loop(CFG, steps=steps, batch=4, seq=32, ckpt_dir=d,
                      ckpt_every=every, log=quiet, device=CPU, **kw)


def leaves(model) -> list:
    """Every tensor of the model's reference tree, codes included, in the
    tree's order."""
    out = []
    for _, leaf in tree_leaves(param_tree(model)):
        out.extend(leaf if isinstance(leaf, list) else [leaf])
    return [t.detach() for t in out]


def assert_models_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def assert_checkpoints_equal(d1, d2, step):
    """Two checkpoints of one step: the same manifest and every array (the
    trainable leaves, both moments, the step counter) bit for bit."""
    p1, p2 = (os.path.join(d, f"step_{step:08d}") for d in (d1, d2))
    with open(os.path.join(p1, "manifest.json")) as f1, \
            open(os.path.join(p2, "manifest.json")) as f2:
        assert f1.read() == f2.read()
    with np.load(os.path.join(p1, "host0.npz")) as z1, \
            np.load(os.path.join(p2, "host0.npz")) as z2:
        assert sorted(z1.files) == sorted(z2.files)
        assert any(k.startswith("opt__mu__") for k in z1.files)
        for k in z1.files:
            assert np.array_equal(z1[k], z2[k]), k


def test_checkpoint_resume_continues_exactly(tmp_path):
    d = str(tmp_path)
    run(10, d, every=5)
    assert checkpoint.latest_step(d) == 10
    _, hist2 = run(14, d, every=5)
    assert len(hist2["loss"]) == 4       # resumed at step 10


def test_resume_matches_uninterrupted_run(tmp_path):
    """Fault-tolerance invariant: crash+restore == never crashed, every
    parameter, moment and the step counter bit for bit."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    run(4, d1, every=4)
    m_once, _ = run(8, d2, every=8)
    # run 1: interrupted at 4 (retention keeps step 4), resume to 8
    m_resumed, hist = run(8, d1, every=4)
    assert len(hist["loss"]) == 4
    assert_models_equal(m_once, m_resumed)
    assert_checkpoints_equal(d1, d2, 8)


def test_loop_matches_the_reference_loop(monkeypatch):
    """3 steps of the port's loop against the reference's ``train_loop``
    from the reference's weights (float32 overrides, lr 1e-2, warmup
    cosine): the same data, the losses within rtol 1e-5, the final params
    within 5e-2 (the bounds of ``test_train_step_matches_reference``)."""
    over = dict(dtype="float32")
    jcfg = jconfigs.get_config("qwen3-4b", smoke=True, **over)
    pcfg = pconfigs.get_config("qwen3-4b", smoke=True, **over)
    kw = dict(steps=3, batch=4, seq=32, seed=0, log=quiet)
    sched = dict(warmup_steps=1, total_steps=10)
    from repro.optim.schedule import warmup_cosine as jwc

    from repro_torch.optim.schedule import warmup_cosine as pwc
    ref_params, ref_hist = jax_train_loop(
        jcfg, opt_cfg=jadamw.AdamWConfig(lr=1e-2),
        schedule_fn=lambda s: jwc(s, **sched), **kw)
    start = jax.tree.map(np.asarray, jax_init(jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(loop_mod, "init_params",
                        lambda cfg, seed, device=None: lm_params_from_numpy(
                            cfg, start, device=device))
    model, hist = train_loop(pcfg, opt_cfg=adamw.AdamWConfig(lr=1e-2),
                             schedule_fn=lambda s: pwc(s, **sched),
                             device=CPU, **kw)
    np.testing.assert_allclose(hist["loss"], ref_hist["loss"], rtol=1e-5)
    assert hist["skipped"] == ref_hist["skipped"] == 0
    got = dict(tree_leaves(lm_params_to_numpy(model)))
    ref = {"/".join(k.key for k in path): np.asarray(leaf, np.float32)
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               ref_params)[0]}
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        assert np.max(np.abs(got[key].astype(np.float32) - r)) < 5e-2, key


def test_failed_step_is_retried(tmp_path, monkeypatch):
    """A step that raises once (the third) is retried after the newest
    checkpoint is restored in place; the run ends as an unfaulted one,
    bit for bit."""
    make = loop_mod.make_train_step

    def flaky(*args, **kwargs):
        step_fn = make(*args, **kwargs)
        calls = {"n": 0}

        def step(model, opt, batch):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("injected step failure")
            return step_fn(model, opt, batch)
        return step

    m_clean, h_clean = run(5, str(tmp_path / "clean"), every=1)
    monkeypatch.setattr(loop_mod, "make_train_step", flaky)
    lines = []
    model, hist = train_loop(CFG, steps=5, batch=4, seq=32,
                             ckpt_dir=str(tmp_path / "flaky"), ckpt_every=1,
                             log=lines.append, device=CPU)
    assert hist["retries"] == 1 and h_clean["retries"] == 0
    assert any(line.startswith("[fault] step failed (RuntimeError: "
                               "injected step failure); recovery attempt "
                               "1/2") for line in lines)
    assert hist["loss"] == h_clean["loss"]
    assert_models_equal(model, m_clean)


def test_preempted_run_resumes_exactly(tmp_path):
    """SIGTERM during the first step's log line: the loop saves at step 1
    and stops; the resumed run ends equal to an uninterrupted one."""
    d, d_once = str(tmp_path / "pre"), str(tmp_path / "once")
    lines = []

    def log(line):
        lines.append(line)
        if line.startswith("step "):
            handler = signal.getsignal(signal.SIGTERM)
            assert getattr(handler, "__self__", None).__class__.__name__ \
                == "PreemptionGuard", handler
            os.kill(os.getpid(), signal.SIGTERM)

    _, hist = train_loop(CFG, steps=6, batch=4, seq=32, ckpt_dir=d,
                         ckpt_every=50, log=log, device=CPU)
    assert len(hist["loss"]) == 1 and checkpoint.latest_step(d) == 1
    assert "[preempt] SIGTERM at step 1: saved and exiting" in lines
    assert signal.getsignal(signal.SIGTERM) is not log
    m_resumed, hist2 = run(6, d)
    m_once, _ = run(6, d_once)
    assert len(hist2["loss"]) == 5
    assert_models_equal(m_resumed, m_once)
    assert_checkpoints_equal(d, d_once, 6)


def test_cli_prints_the_done_line(capsys):
    hist = train_cli.main(["--arch", "qwen3-4b", "--smoke", "--steps", "3",
                           "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == (f"done: 3 steps, final loss {hist['loss'][-1]:.4f}, "
                       f"skipped 0, stragglers {hist['stragglers']}")
    assert out[0].startswith("step     0 loss ")


def test_loop_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop(CFG, steps=1, batch=2, seq=8, log=quiet)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "qwen3-4b", "--smoke", "--steps", "1"])
