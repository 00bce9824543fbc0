"""Import hygiene and device rules of the PyTorch port.

The port imports neither JAX nor the reference package, runs on the CUDA
card unless the caller asks for the CPU, and never sends a CUDA tensor to a
plain version.
"""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch, repro_torch.core.pim, "
            "repro_torch.kernels.rowops.ops, repro_torch.convert, "
            "repro_torch.configs, repro_torch.models, "
            "repro_torch.kernels.pim_matmul.ops, "
            "repro_torch.kernels.flash_attn.ops, repro_torch.serve.engine, "
            "repro_torch.launch.serve\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_source_file_imports_jax_or_the_reference():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            text = f.read()
        assert not FORBIDDEN.search(text), path


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from repro_torch.core import pim
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: pim.make_subarray(),
                 lambda: pim.make_bank(2, 16, 4),
                 lambda: pim.make_device(pim.paper_device(1, 16, 4)),
                 lambda: pim.execute(pim.shift_workload_program(1, 16, 4)),
                 lambda: pim.CostMeter.zeros()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert pim.make_subarray(16, 4, device="cpu").bits.device.type == "cpu"


def test_cuda_states_refuse_the_plain_path():
    from repro_torch.core.pim import exec as pim_exec
    from repro_torch.kernels.rowops import ops
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match="use_kernels=False"):
        pim_exec._kernels_for(False, cuda)
    assert pim_exec._kernels_for(None, cuda) is True
    assert pim_exec._kernels_for(None, torch.device("cpu")) is False
    assert ops._on_card(torch.zeros(1, device="meta").new_empty(
        (1,), device="cpu")) is False
    with pytest.raises(ValueError):
        ops._on_card(torch.zeros(1, device="meta"))


def test_lm_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve.engine import greedy_generate

    cfg = get_config("qwen3-4b", smoke=True, n_layers=1)
    model = init_params(cfg, 0, device="cpu")
    batch = {"tokens": np.zeros((1, 4), np.int32)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: init_params(cfg, 0),
                 lambda: lm_params_from_numpy(cfg, {}),
                 lambda: prefill(cfg, model, batch, 8),
                 lambda: greedy_generate(cfg, model, batch,
                                         max_new_tokens=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    _, caches = prefill(cfg, model, batch, 8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_step(cfg, model, {"tokens": batch["tokens"][:, :1]}, 4,
                    caches)
    out = greedy_generate(cfg, model, batch, max_new_tokens=2, device="cpu")
    assert out.shape == (1, 2) and out.device.type == "cpu"


class _FakeLib:
    """Stands in for a built kernel library: records each C call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append(name)
            return 1 if name == "pim_matmul_splits" else 0
        return call


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    """What a CUDA tensor takes in pim_matmul and flash_attention: the
    device decides (``_on_card``), and on the card the wrapper goes to the
    kernel library and never to the plain version."""
    from types import SimpleNamespace

    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.kernels.pim_matmul import ops as pm

    cuda_like = SimpleNamespace(device=torch.device("cuda"))
    cpu_like = SimpleNamespace(device=torch.device("cpu"))
    for ops in (pm, fa):
        assert ops._on_card(cuda_like) is True
        assert ops._on_card(cpu_like) is False
        with pytest.raises(ValueError):
            ops._on_card(torch.zeros(1, device="meta"))

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    lib = _FakeLib()
    for ops, ref_name in ((pm, "ref_pim_matmul_raw"),
                          (fa, "ref_flash_attention")):
        monkeypatch.setattr(ops, "_on_card", lambda x: True)
        monkeypatch.setattr(ops, "_lib", lambda: lib)
        monkeypatch.setattr(ops._ref, ref_name, plain)
    monkeypatch.setattr(pm, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    x = torch.zeros((4, 8), dtype=torch.bfloat16)
    pm.pim_matmul(x, torch.zeros((8, 3), dtype=torch.int8), torch.ones(3))
    q = torch.zeros((1, 2, 1, 2, 16))
    k = torch.zeros((1, 3, 1, 16))
    fa.flash_attention(q, k, k, torch.arange(1, 3), torch.arange(3))
    assert lib.calls == ["pim_matmul_splits", "pim_matmul",
                         "flash_attn_fwd"]
    assert pm.LAUNCHES["pim_matmul"] >= 1 and fa.LAUNCHES["flash_attn"] >= 1
    pm.reset_launches()
    fa.reset_launches()
