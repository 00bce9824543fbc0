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
            "repro_torch.kernels.rowops.ops, repro_torch.convert\n"
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
