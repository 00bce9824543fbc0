"""The port's examples (``examples/*_torch.py``) on the CPU: the two
PIM examples print the reference examples' lines exactly (DDR3 ns and nJ,
AAP/ACT counts, the VM routines' µs and nJ, the trace round-trip), and
the LM examples run to their own assertions at a small size.
"""
import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = os.path.join(ROOT, "examples")


def load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_stdout(name, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = load(name).main(argv)
    return buf.getvalue(), out


def reference_stdout(name):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, os.path.join(EXAMPLES,
                                                        f"{name}.py")],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("name", ["quickstart", "pim_crypto"])
def test_pim_example_prints_the_reference_lines(name):
    got, _ = port_stdout(f"{name}_torch", ["--device", "cpu"])
    want = reference_stdout(name)
    assert len(want.splitlines()) > 5
    assert got.splitlines() == want.splitlines()


def test_serve_lm_example_on_the_cpu():
    text, (out, out2, out_q) = port_stdout("serve_lm_torch",
                                           ["--device", "cpu"])
    assert torch.equal(out, out2) and out.shape == (4, 24)
    assert out_q.shape == (4, 8) and out.device.type == "cpu"
    assert "pim_w4 (shift-and-add bit planes) decode: (4, 8) OK" in text


def test_train_lm_example_on_the_cpu(tmp_path):
    text, hist = port_stdout("train_lm_torch", [
        "--device", "cpu", "--steps", "60", "--batch", "4", "--seq", "64",
        "--layers", "2", "--vocab", "1000", "--ckpt-dir", str(tmp_path)])
    lines = text.splitlines()
    assert lines[-1] == "OK: loss decreased"
    assert lines[0].startswith("arch=qwen3-4b-100m  params=")
    assert len(hist["loss"]) == 60 and hist["skipped"] == 0
    assert sorted(os.listdir(tmp_path)) == ["step_00000050",
                                            "step_00000060"]


def test_examples_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("quickstart_torch", "pim_crypto_torch", "serve_lm_torch",
                 "train_lm_torch"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_stdout(name, [])
