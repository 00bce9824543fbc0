"""Import hygiene and device rules of the PyTorch port.

The port imports neither JAX, the reference package nor ``ml_dtypes``
(its checkpoints carry bf16 as uint16 bits), runs on the CUDA
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
    r"from\s+repro(\.|\s)|import\s+ml_dtypes\b|from\s+ml_dtypes\b)", re.M)


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch, repro_torch.core.pim, "
            "repro_torch.core.bitplane, "
            "repro_torch.kernels.rowops.ops, repro_torch.convert, "
            "repro_torch.configs, repro_torch.models, "
            "repro_torch.models.ssm, repro_torch.models.rglru, "
            "repro_torch.kernels.pim_matmul.ops, "
            "repro_torch.kernels.flash_attn.ops, repro_torch.serve.engine, "
            "repro_torch.serve.pim_front, repro_torch.core.pim.lint, "
            "repro_torch.core.pim.sem, repro_torch.core.pim.variation, "
            "repro_torch.launch.serve, repro_torch.models.flash, "
            "repro_torch.optim, repro_torch.optim.adamw, "
            "repro_torch.optim.schedule, repro_torch.optim.grad_compress, "
            "repro_torch.train, repro_torch.train.step, "
            "repro_torch.data, repro_torch.data.pipeline, "
            "repro_torch.data.synthetic, repro_torch.ckpt, "
            "repro_torch.ckpt.checkpoint, repro_torch.train.loop, "
            "repro_torch.train.fault, repro_torch.launch.train, "
            "repro_torch.launch.mesh, repro_torch.launch.sharding, "
            "repro_torch.launch.roofline, repro_torch.launch.dryrun\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro', "
            "'ml_dtypes') or m.startswith(('jax.', 'repro.', 'ml_dtypes.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_source_file_imports_jax_or_the_reference():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
             if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    examples = os.path.join(ROOT, "examples")
    files.extend(os.path.join(examples, f) for f in os.listdir(examples)
                 if f.endswith("_torch.py"))
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            text = f.read()
        assert not FORBIDDEN.search(text), path
        # the dry-run traces on a fake process group, not on XLA's forced
        # host devices
        assert "XLA_FLAGS" not in text, path


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from repro_torch.core import pim
    from repro_torch.core.bitplane import PimVM, gf
    from repro_torch.core.pim import lint
    from repro_torch.serve.pim_front import PimServeFront
    cfg = pim.DeviceConfig(channels=1, ranks=1, banks_per_rank=2,
                           num_rows=16, words=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: pim.make_subarray(),
                 lambda: pim.make_bank(2, 16, 4),
                 lambda: pim.make_device(pim.paper_device(1, 16, 4)),
                 lambda: pim.execute(pim.shift_workload_program(1, 16, 4)),
                 lambda: pim.CostMeter.zeros(),
                 lambda: PimVM(width=8, words=2),
                 lambda: PimVM(width=8, words=4, n_banks=2),
                 lambda: gf.aes_xtime_cost(2),
                 lambda: PimServeFront(cfg),
                 lambda: pim.shift_failure_rate(5.0),
                 lambda: lint.main(["--workloads"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert pim.make_subarray(16, 4, device="cpu").bits.device.type == "cpu"
    vm = PimVM(width=8, words=4, n_banks=2, device="cpu")
    assert vm._device.banks.bits.device.type == "cpu"
    assert PimVM(width=8, words=2, device="cpu").state.bits.device.type \
        == "cpu"
    assert PimServeFront(cfg, device="cpu").device.device.type == "cpu"
    assert pim.shift_failure_rate(5.0, 100, device="cpu").device.type \
        == "cpu"
    assert lint.main(["--workloads", "--no-semantic", "--device",
                      "cpu"]) == 0


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
            return 1 if name.endswith("_splits") else 0
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
    monkeypatch.setattr(fa, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    x = torch.zeros((4, 8), dtype=torch.bfloat16)
    pm.pim_matmul(x, torch.zeros((8, 3), dtype=torch.int8), torch.ones(3))
    x = torch.zeros((4, 32), dtype=torch.bfloat16)    # the swapped operands
    pm.pim_matmul(x, torch.zeros((32, 48), dtype=torch.int8), torch.ones(48))
    fa.reset_launches()
    fa._splits.cache_clear()
    q = torch.zeros((1, 2, 1, 2, 16))          # 4 rows: the split route
    k = torch.zeros((1, 3, 1, 16))
    fa.flash_attention(q, k, k, torch.arange(1, 3), torch.arange(3))
    q = torch.zeros((1, 40, 1, 2, 16))         # 80 rows: the tiled route
    k = torch.zeros((1, 40, 1, 16))
    fa.flash_attention(q, k, k, torch.arange(40), torch.arange(40))
    q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)   # the tensor cores
    fa.flash_attention(q, k, k, torch.arange(40), torch.arange(40))
    fa._splits.cache_clear()
    assert lib.calls == ["pim_matmul_splits", "pim_matmul",
                         "pim_matmul_swap_splits", "pim_matmul_swap",
                         "flash_attn_split_kv_splits", "flash_attn_split_kv",
                         "flash_attn_fwd", "flash_attn_tc"]
    assert pm.LAUNCHES["pim_matmul"] >= 1
    assert fa.ROUTES == {"tiled": 1, "split_kv": 1, "tensor_core": 1}
    assert fa.LAUNCHES["flash_attn"] == 3
    pm.reset_launches()
    fa.reset_launches()


def test_ripple_add_on_the_card_goes_to_the_kernel(monkeypatch):
    """What a CUDA tensor takes in ripple_add: the kernel library, never the
    plain version, with one count per launch."""
    from types import SimpleNamespace

    from repro_torch.kernels.rowops import ops

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    lib = _FakeLib()
    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    monkeypatch.setattr(ops, "_lib", lambda: lib)
    monkeypatch.setattr(ops._ref, "ref_ripple_add", plain)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    ops.reset_launches()
    x = torch.zeros((4, 8), dtype=torch.int32)
    ops.ripple_add(x, x, width=8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ripple_add(x.T, x.T, width=8)
    assert lib.calls == ["rowops_ripple_add"]
    assert ops.LAUNCHES["ripple_add"] == 1
    ops.reset_launches()
