"""The port's checkpoints (``repro_torch.ckpt.checkpoint``) against the JAX
package's: counterparts of ``tests/test_train_and_ckpt.py``'s atomicity
and retention tests, and the two packages' checkpoints read by each other
bit for bit (bf16 ``qwen3-4b`` at the smoke size, with and without its
``pim_w4`` linears, with the compression residual), with equal manifests;
bf16 saved and restored in a process that never imports ``ml_dtypes``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.models import init_params as jax_init  # noqa: E402
from repro.train.step import init_train_state as jax_init_state  # noqa: E402,E501
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.ckpt import checkpoint  # noqa: E402
from repro_torch.ckpt.checkpoint import Stacked, train_state  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.train import init_train_state  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CPU = "cpu"
META = {"arch": "qwen3-4b", "seq": 32, "batch": 4}


def test_checkpoint_atomicity_ignores_tmp(tmp_path):
    d = str(tmp_path)
    params = {"a": torch.arange(4.0)}
    checkpoint.save(d, 1, params)
    os.makedirs(os.path.join(d, "step_00000002.tmp.999"), exist_ok=True)
    assert checkpoint.latest_step(d) == 1
    restored, _ = checkpoint.restore(d, 1, {"a": torch.zeros(4)})
    assert torch.equal(restored["a"], params["a"])


def test_checkpoint_retention(tmp_path):
    d = str(tmp_path)
    for s in range(1, 6):
        checkpoint.save(d, s, {"x": torch.ones(2) * s}, keep=2)
    steps = [f for f in os.listdir(d) if f.startswith("step_")]
    assert len(steps) == 2
    assert checkpoint.latest_step(d) == 5


def test_restore_is_in_place_and_checks_shapes(tmp_path):
    """Tensors and each layer of a stacked leaf keep their storage; a
    dtype, shape or layer count other than the checkpoint's raises."""
    d = str(tmp_path)
    layers = [torch.randn(3, 2, dtype=torch.bfloat16) for _ in range(4)]
    tree = {"w": Stacked(layers), "s": torch.tensor(5, dtype=torch.int32),
            "list": [torch.arange(3, dtype=torch.int8)]}
    checkpoint.save(d, 3, tree)
    z = np.load(os.path.join(d, "step_00000003", "host0.npz"))
    assert z["w"].dtype == np.uint16 and z["w"].shape == (4, 3, 2)
    assert sorted(z.files) == ["list__0", "s", "w"]
    dst = [torch.zeros(3, 2, dtype=torch.bfloat16) for _ in range(4)]
    ptrs = [t.data_ptr() for t in dst]
    s = torch.zeros((), dtype=torch.int32)
    codes = torch.zeros(3, dtype=torch.int8)
    got, manifest = checkpoint.restore(
        d, 3, {"w": Stacked(dst), "s": s, "list": [codes]})
    assert got["s"] is s and got["list"][0] is codes
    assert [t.data_ptr() for t in dst] == ptrs
    for a, b in zip(dst, layers):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert int(s) == 5 and torch.equal(codes, tree["list"][0])
    assert manifest["keys"]["w"] == {"shape": [4, 3, 2], "dtype": "bfloat16"}
    for bad in ({"w": Stacked(dst[:3]), "s": s, "list": [codes]},
                {"w": Stacked(dst), "s": s.float(), "list": [codes]},
                {"w": Stacked(dst), "s": s, "list": [codes[:2]]}):
        with pytest.raises(ValueError):
            checkpoint.restore(d, 3, bad)


# ---------------------------------------------------------------------------
# Interchange with the reference's checkpoints
# ---------------------------------------------------------------------------

CASES = [({}, False), ({"quant": "pim_w4"}, False),
         ({"quant": "pim_w4"}, True)]


def bits(a) -> np.ndarray:
    """An array or tensor as its raw bits (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def port_flat(model, opt) -> dict:
    """The port's training state, flat, each leaf's bits (layers
    stacked)."""
    out = {}
    for k, v in checkpoint._flatten(train_state(model, opt)).items():
        if isinstance(v, Stacked):
            v = torch.stack([t.detach() for t in v.tensors])
        out[k] = bits(v)
    return out


def reference_state(overrides, compress, seed):
    """The reference's {"train", "opt"} for the bf16 smoke config, the
    moments (and residual) random float32 and the step 7."""
    jcfg = jconfigs.get_config("qwen3-4b", smoke=True, **overrides)
    params = jax_init(jcfg, jax.random.PRNGKey(seed))
    train, _, opt = jax_init_state(jcfg, params, compress)
    rng = np.random.default_rng(seed)
    rand = lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32)  # noqa: E731,E501
    opt = {k: (jnp.asarray(7, jnp.int32) if k == "step"
               else jax.tree.map(rand, v)) for k, v in opt.items()}
    return {"train": train, "opt": opt}


def port_state(overrides, compress, seed):
    pcfg = pconfigs.get_config("qwen3-4b", smoke=True, **overrides)
    model = init_params(pcfg, seed, device=CPU)
    opt = init_train_state(model, compress)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for key in ("mu", "nu", "residual"):
            for t in opt.get(key, []):
                t.copy_(torch.randn(t.shape, generator=gen))
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    return model, opt


@pytest.mark.parametrize("overrides,compress", CASES)
def test_reference_checkpoint_restores_into_the_port(tmp_path, overrides,
                                                     compress):
    d = str(tmp_path)
    ref = reference_state(overrides, compress, 0)
    jckpt.save(d, 7, ref, meta=META)
    model, opt = port_state(overrides, compress, 1)
    ptrs = [t.data_ptr() for t in opt["mu"]]
    _, manifest = checkpoint.restore(d, 7, train_state(model, opt),
                                     model=model)
    ref_flat = {k: bits(v) for k, v in jckpt._flatten(ref).items()}
    got = port_flat(model, opt)
    assert sorted(got) == sorted(ref_flat)
    assert any(k.startswith("opt/residual/") for k in got) == compress
    for k, r in ref_flat.items():
        assert got[k].dtype == r.dtype and np.array_equal(got[k], r), k
    assert [t.data_ptr() for t in opt["mu"]] == ptrs
    assert torch.equal(model.head_f32, model.embed.detach().float())
    assert manifest["meta"] == META and manifest["step"] == 7


@pytest.mark.parametrize("overrides,compress", CASES)
def test_port_checkpoint_restores_into_the_reference(tmp_path, overrides,
                                                     compress):
    d_port, d_ref = str(tmp_path / "port"), str(tmp_path / "ref")
    os.makedirs(d_port)
    os.makedirs(d_ref)
    model, opt = port_state(overrides, compress, 2)
    checkpoint.save(d_port, 7, train_state(model, opt), meta=META)
    skeleton = reference_state(overrides, compress, 3)
    restored, manifest = jckpt.restore(d_port, 7, skeleton)
    want = port_flat(model, opt)
    got = {k: bits(v) for k, v in jckpt._flatten(restored).items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
    for (a, b) in zip(jax.tree.leaves(restored), jax.tree.leaves(skeleton)):
        assert a.dtype == b.dtype and a.shape == b.shape
    # the two packages' manifests of the same state agree
    jckpt.save(d_ref, 7, skeleton, meta=META)

    def manifest_of(d):
        with open(os.path.join(d, "step_00000007", "manifest.json")) as f:
            return json.load(f)

    assert manifest_of(d_port) == manifest_of(d_ref) == manifest
    assert os.listdir(os.path.join(d_port, "step_00000007")) \
        == os.listdir(os.path.join(d_ref, "step_00000007"))


_NO_ML_DTYPES = r"""
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "ml_dtypes" or name.startswith("ml_dtypes."):
            raise ImportError("ml_dtypes is blocked")
        return None
sys.meta_path.insert(0, _Block())
import numpy as np, torch
from repro_torch.ckpt import checkpoint
d, ref_dir = sys.argv[1], sys.argv[2]
want = np.load(ref_dir + "/bits.npy")
t = torch.from_numpy(want.view(np.int16)).view(torch.bfloat16)
checkpoint.save(d, 1, {"w": t, "layers": checkpoint.Stacked([t, t])})
w, l0, l1 = (torch.zeros_like(t) for _ in range(3))
got, man = checkpoint.restore(d, 1, {"w": w, "layers": checkpoint.Stacked([l0, l1])})
assert man["keys"]["w"]["dtype"] == "bfloat16"
for x in (w, l0, l1):
    assert np.array_equal(x.view(torch.int16).numpy().view(np.uint16), want)
r = torch.zeros_like(t)
checkpoint.restore(ref_dir, 1, {"w": r})
assert np.array_equal(r.view(torch.int16).numpy().view(np.uint16), want)
assert "ml_dtypes" not in sys.modules
print("ok")
"""


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    """In a process where ``ml_dtypes`` cannot be imported: bf16 (NaN,
    ±inf, ±0, subnormals, random) saved and restored bit for bit, and the
    reference's bf16 checkpoint (raw two-byte void in its npz) read as the
    same bits."""
    ref_dir = str(tmp_path / "ref")
    os.makedirs(ref_dir)
    special = np.array([0x7FC0, 0x7F80, 0xFF80, 0x0000, 0x8000, 0x0001,
                        0x807F, 0x3F80], np.uint16)
    rng = np.random.default_rng(0)
    want = np.concatenate([special, rng.integers(0, 2**16, 56,
                                                 dtype=np.uint16)])
    want = want.reshape(8, 8)
    np.save(os.path.join(ref_dir, "bits.npy"), want)
    jckpt.save(ref_dir, 1, {"w": jnp.asarray(want.view(jnp.bfloat16))})
    with np.load(os.path.join(ref_dir, "step_00000001", "host0.npz")) as z:
        assert z["w"].dtype.kind == "V" and z["w"].dtype.itemsize == 2
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_ML_DTYPES, str(tmp_path / "port"),
         ref_dir], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
