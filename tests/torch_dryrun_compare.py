"""Per-device flops of the port's dry-run against the reference dry-run's
cost analysis, every config's train, prefill and decode cells at the smoke
size (batch 8, 32 tokens) on a (2, 4) mesh: one line per cell with both
counts and their ratio. The reference lowers and compiles each cell on 8
forced host devices in a subprocess; the port traces it on a fake process
group (``dryrun.run_cell``). ``tests/test_torch_dryrun.py`` holds the cells
that agree; this table shows the ones that do not.

    PYTHONPATH=src python tests/torch_dryrun_compare.py
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k")
BATCH, SEQ = 8, 32

_REFERENCE = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import SHAPES, get_config
from repro.launch import roofline as rl
from repro.launch.dryrun import build_cell
cells, batch, seq = json.loads(sys.stdin.read())
mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
with mesh:
    for arch, name in cells:
        shape = dataclasses.replace(SHAPES[name], seq_len=seq,
                                    global_batch=batch)
        fn, args, _, _ = build_cell(get_config(arch, smoke=True), shape,
                                    mesh)
        compiled = fn.lower(*args).compile()
        roof, _ = rl.from_compiled(compiled, 8, 1.0,
                                   hlo_text=compiled.as_text())
        out[f"{arch}/{name}"] = roof.flops
print(json.dumps(out))
"""


def main() -> None:
    from repro_torch import configs
    from repro_torch.launch import dryrun
    cells = [(a, s) for a in configs.ARCH_IDS for s in SHAPE_NAMES]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _REFERENCE], env=env,
                           stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    ref_out, ref_err = ref.communicate(json.dumps([cells, BATCH, SEQ]))
    if ref.returncode:
        raise SystemExit(ref_err[-3000:])
    want = json.loads(ref_out.strip().splitlines()[-1])
    with tempfile.TemporaryDirectory() as d:
        for arch, name in cells:
            shape = dataclasses.replace(configs.SHAPES[name], seq_len=SEQ,
                                        global_batch=BATCH)
            rec = dryrun.run_cell(arch, name, "2x4", {"smoke": True},
                                  out_dir=d, shape=shape)
            got = rec.get("flops_per_device", float("nan"))
            w = want[f"{arch}/{name}"]
            print(f"{arch:24s} {name:12s} reference {w:>12.0f} "
                  f"port {got:>12.0f} ratio {got / w:.3f} {rec['status']}",
                  flush=True)


if __name__ == "__main__":
    main()
