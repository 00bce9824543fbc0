"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

The library is built at first use from the sources in this package, into
``build/torch_kernels/<hash of the sources>/`` at the repository root (a
directory ``.gitignore`` lists), so a fresh checkout builds its own kernels
and a changed source never loads a stale library. Nothing here runs at
import time: the CPU tests import every module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
BUILD_ROOT = _HERE.parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> (sources, {C function: (argtypes)})
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
LIBRARIES = {
    "rowops": (
        (_HERE / "rowops" / "csrc" / "rowops.cu",),
        {
            "rowops_shift_cols": (_P, _P, _I, _I, _I, _P),
            "rowops_bitwise": (_P, _P, _P, _P, _L, _I, _P),
            "rowops_bitwise_rows": (_P, _P, _P, _P, _P, _P, _P, _I, _P, _I,
                                    _I, _L, _I, _P),
            "rowops_shift_rows_cluster_words": (),
            "rowops_shift_rows": (_P, _P, _L, _P, _P, _P, _I, _I, _L, _I,
                                  _P),
            "rowops_meter_fold": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _P),
            "rowops_fadd_chain": (_P, _P, _P, _I, _P),
            "rowops_ripple_add": (_P, _P, _P, _L, _I, _I, _P),
        },
    ),
    "pim_matmul": (
        (_HERE / "pim_matmul" / "csrc" / "pim_matmul.cu",),
        {
            "pim_matmul_splits": (_I, _I, _I, _I, _I),
            "pim_matmul": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _P),
            "pim_matmul_tc_splits": (_I, _I, _I, _I, _I),
            "pim_matmul_tc_smem_bytes": (),
            "pim_matmul_tc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _P),
            "pim_matmul_swap_splits": (_I, _I, _I, _I, _I),
            "pim_matmul_swap": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P),
        },
    ),
    "flash_attn": (
        (_HERE / "flash_attn" / "csrc" / "flash_attn.cu",),
        {
            "flash_attn_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _I, _F, _I, _P, _P),
            "flash_attn_tc": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _F, _P, _P),
            "flash_attn_tc_smem_bytes": (_I, _I, _I),
            "flash_attn_split_kv_splits": (_I, _I, _I, _I, _I, _I, _I),
            "flash_attn_split_kv": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _F, _I, _I, _P, _P),
        },
    ),
}

_loaded: dict = {}
_lock = threading.Lock()
BUILD_SECONDS: dict = {}    # name -> seconds nvcc took in this process
BUILD_LOG: dict = {}        # name -> nvcc's report (ptxas registers, smem)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    sources, _ = LIBRARIES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile library ``name`` unless a build of the same sources exists.
    Writes to a temporary file and renames it, so a concurrent or cut
    build never leaves a half-written library behind."""
    import time

    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    sources, _ = LIBRARIES[name]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        BUILD_LOG[name] = proc.stdout + proc.stderr
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with every C
    entry's ``argtypes`` and ``restype`` declared."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in LIBRARIES[name][1].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _loaded[name] = lib
    return lib
