"""Crypto case study (paper §8.0.2) on the PyTorch port: AES GF(2^8)
arithmetic and Reed-Solomon encoding entirely in-DRAM — horizontal data,
migration-cell shifts, Ambit bitwise ops — on the ``repro_torch`` bit-plane
VM, verified against numpy oracles, with DDR3 cost accounting. Every line
it prints equals ``examples/pim_crypto.py``'s.

    PYTHONPATH=src python examples/pim_crypto_torch.py [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is asked for.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

import numpy as np

from repro_torch.core.bitplane import PimVM, arith, gf, rs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    device = ap.parse_args(argv).device

    rng = np.random.default_rng(0)

    print("=== shift-and-add multiplication (paper §1 motivation) ===")
    vm = PimVM(width=8, num_rows=96, words=8,
               device=device)                   # 32 byte lanes
    a = rng.integers(0, 256, vm.lanes)
    b = rng.integers(0, 256, vm.lanes)
    t0, e0 = vm.time_ns, vm.energy_nj
    prod = arith.mul_shift_add(vm, vm.load(a), vm.load(b))
    assert np.array_equal(vm.read(prod), arith.ref_mul(a, b, 8))
    print(f"8-bit x 8-bit on {vm.lanes} lanes: OK  "
          f"[{(vm.time_ns-t0)/1e3:.1f} us, {vm.energy_nj-e0:.0f} nJ DDR3]")

    print("\n=== AES xtime + GF(2^8) multiply (MixColumns core) ===")
    vm = PimVM(width=8, num_rows=96, words=8, device=device)
    state_col = rng.integers(0, 256, vm.lanes)
    coef = rng.integers(0, 256, vm.lanes)
    ra, rb = vm.load(state_col), vm.load(coef)
    x2 = gf.xtime(vm, ra)
    x3 = vm.alloc()
    vm.xor(x2, ra, x3)                              # x3 = xtime(a) ^ a = 3·a
    gm = gf.gf_mul(vm, ra, rb)
    assert np.array_equal(vm.read(x2), gf.ref_xtime(state_col))
    assert np.array_equal(
        vm.read(x3), gf.ref_xtime(state_col) ^ state_col.astype(np.uint64))
    assert np.array_equal(vm.read(gm), gf.ref_gf_mul(state_col, coef))
    print(f"xtime, 3x, full GF mul on {vm.lanes} lanes: OK  "
          f"(shifts used: {vm.counts()['n_shift']})")

    print("\n=== Reed-Solomon RS(n, k) parity, one codeword per lane ===")
    k, npar = 8, 4
    vm = PimVM(width=8, num_rows=120, words=4, device=device)
    msg = rng.integers(0, 256, size=(k, vm.lanes))
    regs = [vm.load(msg[i]) for i in range(k)]
    t0, e0 = vm.time_ns, vm.energy_nj
    parity = rs.rs_encode(vm, regs, npar)
    got = np.stack([vm.read(r) for r in parity])
    ref = rs.ref_rs_encode(msg, npar)
    assert np.array_equal(got, ref)
    cw = np.concatenate([msg.astype(np.uint64), ref[::-1]], axis=0)
    assert not rs.ref_rs_syndromes(cw, npar).any(), "syndromes nonzero!"
    cw[3, 0] ^= 0x11
    assert rs.ref_rs_syndromes(cw, npar).any(), "corruption undetected!"
    print(f"encoded {vm.lanes} codewords ({k} data + {npar} parity): OK; "
          f"syndromes zero; corruption detected")
    print(f"[{(vm.time_ns-t0)/1e3:.1f} us, {vm.energy_nj-e0:.0f} nJ DDR3 "
          f"model — zero bytes moved off-chip]")

    print("\n=== device level: the same RS encode, lanes sharded over "
          "8 banks (§5.1.4) ===")
    vm8 = PimVM(width=8, num_rows=120, words=32, n_banks=8,
                device=device)
    msg8 = rng.integers(0, 256, size=(k, vm8.lanes))
    regs8 = [vm8.load(msg8[i]) for i in range(k)]
    parity8 = rs.rs_encode(vm8, regs8, npar)
    got8 = np.stack([vm8.read(r) for r in parity8])
    assert np.array_equal(got8, rs.ref_rs_encode(msg8, npar))
    print(f"encoded {vm8.lanes} codewords across {vm8.n_banks} banks: OK")
    print(f"[wall {vm8.time_ns/1e3:.1f} us = bus + max over banks; "
          f"{vm8.energy_nj:.0f} nJ summed across banks]")


if __name__ == "__main__":
    main()
