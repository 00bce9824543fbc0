"""Quickstart on the PyTorch port: the paper's in-DRAM shift on the
``repro_torch`` PIM runtime.

Shifts an 8KB row by one bit via the two migration-cell rows (4 AAP
commands), validates the result, and prints the DDR3-1333 timing/energy next
to the paper's NVMain numbers (Tables 2-3), then records the same shift
chain as a program and runs it through the compiled executor. Every line
it prints equals ``examples/quickstart.py``'s.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is asked for.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

import numpy as np
import torch

from repro_torch.core import pim


def u32(rows: torch.Tensor) -> np.ndarray:
    """int32 row bits as the reference's uint32 words."""
    return rows.cpu().numpy().view(np.uint32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    device = pim.resolve_device(args.device)

    rng = np.random.default_rng(0)
    row = rng.integers(0, 2**32, (2048,), dtype=np.uint32)

    def on_device(words):
        return torch.from_numpy(words.view(np.int32)).to(device)

    print("=== one full-row 1-bit right shift (4 AAPs, Fig. 3) ===")
    state = pim.reserve_control_rows(pim.make_subarray(device=device))
    state = pim.write_row(state, 0, row)
    e0, t0 = float(state.meter.total_energy_nj), float(state.meter.time_ns)
    state = pim.issue(state)
    state = pim.shift(state, src=0, dst=1, delta=+1)

    got = u32(state.bits[1])
    expect = u32(pim.shift_row_words(on_device(row), +1))
    assert np.array_equal(got, expect), "shift result mismatch!"
    print(f"shifted 65,536 bits: OK   "
          f"(mig_top captured even columns: "
          f"{bool((state.mig_top & pim.ODD_MASK).max() == 0)})")
    print(f"AAP commands: {int(state.meter.n_aap)}  "
          f"ACTIVATEs: {int(state.meter.n_act)}")
    print(f"latency : {float(state.meter.time_ns)-t0:8.1f} ns   "
          f"(paper: 208.7 ns)")
    print(f"energy  : {float(state.meter.total_energy_nj)-e0:8.2f} nJ   "
          f"(paper: 31.32 nJ)")

    print("\n=== Ambit + shift = functionally complete PIM ===")
    a = rng.integers(0, 2**32, (2048,), dtype=np.uint32)
    b = rng.integers(0, 2**32, (2048,), dtype=np.uint32)
    s = pim.write_row(pim.write_row(state, 2, a), 3, b)
    s = pim.ambit_and(s, 2, 3, 4)
    s = pim.ambit_xor(s, 2, 3, 5)
    s = pim.shift(s, 5, 6, +1)
    assert np.array_equal(u32(s.bits[4]), a & b)
    assert np.array_equal(u32(s.bits[6]),
                          u32(pim.shift_row_words(on_device(a ^ b), 1)))
    print("AND, XOR, then shift the XOR row: OK")

    print("\n=== the paper's Table 2/3 workloads ===")
    for n in (1, 50, 100, 512):
        st = pim.run_shift_workload(row, n, device=device)
        print(f"{n:4d} shifts: {float(st.meter.time_ns):10.1f} ns  "
              f"{float(st.meter.total_energy_nj):9.2f} nJ  "
              f"({float(st.meter.total_energy_nj)/n/8:4.2f} nJ/KB)")

    print("\n=== recorded program: IR -> cost pass -> compiled executor ===")
    b = pim.ProgramBuilder(num_rows=512, words=2048)
    b.reserve_control_rows()
    b.write_row(0, row)
    b.issue()
    b.shift_k(0, 1, 1000)
    prog = b.build()
    summ = pim.cost_summary(prog, refresh=True)
    print(f"recorded {len(prog)} commands; closed-form cost: "
          f"{summ['time_ns']:.1f} ns, {summ['energy_nj']:.1f} nJ")
    res = pim.execute(prog, refresh=True, device=device)
    print(f"compiled executor meter: {float(res.state.meter.time_ns):.1f} ns "
          f"(bit-exact vs the eager ISA; the 1000-shift chain runs as ONE "
          f"fused kernel shift)")
    trace = prog.to_trace()
    back = pim.PimProgram.from_trace(trace)
    print(f"trace round-trip: {len(trace.splitlines())} lines, "
          f"ops preserved: {back.ops == prog.ops}")


if __name__ == "__main__":
    main()
