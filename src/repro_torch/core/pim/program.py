"""PIM program construction & execution helpers.

Port of ``repro.core.pim.program``. A "program" is a recorded
:class:`~.ir.PimProgram` instruction stream run through the compiling
executor (``compile.py`` / ``exec.py``). For the paper's workloads:

    run_shift_workload(n_shifts)  — the NVMain experiment (Tables 2 & 3)
    shift_k                       — multi-bit shift by repetition (§8.0.3)
    bank_parallel(prog)           — §5.1.4: one compiled program, all banks

plus a static cost estimator mirroring the timing model.
"""
from __future__ import annotations

import functools

from . import isa
from .compile import CompiledProgram, compile_program
from .ir import PimProgram, ProgramBuilder
from .state import SubarrayState, as_rows, make_subarray
from .timing import DDR3Timing, DEFAULT_TIMING, refresh_events_scalar


def shift_k(state: SubarrayState, src: int, dst: int, k: int,
            cfg: DDR3Timing = DEFAULT_TIMING) -> SubarrayState:
    """Shift by |k| columns = |k| repeated 1-bit migration shifts (first
    src->dst, the rest dst->dst), recorded as IR and run fused."""
    from . import exec as pim_exec

    compiled = _shift_k_compiled(state.num_rows, state.words,
                                 int(src) % state.num_rows,
                                 int(dst) % state.num_rows, k, cfg)
    return pim_exec.execute(compiled, state, cfg).state


@functools.lru_cache(maxsize=256)
def _shift_k_compiled(num_rows: int, words: int, src: int, dst: int, k: int,
                      cfg: DDR3Timing) -> CompiledProgram:
    b = ProgramBuilder(num_rows, words)
    b.shift_k(src, dst, k)
    return compile_program(b.build(), cfg)


@functools.lru_cache(maxsize=256)
def shift_workload_program(n_shifts: int, num_rows: int = 512,
                           words: int = 2048,
                           verify: bool = False) -> PimProgram:
    """The recorded Table 2/3 instruction stream: one issue burst, then N
    chained 1-bit right shifts (row 0 → row 1 → row 1 …)."""
    if n_shifts < 1:
        raise ValueError("the workload is defined for at least one shift")
    b = ProgramBuilder(num_rows, words, verify=verify)
    b.issue()
    b.shift_k(0, 1, n_shifts)
    return b.build()


@functools.lru_cache(maxsize=256)
def ambit_xor_program(num_rows: int = 16, words: int = 2, *, a: int = 0,
                      b: int = 1, dst: int = 2,
                      read_back: bool = True) -> PimProgram:
    """The canonical recorded ``ambit_xor`` kernel: reserve control rows,
    expand ``dst <- a ^ b`` into its MAJ/NOT primitive sequence, and
    (optionally) read ``dst`` back."""
    builder = ProgramBuilder(num_rows, words)
    builder.reserve_control_rows()
    builder.ambit_xor(a, b, dst)
    if read_back:
        builder.read_row(dst)
    return builder.build()


@functools.lru_cache(maxsize=256)
def _shift_workload_compiled(n_shifts: int, num_rows: int,
                             words: int) -> CompiledProgram:
    return compile_program(shift_workload_program(n_shifts, num_rows, words))


def run_shift_workload(row, n_shifts: int, num_rows: int = 512,
                       words: int = 2048, *, device=None) -> SubarrayState:
    """The paper's NVMain workload: N full-row 1-bit right shifts in Bank 0
    Subarray 0, sequentially, with periodic refresh folded in at the end.
    ``row`` is a (words,) int32 tensor or uint32 numpy row."""
    from . import exec as pim_exec

    state = isa.reserve_control_rows(make_subarray(num_rows, words,
                                                   device=device))
    state.bits[0] = as_rows(row, state.device)
    compiled = _shift_workload_compiled(n_shifts, num_rows, words)
    return pim_exec.execute(compiled, state, refresh=True).state


def bank_parallel(fn: PimProgram | CompiledProgram, n_banks: int,
                  cfg: DDR3Timing = DEFAULT_TIMING):
    """§5.1.4: run the same PIM program concurrently in the ``n_banks``
    banks of a batch of states: wall time is the max over banks while
    energy sums. The reference also maps plain callables with ``vmap``; the
    port takes recorded or compiled programs only (the batch's leading
    axis sets the bank count, as in the reference's program path)."""
    from . import exec as pim_exec
    return pim_exec.bank_parallel(fn, cfg)


def estimate_cost(n_shifts: int = 0, n_aaps: int = 0, n_tras: int = 0,
                  cfg: DDR3Timing = DEFAULT_TIMING) -> dict:
    """Static cost model for planning PIM programs (float64 DDR3 model
    outputs)."""
    t = (n_shifts * cfg.t_shift + n_aaps * cfg.t_aap + n_tras * cfg.tRC
         + cfg.t_issue)
    n_ref = refresh_events_scalar(t, cfg)
    t += n_ref * cfg.tRFC
    e_act = (n_shifts * 8 + n_aaps * 2 + n_tras) * cfg.e_act \
        + n_tras * 2 * cfg.e_act_extra_row
    e_pre = (n_shifts * 4 + n_aaps + n_tras) * cfg.e_pre
    e_ref = n_ref * cfg.e_ref
    e_bg = t * cfg.p_background
    return {
        "time_ns": t,
        "energy_nj": e_act + e_pre + e_ref + e_bg,
        "e_act": e_act, "e_pre": e_pre, "e_refresh": e_ref,
        "n_refresh": n_ref,
    }
