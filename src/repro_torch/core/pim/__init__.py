"""In-DRAM PIM runtime in PyTorch: the paper's migration-cell shift + Ambit
ISA, the recorded-program compiler and executor, and the device scheduler.
Port of ``repro.core.pim`` (its main path; see ROADMAP.md for the rest)."""
from .state import (CostMeter, SubarrayState, make_bank, make_subarray,
                    EVEN_MASK, ODD_MASK, NUM_ROWS, ROW_BITS, ROW_WORDS,
                    WORD_BITS, resolve_device)
from .timing import (DDR3Timing, DEFAULT_TIMING, apply_refresh,
                     burst_time_ns, charge_copy, copy_cost,
                     cpu_movement_energy_nj, refresh_events,
                     refresh_events_scalar)
from .isa import (C0, C1, T0, T1, T2, T3, ambit_and, ambit_maj, ambit_not,
                  ambit_or, ambit_xor, dcc_to, dra, issue, lisa_copy,
                  maj3_words, not_to_dcc, read_row, reserve_control_rows,
                  rowclone, run_on_bits, run_program, shift,
                  shift_row_words, tra, write_row)
from .program import (ambit_xor_program, bank_parallel, estimate_cost,
                      run_shift_workload, shift_k, shift_workload_program)
from .ir import (COPY_SELF, PimOp, PimProgram, ProgramBuilder,
                 decode_payload, from_trace_banks, from_trace_device, record,
                 rle_encode_payload, sequence_digest, to_trace_banks,
                 to_trace_device, concat)
from .compile import (CompiledProgram, compile_program, cost_pass,
                      cost_summary, cost_tables, cost_tables_reference,
                      dead_copy_elimination, fuse, SHIFT_FUSE_MIN)
from .exec import ExecResult, RUNNER_STATS, execute, make_runner
from .device import (DeviceConfig, DeviceState, bus_time_ns,
                     channel_bus_model, channel_occupancy, device_wall_ns,
                     host_bus_ns, issue_bus_ns, make_device, paper_device)
from .schedule import (CopyDrainStats, SCHED_STATS, ScheduleResult,
                       compiled_for, gather_rows, schedule, shard_lanes,
                       shard_rows, stream_key, xor_reduce_program)


def reset_stats() -> None:
    """Zero the instrumentation counters (column builds, scheduler plan and
    compile misses and steps, runner builds, kernel launches), so
    stats-asserting code can run in any order."""
    from ...kernels.rowops.ops import reset_launches
    from .ir import COLUMN_STATS
    for counters in (COLUMN_STATS, SCHED_STATS, RUNNER_STATS):
        for k in counters:
            counters[k] = 0
    reset_launches()


__all__ = [
    "CostMeter", "SubarrayState", "make_bank", "make_subarray",
    "EVEN_MASK", "ODD_MASK", "NUM_ROWS", "ROW_BITS", "ROW_WORDS", "WORD_BITS",
    "resolve_device",
    "DDR3Timing", "DEFAULT_TIMING", "apply_refresh", "burst_time_ns",
    "charge_copy", "copy_cost", "cpu_movement_energy_nj", "refresh_events",
    "refresh_events_scalar",
    "C0", "C1", "T0", "T1", "T2", "T3", "ambit_and", "ambit_maj", "ambit_not",
    "ambit_or", "ambit_xor", "dcc_to", "dra", "issue", "lisa_copy",
    "maj3_words", "not_to_dcc", "read_row", "reserve_control_rows",
    "rowclone", "run_on_bits", "run_program", "shift", "shift_row_words",
    "tra", "write_row",
    "ambit_xor_program", "bank_parallel", "estimate_cost",
    "run_shift_workload", "shift_k", "shift_workload_program",
    "COPY_SELF", "PimOp", "PimProgram", "ProgramBuilder", "record",
    "decode_payload", "rle_encode_payload", "sequence_digest",
    "from_trace_banks", "from_trace_device", "to_trace_banks",
    "to_trace_device", "concat",
    "CompiledProgram", "compile_program", "cost_pass", "cost_summary",
    "cost_tables", "cost_tables_reference", "dead_copy_elimination", "fuse",
    "SHIFT_FUSE_MIN",
    "ExecResult", "RUNNER_STATS", "execute", "make_runner",
    "DeviceConfig", "DeviceState", "bus_time_ns", "channel_bus_model",
    "channel_occupancy", "device_wall_ns", "host_bus_ns", "issue_bus_ns",
    "make_device", "paper_device",
    "CopyDrainStats", "SCHED_STATS", "ScheduleResult", "compiled_for",
    "gather_rows", "schedule", "shard_lanes", "shard_rows", "stream_key",
    "xor_reduce_program", "reset_stats",
]
