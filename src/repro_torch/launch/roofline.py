"""Roofline terms of a dry-run cell (port of ``repro.launch.roofline``).

Three terms per (arch × shape × mesh), NVIDIA H100 SXM5 constants (the
card ``nvidia-smi --query-gpu=name,power.limit`` names "NVIDIA H100 80GB
HBM3", 700 W):

    T_compute    = flops_per_device / 989e12     [bf16 dense tensor core]
    T_memory     = hbm_bytes_per_device / 3.35e12  [HBM3]
    T_collective = link_bytes_per_device / 450e9   [NVLink 4, per direction]

Sources, the H100 datasheet (SXM5 column): 989.4 TFLOP/s bf16 dense
(1,979 with sparsity), 3.35 TB/s HBM3, 900 GB/s NVLink 4 per card, that is
450 GB/s in each direction. A ring that crosses a node boundary runs at
the network's rate (InfiniBand NDR, 50 GB/s per port), which this single
link term does not model: the reference makes the same simplification
with its one ``LINK_BW``.

The dry-run's counters hand in per-device flops and HBM bytes and one
``(kind, bytes, group size)`` record per collective; ``collective_bytes``
turns those into per-device link traffic with the reference's ring
factors:

    all-reduce       2 · bytes · (n−1)/n      (reduce-scatter + all-gather)
    all-gather       bytes · (n−1)/n          (bytes = full result)
    reduce-scatter   bytes · (n−1)           (bytes = the result shard)
    all-to-all       bytes · (n−1)/n
    collective-permute  bytes

An *analytic* FLOP model per cell (from the config) is reported alongside
— MODEL_FLOPS = 6·N·D for training, 2·N·D for inference (N = active
params).
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM5 (H100 80GB HBM3, 700 W)
PEAK_FLOPS = 989e12          # bf16 dense / card
HBM_BW = 3.35e12             # bytes/s / card
LINK_BW = 450e9              # bytes/s / card, NVLink 4, one direction

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(records, n_devices: int) -> dict:
    """Per-device link-traffic bytes by collective kind (ring model), from
    ``(kind, result bytes, group size)`` records; a record without a group
    size spans ``n_devices``."""
    out = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for kind, result_bytes, n in records:
        n = n_devices if n is None else n
        if n <= 1:
            continue
        ring = (n - 1) / n
        if kind == "all-reduce":
            traffic = 2.0 * result_bytes * ring
        elif kind == "all-gather":
            traffic = result_bytes * ring          # result = gathered size
        elif kind == "reduce-scatter":
            traffic = result_bytes * (n - 1)       # operand = result × n
        elif kind == "all-to-all":
            traffic = result_bytes * ring
        else:                                      # collective-permute
            traffic = result_bytes
        out[kind] += traffic
        counts[kind] += 1
    out["total"] = sum(out[k] for k in COLLECTIVES)
    out["counts"] = counts
    return out


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device flops
    hbm_bytes: float             # per-device bytes accessed
    link_bytes: float            # per-device collective link traffic
    chips: int
    model_flops: float           # analytic global model flops

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.link_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the bound: (MODEL_FLOPS/chips/peak) /
        max-term — the score-carrying number (1.0 = perfect)."""
        ideal = self.model_flops / self.chips / PEAK_FLOPS
        return ideal / max(self.bound_time, 1e-30)

    @property
    def flops_utilization(self) -> float:
        """MODEL_FLOPS / traced flops — remat/redundancy waste detector."""
        return self.model_flops / max(self.flops * self.chips, 1e-30)


def analytic_model_flops(cfg, shape_kind: str, seq: int, batch: int) -> float:
    tokens = batch * (seq if shape_kind in ("train", "prefill") else 1)
    n = cfg.n_active_params()
    per_tok = 6 * n if shape_kind == "train" else 2 * n
    return float(per_tok) * tokens
