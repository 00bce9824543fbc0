"""Analytic area-overhead model (paper §5.3 / §6, Tables 5 and the layout).
Port of ``repro.core.pim.area`` (plain Python floats, unchanged).

The migration-cell design adds, per 512-row subarray:
  - 2 rows of migration cells (each migration cell = two standard 1T1C cells
    whose capacitor top plates are wired together — no new devices),
  - 2 extra wordlines to drive the second access ports,
  - the plate-connect wiring itself.

Cell area uses the open-bitline 6F^2 figure; the comparison numbers for
SIMDRAM / DRISA variants are the published figures quoted in the paper.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AreaModel:
    rows_per_subarray: int = 512
    migration_rows: int = 2
    cell_area_f2: float = 6.0
    # Wiring/wordline overhead expressed as equivalent extra rows.
    wiring_equiv_rows: float = 1.0
    ambit_extra_pct: float = 1.0  # paper: implementing on top of Ambit ~ +1%

    @property
    def overhead_pct(self) -> float:
        extra = self.migration_rows + self.wiring_equiv_rows
        return 100.0 * extra / self.rows_per_subarray

    @property
    def overhead_with_ambit_pct(self) -> float:
        return self.overhead_pct + self.ambit_extra_pct


# Published comparison points quoted by the paper (Table 5).
PAPER_TABLE5 = [
    ("w/ Migration Cells", "Wiring", "<1% (without Ambit)"),
    ("SIMDRAM", "Control unit + Transposition unit", "0.2% (vs Intel Xeon CPU)"),
    ("DRISA 3T1C", "Shifters, controllers, bus, buffers", "~6.8% (vs 8Gb DRAM)"),
    ("DRISA 1T1C-nor", "NOR gates + latches + shifters", "~34% added circuits"),
    ("DRISA 1T1C-mixed", "Mixed logic gates + shifters", "~40% added circuits"),
    ("DRISA 1T1C-adder", "Adders + shifters", "~60% added circuits"),
]


def mim_capacitor_plate_side_um(c_farads: float = 25e-15,
                                eps_r: float = 20.0,
                                thickness_m: float = 8e-9) -> float:
    """Paper §6: HfO2 MIM capacitor plate sizing.  C = eps0*eps_r*A/d."""
    eps0 = 8.8854e-12
    area_m2 = c_farads * thickness_m / (eps0 * eps_r)
    return (area_m2 ** 0.5) * 1e6  # um
