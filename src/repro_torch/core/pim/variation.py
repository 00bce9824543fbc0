"""Monte-Carlo process-variation reliability model (paper §5.2, Table 4).

Port of ``repro.core.pim.variation``: the same analytic model in plain
torch math (the reference computes it in ``jnp``, not in a Pallas kernel),
its normals drawn from a ``torch.Generator`` on the device. ``jax.random``
cannot be matched bit for bit, so the rate is held to :data:`PAPER_TABLE4`
within the reference test's bounds, and :func:`_sense_margin` to the
reference's on the same draws.

The paper's LTSPICE study perturbs cell capacitance, transistor W/L, and
bitline/wordline RC by a uniform ±p% and reports the fraction of 100,000
trials in which the 4-AAP shift fails. Charge sharing at each activation
develops a bitline swing

    dV = (Vdd/2) * Cc / (Cc + Cbl) * f_transfer

where f_transfer = 1 - exp(-t_share / (Ron * Cser)) captures incomplete
transfer through the access transistor within the allotted tRCD window (a
migration cell drives its *partner* bitline through the second port, so its
series resistance matters twice). The sense amplifier resolves correctly when
dV exceeds its input offset, modeled as N(0, sigma_sa) plus a fixed margin.
One shift = 4 AAPs = 8 sensing events; the shift fails if ANY event fails.

Constants are 22nm values from the paper's Table 1 (Vdd=1.2 V, Cc=25 fF,
BL C/cell=0.24 fF, 512 cells/bitline) with the sense-margin/transfer
constants calibrated once so the model reproduces Table 4 at the paper's
variation levels.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Tech22nm:
    vdd: float = 1.2
    wl_boost: float = 2.5
    c_cell_f: float = 25e-15
    cells_per_bl: int = 512
    c_bl_per_cell_f: float = 0.24e-15
    r_bl_per_cell: float = 0.120          # ohm (120 mohm)
    access_w: float = 44e-9
    access_l: float = 22e-9
    t_share_s: float = 13.5e-9            # tRCD window for charge sharing
    # Calibrated sensing constants (see module docstring):
    sa_sigma_v: float = 0.02              # sense-amp offset spread scale
    sa_sigma_sat: float = 0.06            # mismatch saturation level (tanh)
    sa_margin_v: float = 0.055            # deterministic margin requirement
    param_sigma_frac: float = 0.5         # +-p% read as a 2-sigma bound
    r_on_nominal: float = 8.0e3           # access-transistor on resistance


TECH22 = Tech22nm()
SENSE_EVENTS_PER_SHIFT = 8  # 4 AAPs x 2 activations


def _sense_margin(u: torch.Tensor, tech: Tech22nm) -> torch.Tensor:
    """Per-event margin given parameter draws u[..., 0:5] (float32), in the
    reference's order of operations.

    u slots: 0=cell cap, 1=bitline cap, 2=transistor W (conductance),
             3=transistor L (conductance, inverse), 4=threshold/overdrive.
    Scaled outside by the variation level p.
    """
    cc = tech.c_cell_f * (1.0 + u[..., 0])
    cbl = tech.cells_per_bl * tech.c_bl_per_cell_f * (1.0 + u[..., 1])
    # Conductance g ~ W/L * overdrive; Ron = 1/g.
    g_rel = (1.0 + u[..., 2]) / (1.0 + u[..., 3]) * (1.0 + 0.8 * u[..., 4])
    r_on = tech.r_on_nominal / torch.clamp_min(g_rel, 1e-3)
    # Migration cell drives through TWO access ports in series.
    tau = 2.0 * r_on * (cc * cbl / (cc + cbl))
    f_transfer = 1.0 - torch.exp(-tech.t_share_s / tau)
    dv = 0.5 * tech.vdd * cc / (cc + cbl) * f_transfer
    return dv - tech.sa_margin_v


def shift_failure_rate(variation_pct: float, n_trials: int = 100_000,
                       tech: Tech22nm = TECH22, *, generator=None,
                       device=None) -> torch.Tensor:
    """Fraction of Monte-Carlo trials in which a full shift fails: a 0-d
    float32 tensor on ``device`` (the card unless ``device="cpu"``).

    Each trial draws independent parameter sets for the 8 sensing events of
    one 4-AAP shift plus a per-event sense-amp offset; the shift fails if any
    event's margin falls below its offset. The normals come from
    ``generator``, which must live on ``device``; without one, a generator
    seeded with 0 is made there.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    elif generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, draws on "
                         f"{device}")
    p = variation_pct / 100.0
    # +-p% is read as a k-sigma bound (industry convention for corner specs).
    u = (p * tech.param_sigma_frac) * torch.randn(
        (n_trials, SENSE_EVENTS_PER_SHIFT, 5), generator=generator,
        device=device)
    margin = _sense_margin(u, tech)
    # Offset spread grows with local mismatch but saturates: beyond a point
    # the dominant mismatch sources (Vth pairs in the SA) are fully expressed.
    sigma = tech.sa_sigma_v * math.tanh(p / tech.sa_sigma_sat)
    offset = sigma * torch.randn((n_trials, SENSE_EVENTS_PER_SHIFT),
                                 generator=generator, device=device)
    event_fail = margin < torch.abs(offset)
    return torch.any(event_fail, dim=-1).to(torch.float32).mean()


PAPER_TABLE4 = {0.0: 0.0, 5.0: 0.005, 10.0: 0.14, 20.0: 0.30}
