"""Parity of the port's multi-tenant PIM serving front end
(``repro_torch.serve.pim_front``) with the JAX reference, on the CPU.

Counterparts of ``tests/test_pim_serve.py`` and of the multi-tenant leg of
``tests/test_pim_differential.py`` (``_assert_multitenant_agrees``). Each
scenario runs once per package on programs recorded with the same builder
calls (or read from the same trace), keeps the reference test's own
assertions, and returns what it observed. Tolerance: exact equality of
placements, admission errors (message and lint codes), per-slot bits,
reads, integer meters, float32 time and energy per slot (as bit patterns),
tenant reports (float64 busy and energy, wall percentiles), coalescing,
dispatch and plan counts and ``reconcile()``.
"""
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pim as ref  # noqa: E402
from repro.serve import pim_front as ref_front  # noqa: E402
from repro_torch.core import pim as port  # noqa: E402
from pim_serve_scenarios import (FLOAT_FIELDS, INT_FIELDS,  # noqa: E402
                                 SCENARIOS, WORDS, cfg_of, front_obs, plain,
                                 port_kit)
from test_pim_differential import _build_program  # noqa: E402

REF = types.SimpleNamespace(
    name="ref", pim=ref, front=ref_front,
    sched=importlib.import_module("repro.core.pim.schedule"),
    make=lambda cfg, **kw: ref_front.PimServeFront(cfg, **kw),
    numpy=lambda x: np.asarray(x))
PORT = port_kit("cpu")
KITS = (REF, PORT)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_the_reference(name):
    got = []
    for k in KITS:
        k.pim.reset_stats()
        got.append(SCENARIOS[name](k))
    assert got[1] == got[0]


# ---------------------------------------------------------------------------
# The multi-tenant differential leg, port against port and reference
# ---------------------------------------------------------------------------

def tenants_of(seed, n_steps):
    """The reference leg's random tenants: sizes, layouts and per-step
    payloads from one seed, as reference programs."""
    rng = np.random.default_rng(seed)
    sizes = [1, int(rng.integers(1, 3))]
    if sum(sizes) < 4 and rng.random() < 0.5:
        sizes.append(int(rng.integers(1, 4 - sum(sizes) + 1)))
    tenants = {}
    for i, nb in enumerate(sizes):
        layout = [_build_program(rng, int(rng.integers(1, 10)))
                  if rng.random() < 0.8 else None for _ in range(nb)]
        if all(p is None for p in layout):
            layout[0] = _build_program(rng, 3)
        steps = [[p.with_payloads(
                      rng.integers(0, 2**32, (len(p.payloads), WORDS),
                                   dtype=np.uint32))
                  if p is not None else None for p in layout]
                 for _ in range(n_steps)]
        tenants[f"t{i}"] = (nb, steps)
    return tenants


def to_port(steps):
    return [[None if p is None else port.PimProgram.from_trace(p.to_trace())
             for p in s] for s in steps]


def run_front(k, tenants):
    cfg = cfg_of(k)
    front = k.make(cfg)
    placements = {tid: front.submit(tid, steps, banks=nb)
                  for tid, (nb, steps) in tenants.items()}
    reads = {tid: [] for tid in tenants}
    for res in front.run():
        for tid in res.placements:
            got = res.tenant_reads(tid)
            reads[tid].extend(got if res.n_steps > 1 else [got])
    return front, placements, reads


@pytest.mark.parametrize("seed", range(6))
def test_multitenant_agrees_with_isolated_and_the_reference(seed):
    n_steps = 1 + seed % 3
    tenants_r = tenants_of(seed, n_steps)
    tenants_p = {tid: (nb, to_port(steps))
                 for tid, (nb, steps) in tenants_r.items()}
    REF.pim.reset_stats()
    front_r, _, reads_r = run_front(REF, tenants_r)
    PORT.pim.reset_stats()
    front_p, placements, reads_p = run_front(PORT, tenants_p)

    # port == reference: the shared device, reads, reports, reconcile
    assert front_obs(PORT, front_p) == front_obs(REF, front_r)
    assert plain(reads_p) == plain(reads_r)

    # port == the port's tenants run alone on private slices
    rec = front_p.reconcile()
    shared = front_p.device
    for tid, (nb, steps) in tenants_p.items():
        dev = port.make_device(cfg_of(PORT).subdevice(nb), device="cpu")
        reads_iso = []
        for s in steps:
            r = port.schedule(dev, s)
            dev = r.state
            reads_iso.append(r.reads)
        banks = list(placements[tid].banks)
        assert torch.equal(shared.banks.bits[banks], dev.banks.bits), tid
        for f in INT_FIELDS + FLOAT_FIELDS:
            assert torch.equal(getattr(shared.banks.meter, f)[banks],
                               getattr(dev.banks.meter, f)), (tid, f)
        assert plain(reads_p[tid]) == plain(reads_iso), tid
        rep = front_p.report(tid)
        assert rep.energy_nj == float(
            dev.slot_energy_nj.numpy().astype(np.float64).sum())
        assert rep.busy_ns == float(
            dev.slot_time_ns.numpy().astype(np.float64).sum())
        assert rep.host_bytes == sum(
            p.host_bytes for s in steps for p in s if p is not None)
    np.testing.assert_allclose(rec["tenant_energy_nj"],
                               rec["device_energy_nj"], rtol=1e-9)
    np.testing.assert_allclose(rec["tenant_busy_ns"],
                               rec["device_busy_ns"], rtol=1e-9)
    assert rec["tenant_host_bytes"] == rec["device_host_bytes"]
