"""The port's Table 4 and Table 5 models against the JAX reference, on the
CPU.

``shift_failure_rate`` draws its normals from a ``torch.Generator``, which
cannot reproduce ``jax.random``'s draws, so the rate is held to the paper's
Table 4 with the reference test's own bounds (``tests/test_pim_variation.py``,
N = 40,000). ``_sense_margin`` is held to the reference's on the same
draws within 1e-6 relative, and the area model's floats are equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.pim import area as ref_area  # noqa: E402
from repro.core.pim import variation as ref_var  # noqa: E402
from repro_torch.core.pim import area as port_area  # noqa: E402
from repro_torch.core.pim import variation as V  # noqa: E402

N = 40_000
# variation % -> (paper rate, the reference test's absolute bound)
BOUNDS = {0.0: (0.0, 0.0), 5.0: (0.005, 0.004), 10.0: (0.14, 0.04),
          20.0: (0.30, 0.06)}


def rate(p, seed=7):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return float(V.shift_failure_rate(p, n_trials=N, generator=g,
                                      device="cpu"))


@pytest.mark.parametrize("pct", sorted(BOUNDS))
def test_rate_close_to_paper_table4(pct):
    paper, bound = BOUNDS[pct]
    assert V.PAPER_TABLE4[pct] == ref_var.PAPER_TABLE4[pct] == paper
    got = rate(pct)
    if pct == 0.0:
        assert got == 0.0
    else:
        assert got == pytest.approx(paper, abs=bound)


def test_failure_rate_monotone_in_variation():
    rates = [rate(p) for p in (0.0, 5.0, 10.0, 20.0)]
    assert all(a < b for a, b in zip(rates, rates[1:]))


def test_rate_is_a_float32_scalar_and_seeded():
    g = torch.Generator(device="cpu")
    g.manual_seed(3)
    r = V.shift_failure_rate(10.0, n_trials=1000, generator=g, device="cpu")
    assert r.shape == () and r.dtype == torch.float32
    assert r.device.type == "cpu"
    assert float(r) == float(V.shift_failure_rate(10.0, n_trials=1000,
                                                  generator=torch.Generator()
                                                  .manual_seed(3),
                                                  device="cpu"))
    # no generator: a fresh one seeded with 0, the same rate every call
    assert float(V.shift_failure_rate(10.0, 1000, device="cpu")) == \
        float(V.shift_failure_rate(10.0, 1000, device="cpu"))


@pytest.mark.parametrize("pct", [5.0, 10.0, 20.0])
def test_sense_margin_matches_the_reference_on_the_same_draws(pct):
    rng = np.random.default_rng(int(pct))
    p = pct / 100.0
    u = (p * V.TECH22.param_sigma_frac
         * rng.standard_normal((N // 8, 8, 5))).astype(np.float32)
    want = np.asarray(ref_var._sense_margin(jnp.asarray(u), ref_var.TECH22))
    got = V._sense_margin(torch.from_numpy(u), V.TECH22).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_nominal_margin_positive():
    m = V._sense_margin(torch.zeros((1, 1, 5)), V.TECH22)
    assert 0.03 < float(m[0, 0]) < 0.08
    assert float(m[0, 0]) == float(ref_var._sense_margin(
        jnp.zeros((1, 1, 5)), ref_var.TECH22)[0, 0])


def test_tech_constants_equal_the_reference():
    assert V.TECH22.__dict__ == ref_var.TECH22.__dict__
    assert V.SENSE_EVENTS_PER_SHIFT == ref_var.SENSE_EVENTS_PER_SHIFT


def test_generator_on_another_device_is_refused():
    g = torch.Generator(device="cpu")
    with pytest.raises(ValueError, match="generator"):
        V.shift_failure_rate(5.0, 10, generator=g, device="meta")


def test_area_model_equals_the_reference():
    a, r = port_area.AreaModel(), ref_area.AreaModel()
    assert a == port_area.AreaModel(**r.__dict__)
    assert a.overhead_pct == r.overhead_pct
    assert a.overhead_with_ambit_pct == r.overhead_with_ambit_pct
    assert a.overhead_pct < 1.0                 # paper: "<1% (w/o Ambit)"
    assert port_area.PAPER_TABLE5 == ref_area.PAPER_TABLE5
    for args in ((), (25e-15,), (30e-15, 25.0, 6e-9)):
        assert port_area.mim_capacitor_plate_side_um(*args) == \
            ref_area.mim_capacitor_plate_side_um(*args)
