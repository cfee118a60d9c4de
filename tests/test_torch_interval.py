"""The port's interval theory (``repro_torch.core.interval``: paper eqs. 1,
2, 3, 7; Fig. 6's values) against the JAX package's, case for case with
``tests/test_interval.py``: each case asserts what the reference's asserts
on the port and holds every number equal to the reference's on the same
inputs (the hypothesis cases too). The module is carried over unchanged,
so the tolerance is exact (``==`` on floats)."""

from __future__ import annotations

import math

import pytest
from _hypothesis_compat import given, st

from repro.core import interval as ref
from repro_torch.core import interval as port


def test_eq1_mtbf_scales_inverse_with_nodes():
    assert port.system_mtbf(3600.0, 1) == 3600.0
    assert port.system_mtbf(3600.0, 100) == 36.0
    for n in (1, 100, 2**15):
        assert port.system_mtbf(3600.0, n) == ref.system_mtbf(3600.0, n)


@given(st.floats(min_value=1.0, max_value=1e7), st.floats(min_value=1e-3, max_value=1e3))
def test_eq3_first_order_optimum(mu, c):
    t = port.optimal_interval(mu, c)
    assert t == pytest.approx(math.sqrt(2 * mu * c))
    assert t == ref.optimal_interval(mu, c)


@given(st.floats(min_value=100.0, max_value=1e7), st.floats(min_value=1e-3, max_value=10.0))
def test_eq7_overhead_formula(mu, c):
    ov = port.overhead(c, mu)
    assert ov == pytest.approx(c / math.sqrt(2 * mu * c))
    assert ov == ref.overhead(c, mu)


def test_paper_fig6_claims():
    """At mu = 1 h and the paper's measured checkpoint times the overhead
    stays below ~4% (2^15 ranks: C < 7 s)."""
    mu = 3600.0
    assert port.overhead(7.0, mu) < 0.04
    assert port.overhead(2.0, mu) < 0.03
    assert (port.overhead(7.0, mu), port.overhead(2.0, mu)) == (ref.overhead(7.0, mu), ref.overhead(2.0, mu))


def test_eq2_memory_factors():
    assert port.memory_factor(2) == 5.0
    assert port.memory_factor(1) == 3.0
    assert port.parity_memory_factor(4) == pytest.approx(1 + 2 * 1.25)
    for n in (1, 2, 3):
        assert port.memory_factor(n) == ref.memory_factor(n)
    for g in (2, 4, 8):
        assert port.parity_memory_factor(g) == ref.parity_memory_factor(g)


def test_scheduler_adapts():
    def drive(mod):
        s = mod.CheckpointScheduler(mtbf_s=3600.0, step_time_s=1.0, checkpoint_s=2.0)
        p0 = s.period_steps
        for _ in range(21):
            s.record_checkpoint_duration(8.0)
        return p0, s.period_steps, s.interval_s, s.expected_overhead, s.due(p0 * 100, 0), s.due(1, 0)

    got = drive(port)
    p0, p1, _, _, due_late, due_early = got
    assert p0 == int(round(math.sqrt(2 * 3600 * 2.0)))
    assert p1 > p0               # costlier C -> longer interval
    assert due_late and not due_early
    assert got == drive(ref)


def test_overhead_monotonic_in_system_size():
    """Larger systems -> smaller mu (eq. 1) -> larger overhead at T_opt."""
    c = 5.0
    sizes = (2**10, 2**13, 2**15)
    ovs = [port.overhead(c, port.system_mtbf(87600.0 * 3600, n)) for n in sizes]
    assert ovs[0] < ovs[1] < ovs[2]
    assert ovs == [ref.overhead(c, ref.system_mtbf(87600.0 * 3600, n)) for n in sizes]
