"""The port's 3BO pipeline simulator (``repro_torch.core.overlap``) against
JAX's ``repro.core.overlap``: the same inputs give equal results, not
close ones (both run the same Python float operations in the same order).
Cases: each of ``tests/test_overlap.py``'s stage times, a seeded sweep, and
a hypothesis sweep where hypothesis is installed."""

import numpy as np
import pytest
from optional_hypothesis import given, settings, strategies as st

pytest.importorskip("torch")

from repro.core import overlap as jov  # noqa: E402
from repro_torch.core import overlap as tov  # noqa: E402

MODES = ("NBO", "SBO", "2BO", "3BO")

# (t_attn, t_ffn, t_dispatch, t_combine, t_shared): tests/test_overlap.py's
# TIGHT, light, comm-bound and slack stage times
CASES = {
    "tight": (1.0, 1.0, 0.4, 0.4, 0.3),
    "light": (1.0, 0.4, 0.25, 0.25, 0.0),
    "comm_bound": (0.5, 0.5, 0.6, 0.6, 0.0),
    "slack": (1.0, 0.2, 0.1, 0.1, 0.0),
}


def _pair(times):
    return (jov.StageTimes(*times), tov.StageTimes(*times))


def _same_result(j, t):
    assert t.mode == j.mode and t.n_micro == j.n_micro
    assert t.n_layers == j.n_layers
    assert t.events == j.events
    assert (t.makespan, t.a_busy, t.f_busy, t.c_busy) == (
        j.makespan, j.a_busy, j.f_busy, j.c_busy)
    assert (t.a_util, t.f_util, t.a_bubble, t.f_bubble) == (
        j.a_util, j.f_util, j.a_bubble, j.f_bubble)


def _check_all(times, n_layers):
    js, ts = _pair(times)
    assert ts.t_comm == js.t_comm
    assert tov.afd_2bo_has_bubbles(ts) == jov.afd_2bo_has_bubbles(js)
    for duplex in (True, False):
        assert (tov.afd_3bo_steady_period(ts, duplex)
                == jov.afd_3bo_steady_period(js, duplex))
    for mode in MODES:
        for colocated in (None, True, False):
            _same_result(jov.simulate(mode, js, n_layers, colocated),
                         tov.simulate(mode, ts, n_layers, colocated))
        assert (tov.steady_state_utilization(mode, ts, n_layers)
                == jov.steady_state_utilization(mode, js, n_layers))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n_layers", [4, 16])
def test_simulator_equals_jax(case, n_layers):
    _check_all(CASES[case], n_layers)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("duplex", [True, False])
def test_utilization_equals_jax_both_link_models(case, duplex):
    js, ts = _pair(CASES[case])
    for mode in MODES:
        assert tov.steady_state_utilization(
            mode, ts, 24, colocated=False, duplex=duplex) == \
            jov.steady_state_utilization(mode, js, 24, colocated=False,
                                         duplex=duplex)
        _same_result(jov.simulate(mode, js, 8, duplex=duplex, n_micro=4),
                     tov.simulate(mode, ts, 8, duplex=duplex, n_micro=4))


@pytest.mark.parametrize("case,factor", [("tight", 2.0), ("slack", 1.5),
                                         ("comm_bound", 3.0)])
def test_jitter_equals_jax(case, factor):
    js, ts = _pair(CASES[case])
    assert (tov.jitter_propagation_delay(ts, 16, factor)
            == jov.jitter_propagation_delay(js, 16, factor))
    spike = dict(factor=factor, at_mb=1, at_layer=2, at_stage="attn")
    _same_result(
        jov.simulate("3BO", js, 8,
                     jitter=lambda m, l, s: jov.jitter_spike(m, l, s, **spike)),
        tov.simulate("3BO", ts, 8,
                     jitter=lambda m, l, s: tov.jitter_spike(m, l, s, **spike)))


@pytest.mark.parametrize("seed", range(6))
def test_seeded_sweep_equals_jax(seed):
    rng = np.random.default_rng(seed)
    times = tuple(float(x) for x in np.concatenate(
        [rng.uniform(0.1, 2.0, 2), rng.uniform(0.05, 1.0, 2),
         rng.uniform(0.0, 0.5, 1)]))
    _check_all(times, 8)


@settings(max_examples=10, deadline=None)
@given(t_a=st.floats(0.1, 2.0), t_f=st.floats(0.1, 2.0),
       t_d=st.floats(0.05, 1.0), t_c=st.floats(0.05, 1.0),
       t_s=st.floats(0.0, 0.5))
def test_hypothesis_sweep_equals_jax(t_a, t_f, t_d, t_c, t_s):
    _check_all((t_a, t_f, t_d, t_c, t_s), 6)
