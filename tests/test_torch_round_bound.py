"""PyTorch port, round bounds: the computed budget against the JAX reference.

Sufficiency, as `test_round_bound.py` holds it for the reference: on random
demand, fork/join DAGs and warm-carried windows, both engines compute the
same `round_bound`, and the port's `simulate` converges within it with zero
residual, equal to the reference's run; so do the coherence lowerings
(`coherence_traffic.lower_coherence`, chain and concurrent fan-out), and
so does every window of a carried stream (`streaming.simulate_stream`),
whose result reports the unified diagnostics.

Insufficiency, a reference-side limit that the port reproduces: on the
paper's ring at scale 16 with 120 requests per pair, both engines need 83
rounds against a computed bound of 71.  Tolerance: exact.
"""

import numpy as np
import pytest
from _hyp_compat import given, settings, st  # optional-hypothesis shim

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 for the reference)
from repro.core import engine as RE  # noqa: E402
from repro.core import streaming as RS  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import streaming as PS  # noqa: E402
from test_engine import _join_case, _random_case  # noqa: E402
from test_torch_engine import _carry_np, _port, _schedules_equal  # noqa: E402
from test_torch_lowering import _both  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs several worker
    processes side by side)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sufficient(hops, ch, issue, carry=None):
    """Both engines with the default budget: they compute the same bound,
    and the port's run equals the reference's."""
    h, c, i = _port(hops, ch, issue)
    bound = P.round_bound(h)
    assert bound == RE.round_bound(hops)
    ref = RE.simulate(hops, ch, jnp.asarray(issue), carry=carry)
    port = P.simulate(h, c, i, carry=None if carry is None
                      else P.carry_from_arrays(carry, device="cpu"))
    _schedules_equal(ref, port)
    return port, bound


@given(st.integers(0, 10_000))
@settings(max_examples=15, deadline=None)
def test_bound_sufficient_random_demand(seed):
    hops, ch, issue, _ = _random_case(seed)
    port, bound = _sufficient(hops, ch, issue)
    assert port.converged and port.residual_ps == 0
    assert port.rounds <= bound


@pytest.mark.parametrize("seed", range(6))
def test_bound_sufficient_fork_join(seed):
    hops, ch, issue = _join_case(seed)
    port, bound = _sufficient(hops, ch, issue)
    assert port.converged and port.residual_ps == 0
    assert port.rounds <= bound


@pytest.mark.parametrize("family,seed", [("random", 0), ("random", 1),
                                         ("join", 5), ("join", 6)])
def test_bound_sufficient_warm_carry(family, seed):
    """One window of a carried stream: channel state (and, with joins, the
    join seeds) carried in from a previous window."""
    if family == "random":
        hops, ch, issue, _ = _random_case(60 + seed)
        carry = _carry_np(ch.bw_MBps.shape[0], None, seed)
    else:
        hops, ch, issue = _join_case(seed)
        carry = _carry_np(ch.bw_MBps.shape[0], hops.channel.shape[0], seed)
    port, bound = _sufficient(hops, ch, issue, carry=carry)
    assert port.converged and port.residual_ps == 0
    assert port.rounds <= bound


@pytest.mark.parametrize("fanout", ["chain", "concurrent"])
def test_bound_sufficient_coherence_lowering(fanout):
    """`test_round_bound.py::test_bound_sufficient_coherence_lowering` on
    the port: the lowered event log of a 160-request stream converges
    within the bound, equal to the reference's run of the same tables."""
    from repro.core import coherence_traffic as RC
    from repro.core import snoop_filter as RS
    from repro_torch.core import coherence_traffic as PC
    from repro_torch.core import snoop_filter as PS
    from test_torch_coherence import _graphs

    (rg, rspec), (pg, pspec) = _graphs(n_req=2)
    stream = tuple(np.asarray(x) for x in RS.make_skewed_stream(
        160, 64, write_ratio=0.4, n_requesters=2, seed=9))
    rcfg = RS.SFConfig(capacity=24, policy="fifo", footprint_lines=64)
    _, rev = RS.simulate_sf(*(jnp.asarray(x) for x in stream), rcfg,
                            RS.CacheConfig(capacity=24), n_requesters=2,
                            return_events=True)
    rlow = RC.lower_coherence(rg, rspec, rcfg, *stream,
                              rev, fanout=fanout)
    pcfg = PS.SFConfig(capacity=24, policy="fifo", footprint_lines=64)
    _, pev = PS.simulate_sf(*(torch.from_numpy(np.array(x))
                              for x in stream), pcfg,
                            PS.CacheConfig(capacity=24), n_requesters=2,
                            return_events=True)
    plow = PC.lower_coherence(pg, pspec, pcfg, *stream, pev, fanout=fanout)
    issue = PC.coherence_issue(plow, pev.fab_issue_ps)
    bound = P.round_bound(plow.hops)
    assert bound == RE.round_bound(rlow.hops)
    ref = RE.simulate(rlow.hops, RE.make_channels(rg),
                      RC.coherence_issue(rlow, rev.fab_issue_ps))
    port = P.simulate(plow.hops, P.make_channels(pg, device="cpu"), issue)
    _schedules_equal(ref, port)
    assert port.converged and port.residual_ps == 0
    assert port.rounds <= bound


def _streams(hops, ch, issue, window, options=None):
    """The port's and the reference's streamed runs of one case."""
    h, c, i = _port(hops, ch, issue)
    port = PS.simulate_stream(PS.stream_windows(h, i, window), c,
                              options=None if options is None
                              else P.SimOptions(**options))
    ref = RS.simulate_stream(RS.stream_windows(hops, np.asarray(issue),
                                               window), ch,
                             options=None if options is None
                             else RE.SimOptions(**options))
    return port, ref


def test_bound_sufficient_stream_carry():
    """`test_round_bound.py::test_bound_sufficient_stream_carry`: every
    window of a carried fork/join stream converges within its computed
    bound, with the reference's rounds."""
    port, ref = _streams(*_join_case(5), 7)
    assert port.converged and port.oracle_windows == 0
    assert port.residual_ps == 0
    assert (port.rounds, port.state.rounds_max, port.windows) == \
        (ref.rounds, ref.state.rounds_max, ref.windows)


def test_one_options_object_threads_through_simulate_stream():
    """The stream part of `test_round_bound.py::
    test_one_options_object_threads_through_every_entry_point`."""
    hops, ch, issue, _ = _random_case(2)
    port, ref = _streams(hops, ch, issue, 9, dict(check="oracle"))
    assert port.converged and ref.converged
    assert port.rounds == ref.rounds


def test_stream_result_reports_unified_diagnostics():
    """The stream part of `test_round_bound.py::
    test_unified_result_diagnostics`."""
    hops, ch, issue, _ = _random_case(5)
    port, ref = _streams(hops, ch, issue, 11)
    for field in ("rounds", "converged", "residual_ps"):
        assert hasattr(port, field)
        assert getattr(port, field) == getattr(ref, field), field
    assert port.rounds == port.state.rounds_sum


def test_ring_paper_scale_exceeds_bound():
    """The paper's §V-A ring at scale 16, 120 requests per pair: both
    engines need 83 rounds, past the computed bound of 71, so with the
    default budget both stop unconverged and only `simulate_auto`'s oracle
    fallback gives the exact schedule."""
    _, _, wr, wp = _both("ring", 8, n_per_pair=120)
    bound = P.round_bound(wp.hops)
    assert bound == RE.round_bound(wr.hops) == 71
    opts = dict(max_rounds=2 * bound)
    ref = RE.simulate(wr.hops, wr.channels, wr.issue_ps,
                      RE.SimOptions(**opts))
    port = P.simulate(wp.hops, wp.channels, wp.issue_ps,
                      P.SimOptions(**opts))
    _schedules_equal(ref, port)
    assert port.converged and port.rounds == 83 > bound
