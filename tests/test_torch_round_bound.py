"""PyTorch port, round bounds: the computed budget against the JAX reference.

Sufficiency, as `test_round_bound.py` holds it for the reference: on random
demand, fork/join DAGs and warm-carried windows, both engines compute the
same `round_bound`, and the port's `simulate` converges within it with zero
residual, equal to the reference's run.  The reference's streamed case
(`streaming.simulate_stream`) and its coherence lowerings
(`coherence_traffic.lower_coherence`) have no port yet; their sufficiency
cases wait for those modules.

Insufficiency, a reference-side limit that the port reproduces: on the
paper's ring at scale 16 with 120 requests per pair, both engines need 83
rounds against a computed bound of 71.  Tolerance: exact.
"""

import pytest
from _hyp_compat import given, settings, st  # optional-hypothesis shim

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 for the reference)
from repro.core import engine as RE  # noqa: E402
import repro_torch.core as P  # noqa: E402
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
