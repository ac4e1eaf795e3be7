"""PyTorch port, engine: schedules and stats equal the JAX reference's.

Each case feeds one lowered triple (the reference's tables, carried across
with `repro_torch.core.convert`) to both engines on the CPU and compares
``start`` / ``depart`` / ``arrive`` / ``complete`` / ``rounds`` /
``converged`` / ``residual_ps`` exactly; the stats reductions, the
event-driven oracle, the oracle fallback and one whole-slice pipeline
(`build_workload` -> `simulate` -> `request_stats`) are held the same way.
Tolerance: exact (int64 picoseconds, float64 quotients of equal integers).
"""

import numpy as np
import pytest
from _hyp_compat import given, settings, st  # optional-hypothesis shim

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402  (x64 for the reference)
from repro.core import engine as RE  # noqa: E402
from repro.core import ref_des as RD  # noqa: E402
import repro_torch.core as P  # noqa: E402
from test_engine import (_join_case, _random_case,  # noqa: E402
                         _tight_feedback_case)

SCHEDULE_FIELDS = ("start", "depart", "arrive", "complete")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several worker
    processes side by side, and torch's default pool (one thread per core
    in each of them) oversubscribes the cores many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port(hops, ch, issue):
    return (P.hops_from_arrays(hops, device="cpu"),
            P.channels_from_arrays(ch, device="cpu"),
            P.issue_from_array(issue, device="cpu"))


def _schedules_equal(ref, port):
    for f in SCHEDULE_FIELDS:
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              getattr(port, f).numpy()), f
    assert int(ref.rounds) == port.rounds
    assert bool(ref.converged) == port.converged
    assert int(ref.residual_ps) == port.residual_ps


def _simulate_both(hops, ch, issue, options=None, carry=None):
    ref = RE.simulate(hops, ch, jnp.asarray(issue),
                      None if options is None
                      else RE.SimOptions(**options), carry=carry)
    port = P.simulate(*_port(hops, ch, issue),
                      None if options is None else P.SimOptions(**options),
                      carry=None if carry is None
                      else P.carry_from_arrays(carry, device="cpu"))
    _schedules_equal(ref, port)
    return ref, port


def _stochastic(ber):
    from test_link_reliability import _stochastic as cfg, _wl
    wl = _wl(cfg(ber), n=60)
    return wl.hops, wl.channels, np.asarray(wl.issue_ps)


@given(st.integers(0, 10_000))
@settings(max_examples=12, deadline=None)
def test_simulate_random_case_equal(seed):
    hops, ch, issue, _ = _random_case(seed)
    _, port = _simulate_both(hops, ch, issue)
    assert port.converged and port.rounds <= P.round_bound(
        P.hops_from_arrays(hops, device="cpu"))


@pytest.mark.parametrize("seed", range(6))
def test_simulate_join_case_equal(seed):
    hops, ch, issue = _join_case(seed)
    assert P.round_bound(P.hops_from_arrays(hops, device="cpu")) == \
        RE.round_bound(hops)
    _, port = _simulate_both(hops, ch, issue)
    assert port.converged and port.residual_ps == 0


@pytest.mark.parametrize("ber", [1e-4, 3e-4])
def test_simulate_stochastic_reliability_equal(ber):
    hops, ch, issue = _stochastic(ber)
    assert int(np.asarray(hops.retrain_after_ps).max()) > 0
    _simulate_both(hops, ch, issue)


def _carry_np(n_channels, n_rows, seed):
    rng = np.random.default_rng(seed)
    return R.StreamCarry(
        depart_ps=jnp.asarray(rng.integers(0, 6000, n_channels)),
        last_dir=jnp.asarray(rng.integers(-1, 2, n_channels).astype(np.int8)),
        last_row=jnp.asarray(rng.integers(-2, 3, n_channels)
                             .astype(np.int32)),
        down_until_ps=jnp.asarray(np.where(rng.random(n_channels) < .5,
                                           rng.integers(0, 9000, n_channels),
                                           0)),
        join_seed_ps=(None if n_rows is None else
                      jnp.asarray(rng.integers(0, 8000, n_rows))))


@pytest.mark.parametrize("seed", range(3))
def test_simulate_warm_carry_equal(seed):
    hops, ch, issue, _ = _random_case(40 + seed)
    _simulate_both(hops, ch, issue,
                   carry=_carry_np(ch.bw_MBps.shape[0], None, seed))
    jh, jc, ji = _join_case(seed)
    _simulate_both(jh, jc, ji, carry=_carry_np(jc.bw_MBps.shape[0],
                                               jh.channel.shape[0], seed))


def test_empty_carry_equals_no_carry():
    hops, ch, issue, _ = _random_case(3)
    h, c, i = _port(hops, ch, issue)
    cold = P.simulate(h, c, i, carry=P.empty_carry(c.bw_MBps.shape[0],
                                                   device="cpu"))
    plain = P.simulate(h, c, i)
    for f in SCHEDULE_FIELDS:
        assert torch.equal(getattr(cold, f), getattr(plain, f))


def test_truncated_budget_reports_residual_equal():
    hops, ch, issue = _tight_feedback_case(n=600, h=6)
    _, port = _simulate_both(hops, ch, issue, options=dict(max_rounds=1))
    assert not port.converged and port.residual_ps > 0


@pytest.mark.parametrize("seed", [0, 7])
def test_stats_equal(seed):
    hops, ch, issue, valid = _random_case(seed)
    ref, port = _simulate_both(hops, ch, issue)
    h, c, i = _port(hops, ch, issue)
    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, issue.shape[0]).astype(np.int64)
    meas = rng.random(issue.shape[0]) < 0.7
    a = RE.request_stats(hops, ref, jnp.asarray(issue), jnp.asarray(pay),
                         jnp.asarray(meas))
    b = P.request_stats(h, port, i, torch.from_numpy(pay),
                        torch.from_numpy(meas))
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), b[k].numpy()), k
    for window in (None, (jnp.int64(100), jnp.int64(90_000))):
        a = RE.channel_stats(hops, ref, ch, window)
        b = P.channel_stats(h, port, c, window and tuple(int(t)
                                                         for t in window))
        assert a.keys() == b.keys()
        for k in a:
            x, y = np.asarray(a[k]), b[k].numpy()
            assert x.dtype == y.dtype and np.array_equal(x, y), k


def test_replay_round_stalls_equal():
    hops, ch, issue = _stochastic(3e-4)
    ref = RE.simulate(hops, ch, issue)
    h, c, i = _port(hops, ch, issue)
    port = P.simulate(h, c, i)
    for a, b in zip(RE.replay_round(hops, ch, ref),
                    P.replay_round(h, c, port)):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("family", ["random", "join", "stochastic", "carry"])
def test_oracle_equal(family):
    carry = None
    if family == "random":
        hops, ch, issue, _ = _random_case(11)
    elif family == "join":
        hops, ch, issue = _join_case(3)
    elif family == "stochastic":
        hops, ch, issue = _stochastic(1e-4)
    else:
        hops, ch, issue = _join_case(4)
        carry = _carry_np(ch.bw_MBps.shape[0], hops.channel.shape[0], 4)
    ref = RD.simulate_ref(hops, ch, issue, carry=carry)
    port = P.simulate_ref(*_port(hops, ch, issue),
                          carry=None if carry is None
                          else P.carry_from_arrays(carry, device="cpu"))
    assert ref.keys() == port.keys()
    for k in ref:
        assert np.array_equal(ref[k], port[k]), k
    sched = P.ref_schedule(port, device="cpu")
    assert sched.converged and sched.rounds == 0


def test_simulate_auto_falls_back_to_oracle():
    """The reference's natural non-convergence case: the budget runs out,
    and `simulate_auto` returns the oracle's exact schedule."""
    hops, ch, issue = _tight_feedback_case()
    h, c, i = _port(hops, ch, issue)
    direct = P.simulate(h, c, i)
    assert not direct.converged
    sched, used_oracle = P.simulate_auto(h, c, i)
    assert used_oracle and sched.converged
    assert sched.rounds == direct.rounds == P.round_bound(h)
    ref = RD.simulate_ref(hops, ch, issue)
    for f in SCHEDULE_FIELDS:
        assert np.array_equal(getattr(sched, f).numpy(), ref[f]), f
    off, used = P.simulate_auto(h, c, i, P.SimOptions(check="off"))
    assert not used and not off.converged


def test_simulate_auto_extend_runs_the_fixpoint_on():
    """``check="extend"`` runs the fixpoint past its bound on the tables'
    device: on the tight feedback case it converges after 38 rounds (bound
    32) to the schedule the reference's oracle fallback gives, with no
    oracle.  With a budget of 2 it is still unconverged after 8 x 2 rounds
    and the oracle answers."""
    hops, ch, issue = _tight_feedback_case()
    h, c, i = _port(hops, ch, issue)
    sched, used_oracle = P.simulate_auto(h, c, i,
                                         P.SimOptions(check="extend"))
    assert not used_oracle and sched.converged
    assert sched.rounds == 38 > P.round_bound(h)
    ref, ref_oracle = RE.simulate_auto(hops, ch, jnp.asarray(issue))
    assert ref_oracle
    for f in SCHEDULE_FIELDS:
        assert np.array_equal(getattr(sched, f).numpy(),
                              np.asarray(getattr(ref, f))), f
    short, used_oracle = P.simulate_auto(
        h, c, i, P.SimOptions(max_rounds=2, check="extend"))
    assert used_oracle and short.converged
    assert short.rounds == P.engine.EXTEND_FACTOR * 2
    assert torch.equal(short.complete, sched.complete)


def test_simulate_auto_converged_and_static_mode():
    hops, ch, issue, _ = _random_case(5)
    h, c, i = _port(hops, ch, issue)
    sched, used_oracle = P.simulate_auto(h, c, i)
    assert sched.converged and not used_oracle
    # static mode verifies the clean tables, then resolves them as the
    # reference's static mode does; a corrupted table raises VerifyError
    static, used_oracle = P.simulate_auto(h, c, i,
                                          P.SimOptions(check="static"))
    ref, ref_oracle = RE.simulate_auto(hops, ch, jnp.asarray(issue),
                                       RE.SimOptions(check="static"))
    assert used_oracle == bool(ref_oracle)
    assert torch.equal(static.complete, sched.complete)
    assert np.array_equal(static.complete.numpy(), np.asarray(ref.complete))
    bad = h._replace(channel=torch.where(h.valid, c.bw_MBps.shape[0],
                                         h.channel).int())
    with pytest.raises(P.VerifyError, match="chan.bounds"):
        P.simulate_auto(bad, c, i, P.SimOptions(check="static"))
    with pytest.raises(ValueError):
        P.SimOptions(check="strict")


@pytest.mark.parametrize("kind", ["chain", "ring"])
def test_whole_slice_pipeline_equal(kind):
    """build_workload -> simulate -> request_stats, each package on its own
    lowering, at 4 requester/memory pairs."""
    from test_torch_lowering import _both

    _, _, wr, wp = _both(kind, 4, n_per_pair=20)
    ref = RE.simulate(wr.hops, wr.channels, wr.issue_ps)
    port = P.simulate(wp.hops, wp.channels, wp.issue_ps)
    _schedules_equal(ref, port)
    assert port.converged
    a = RE.request_stats(wr.hops, ref, wr.issue_ps, wr.payload_bytes,
                         wr.measured)
    b = P.request_stats(wp.hops, port, wp.issue_ps, wp.payload_bytes,
                        wp.measured)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), b[k].numpy()), k
    assert int(b["steady_bandwidth_MBps"]) > 0
