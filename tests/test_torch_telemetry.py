"""PyTorch port, the telemetry layer against the JAX reference's.

The families of ``tests/test_telemetry.py`` (attribution, channel
counters, blame, windowed series, sketches, the stream fold, SF counters,
`fabric_metrics`), each holding ``repro_torch.core.telemetry`` to
``repro.core.telemetry`` on the same inputs on the CPU:

* the reference's lowered tables (`build_workload` of the reference, the
  join cases, a coupled coherence run) cross over with
  `repro_torch.core.convert`; the port resolves the schedule (its engine is
  held bit for bit to the reference's in ``test_torch_engine.py``), and the
  same schedule goes to both telemetry layers (`_ref_schedule`);
* the reference's vmapped BER sweep is held member by member against the
  port's reductions over `simulate_stacked` members;
* ``test_telemetry_is_pure_observer``'s counterpart runs `fabric_metrics`
  and re-simulates (the trace export is held in
  ``test_torch_critical_path.py``).

Tolerance: exact.  Integers are equal; float64 fields (utilization, busy
fraction, in-flight, hit rate) are equal bit for bit, since both sides
divide the same int64 values as float64.
"""

import numpy as np
import pytest
from _hyp_compat import given, settings, st  # optional-hypothesis shim

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 for the reference)
from repro.core import engine as RE  # noqa: E402
from repro.core import snoop_filter as RS  # noqa: E402
from repro.core import telemetry as rtm  # noqa: E402
from repro.core.link_layer import FlitConfig  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import telemetry as ptm  # noqa: E402
from test_telemetry import (FLIT_CONFIGS, _bus_wl,  # noqa: E402
                            _join_case)
from test_torch_engine import _port  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs several worker
    processes side by side)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_tuple(cls, port_tuple):
    """A reference NamedTuple of jnp arrays with the port's values."""
    return cls(**{f: None if v is None else jnp.asarray(v.numpy())
                  for f, v in zip(port_tuple._fields, port_tuple)})


def _ref_schedule(sched):
    return RE.Schedule(
        arrive=jnp.asarray(sched.arrive.numpy()),
        start=jnp.asarray(sched.start.numpy()),
        depart=jnp.asarray(sched.depart.numpy()),
        complete=jnp.asarray(sched.complete.numpy()),
        rounds=jnp.asarray(sched.rounds), converged=jnp.asarray(
            sched.converged), residual_ps=jnp.asarray(sched.residual_ps))


def _equal(ref, port, what):
    """Exact equality of a reference array and a port tensor, dtype kind
    and, for floats, every bit of the float64 values."""
    r, p = np.asarray(ref), port.numpy()
    assert r.shape == p.shape, what
    if np.issubdtype(r.dtype, np.floating):
        assert p.dtype == np.float64 and r.dtype == np.float64, what
        assert np.array_equal(r.view(np.int64), p.view(np.int64)), what
    else:
        assert np.array_equal(r.astype(np.int64), p.astype(np.int64)), what


def _tuples_equal(ref, port, what=""):
    assert ref._fields == port._fields
    for f in ref._fields:
        _equal(getattr(ref, f), getattr(port, f), f"{what}{f}")


_CASES = {}


def _case(key, build):
    """(port hops, channels, issue, schedule; reference hops, channels,
    issue, schedule) of one lowered case, built and resolved once per
    module: the port simulates, and both layers read that schedule."""
    if key not in _CASES:
        hops, ch, issue = build()
        ph, pc, pi = _port(hops, ch, issue)
        ps = P.simulate(ph, pc, pi)
        assert ps.converged
        _CASES[key] = ((ph, pc, pi, ps),
                       (_ref_tuple(RE.Hops, ph), _ref_tuple(RE.Channels, pc),
                        jnp.asarray(pi.numpy()), _ref_schedule(ps)))
    return _CASES[key]


def _bus(mode, n=50, seed=3):
    def build():
        wl = _bus_wl(FLIT_CONFIGS[mode], n=n, seed=seed)
        return wl.hops, wl.channels, np.asarray(wl.issue_ps)
    return _case(("bus", mode, n, seed), build)


def _joins(seed):
    def build():
        hops, ch, issue = _join_case(seed)
        return hops, ch, np.asarray(issue)
    return _case(("join", seed), build)


def _attribution_equal(port, ref):
    (ph, pc, pi, ps), (rh, rc, ri, rs) = port, ref
    att = ptm.attribute_latency(ph, pc, ps, pi)
    _tuples_equal(rtm.attribute_latency(rh, rc, rs, ri), att, "att.")
    assert int(ptm.conservation_residual(att).abs().max()) == 0
    for f in att._fields[:-1]:
        assert int(getattr(att, f).min()) >= 0, f
    blame = ptm.channel_blame(ph, pc, ps, pi)
    _tuples_equal(rtm.channel_blame(rh, rc, rs, ri), blame, "blame.")
    assert int(ptm.blame_conservation_residual(blame)) == 0
    return att


# ---------------------------------------------------------------------------
# conservation invariant, held to the reference
# ---------------------------------------------------------------------------

@given(st.integers(0, 10_000), st.sampled_from(sorted(FLIT_CONFIGS)))
@settings(max_examples=12, deadline=None)
def test_attribution_equals_reference_flit_reliability(seed, mode):
    att = _attribution_equal(*_bus(mode, n=40, seed=seed % 97))
    if mode != "stochastic":
        assert int(att.retrain_stall_ps.sum()) == 0


@given(st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_attribution_equals_reference_joins(seed):
    _attribution_equal(*_joins(seed))


def test_attribution_equals_reference_coupled_coherence():
    """The coupled coherence schedule (BISnp joins) of the port's
    `simulate_coupled`, through both layers."""
    from repro_torch.core import topology as PT
    from repro_torch.core import coherence_traffic as PC

    kinds = [PT.SWITCH, PT.REQUESTER, PT.REQUESTER, PT.MEMORY]
    graph = PT.Topology(np.asarray(kinds, np.int64),
                        [PT.LinkSpec(i, 0, 64_000, 26_000)
                         for i in range(1, 4)], name="star").build()
    spec = PC.CoherenceFabricSpec(dev_node=3, req_nodes=(1, 2))
    stream = P.make_skewed_stream(200, 256, write_ratio=0.3, n_requesters=2,
                                  seed=4, device="cpu")
    res = P.simulate_coupled(*stream, P.SFConfig(capacity=32,
                                                 footprint_lines=256),
                             P.CacheConfig(capacity=32), graph, spec,
                             n_requesters=2, max_iters=8, device="cpu")
    assert res.converged
    pc = P.make_channels(graph, device="cpu")
    pi = P.coherence_issue(res.lowering, res.events.fab_issue_ps)
    port = (res.lowering.hops, pc, pi, res.schedule)
    ref = (_ref_tuple(RE.Hops, port[0]), _ref_tuple(RE.Channels, pc),
           jnp.asarray(pi.numpy()), _ref_schedule(res.schedule))
    att = _attribution_equal(port, ref)
    assert int(att.join_wait_ps.sum()) > 0   # BISnp joins stall requests


# ---------------------------------------------------------------------------
# every reduction against the reference and against the oracle's schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(FLIT_CONFIGS))
def test_metrics_equal_reference_and_oracle(mode):
    port, ref = _bus(mode)
    ph, pc, pi, ps = port
    rh, rc, ri, rs = ref
    _tuples_equal(rtm.channel_telemetry(rh, rc, rs),
                  ptm.channel_telemetry(ph, pc, ps), "chan.")
    _tuples_equal(rtm.windowed_series(rh, rc, rs, ri, n_bins=16),
                  ptm.windowed_series(ph, pc, ps, pi, n_bins=16), "series.")
    # the oracle's schedule gives the same metrics
    oracle = P.ref_schedule(P.simulate_ref(ph, pc, pi), "cpu")
    for fn in (ptm.attribute_latency, ptm.channel_blame):
        _tuples_equal(fn(ph, pc, ps, pi), fn(ph, pc, oracle, pi))
    _tuples_equal(ptm.channel_telemetry(ph, pc, ps),
                  ptm.channel_telemetry(ph, pc, oracle))
    a = ptm.windowed_series(ph, pc, ps, pi, n_bins=16)
    b = ptm.windowed_series(ph, pc, oracle, pi, n_bins=16)
    for f in ("busy_ps", "completions"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("mode", ["byte", "stochastic"])
def test_fabric_metrics_equals_reference(mode):
    (ph, pc, pi, ps), (rh, rc, ri, rs) = _bus(mode)
    got = ptm.fabric_metrics(ph, pc, ps, pi)
    want = rtm.fabric_metrics(rh, rc, rs, ri)
    assert set(got) == set(want)
    for key in ("attribution", "blame", "channels", "series",
                "latency_sketch"):
        _tuples_equal(want[key], got[key], f"{key}.")
    _equal(want["latency_quantiles_ps"], got["latency_quantiles_ps"], "q")
    assert got["rounds"] == int(want["rounds"])
    assert got["converged"] == bool(want["converged"])


def test_telemetry_is_pure_observer():
    """`fabric_metrics` writes to none of its inputs, and re-simulating
    after it gives the same schedule bit for bit."""
    (ph, pc, pi, ps), _ = _bus("stochastic")
    snap = [x.clone() for t in (ph, pc) for x in t if x is not None]
    snap += [pi.clone()] + [getattr(ps, f).clone()
                            for f in ("arrive", "start", "depart",
                                      "complete")]
    ptm.fabric_metrics(ph, pc, ps, pi)
    after = [x for t in (ph, pc) for x in t if x is not None]
    after += [pi] + [getattr(ps, f) for f in ("arrive", "start", "depart",
                                              "complete")]
    assert all(torch.equal(a, b) for a, b in zip(snap, after))
    again = P.simulate(ph, pc, pi)
    for f in ("arrive", "start", "depart", "complete"):
        assert torch.equal(getattr(ps, f), getattr(again, f)), f


def test_replay_round_reproduces_fixpoint():
    for mode in ("byte", "stochastic"):
        (ph, pc, pi, ps), (rh, rc, ri, rs) = _bus(mode)
        start, depart, stall = P.replay_round(ph, pc, ps)
        assert torch.equal(start, ps.start) and torch.equal(depart,
                                                            ps.depart)
        _equal(RE.replay_round(rh, rc, rs)[2], stall, "stall")
        if mode == "byte":
            assert int(stall.sum()) == 0


# ---------------------------------------------------------------------------
# the stacked BER sweep, member by member against the reference's vmap
# ---------------------------------------------------------------------------

def test_stacked_ber_sweep_equals_reference_vmap():
    from repro_torch.studies.link_reliability import _pad

    wls = [_bus_wl(FlitConfig("flit256", ber=b, reliability="stochastic",
                              rel_seed=7, retrain_threshold=2,
                              retrain_ps=500_000), n=40)
           for b in (1e-5, 3e-4)]
    hs = [P.hops_from_arrays(w.hops, device="cpu") for w in wls]
    h_max = max(h.channel.shape[1] for h in hs)
    stacked = P.stack_members([_pad(h, h_max) for h in hs])
    ch = P.channels_from_arrays(wls[0].channels, device="cpu")
    issue = P.issue_from_array(wls[0].issue_ps, device="cpu")
    opts = P.SimOptions(max_rounds=P.round_bound(stacked))
    sched = P.simulate_stacked(stacked, P.stack_members([ch] * 2),
                               torch.stack([issue] * 2), opts)
    assert all(sched.converged)

    r_stacked = _ref_tuple(RE.Hops, stacked)
    r_ch, r_issue = wls[0].channels, wls[0].issue_ps
    r_opts = RE.SimOptions(max_rounds=P.round_bound(stacked))

    @jax.jit
    def sweep(hops):
        s = jax.vmap(lambda h: RE.simulate(h, r_ch, r_issue, r_opts))(hops)
        att = jax.vmap(lambda h, x: rtm.attribute_latency(
            h, r_ch, x, r_issue))(hops, s)
        chans = jax.vmap(lambda h, x: rtm.channel_telemetry(
            h, r_ch, x))(hops, s)
        sk = jax.vmap(lambda t: rtm.sketch_update(rtm.sketch_new(),
                                                  t))(att.total_ps)
        return s, att, chans, jax.vmap(rtm.sketch_quantiles)(sk)

    r_sched, r_att, r_chans, r_q = sweep(r_stacked)
    stalls = []
    for i in range(2):
        h, s = P.member(stacked, i), P.member(sched, i)
        assert s.rounds == int(r_sched.rounds[i])
        att = ptm.attribute_latency(h, ch, s, issue)
        _tuples_equal(jax.tree_util.tree_map(lambda x: x[i], r_att), att)
        _tuples_equal(jax.tree_util.tree_map(lambda x: x[i], r_chans),
                      ptm.channel_telemetry(h, ch, s))
        q = ptm.sketch_quantiles(ptm.sketch_update(ptm.sketch_new("cpu"),
                                                   att.total_ps))
        _equal(r_q[i], q, "quantiles")
        assert int(q[0]) <= int(q[2])
        stalls.append(int(att.retrain_stall_ps.sum()))
    # more bit errors -> strictly more retraining stall at these BERs
    assert stalls[1] > stalls[0]


def test_study_rows_equal_reference():
    """`studies.telemetry.run(quick=True)` gives the reference bench's five
    rows, ``telemetry/metrics_per_sweep`` (the trace's event count) among
    them: names, ``derived`` and ``meta`` letter for letter."""
    import benchmarks.bench_telemetry as RB
    from repro_torch.studies import telemetry as PB

    got = PB.run(quick=True, device="cpu")
    want = RB.run(quick=True)
    assert [r.name for r in want] == [r.name for r in got]
    assert got[-1].name == "telemetry/metrics_per_sweep"
    for g, w in zip(got, want):
        assert (g.name, g.derived, g.meta) == (w.name, w.derived, w.meta)


# ---------------------------------------------------------------------------
# channel counters + windowed series
# ---------------------------------------------------------------------------

def test_channel_telemetry_matches_channel_stats():
    (ph, pc, pi, ps), _ = _bus("flit", n=60)
    ct = ptm.channel_telemetry(ph, pc, ps)
    cs = P.channel_stats(ph, ps, pc)
    assert torch.equal(ct.busy_ps, cs["busy_ps"])
    assert torch.equal(ct.wait_ps, cs["wait_ps"])
    assert int(ct.payload_bytes.sum()) == int(
        torch.where(ph.is_payload, ph.nbytes, 0).sum())
    assert int(ct.wire_bytes.sum()) > int(ct.payload_bytes.sum())
    assert ct.utilization.dtype == torch.float64


def _hand_case(issue):
    ch = P.Channels(torch.tensor([1000]), torch.zeros(1, dtype=torch.int64),
                    torch.zeros(1, dtype=torch.int64),
                    torch.zeros(1, dtype=torch.int64))
    n = 3
    hops = P.Hops(torch.zeros((n, 1), dtype=torch.int32),
                  torch.full((n, 1), 100, dtype=torch.int64),
                  torch.zeros((n, 1), dtype=torch.int8),
                  torch.full((n, 1), -1, dtype=torch.int32),
                  torch.zeros((n, 1), dtype=torch.int64),
                  torch.ones((n, 1), dtype=torch.bool),
                  torch.ones((n, 1), dtype=torch.bool))
    issue = torch.tensor(issue, dtype=torch.int64)
    return ptm.channel_telemetry(hops, ch, P.simulate(hops, ch, issue))


def test_peak_backlog_hand_case():
    """3 requests arrive at t=0 on one channel (ser 100k ps each): backlog
    peaks at 3 (arrivals count before the same-instant grant)."""
    ct = _hand_case([0, 0, 0])
    assert int(ct.peak_backlog[0]) == 3
    assert int(ct.busy_ps[0]) == 3 * 100_000
    ct2 = _hand_case([0, 100_000, 200_000])
    assert int(ct2.peak_backlog[0]) == 1
    assert int(ct2.wait_ps[0]) == 0


def test_windowed_series_sums_to_totals():
    (ph, pc, pi, ps), _ = _bus("replay", n=60)
    ws = ptm.windowed_series(ph, pc, ps, pi, n_bins=16)
    ct = ptm.channel_telemetry(ph, pc, ps)
    assert int(ws.busy_ps.sum()) == int(ct.busy_ps.sum())
    assert int(ws.completions.sum()) == int(ps.complete.shape[0])
    total_lat = int((ps.complete - pi).sum())
    assert int((ws.inflight * ws.bin_ps).sum()) == total_lat
    assert ws.busy_frac.dtype == ws.inflight.dtype == torch.float64


# ---------------------------------------------------------------------------
# quantile sketch
# ---------------------------------------------------------------------------

def _sketch_both(vals, mask=None):
    return (rtm.sketch_update(rtm.sketch_new(), jnp.asarray(vals),
                              mask=None if mask is None
                              else jnp.asarray(mask)),
            ptm.sketch_update(ptm.sketch_new("cpu"), torch.from_numpy(vals),
                              mask=None if mask is None
                              else torch.from_numpy(mask)))


def test_sketch_binning_equals_reference():
    rng = np.random.default_rng(2)
    v = np.concatenate([np.arange(-3, 70), 1 << np.arange(63),
                        (1 << np.arange(1, 63)) - 1,
                        rng.integers(0, 1 << 62, 2000),
                        [np.iinfo(np.int64).max]]).astype(np.int64)
    _equal(rtm.sketch_bin(jnp.asarray(v)), ptm.sketch_bin(torch.from_numpy(
        v)), "bins")
    b = np.arange(ptm.SKETCH_BINS, dtype=np.int64)
    _equal(rtm.sketch_value(jnp.asarray(b)), ptm.sketch_value(
        torch.from_numpy(b)), "values")
    small = torch.arange(32)
    assert torch.equal(ptm.sketch_value(ptm.sketch_bin(small)), small)
    assert (ptm.SKETCH_BINS, ptm.SKETCH_REL_ERROR) == (rtm.SKETCH_BINS,
                                                       rtm.SKETCH_REL_ERROR)


def test_sketch_quantiles_equal_reference_and_within_resolution():
    rng = np.random.default_rng(11)
    vals = np.concatenate([
        rng.integers(1, 100, 4000),
        (rng.lognormal(13, 1.5, 6000)).astype(np.int64),
    ]).astype(np.int64)
    ref, sk = _sketch_both(vals)
    _tuples_equal(ref, sk)
    qs = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0)
    _equal(rtm.sketch_quantile(ref, jnp.asarray(qs)),
           ptm.sketch_quantile(sk, qs), "quantiles")
    for q in qs[1:-1]:
        est = int(ptm.sketch_quantile(sk, q))
        exact = int(np.quantile(vals, q, method="inverted_cdf"))
        assert abs(est - exact) <= max(exact * 2 * ptm.SKETCH_REL_ERROR, 1)
    assert int(ptm.sketch_quantile(sk, 0.0)) == int(vals.min())
    assert int(ptm.sketch_quantile(sk, 1.0)) == int(vals.max())


def test_sketch_merge_equals_concat_and_streams():
    rng = np.random.default_rng(5)
    a = rng.integers(1, 10**9, 3000).astype(np.int64)
    b = (rng.lognormal(10, 2, 2000)).astype(np.int64)
    one = ptm.sketch_update(ptm.sketch_new("cpu"),
                            torch.from_numpy(np.concatenate([a, b])))
    merged = ptm.sketch_merge(
        ptm.sketch_update(ptm.sketch_new("cpu"), torch.from_numpy(a)),
        ptm.sketch_update(ptm.sketch_new("cpu"), torch.from_numpy(b)))
    _tuples_equal(one, merged)
    chunks = ptm.sketch_new("cpu")
    for part in np.array_split(np.concatenate([a, b]), 7):
        chunks = ptm.sketch_update(chunks, torch.from_numpy(part))
    assert torch.equal(chunks.counts, one.counts)
    ref, masked = _sketch_both(a, mask=np.arange(a.size) % 3 == 0)
    _tuples_equal(ref, masked)
    ref, empty = _sketch_both(a, mask=np.zeros(a.size, bool))
    _tuples_equal(ref, empty)
    assert int(empty.n) == 0
    assert int(ptm.sketch_quantile(empty, 0.5)) == 0
    _equal(rtm.sketch_quantiles(ref), ptm.sketch_quantiles(empty), "empty")


def test_fabric_metrics_check_catches_corruption():
    (ph, pc, pi, ps), _ = _bus("byte", n=30)
    ptm.fabric_metrics(ph, pc, ps, pi)  # clean: ok
    bad = ps._replace(complete=ps.complete + 1)
    with pytest.raises(AssertionError, match="latency attribution violates "
                                             "conservation by 1 ps"):
        ptm.fabric_metrics(ph, pc, bad, pi)
    ptm.fabric_metrics(ph, pc, bad, pi, check=False)


# ---------------------------------------------------------------------------
# the stream fold on one window
# ---------------------------------------------------------------------------

def test_stream_fold_one_window_equals_reference_and_monolithic():
    """The whole schedule folded as a single window (every item settled,
    every row retired and gated once) equals the reference's fold field for
    field, and its finalized counters and blame equal the monolithic
    `channel_telemetry` / `channel_blame`."""
    (ph, pc, pi, ps), (rh, rc, ri, rs) = _bus("stochastic")
    c = int(pc.bw_MBps.shape[0])
    stall = P.replay_round(ph, pc, ps)[2]
    rows = torch.ones(pi.shape[0], dtype=torch.bool)
    args = (ph.valid, rows, ps.complete - pi, stall, rows,
            ps.arrive[:, 0] - pi)
    acc = ptm.stream_telemetry_fold(ptm.stream_telemetry_new(c, "cpu"), ph,
                                    pc, ps, *args)
    ref = rtm.stream_telemetry_fold(rtm.stream_telemetry_new(c), rh, rc, rs,
                                    *(jnp.asarray(x.numpy()) for x in args))
    _tuples_equal(ref.sketch, acc.sketch, "sketch.")
    for f in ref._fields[1:]:
        _equal(getattr(ref, f), getattr(acc, f), f)
    got, want = (ptm.stream_telemetry_finalize(acc),
                 rtm.stream_telemetry_finalize(ref))
    for key in ("n_retired", "span_ps"):
        assert got[key] == want[key], key
    for key in ("quantiles_ps", "payload_bytes", "wire_bytes", "busy_ps",
                "wait_ps", "utilization"):
        assert got[key].dtype == np.asarray(want[key]).dtype, key
        assert np.array_equal(got[key], np.asarray(want[key])), key
    for key, val in want["blame"].items():
        assert np.array_equal(got["blame"][key], val), key
    ct = ptm.channel_telemetry(ph, pc, ps)
    bl = ptm.channel_blame(ph, pc, ps, pi)
    assert np.array_equal(got["busy_ps"], ct.busy_ps.numpy())
    assert np.array_equal(got["wire_bytes"], ct.wire_bytes.numpy())
    for key in ("queue_ps", "retrain_ps", "wire_ps", "row_extra_ps"):
        assert np.array_equal(got["blame"][key], getattr(bl, key).numpy())
    assert got["blame"]["join_ps"] == int(bl.join_ps)
    assert got["blame"]["fixed_ps"] == int(bl.fixed_ps)


# ---------------------------------------------------------------------------
# SF protocol counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_req", [2, 4])
def test_sf_telemetry_equals_reference(n_req):
    addr, wr, rid = P.make_skewed_stream(300, 256, write_ratio=0.3,
                                         n_requesters=n_req, seed=4,
                                         device="cpu")
    _, ev = P.simulate_sf(addr, wr, rid,
                          P.SFConfig(capacity=32, footprint_lines=256),
                          P.CacheConfig(capacity=32), n_requesters=n_req,
                          return_events=True)
    got = ptm.sf_telemetry(ev, n_requesters=n_req)
    want = rtm.sf_telemetry(_ref_tuple(RS.SFEvents, ev), n_requesters=n_req)
    _tuples_equal(want, got)
    t = int(ev.cache_hit.shape[0])
    assert int(got.fanout_hist.sum()) == t
    assert int(got.bisnp_legs) == int(P.owner_count(ev.bisnp_mask).sum())
    assert int(got.wb_lines) == int(ev.wb_lines.sum())
