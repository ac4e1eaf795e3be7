"""PyTorch port, the streaming windowed engine against the JAX reference's.

``repro_torch.core.streaming`` held to ``repro.core.streaming`` on the same
inputs on the CPU, with the families of ``tests/test_streaming.py`` at
fixed seeds (the reference compiles its window fixpoint once per window
shape, so the cases stay at the reference's sizes):

* **windowed equals monolithic**: the random, reliability-marker and
  fork/join cases at windows 1, 5 and 1000, and the built markers workload
  at window 17.  The port's collected schedule equals the port's own
  monolithic run (every valid item folded once, every row retired once)
  and the reference's streamed ``collected`` array for array; ``summary()``
  equals the reference's key for key (quantiles, blame, peak backlog,
  rounds, windows, types);
* **telemetry**: the streamed counters and sketch equal the monolithic
  `channel_telemetry` and sketch (windows 1 and 6);
* **contracts**: groups never split, out-of-order chunks and mixed layouts
  rejected, state resumed across calls, an empty carry is the identity, the
  window's carry is a copy of the frontier, the ``check`` modes (``"off"``
  raises on an unconverged window, ``"oracle"`` answers it);
* **coherence**: a `CoherenceStream` streamed equals its monolithic run;
* **chunks**: `stream_windows` on CPU tensors yields the reference's chunks,
  and `simulate_stream` takes the reference's NumPy chunks as they are;
* **the study**: `studies.streaming.run(quick=True)`'s rows equal
  ``benchmarks/bench_streaming.py``'s (``derived`` without ``req_per_s``,
  ``meta`` without the host phases).

Reference-only tests with no port counterpart: the deprecated
``max_rounds`` / ``oracle_fallback`` / ``static_check`` kwargs and
``SimOptions.use_kernel`` (the port has neither; the tensors' device picks
the serve path).  Tolerance: exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference)
from repro.core import engine as RE  # noqa: E402
from repro.core import streaming as RS  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import streaming as PS  # noqa: E402
from repro_torch.core import telemetry as PT  # noqa: E402
from test_streaming import (_join_case, _random_case,  # noqa: E402
                            _reliability_case)
from repro_torch.studies.streaming import (  # noqa: E402
    stream_matches_monolithic)
from test_torch_engine import _port  # noqa: E402

CASES = {"random": _random_case, "rel": _reliability_case,
         "join": _join_case}
SEEDS = (0, 1, 2)
WINDOWS = (1, 5, 1000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs several worker
    processes side by side)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _stream_check(ph, pc, pi, window, **kw):
    """The port's windowed run equals the port's monolithic run, bit for
    bit (`studies.streaming.stream_matches_monolithic`): every valid item's
    (start, depart, arrive) exactly once, every row's completion and gated
    first-hop arrival, the blame fold and the peak backlog."""
    mono = P.simulate(ph, pc, pi)
    assert mono.converged
    out = PS.simulate_stream(PS.stream_windows(ph, pi, window), pc,
                             collect_schedule=True, **kw)
    assert out.n_rows == ph.valid.shape[0]
    stream_matches_monolithic(ph, pc, pi, mono, out)
    return mono, out


def _summaries_equal(ref: dict, port: dict):
    assert set(ref) == set(port)
    for key, want in ref.items():
        got = port[key]
        if key == "blame":
            assert set(got) == set(want)
            for k, w in want.items():
                assert np.array_equal(np.asarray(got[k]), np.asarray(w)), k
                assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k
        elif isinstance(want, np.ndarray):
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype, \
                key
            assert np.array_equal(got, want), key
        else:
            assert type(got) is type(want) and got == want, key


def _collected_equal(ref: dict, port: dict):
    assert set(ref) == set(port)
    for key, want in ref.items():
        assert port[key].dtype == want.dtype, key
        assert np.array_equal(port[key], want), key


def _against_reference(hops, ch, issue, window):
    """Windowed equals monolithic on the port, and the port's stream equals
    the reference's: collected arrays and summary."""
    _, out = _stream_check(*_port(hops, ch, issue), window)
    ref = RS.simulate_stream(RS.stream_windows(hops, issue, window), ch,
                             collect_schedule=True)
    _collected_equal(ref.collected, out.collected)
    _summaries_equal(ref.summary(), out.summary())
    assert (out.rounds, out.converged, out.residual_ps) == \
        (ref.rounds, ref.converged, ref.residual_ps)
    return out


# ---------------------------------------------------------------------------
# the correctness contract: windowed == monolithic == the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("family", sorted(CASES))
def test_stream_equals_monolithic_and_reference(family, seed, window):
    hops, ch, issue = CASES[family](seed)
    _against_reference(hops, ch, issue, window)


def test_stream_equals_monolithic_built_workload_markers():
    """The full build path: stochastic flit reliability whose retraining
    stalls insert full-duplex mirror markers into the hop table."""
    from repro.core import topology as RT
    from repro.core.devices import RequesterSpec, build_workload
    from repro.core.link_layer import FlitConfig

    topo = RT.with_flit(RT.single_bus(n_mems=4, bw_MBps=128_000),
                        FlitConfig("flit256", ber=3e-4,
                                   reliability="stochastic", rel_seed=7,
                                   retrain_threshold=2, retrain_ps=1_000_000))
    spec = RequesterSpec(node=0, n_requests=150, targets=[2, 3, 4, 5],
                         read_ratio=0.5, issue_interval_ps=300,
                         payload_bytes=944, seed=3)
    wl = build_workload(topo.build(), [spec], warmup_frac=0.0)
    assert np.asarray(wl.hops.retrain_after_ps).any()
    out = _against_reference(wl.hops, wl.channels, np.asarray(wl.issue_ps),
                             17)
    assert out.carried_peak > 0


# ---------------------------------------------------------------------------
# streamed telemetry fold == monolithic counters and sketch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", (1, 6))
def test_stream_telemetry_matches_monolithic(window):
    hops, ch, issue = _reliability_case(3)
    ph, pc, pi = _port(hops, ch, issue)
    mono, out = _stream_check(ph, pc, pi, window)
    tel = PT.channel_telemetry(ph, pc, mono)
    acc = out.telemetry
    for f in ("payload_bytes", "wire_bytes", "busy_ps", "wait_ps"):
        assert torch.equal(getattr(acc, f), getattr(tel, f)), f
    lat = mono.complete - pi
    sk = PT.sketch_update(PT.sketch_new("cpu"), lat,
                          mask=torch.ones(lat.shape, dtype=torch.bool))
    assert torch.equal(PT.sketch_quantiles(acc.sketch),
                       PT.sketch_quantiles(sk))
    assert int(acc.n_retired) == lat.shape[0]
    ref = RS.simulate_stream(RS.stream_windows(hops, issue, window), ch)
    for f in acc._fields:
        if f != "sketch":
            assert np.array_equal(getattr(acc, f).numpy(),
                                  np.asarray(getattr(ref.telemetry, f))), f
    for f in acc.sketch._fields:
        assert np.array_equal(getattr(acc.sketch, f).numpy(),
                              np.asarray(getattr(ref.telemetry.sketch, f))), f
    s = out.summary()
    assert s["n_retired"] == lat.shape[0] and s["windows"] == out.windows


# ---------------------------------------------------------------------------
# chunk-stream contracts
# ---------------------------------------------------------------------------

def test_stream_windows_never_split_join_groups():
    ph, _, pi = _port(*_join_case(11))
    for w in (1, 2, 3):
        for ck, _ in PS.stream_windows(ph, pi, w):
            jid, jw, ja = (x.numpy() for x in (ck.join_id, ck.join_wait,
                                               ck.join_arity))
            for g in np.unique(jw[jw >= 0]):
                # every waiter's arity is satisfied inside its own chunk
                assert (jid == g).sum() == ja[jw == g].max()


def test_out_of_order_chunk_stream_rejected():
    ph, pc, pi = _port(*_random_case(1))
    chunks = list(PS.stream_windows(ph, pi, 10))[::-1]
    assert len(chunks) > 1
    with pytest.raises(ValueError, match="out of order"):
        PS.simulate_stream(chunks, pc)


def test_mixed_layout_chunk_stream_rejected():
    h1, c1, i1 = _port(*_random_case(2))
    h2, _, i2 = _port(*_reliability_case(2))
    with pytest.raises(ValueError, match="layout"):
        PS.simulate_stream([(h1, i1 - i1.min()), (h2, i2 + i1.max())],
                           P.Channels(*c1[:4]))


def test_stream_state_resumes_across_calls():
    """Two `simulate_stream` calls with the state handed across equal one
    call when the split lands on a quiescent boundary (the second segment
    issues after a gap longer than any makespan)."""
    ph, pc, pi = _port(*_random_case(33))
    early = list(PS.stream_windows(ph, pi, 4))
    late = list(PS.stream_windows(ph, pi + 2_000_000_000, 4))
    one = PS.simulate_stream(early + late, pc)
    state = PS.StreamState(pc)
    PS.simulate_stream(early, pc, state)
    b = PS.simulate_stream(late, pc, state)
    assert b.n_rows == one.n_rows == 2 * ph.channel.shape[0]
    assert int(b.telemetry.n_retired) == int(one.telemetry.n_retired)
    assert torch.equal(b.telemetry.busy_ps, one.telemetry.busy_ps)
    assert torch.equal(PT.sketch_quantiles(b.telemetry.sketch),
                       PT.sketch_quantiles(one.telemetry.sketch))


def test_empty_carry_is_identity():
    """A cold carry with its join seeds seeds the fork/join family's
    schedule as no carry does (``test_torch_engine.py`` holds the random
    family without join seeds)."""
    ph, pc, pi = _port(*_join_case(5))
    base = P.simulate(ph, pc, pi)
    seeded = P.simulate(ph, pc, pi, carry=P.empty_carry(
        pc.bw_MBps.shape[0], ph.channel.shape[0], device="cpu"))
    for f in ("start", "depart", "arrive", "complete"):
        assert torch.equal(getattr(base, f), getattr(seeded, f)), f


def test_window_carry_is_a_copy_of_the_frontier():
    """The carry a window is seeded with never aliases the host frontier
    that the window's settlement updates in place."""
    _, pc, _ = _port(*_join_case(3))
    state = PS.StreamState(pc)
    seed = np.arange(4, dtype=np.int64)
    carry = PS._carry(state, seed, torch.device("cpu"))
    for tensor, host in zip(carry, (state.ch_dep, state.ch_dir,
                                    state.ch_row, state.ch_down, seed)):
        assert tensor.dtype == torch.from_numpy(host).dtype
        before = tensor.clone()
        host += 7
        assert torch.equal(tensor, before)


def test_check_modes_guard_unconverged_windows():
    """``check="off"`` raises on a window that misses its budget; the
    default and ``"oracle"`` answer it with the oracle, as the reference
    does, and stay exact."""
    hops, ch, issue = _random_case(7)
    ph, pc, pi = _port(hops, ch, issue)
    with pytest.raises(RuntimeError, match="did not converge"):
        PS.simulate_stream(PS.stream_windows(ph, pi, 1000), pc,
                           options=P.SimOptions(max_rounds=1, check="off"))
    with pytest.raises(TypeError, match="SimOptions"):
        PS.simulate_stream(PS.stream_windows(ph, pi, 1000), pc,
                           options={"max_rounds": 1})
    for check in ("oracle", "static"):
        out = _stream_check(ph, pc, pi, 5, options=P.SimOptions(
            max_rounds=1, check=check))[1]
        ref = RS.simulate_stream(
            RS.stream_windows(hops, issue, 5), ch, collect_schedule=True,
            options=RE.SimOptions(max_rounds=1, check=check))
        assert out.oracle_windows == ref.oracle_windows > 0
        assert not out.converged and not ref.converged
        _collected_equal(ref.collected, out.collected)
        _summaries_equal(ref.summary(), out.summary())


def test_empty_chunks_are_skipped():
    ph, pc, pi = _port(*_random_case(4))
    chunks = list(PS.stream_windows(ph, pi, 6))
    empty = (P.Hops(*(None if x is None else x[:0] for x in ph)), pi[:0])
    padded = [empty] + [c for ck in chunks for c in (ck, empty)]
    a = PS.simulate_stream(chunks, pc).summary()
    b = PS.simulate_stream(padded, pc).summary()
    _summaries_equal(a, b)


# ---------------------------------------------------------------------------
# coherence: a chunked coherence stream == its monolithic run
# ---------------------------------------------------------------------------

def test_coherence_stream_matches_monolithic():
    """`test_streaming.py::test_coherence_stream_matches_monolithic` on both
    packages over the same request stream: the port's chunked
    `CoherenceStream` equals its own monolithic scan, lowering and schedule,
    and the reference's `CoherenceStream` streamed (collected arrays and
    summary)."""
    from repro.core import coherence_traffic as RC
    from repro.core import snoop_filter as RSF
    from repro.core import topology as RT
    from repro_torch.core import snoop_filter as PSF
    from repro_torch.core.coherence_traffic import (CoherenceFabricSpec,
                                                    CoherenceStream,
                                                    coherence_issue,
                                                    lower_coherence)

    kinds = [P.SWITCH, P.REQUESTER, P.REQUESTER, P.MEMORY]
    links = [P.LinkSpec(i, 0, 64_000, 26_000) for i in (1, 2, 3)]
    graph = P.Topology(np.asarray(kinds, np.int64), links,
                       name="star").build()
    spec = CoherenceFabricSpec(dev_node=3, req_nodes=(1, 2))
    sf_cfg = PSF.SFConfig(capacity=16, footprint_lines=256, policy="lru")
    ccfg = PSF.CacheConfig(capacity=8)
    addr, wr, rid = PSF.make_skewed_stream(420, 256, write_ratio=0.3,
                                           n_requesters=2, seed=4,
                                           device="cpu")
    _, ev = PSF.simulate_sf(addr, wr, rid, sf_cfg, ccfg, n_requesters=2,
                            return_events=True)
    low = lower_coherence(graph, spec, sf_cfg, addr, wr, rid, ev,
                          fanout="chain", device="cpu")
    cs = CoherenceStream(addr, wr, rid, sf_cfg, ccfg, graph, spec,
                         chunk=101, n_requesters=2, fanout="chain",
                         device="cpu")
    ch = cs.channels()
    issue = coherence_issue(low, ev.fab_issue_ps)
    mono = P.simulate(low.hops, ch, issue)
    assert mono.converged
    out = PS.simulate_stream(cs, ch, collect_schedule=True)
    stream_matches_monolithic(low.hops, ch, issue, mono, out)
    assert cs.n_done == 420 and out.n_rows == low.hops.channel.shape[0]

    rgraph = RT.Topology(np.asarray(kinds, np.int64),
                         [RT.LinkSpec(i, 0, 64_000, 26_000)
                          for i in (1, 2, 3)], name="star").build()
    rcs = RC.CoherenceStream(
        *(x.numpy() for x in (addr, wr, rid)),
        RSF.SFConfig(capacity=16, footprint_lines=256, policy="lru"),
        RSF.CacheConfig(capacity=8), rgraph,
        RC.CoherenceFabricSpec(dev_node=3, req_nodes=(1, 2)), chunk=101,
        n_requesters=2, fanout="chain")
    ref = RS.simulate_stream(rcs, rcs.channels(), collect_schedule=True)
    _collected_equal(ref.collected, out.collected)
    _summaries_equal(ref.summary(), out.summary())


# ---------------------------------------------------------------------------
# chunks: the port's splitter and the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(CASES))
def test_stream_windows_yield_the_reference_chunks(family):
    hops, ch, issue = CASES[family](6)
    ph, _, pi = _port(hops, ch, issue)
    for w in (1, 3):
        ref = list(RS.stream_windows(hops, issue, w))
        got = list(PS.stream_windows(ph, pi, w))
        assert len(got) == len(ref)
        for (gh, gi), (rh, ri) in zip(got, ref):
            assert isinstance(gi, torch.Tensor)
            assert np.array_equal(gi.numpy(), np.asarray(ri))
            for f in RE.Hops._fields:
                g, r = getattr(gh, f), getattr(rh, f)
                assert (g is None) == (r is None), f
                if g is not None:
                    assert isinstance(g, torch.Tensor), f
                    assert np.array_equal(g.numpy(), np.asarray(r)), f
                    assert g.numpy().dtype == np.asarray(r).dtype, f


def test_simulate_stream_takes_numpy_chunks():
    """Chunks given as host arrays (here the reference's splitter's) run as
    the port's own tensor chunks do."""
    hops, ch, issue = _join_case(2)
    ph, pc, pi = _port(hops, ch, issue)
    chunks = [(RE.Hops(*(None if x is None else np.asarray(x) for x in h)),
               np.asarray(i)) for h, i in RS.stream_windows(hops, issue, 4)]
    a = PS.simulate_stream(chunks, pc, collect_schedule=True)
    b = PS.simulate_stream(PS.stream_windows(ph, pi, 4), pc,
                           collect_schedule=True)
    _collected_equal(b.collected, a.collected)
    _summaries_equal(b.summary(), a.summary())


# ---------------------------------------------------------------------------
# the study, against benchmarks/bench_streaming.py
# ---------------------------------------------------------------------------

_STUDY = {}


def _study_rows():
    """Both studies' quick rows, run once per module: (port, reference),
    each as (name, derived without req_per_s, meta without host phases)."""
    if not _STUDY:
        import benchmarks.bench_streaming as RB
        from repro_torch.studies import streaming as PB

        def strip(rows):
            return [(r.name,
                     ";".join(p for p in r.derived.split(";")
                              if not p.startswith("req_per_s=")),
                     {k: v for k, v in r.meta.items() if k != "host_phases"})
                    for r in rows]

        port = PB.run(quick=True, device="cpu")
        _STUDY["phases"] = port[0].meta["host_phases"]
        _STUDY["rows"] = (strip(port), strip(RB.run(quick=True)))
    return _STUDY["rows"]


@pytest.mark.parametrize("row", ("streaming/windowed_trace",
                                 "streaming/equivalence_gate"))
def test_study_rows_equal_reference(row):
    port, ref = _study_rows()
    assert [r[0] for r in port] == [r[0] for r in ref]
    (got,) = [r for r in port if r[0] == row]
    (want,) = [r for r in ref if r[0] == row]
    assert got == want
    assert {f"stream.{s}" for s in PS.STEPS} <= set(_STUDY["phases"])
