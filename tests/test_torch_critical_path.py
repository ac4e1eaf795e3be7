"""PyTorch port, the observability back end against the JAX reference's.

``repro_torch.core.critical_path`` and ``trace_export`` held to
``repro.core.critical_path`` and ``trace_export`` on the same inputs on the
CPU, with the families of ``tests/test_critical_path.py`` and the trace
families of ``tests/test_telemetry.py``:

* the random, reliability-marker and fork/join cases of
  ``test_streaming`` (fixed seeds) cross over with
  `repro_torch.core.convert`; the port resolves the schedule (its engine is
  held bit for bit to the reference's in ``test_torch_engine.py``) and both
  packages extract from that schedule: every `Backpointers` array, every
  `PathEdge` list, the blame tables and rollups, the what-ifs and the trace
  dicts (with flows and blame) are equal;
* the hand-built bindings (QUEUE, RETRAIN, JOIN, the unused-channel
  what-if) on the port, the pure-observer check, and ``check=True``
  raising the reference's message on a corrupted schedule;
* `hop_legs` / `leg_blame` on both fan-outs of a coherence lowering;
* the streamed families at fixed seeds x windows x families: the port's
  streamed blame and peak backlog (`core.streaming`) equal the reference's
  monolithic `channel_blame` and `channel_telemetry`.  `_reliability_case`
  seeds 86 and 236 build a link-down marker on a channel with a turnaround:
  under the default check both packages reject them at the door with the
  same ``rel.marker`` finding, and under ``check="oracle"`` their streamed
  blame equals the monolithic one (this rejection is what fails the
  reference's Hypothesis test on seed 236, not a divergence of the fold);
* `studies.critical_path` against ``benchmarks/bench_critical_path.py``'s
  three rows and artifact, and `studies.fabric_trace_viewer` against
  ``examples/fabric_trace_viewer.py`` (printout and trace file), at
  ``--quick``.

Tolerance: exact.  Integers, edge lists, tables and trace dicts are equal;
the what-ifs' float64 ``wire / factor`` truncates the same way on both
sides.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 for the reference)
from repro.core import coherence_traffic as RC  # noqa: E402
from repro.core import critical_path as rcp  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core import streaming as RS  # noqa: E402
from repro.core import telemetry as rtm  # noqa: E402
from repro.core import verify as RV  # noqa: E402
from repro.core import trace_export as rtx  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import coherence_traffic as PC  # noqa: E402
from repro_torch.core import critical_path as pcp  # noqa: E402
from repro_torch.core import engine as PE  # noqa: E402
from repro_torch.core import streaming as PS  # noqa: E402
from repro_torch.core import trace_export as ptx  # noqa: E402
from repro_torch.studies.streaming import _blame_equal  # noqa: E402
from test_streaming import (_join_case, _random_case,  # noqa: E402
                            _reliability_case)
from test_telemetry import FLIT_CONFIGS, _bus_wl  # noqa: E402
from test_torch_coherence import (_events, _graphs,  # noqa: E402
                                  _stream, _tensors)
from test_torch_engine import _port  # noqa: E402
from test_torch_telemetry import _ref_schedule, _ref_tuple  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CASES = {"random": _random_case, "rel": _reliability_case,
         "join": _join_case}
SEEDS = (0, 3, 5, 11)
FAMILY_SEEDS = [(f, s) for f in sorted(CASES) for s in SEEDS]
BP_ARRAYS = ("issue", "arrive", "start", "depart", "complete", "valid",
             "serving", "channel", "wire", "row_extra", "fixed", "bind",
             "qpred_row", "qpred_hop", "rsrc_row", "rsrc_hop", "gate_row")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs several worker
    processes side by side)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_CASES = {}


def _case(family, seed):
    """(port hops, channels, issue, schedule, backpointers; the reference's
    same five) of one case, built and extracted once per module: the port
    resolves the schedule and both packages extract from it."""
    key = (family, seed)
    if key not in _CASES:
        hops, ch, issue = CASES[family](seed)
        ph, pc, pi = _port(hops, ch, issue)
        ps = P.simulate(ph, pc, pi)
        assert ps.converged
        rh, rc = _ref_tuple(RE.Hops, ph), _ref_tuple(RE.Channels, pc)
        ri, rs = np.asarray(issue), _ref_schedule(ps)
        _CASES[key] = ((ph, pc, pi, ps,
                        pcp.extract_backpointers(ph, pc, ps, pi)),
                       (rh, rc, ri, rs,
                        rcp.extract_backpointers(rh, rc, rs, ri)))
    return _CASES[key]


def _bp_equal(ref, port):
    assert (ref.n, ref.h, ref.c) == (port.n, port.h, port.c)
    for f in BP_ARRAYS:
        a, b = getattr(ref, f), getattr(port, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _what_ifs_equal(ref, port):
    assert set(ref) == set(port)
    for key, want in ref.items():
        got = port[key]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), key
        else:
            assert type(got) is type(want) and got == want, key


# ---------------------------------------------------------------------------
# the replay, the paths, the blame, the what-ifs, the trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_wire_ser_ps_equals_engine(seed):
    """The host replay's serialization equals the engine's on the rel
    family's flit tables (replay bytes, mixed flit and byte channels)."""
    hops, ch, _ = _reliability_case(seed)
    ph, pc, _ = _port(hops, ch, np.zeros(hops.channel.shape[0], np.int64))
    c = pc.bw_MBps.shape[0]
    clip = torch.clamp_max(ph.channel.long(), c - 1).reshape(-1)
    for ppm in (None, np.array([0, 1_000, 250_000, 1_000_000_000])):
        if ppm is not None:
            pc = pc._replace(replay_ppm=torch.from_numpy(
                np.resize(ppm, c).astype(np.int64)))
        want = PE.wire_ser_ps(ph.nbytes.reshape(-1), pc, clip,
                              extra_wire=ph.extra_wire_bytes.reshape(-1))
        got = pcp._np_wire_ser_ps(ph.nbytes.reshape(-1).numpy(), pc,
                                  clip.numpy(),
                                  ph.extra_wire_bytes.reshape(-1).numpy())
        assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("family,seed", FAMILY_SEEDS)
def test_backpointers_equal_reference(family, seed):
    (*_, pbp), (*_, rbp) = _case(family, seed)
    _bp_equal(rbp, pbp)


@pytest.mark.parametrize("family,seed", FAMILY_SEEDS)
def test_paths_and_blame_equal_reference(family, seed):
    (*_, pbp), (*_, rbp) = _case(family, seed)
    ppaths, rpaths = pcp.critical_paths(pbp), rcp.critical_paths(rbp)
    assert [[tuple(e) for e in p] for p in ppaths] == \
        [[tuple(e) for e in p] for p in rpaths]
    assert all(type(v) is int for p in ppaths for e in p for v in e)
    pbl, rbl = pcp.blame(pbp, paths=ppaths), rcp.blame(rbp, paths=rpaths)
    assert pbl.table.dtype == rbl.table.dtype
    assert np.array_equal(pbl.table, rbl.table)
    assert (pbl.n_requests, pbl.total_ps) == (rbl.n_requests, rbl.total_ps)
    assert pbl.by_kind() == rbl.by_kind()
    assert pbl.top(5) == rbl.top(5)
    assert np.array_equal(pbl.by_channel(), rbl.by_channel())
    # a subset of rows, as the main path asks for them
    rows = list(range(0, pbp.n, 3))
    assert [list(p) for p in pcp.critical_paths(pbp, rows=rows)] == \
        [list(p) for p in rcp.critical_paths(rbp, rows=rows)]
    assert np.array_equal(pcp.blame(pbp, rows=rows).table,
                          rcp.blame(rbp, rows=rows).table)


@pytest.mark.parametrize("family,seed", FAMILY_SEEDS)
def test_speedup_if_equals_reference(family, seed):
    (*_, pbp), (*_, rbp) = _case(family, seed)
    busiest = int(np.argmax(rcp.blame(rbp).by_channel()[:-1]))
    for factor in (1.0, 2.0, 4.0):
        _what_ifs_equal(rcp.speedup_if(rbp, busiest, factor),
                        pcp.speedup_if(pbp, busiest, factor))
    assert pcp.speedup_if(pbp, busiest, 1.0)["saved_ps"] == 0


@pytest.mark.parametrize("family,seed", FAMILY_SEEDS)
def test_schedule_trace_equals_reference(family, seed):
    (ph, pc, _, ps, pbp), (rh, rc, _, rs, rbp) = _case(family, seed)
    got = ptx.schedule_trace(ph, pc, ps, flows=pbp, blame=pcp.blame(pbp))
    want = rtx.schedule_trace(rh, rc, rs, flows=rbp, blame=rcp.blame(rbp))
    assert json.dumps(got) == json.dumps(want)
    assert ptx.validate_trace(got) == []


@pytest.mark.parametrize("mode", sorted(FLIT_CONFIGS))
def test_bus_trace_equals_reference(mode):
    """The trace families of ``test_telemetry.py``: the link-reliability
    bus in every flit mode, with the names of its channel tracks."""
    wl = _bus_wl(FLIT_CONFIGS[mode], n=40)
    ph, pc, pi = _port(wl.hops, wl.channels, np.asarray(wl.issue_ps))
    ps = P.simulate(ph, pc, pi)
    got = ptx.schedule_trace(ph, pc, ps)
    want = rtx.schedule_trace(wl.hops, wl.channels, _ref_schedule(ps))
    assert json.dumps(got) == json.dumps(want)
    assert ptx.validate_trace(got) == [] and ptx.validate_trace(
        json.dumps(got)) == []


def _flow(ph, ts, fid=1, **kw):
    e = {"ph": ph, "pid": 0, "tid": 0, "ts": ts, "cat": "critical_path",
         "name": "queue", "id": fid}
    e.update(kw)
    return e


def _malformed(evs):
    """The reference suite's malformed traces (``test_telemetry.py``)."""
    i_b = max(i for i, e in enumerate(evs) if e["ph"] == "B")
    return [
        {"traceEvents": evs[:i_b] + evs[i_b + 1:]},
        {"traceEvents": list(reversed(evs))},
        "not json {", {"foo": 1}, {"traceEvents": {"a": 1}},
        {"traceEvents": [{"nope": 1}]},
        {"traceEvents": [{"ph": "B", "pid": 0, "tid": 0, "ts": -5,
                          "name": "x"}]},
        {"traceEvents": [_flow("s", 0), _flow("f", 5, bp="e")]},
        {"traceEvents": [_flow("s", 0), _flow("t", 2),
                         _flow("f", 5, bp="e")]},
        {"traceEvents": [_flow("s", 0)]},
        {"traceEvents": [_flow("f", 5, bp="e")]},
        {"traceEvents": [_flow("t", 2)]},
        {"traceEvents": [_flow("s", 0), _flow("s", 1),
                         _flow("f", 5, bp="e")]},
        {"traceEvents": [_flow("s", 0), _flow("s", 1, cat="other"),
                         _flow("f", 5, bp="e")]},
        {"traceEvents": [{"ph": "s", "pid": 0, "tid": 0, "ts": 0,
                          "cat": "critical_path", "name": "queue"}]},
        {"traceEvents": [{"ph": "s", "pid": 0, "tid": 0, "ts": 0,
                          "cat": "critical_path", "id": 1},
                         _flow("f", 5, bp="e")]},
        {"traceEvents": [_flow("s", 10), _flow("f", 3, bp="e")]},
    ]


def test_validate_trace_equals_reference_on_malformed():
    (ph, pc, _, ps, pbp), _ = _case("rel", 3)
    evs = ptx.schedule_trace(ph, pc, ps, flows=pbp)["traceEvents"]
    cases = _malformed(evs)
    verdicts = [ptx.validate_trace(x) for x in cases]
    assert verdicts == [rtx.validate_trace(x) for x in cases]
    assert sum(v == [] for v in verdicts) == 2  # the two well-formed flows


def test_merge_intervals_equals_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        lo = rng.integers(0, 100, 12)
        spans = [(int(a), int(a + b)) for a, b in
                 zip(lo, rng.integers(0, 30, 12))]
        assert ptx._merge_intervals(spans) == rtx._merge_intervals(spans)


# ---------------------------------------------------------------------------
# hand-built bindings, one case per gating family, and the observer
# ---------------------------------------------------------------------------

def _one_chan(turn=0, rh=0, rm=0, c=1):
    return P.Channels(*(torch.tensor(x, dtype=torch.int64) for x in (
        [1000] * c, [turn] * c, [rh] * c, [rm] * c)))


def _hops_1hop(nbytes, dirn, retrain=None):
    n = len(nbytes)
    return P.Hops(
        channel=torch.zeros((n, 1), dtype=torch.int32),
        nbytes=torch.tensor(nbytes, dtype=torch.int64).reshape(n, 1),
        direction=torch.tensor(dirn, dtype=torch.int8).reshape(n, 1),
        row=torch.full((n, 1), -1, dtype=torch.int32),
        fixed_after_ps=torch.zeros((n, 1), dtype=torch.int64),
        is_payload=torch.ones((n, 1), dtype=torch.bool),
        valid=torch.ones((n, 1), dtype=torch.bool),
        retrain_after_ps=None if retrain is None else torch.tensor(
            retrain, dtype=torch.int64).reshape(n, 1))


def _extract(hops, ch, issue):
    issue = torch.tensor(issue, dtype=torch.int64)
    sched = P.simulate(hops, ch, issue)
    assert sched.converged
    return sched, pcp.extract_backpointers(hops, ch, sched, issue)


def test_queue_binding_and_edge():
    # row 1 waits for row 0's grant on the shared channel + the direction
    # turnaround; its path must cross to row 0 through a QUEUE edge
    _, bp = _extract(_hops_1hop([1000, 1000], [0, 1]), _one_chan(turn=700),
                     [0, 0])
    assert bp.bind[1, 0] == pcp.B_QUEUE
    assert (bp.qpred_row[1, 0], bp.qpred_hop[1, 0]) == (0, 0)
    path = pcp.critical_path(bp, 1)
    q = next(e for e in path if e.kind == pcp.K_QUEUE)
    assert q.ps == 700 and (q.src_row, q.src_hop) == (0, 0)
    assert sum(e.ps for e in path if e.kind == pcp.K_WIRE) == 2_000_000
    assert pcp.path_total(path) == int(bp.complete[1]) - int(bp.issue[1])


def test_retrain_binding_and_edge():
    # row 0's transmission triggers a 500 ns down window; row 1 arrives
    # mid-window, so its grant binds to the retrain release
    _, bp = _extract(_hops_1hop([1000, 1000], [0, 0], retrain=[500_000, 0]),
                     _one_chan(), [0, 1_200_000])
    assert bp.bind[1, 0] == pcp.B_RETRAIN
    assert (bp.rsrc_row[1, 0], bp.rsrc_hop[1, 0]) == (0, 0)
    path = pcp.critical_path(bp, 1)
    r = next(e for e in path if e.kind == pcp.K_RETRAIN)
    assert r.ps == 300_000          # 1.5e6 release - 1.2e6 arrival
    assert pcp.path_total(path) == int(bp.complete[1]) - int(bp.issue[1])


def test_join_gate_edge():
    """A seeded join case whose slowest contributor gates a row's path
    surfaces the JOIN edge (the reference's scan over seeds)."""
    for seed in range(40):
        hops, ch, issue = _join_case(seed)
        _, bp = _extract(*_port(hops, ch, issue)[:2], np.asarray(issue))
        for r in np.nonzero(bp.gate_row >= 0)[0]:
            path = pcp.critical_path(bp, int(r))
            j = next((e for e in path if e.kind == pcp.K_JOIN), None)
            if j is None:
                continue
            assert j.row == r and j.hop == -1
            assert j.src_row == int(bp.gate_row[r])
            assert pcp.path_total(path) == (int(bp.complete[r])
                                            - int(bp.issue[r]))
            return
    pytest.fail("no seeded join case surfaced a JOIN edge")


def test_speedup_if_unused_channel_noop():
    _, bp = _extract(_hops_1hop([1000, 1000], [0, 0]), _one_chan(c=2),
                     [0, 0])
    assert pcp.speedup_if(bp, 1, 16.0)["saved_ps"] == 0


@pytest.mark.parametrize("family", sorted(CASES))
def test_extraction_is_pure_observer(family):
    """Extraction writes to none of its inputs and its arrays alias none of
    them; re-simulating afterwards gives the same schedule bit for bit."""
    hops, ch, issue = CASES[family](4)
    ph, pc, pi = _port(hops, ch, issue)
    sched = P.simulate(ph, pc, pi)
    inputs = [x for t in (ph, pc) for x in t if x is not None]
    inputs += [pi] + [getattr(sched, f) for f in ("arrive", "start",
                                                  "depart", "complete")]
    snap = [x.clone() for x in inputs]
    bp = pcp.extract_backpointers(ph, pc, sched, pi)
    for name in BP_ARRAYS:
        getattr(bp, name)[...] = 0   # the arrays are the observer's own
    assert all(torch.equal(a, b) for a, b in zip(snap, inputs))
    again = P.simulate(ph, pc, pi)
    for f in ("arrive", "start", "depart", "complete"):
        assert torch.equal(getattr(sched, f), getattr(again, f)), f


@pytest.mark.parametrize("field,message", [
    ("start", "backpointer replay diverged: start"),
    ("depart", "backpointer replay diverged: depart"),
    ("arrive", "backpointer replay diverged: arrive"),
])
def test_check_raises_reference_message(field, message):
    (ph, pc, pi, ps, _), (rh, rc, ri, _, _) = _case("rel", 5)
    serving = (ph.valid & (ph.nbytes > 0)).nonzero()
    r, j = (int(x) for x in serving[len(serving) // 2])
    bad = getattr(ps, field).clone()
    if field == "arrive":
        r, j = r, ph.channel.shape[1]  # a completion: read by no grant
    bad[r, j] += 1
    ps_bad = ps._replace(**{field: bad})
    with pytest.raises(AssertionError, match=message):
        pcp.extract_backpointers(ph, pc, ps_bad, pi)
    with pytest.raises(AssertionError, match=message):
        rcp.extract_backpointers(rh, rc, _ref_schedule(ps_bad), ri)
    pcp.extract_backpointers(ph, pc, ps_bad, pi, check=False)


# ---------------------------------------------------------------------------
# coherence lowering: protocol legs, by_switch on a built fabric
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fanout", ["chain", "concurrent"])
def test_hop_legs_and_leg_blame_equal_reference(fanout):
    (rgraph, rspec), (pgraph, pspec) = _graphs("star")
    stream = _stream(n=100, footprint=128, write_ratio=0.4, seed=7)
    rcfg, rev, pcfg, pev = _events(stream, 16, 128, 2)
    rlow = RC.lower_coherence(rgraph, rspec, rcfg,
                              *(jnp.asarray(x) for x in stream), rev,
                              fanout=fanout)
    plow = PC.lower_coherence(pgraph, pspec, pcfg, *_tensors(stream), pev,
                              fanout=fanout, device="cpu")
    rlegs, plegs = RC.hop_legs(rlow), PC.hop_legs(plow)
    assert plegs.dtype == rlegs.dtype and np.array_equal(plegs, rlegs)

    ch = P.make_channels(pgraph, device="cpu")
    issue = PC.coherence_issue(plow, pev.fab_issue_ps)
    sched = P.simulate(plow.hops, ch, issue)
    assert sched.converged
    pbp = pcp.extract_backpointers(plow.hops, ch, sched, issue)
    rbp = rcp.extract_backpointers(
        rlow.hops, RE.make_channels(rgraph), _ref_schedule(sched),
        issue.numpy())
    _bp_equal(rbp, pbp)
    ppaths, rpaths = pcp.critical_paths(pbp), rcp.critical_paths(rbp)
    lb = PC.leg_blame(plow, ppaths)
    assert lb == RC.leg_blame(rlow, rpaths)
    assert sum(lb.values()) == sum(pcp.path_total(p) for p in ppaths)
    assert lb["service"] > 0
    assert pcp.blame(pbp, paths=ppaths).by_switch(pgraph) == \
        rcp.blame(rbp, paths=rpaths).by_switch(rgraph)
    assert ptx.channel_names(pgraph) == rtx.channel_names(rgraph)


# ---------------------------------------------------------------------------
# streamed fold == monolithic blame / peak backlog, on both packages
# ---------------------------------------------------------------------------

STREAM_SEEDS = (0, 3)
STREAM_WINDOWS = (1, 7, 1000)
# the only `_reliability_case` seeds of 0-399 whose tables hold a link-down
# marker on a channel with a turnaround: the verifier rejects them
REJECTED_SEEDS = (86, 236)
_MONO = {}


def _mono(family, seed):
    """The reference's monolithic `channel_blame` and peak backlog of one
    case, computed once per module (on the `_case` tables and schedule
    where the case has them)."""
    key = (family, seed)
    if key not in _MONO:
        if key in _CASES or seed in SEEDS:
            _, (hops, ch, issue, sched, _) = _case(family, seed)
        else:
            hops, ch, issue = CASES[family](seed)
            sched = RE.simulate(hops, ch, jnp.asarray(issue))
            assert bool(sched.converged)
        _MONO[key] = (rtm.channel_blame(hops, ch, sched, jnp.asarray(issue)),
                      np.asarray(rtm.channel_telemetry(hops, ch,
                                                       sched).peak_backlog))
    return _MONO[key]


def _stream_port(family, seed, window, options=None):
    ph, pc, pi = _port(*CASES[family](seed))
    return PS.simulate_stream(PS.stream_windows(ph, pi, window), pc,
                              options=options)


@pytest.mark.parametrize("window", STREAM_WINDOWS)
@pytest.mark.parametrize("family,seed", [(f, s) for f in sorted(CASES)
                                         for s in STREAM_SEEDS])
def test_streamed_blame_equals_monolithic(family, seed, window):
    """`test_critical_path.py::test_streamed_blame_equals_monolithic` at
    fixed seeds: the port's streamed blame equals the reference's
    monolithic `channel_blame` bit for bit."""
    _blame_equal(_stream_port(family, seed, window).summary()["blame"],
                 _mono(family, seed)[0])


@pytest.mark.parametrize("window", STREAM_WINDOWS)
@pytest.mark.parametrize("family,seed", [(f, s) for f in sorted(CASES)
                                         for s in STREAM_SEEDS])
def test_streamed_peak_backlog_equals_monolithic(family, seed, window):
    got = _stream_port(family, seed, window).summary()["peak_backlog"]
    assert np.array_equal(got, _mono(family, seed)[1])


def test_stream_fixpoint_diagnostics():
    s = _stream_port("random", 2, 5).summary()
    assert s["windows_converged"] == s["windows"]
    assert s["rounds_sum"] >= s["windows"] >= 1
    assert 1 <= s["rounds_max"] <= s["rounds_sum"]


@pytest.mark.parametrize("window", (1, 5, 64))
@pytest.mark.parametrize("seed", REJECTED_SEEDS)
def test_rejected_reliability_seeds_raise_as_reference(seed, window):
    """Under the default ``check="static"`` both packages verify every
    chunk at the door and reject these seeds with the same ``rel.marker``
    finding (a link-down marker on a channel with a turnaround), at the
    same row, hop and channel of the same chunk."""
    hops, ch, issue = _reliability_case(seed)
    with pytest.raises(RV.VerifyError) as ref:
        RS.simulate_stream(RS.stream_windows(hops, issue, window), ch)
    with pytest.raises(P.VerifyError) as port:
        _stream_port("rel", seed, window)
    assert ref.value.report.findings[0].code == "rel.marker"
    assert port.value.report.findings == ref.value.report.findings
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("window", (1, 2, 5, 64))
@pytest.mark.parametrize("seed", REJECTED_SEEDS)
def test_rejected_reliability_seeds_blame_under_oracle_check(seed, window):
    """With ``SimOptions(check="oracle")`` (no verifier) the streamed blame
    of these seeds equals the reference's monolithic `channel_blame`: the
    reference-side failure of ``test_streamed_blame_equals_monolithic`` is
    the verifier's rejection, not a divergence of the fold."""
    s = _stream_port("rel", seed, window,
                     P.SimOptions(check="oracle")).summary()
    mb, peak = _mono("rel", seed)
    _blame_equal(s["blame"], mb)
    assert np.array_equal(s["peak_backlog"], peak)
    assert int(mb.retrain_ps.sum()) > 0


# ---------------------------------------------------------------------------
# the study and the trace viewer, against the reference's bench and example
# ---------------------------------------------------------------------------

def _without_phases(meta):
    return {k: v for k, v in meta.items() if k != "host_phases"}


def test_study_rows_and_artifact_equal_reference(tmp_path, monkeypatch):
    """`studies.critical_path.run(quick=True)` gives the reference bench's
    three rows (names, ``derived``, ``meta`` but the host phases) and the
    same artifact entries, the streamed blame gate's included."""
    import benchmarks.bench_critical_path as RB
    from repro_torch.studies import critical_path as PB

    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    got = PB.run(quick=True, device="cpu")
    port_art = json.loads(Path(PB.ARTIFACT).read_text())
    monkeypatch.chdir(tmp_path / "ref")
    want = RB.run(quick=True)
    ref_art = json.loads(Path(RB.ARTIFACT).read_text())
    assert [r.name for r in got] == [r.name for r in want]
    assert got[-1].name == "critical_path/streaming_blame_gate"
    for g, w in zip(got, want):
        assert (g.name, g.derived, _without_phases(g.meta)) == \
            (w.name, w.derived, _without_phases(w.meta))
        assert set(g.meta["host_phases"]) <= {
            "lower", "sf_scan", "verify", "simulate", "execute", "build"}
    assert set(port_art) == set(ref_art)
    for key in ("coherence_fabric", "reliability_bus", "streaming_smoke",
                "kinds"):
        assert port_art[key] == ref_art[key], key


def _printed(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue()


def test_viewer_prints_what_the_example_prints(tmp_path, monkeypatch):
    """``--quick``: the printout (attribution, sketch quantiles, hottest
    channel, the coupled fixpoint's iterations and residuals, the trace's
    event count) and the trace file equal the example's."""
    from repro_torch.studies import fabric_trace_viewer as PV

    spec = importlib.util.spec_from_file_location(
        "fabric_trace_viewer_example",
        REPO / "examples" / "fabric_trace_viewer.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    got = _printed(lambda: PV.main(["--quick", "--device", "cpu",
                                    "--out", "trace.json"]))
    monkeypatch.chdir(tmp_path / "ref")
    monkeypatch.setattr("sys.argv", ["x", "--quick", "--out", "trace.json"])
    want = _printed(ex.main)
    assert got == want
    assert "events on 13 channel tracks" in got
    assert (tmp_path / "port" / "trace.json").read_bytes() == \
        (tmp_path / "ref" / "trace.json").read_bytes()
