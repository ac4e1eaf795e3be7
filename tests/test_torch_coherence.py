"""PyTorch port, fabric-coupled coherence against the JAX reference.

The families of `tests/test_coherence_traffic.py`, on the port on the CPU:
the isolated-mode goldens and the chain-layout goldens (the reference's
constants); the lowering of both fan-outs (hop tables, column maps, row
and snoop maps equal to the reference's); engine runs of the lowered
tables equal to the port's oracle and to the reference's engine, with
background traffic; `simulate_coupled` equal to the reference's (every
iteration count, latency, BISnp round trip and schedule), damped and
undamped, and `coupled_fixpoint`'s members equal to their runs alone; the
join on the slowest BIRsp; upgrade-BISnp rows; `pad_rows`;
retraining markers under both layouts, link-down markers, credit DLLPs and
adaptive routing on the port; the trace stream contract; and
`CoherenceStream`'s chunks equal to the reference's.

Tolerance: exact equality (int64 picoseconds and integer tables).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402  (x64 for the reference)
from repro.core import coherence_traffic as RC  # noqa: E402
from repro.core import engine as RE  # noqa: E402
from repro.core import snoop_filter as RS  # noqa: E402
from repro.core import topology as RT  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import coherence_traffic as PC  # noqa: E402
from repro_torch.core import snoop_filter as PS  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402
from test_torch_engine import _port, _schedules_equal  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs several worker
    processes side by side)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _star(T, spec_cls, n_req=2, n_extra=0, bw=64_000, fixed=26_000):
    kinds = ([T.SWITCH] + [T.REQUESTER] * n_req + [T.MEMORY]
             + [T.REQUESTER] * n_extra)
    links = [T.LinkSpec(i, 0, bw, fixed) for i in range(1, len(kinds))]
    graph = T.Topology(np.asarray(kinds, np.int64), links,
                       name="star").build()
    return graph, spec_cls(dev_node=n_req + 1,
                           req_nodes=tuple(range(1, n_req + 1)))


def _chain2(T, spec_cls, n_req=2):
    kinds = [T.SWITCH, T.SWITCH] + [T.REQUESTER] * n_req + [T.MEMORY]
    links = [T.LinkSpec(0, 1, 64_000, 26_000)]
    links += [T.LinkSpec(2 + i, 0, 64_000, 26_000) for i in range(n_req)]
    links.append(T.LinkSpec(2 + n_req, 1, 64_000, 26_000))
    graph = T.Topology(np.asarray(kinds, np.int64), links,
                       name="chain2").build()
    return graph, spec_cls(dev_node=2 + n_req,
                           req_nodes=tuple(range(2, 2 + n_req)))


def _stochastic(T, spec_cls, link_layer):
    flit = link_layer.FlitConfig("flit256", ber=2e-4,
                                 reliability="stochastic", rel_seed=5,
                                 retrain_threshold=2, retrain_ps=500_000)
    kinds = [T.SWITCH, T.REQUESTER, T.REQUESTER, T.MEMORY]
    links = [T.LinkSpec(i, 0, 128_000, 26_000, flit=flit)
             for i in range(1, 4)]
    graph = T.Topology(np.asarray(kinds, np.int64), links,
                       name="star-sto").build()
    return graph, spec_cls(dev_node=3, req_nodes=(1, 2))


def _graphs(kind="star", **kw):
    """The same fabric built by each package: (reference, port)."""
    if kind == "stochastic":
        return (_stochastic(RT, RC.CoherenceFabricSpec, R.link_layer),
                _stochastic(PT, PC.CoherenceFabricSpec, P.link_layer))
    make = _star if kind == "star" else _chain2
    return (make(RT, RC.CoherenceFabricSpec, **kw),
            make(PT, PC.CoherenceFabricSpec, **kw))


def _tensors(stream):
    return tuple(torch.from_numpy(np.array(x)) for x in stream)


def _stream(n=400, footprint=256, n_req=2, write_ratio=0.3, seed=4):
    return tuple(np.asarray(x) for x in RS.make_skewed_stream(
        n, footprint, write_ratio=write_ratio, n_requesters=n_req,
        seed=seed))


_SCANS = {}


def _events(stream, capacity, footprint, n_req, policy="fifo"):
    """Both scans' events (they are equal: test_torch_snoop_filter.py),
    each scan pair run once per stream and configuration in this module
    (the cases of both fan-outs share it)."""
    key = (tuple(np.asarray(x).tobytes() for x in stream), capacity,
           footprint, n_req, policy)
    if key not in _SCANS:
        rcfg = RS.SFConfig(capacity=capacity, policy=policy,
                           footprint_lines=footprint)
        pcfg = PS.SFConfig(capacity=capacity, policy=policy,
                           footprint_lines=footprint)
        _, rev = RS.simulate_sf(*(jnp.asarray(x) for x in stream), rcfg,
                                RS.CacheConfig(capacity=capacity),
                                n_requesters=n_req, return_events=True)
        _, pev = PS.simulate_sf(*_tensors(stream), pcfg,
                                PS.CacheConfig(capacity=capacity),
                                n_requesters=n_req, return_events=True)
        _SCANS[key] = (rcfg, rev, pcfg, pev)
    return _SCANS[key]


def _hops_equal(ref, port, what=""):
    for f in RE.Hops._fields:
        a, b = getattr(ref, f), getattr(port, f)
        assert (a is None) == (b is None), (what, f)
        if a is not None:
            assert np.array_equal(np.asarray(a), b.numpy()), (what, f)


def _lowerings_equal(ref, port):
    _hops_equal(ref.hops, port.hops)
    for f in ("fwd_cols", "snoop_cols", "n_snoop", "svc_col", "n_cols",
              "fanout"):
        assert getattr(ref, f) == getattr(port, f), f
    for f in ("miss", "col_map", "row_req", "snoop_rows"):
        a, b = getattr(ref, f), getattr(port, f)
        assert (a is None and b is None) or np.array_equal(a, b), f


def _lower_both(graphs, stream, capacity, footprint, n_req, fanout,
                upgrade=None, policy="fifo"):
    (rg, rspec), (pg, pspec) = graphs
    rcfg, rev, pcfg, pev = _events(stream, capacity, footprint, n_req,
                                   policy)
    rlow = RC.lower_coherence(rg, rspec, rcfg, *stream, rev, fanout=fanout,
                              upgrade_bisnp=upgrade)
    plow = PC.lower_coherence(pg, pspec, pcfg, *_tensors(stream), pev,
                              fanout=fanout, upgrade_bisnp=upgrade)
    _lowerings_equal(rlow, plow)
    return rlow, rev, plow, pev


# ---------------------------------------------------------------------------
# goldens of the reference's tests
# ---------------------------------------------------------------------------

GOLDEN = {   # tests/test_coherence_traffic.py::GOLDEN
    ("fifo", 1, 0): (165750000, 1001360, 509, 509, 83114000,
                     16282, 194, 17081),
    ("lifo", 1, 0): (134449000, 898936, 432, 432, 67357000,
                     16075, 199, 17641),
    ("blp", 2, 12000): (248789155, 1691133, 541, 885, 124569410,
                        24316, 155, 24844),
}


@pytest.mark.parametrize("key", sorted(GOLDEN))
def test_isolated_default_bitexact_golden(key):
    policy, invblk, bus = key
    addr, wr, rid = PS.make_skewed_stream(2000, 512, write_ratio=0.2,
                                          n_requesters=2, seed=9,
                                          device="cpu")
    cfg = PS.SFConfig(capacity=102, policy=policy, invblk_max=invblk,
                      footprint_lines=512, bus_MBps=bus)
    r = PS.simulate_sf(addr, wr, rid, cfg, PS.CacheConfig(capacity=102),
                       n_requesters=2)
    lat = r.latency_ps.numpy()
    got = (int(lat.sum()), int(np.bitwise_xor.reduce(lat)),
           int(r.bisnp_events), int(r.invalidated_lines),
           int(r.total_time_ps), int(r.final_sf_tag.sum()),
           int(r.final_sf_owner.sum()), int(r.final_cache_tag.sum()))
    assert got == GOLDEN[key]


CHAIN_GOLDEN = {   # tests/test_coherence_traffic.py::CHAIN_GOLDEN
    2: (8261597974, 10262994, 106804442098, 86720, (500, 13)),
    3: (6737980178, 12603614, 113607190988, 106752, (500, 17)),
}


@pytest.mark.parametrize("n_req", sorted(CHAIN_GOLDEN))
def test_chain_fanout_bitexact_golden(n_req):
    graph, spec = _star(PT, PC.CoherenceFabricSpec, n_req)
    addr, wr, rid = PS.make_skewed_stream(500, 256, write_ratio=0.3,
                                          n_requesters=n_req, seed=4,
                                          device="cpu")
    cfg = PS.SFConfig(capacity=32, policy="fifo", footprint_lines=256)
    _, ev = PS.simulate_sf(addr, wr, rid, cfg, PS.CacheConfig(capacity=32),
                           n_requesters=n_req, return_events=True)
    low = PC.lower_coherence(graph, spec, cfg, addr, wr, rid, ev,
                             fanout="chain")
    assert low.hops.join_id is None
    sched = P.simulate(low.hops, P.make_channels(graph, device="cpu"),
                       ev.fab_issue_ps)
    assert sched.converged
    comp, st = sched.complete.numpy(), sched.start.numpy()
    got = (int(comp.sum()), int(np.bitwise_xor.reduce(comp)), int(st.sum()),
           int(low.hops.nbytes.sum()), tuple(low.hops.channel.shape))
    assert got == CHAIN_GOLDEN[n_req]


# ---------------------------------------------------------------------------
# lowering + engine == oracle == reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fanout", ["chain", "concurrent"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lowered_schedule_equals_oracle_and_reference(seed, fanout):
    rng = np.random.default_rng(seed)
    n_req = int(rng.integers(1, 4))
    graphs = _graphs("star" if seed % 2 == 0 else "chain2", n_req=n_req)
    n = int(rng.integers(60, 200))
    footprint = int(rng.choice([64, 128, 256]))
    stream = _stream(n, footprint, n_req, float(rng.uniform(0.1, 0.6)),
                     int(rng.integers(0, 999)))
    cap = max(footprint // 8, 4)
    rlow, rev, plow, pev = _lower_both(graphs, stream, cap, footprint,
                                       n_req, fanout)
    assert int(pev.bisnp_mask.max()) > 0
    (rg, _), (pg, _) = graphs
    issue = PC.coherence_issue(plow, pev.fab_issue_ps)
    ch = P.make_channels(pg, device="cpu")
    sched = P.simulate(plow.hops, ch, issue)
    ref = RE.simulate(rlow.hops, RE.make_channels(rg),
                      RC.coherence_issue(rlow, rev.fab_issue_ps))
    _schedules_equal(ref, sched)
    oracle = P.simulate_ref(plow.hops, ch, issue)
    assert sched.converged
    for f in ("start", "depart", "complete"):
        assert np.array_equal(getattr(sched, f).numpy(), oracle[f]), f


def _background(mod, graph, dev_node, **kw):
    return mod.build_workload(graph, [mod.RequesterSpec(
        node=4, n_requests=150, targets=[dev_node], read_ratio=0.5,
        issue_interval_ps=2_000, payload_bytes=512, seed=2)],
        header_bytes=16, warmup_frac=0.0, **kw)


@pytest.mark.parametrize("fanout", ["chain", "concurrent"])
def test_background_concat_equals_reference_and_oracle(fanout):
    graphs = _graphs(n_req=2, n_extra=1)
    (rg, rspec), (pg, pspec) = graphs
    stream = _stream(n=200)
    rlow, rev, plow, pev = _lower_both(graphs, stream, 32, 256, 2, fanout,
                                       policy="lifo")
    rhops, rissue = RC.concat_background(
        rlow, RC.coherence_issue(rlow, rev.fab_issue_ps),
        _background(R, rg, rspec.dev_node))
    phops, pissue = PC.concat_background(
        plow, PC.coherence_issue(plow, pev.fab_issue_ps),
        _background(P, pg, pspec.dev_node, device="cpu"))
    _hops_equal(rhops, phops)
    assert np.array_equal(np.asarray(rissue), pissue.numpy())
    ch = P.make_channels(pg, device="cpu")
    sched = P.simulate(phops, ch, pissue)
    ref = P.simulate_ref(phops, ch, pissue)
    assert sched.converged
    assert np.array_equal(sched.complete.numpy(), ref["complete"])


# ---------------------------------------------------------------------------
# the coupled fixpoint
# ---------------------------------------------------------------------------

def _coupled_equal(ref, port):
    assert (ref.iters, ref.converged, ref.used_oracle, ref.damped,
            ref.rounds) == (port.iters, port.converged, port.used_oracle,
                            port.damped, port.rounds)
    assert np.array_equal(np.asarray(ref.residual_ps), port.residual_ps)
    for f in ("fabric_lat_ps", "bisnp_lat_ps", "issue_ps",
              "fabric_issue_ps"):
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              getattr(port, f).numpy()), f
    _schedules_equal(ref.schedule, port.schedule)
    for f in ("latency_ps", "cache_hit", "bisnp_events", "total_time_ps",
              "bandwidth_MBps"):
        assert np.array_equal(np.asarray(getattr(ref.sf, f)),
                              getattr(port.sf, f).numpy()), f


def _coupled_both(graphs, stream, capacity, footprint, n_req, policy="fifo",
                  background=False, options=None, **kw):
    (rg, rspec), (pg, pspec) = graphs
    rbg = pbg = None
    if background:
        rbg = _background(R, rg, rspec.dev_node)
        pbg = _background(P, pg, pspec.dev_node, device="cpu")
    ref = RC.simulate_coupled(
        *stream, RS.SFConfig(capacity=capacity, policy=policy,
                             footprint_lines=footprint),
        RS.CacheConfig(capacity=capacity), rg, rspec, n_requesters=n_req,
        background=rbg, options=None if options is None
        else RE.SimOptions(**options), **kw)
    port = PC.simulate_coupled(
        *_tensors(stream), PS.SFConfig(capacity=capacity, policy=policy,
                                       footprint_lines=footprint),
        PS.CacheConfig(capacity=capacity), pg, pspec, n_requesters=n_req,
        background=pbg, options=None if options is None
        else P.SimOptions(**options), device="cpu", **kw)
    _coupled_equal(ref, port)
    return port


@pytest.mark.parametrize("fanout", ["chain", "concurrent"])
def test_coupled_equals_reference_with_background(fanout):
    port = _coupled_both(_graphs(n_req=2, n_extra=1), _stream(n=200), 32,
                         256, 2, policy="lifo", background=True,
                         max_iters=10, fanout=fanout)
    assert port.converged and not port.used_oracle
    # the final pass is the port's engine's, equal to its oracle
    ch = P.make_channels(_graphs(n_req=2, n_extra=1)[1][0], device="cpu")
    oracle = P.simulate_ref(port.fabric_hops, ch, port.fabric_issue_ps)
    assert np.array_equal(port.schedule.complete.numpy(), oracle["complete"])


@pytest.mark.parametrize("damping", [False, True])
def test_coupled_fixpoint_members_equal_their_runs_alone(damping):
    """`coupled_fixpoint` over three policies at once (one scan call and
    one stacked fabric pass an iteration) gives each member what
    `simulate_coupled`, its one-member case, gives it alone: undamped the
    members converge at different iterations, damped at ``tol_ps`` 2,000
    each takes its final pass."""
    graph, spec = _star(PT, PC.CoherenceFabricSpec, 2)
    stream = _tensors(_stream(n=200))
    cache = PS.CacheConfig(capacity=48)
    cfgs = [PS.SFConfig(capacity=48, policy=p, footprint_lines=256,
                        invblk_max=2 if p == "blp" else 1)
            for p in ("fifo", "lifo", "blp")]

    def scan(ks, fabs):
        return PS.simulate_sf_many([dict(
            addr=stream[0], is_write=stream[1], req_id=stream[2],
            sf_cfg=cfgs[k], cache_cfg=cache, n_requesters=2,
            fabric_lat_ps=f, return_events=True, device="cpu")
            for k, f in zip(ks, fabs)])

    first = scan(range(3), [None] * 3)
    lows = [PC.lower_coherence(graph, spec, c, *stream, ev, device="cpu")
            for c, (_, ev) in zip(cfgs, first)]
    ep = graph.topo.endpoint
    ch = P.make_channels(graph, ep.row_hit_extra_ps, ep.row_miss_extra_ps,
                         device="cpu")
    kw = dict(options=P.SimOptions(damping=damping), max_iters=10,
              tol_ps=2_000 if damping else 0)
    runs = PC.coupled_fixpoint(scan, first, lows, None, ch, **kw)
    iters = set()
    for cfg, run in zip(cfgs, runs):
        alone = PC.simulate_coupled(*stream, cfg, cache, graph, spec,
                                    n_requesters=2, device="cpu", **kw)
        assert ((run.iters, run.converged, run.rounds, run.damped,
                 run.used_oracle) == (alone.iters, alone.converged,
                                      alone.rounds, alone.damped, False))
        assert np.array_equal(run.residual_ps, alone.residual_ps)
        n = alone.schedule.complete.shape[0]
        for a, b in ((run.schedule.complete[:n], alone.schedule.complete),
                     (run.sf.latency_ps, alone.sf.latency_ps),
                     (run.fabric_lat_ps, alone.fabric_lat_ps),
                     (run.bisnp_lat_ps, alone.bisnp_lat_ps)):
            assert torch.equal(a, b)
        iters.add(run.iters)
    assert run.converged and len(iters) == (1 if damping else 2)


def test_coupled_decisions_match_isolated_and_inclusive():
    stream = _stream(n=200)
    port = _coupled_both(_graphs(n_req=2), stream, 48, 256, 2, max_iters=10)
    iso = PS.simulate_sf(*_tensors(stream),
                         PS.SFConfig(capacity=48, footprint_lines=256),
                         PS.CacheConfig(capacity=48), n_requesters=2)
    assert port.converged
    for f in ("bisnp_events", "invalidated_lines", "final_sf_tag",
              "final_sf_owner", "final_cache_tag", "cache_hit"):
        assert torch.equal(getattr(port.sf, f), getattr(iso, f)), f
    assert not torch.equal(port.sf.latency_ps, iso.latency_ps)
    # BISnp round trips: one per snooped owner of every miss and upgrade
    bl = port.bisnp_lat_ps.numpy()
    mask = port.events.bisnp_mask.numpy()
    miss = port.lowering.miss
    fab = miss | (~miss & port.events.conflict.numpy())
    n_slots = sum(int(((mask[fab] >> b) & 1).sum()) for b in range(2))
    assert int((bl > 0).sum()) == n_slots
    assert bl[bl > 0].min() > 4 * 26_000


def test_concurrent_joins_on_slowest_birsp():
    """Snooped misses with more than one owner complete earlier under the
    fork/join layout than under the chain (max of k round trips against
    their sum), on the port's engine."""
    graph, spec = _star(PT, PC.CoherenceFabricSpec, 3)
    addr, wr, rid = PS.make_skewed_stream(400, 128, write_ratio=0.4,
                                          n_requesters=3, seed=12,
                                          device="cpu")
    cfg = PS.SFConfig(capacity=16, policy="fifo", footprint_lines=128)
    _, ev = PS.simulate_sf(addr, wr, rid, cfg, PS.CacheConfig(capacity=16),
                           n_requesters=3, return_events=True)
    ch = P.make_channels(graph, device="cpu")
    lats = {}
    for fanout in ("chain", "concurrent"):
        low = PC.lower_coherence(graph, spec, cfg, addr, wr, rid, ev,
                                 fanout=fanout, upgrade_bisnp=False)
        sched = P.simulate(low.hops, ch, PC.coherence_issue(
            low, ev.fab_issue_ps))
        assert sched.converged
        t = low.miss.shape[0]
        lats[fanout] = (sched.complete[:t] - ev.fab_issue_ps).numpy()
    mask = ev.bisnp_mask.numpy()
    multi = P.snoop_filter.owner_count(ev.bisnp_mask).numpy() > 1
    snooped = ~ev.cache_hit.numpy() & (mask > 0)
    assert (snooped & multi).sum() > 0
    assert (lats["concurrent"][snooped & multi].mean()
            < lats["chain"][snooped & multi].mean())
    assert (lats["concurrent"][snooped] <= lats["chain"][snooped]).mean() > 0.9


def test_upgrade_bisnp_rows_equal_reference():
    """Write conflicts on hits fork BISnp-only rows issued at the hit's
    clock; both lowerings (with and without them) equal the reference's."""
    graphs = _graphs(n_req=2)
    stream = _stream(n=500, write_ratio=0.5, seed=13)
    _, _, plow_on, pev = _lower_both(graphs, stream, 48, 256, 2,
                                     "concurrent")
    _, _, plow_off, _ = _lower_both(graphs, stream, 48, 256, 2,
                                    "concurrent", upgrade=False)
    hit, conf = pev.cache_hit.numpy(), pev.conflict.numpy()
    assert (hit & conf).any()
    n_up = int(P.snoop_filter.owner_count(pev.bisnp_mask)[
        torch.from_numpy(hit & conf)].sum())
    assert (plow_on.hops.channel.shape[0]
            == plow_off.hops.channel.shape[0] + n_up)
    up_rows = np.asarray([r for j in np.nonzero(hit & conf)[0]
                          for r in plow_on.snoop_rows[j] if r >= 0])
    assert (plow_on.hops.join_wait.numpy()[up_rows] == -1).all()
    assert not plow_on.hops.valid.numpy()[:hit.shape[0]][hit].any()


def test_pad_rows_preserves_schedule():
    (rg, rspec), (pg, pspec) = graphs = _graphs(n_req=2)
    stream = _stream(n=150)
    rlow, rev, plow, pev = _lower_both(graphs, stream, 32, 256, 2,
                                       "concurrent")
    n = plow.hops.channel.shape[0]
    _hops_equal(RC.pad_rows(rlow.hops, n + 37), PC.pad_rows(plow.hops,
                                                            n + 37))
    issue = PC.coherence_issue(plow, pev.fab_issue_ps)
    ch = P.make_channels(pg, device="cpu")
    s0 = P.simulate(plow.hops, ch, issue)
    s1 = P.simulate(PC.pad_rows(plow.hops, n + 37), ch,
                    torch.cat([issue, torch.zeros(37, dtype=torch.int64)]))
    assert s0.converged and s1.converged
    assert torch.equal(s0.complete, s1.complete[:n])
    with pytest.raises(ValueError):
        PC.pad_rows(plow.hops, n - 1)


def _oscillating():
    """The reference test's half-duplex star whose undamped fixpoint
    oscillates (`_oscillating_config`), built by both packages."""
    def build(T, spec_cls):
        kinds = [T.SWITCH, T.REQUESTER, T.REQUESTER, T.MEMORY]
        links = [T.LinkSpec(i, 0, 8_000, 26_000, T.HALF, 200_000)
                 for i in range(1, 4)]
        graph = T.Topology(np.asarray(kinds, np.int64), links,
                           name="hd-osc").build()
        return graph, spec_cls(dev_node=3, req_nodes=(1, 2))

    rng = np.random.default_rng(0)
    stream = (rng.integers(0, 64, 40).astype(np.int32),
              rng.random(40) < 0.4, (np.arange(40) % 2).astype(np.int32))
    return ((build(RT, RC.CoherenceFabricSpec),
             build(PT, PC.CoherenceFabricSpec)), stream)


def test_damped_fixpoint_equals_reference():
    """Same budget and tolerance: the undamped loop still oscillates, the
    damped one converges, each equal to the reference's run."""
    graphs, stream = _oscillating()
    kw = dict(max_iters=33, tol_ps=2_000)
    raw = _coupled_both(graphs, stream, 8, 64, 2,
                        options=dict(damping=False), **kw)
    damped = _coupled_both(graphs, stream, 8, 64, 2,
                           options=dict(damping=True), **kw)
    assert not raw.converged
    assert damped.converged and damped.damped > 0


def test_damping_off_is_default():
    graphs = _graphs(n_req=2)
    stream = _stream(n=200)
    a = _coupled_both(graphs, stream, 48, 256, 2, max_iters=10)
    c = _coupled_both(graphs, stream, 48, 256, 2, max_iters=40,
                      tol_ps=2_000, options=dict(damping=True))
    assert a.converged and a.damped == 0 and c.converged
    assert int((c.fabric_lat_ps - a.fabric_lat_ps).abs().max()) <= 2_000


# ---------------------------------------------------------------------------
# retraining markers, link-down markers, credit DLLPs, adaptive routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fanout", ["chain", "concurrent"])
def test_lowering_survives_retrain_markers(fanout):
    """On a graph sampling retraining stalls the marker-shifted tables and
    the column map equal the reference's, the schedule its oracle's, and
    the BISnp round trips cover every snooped slot."""
    graphs = _graphs("stochastic")
    stream = _stream(n=300, seed=6)
    rlow, rev, plow, pev = _lower_both(graphs, stream, 32, 256, 2, fanout)
    assert plow.hops.retrain_after_ps.any()
    if fanout == "chain":
        assert plow.n_cols > plow.col_map.shape[1]
    (rg, _), (pg, _) = graphs
    issue = PC.coherence_issue(plow, pev.fab_issue_ps)
    ch = P.make_channels(pg, device="cpu")
    sched = P.simulate(plow.hops, ch, issue)
    oracle = P.simulate_ref(plow.hops, ch, issue)
    assert sched.converged
    assert np.array_equal(sched.complete.numpy(), oracle["complete"])
    rsched = RE.simulate(rlow.hops, RE.make_channels(rg),
                         RC.coherence_issue(rlow, rev.fab_issue_ps))
    bl = PC.bisnp_latencies(sched, plow)
    assert np.array_equal(np.asarray(RC.bisnp_latencies(rsched, rlow)),
                          bl.numpy())
    mask, conf = pev.bisnp_mask.numpy(), pev.conflict.numpy()
    fab = plow.miss | ((~plow.miss & conf) if fanout == "concurrent"
                       else False)
    n_slots = sum(int(((mask[fab] >> b) & 1).sum()) for b in range(2))
    assert int((bl > 0).sum()) == n_slots


@pytest.mark.parametrize("seed", range(3))
def test_link_down_markers_engine_equals_oracle(seed):
    from test_coherence_traffic import _marker_case

    hops, ch, issue = _marker_case(seed)
    h, c, i = _port(hops, ch, issue)
    sched = P.simulate(h, c, i)
    ref = P.simulate_ref(h, c, i)
    _schedules_equal(RE.simulate(hops, ch, jnp.asarray(issue)), sched)
    assert sched.converged
    assert np.array_equal(sched.complete.numpy(), ref["complete"])


def test_credit_dllp_reverse_hops_oracle_exact():
    cfg = P.FlitConfig("flit256", credit_dllp=True, rx_credits=16)
    graph = P.with_flit(P.single_bus(n_mems=2, bw_MBps=128_000), cfg).build()
    spec = P.RequesterSpec(node=0, n_requests=120, targets=[2, 3],
                           read_ratio=1.0, issue_interval_ps=400,
                           payload_bytes=944, seed=3)
    wl = P.build_workload(graph, [spec], warmup_frac=0.0, device="cpu")
    dllp = wl.requester < 0
    assert dllp.any() and not wl.measured.numpy()[dllp].any()
    d = wl.hops.nbytes.numpy()[dllp]
    assert (d[:, 0] == P.calibration.CREDIT_DLLP_B).all()
    assert not d[:, 1:].any()
    sched = P.simulate(wl.hops, wl.channels, wl.issue_ps)
    ref = P.simulate_ref(wl.hops, wl.channels, wl.issue_ps)
    assert sched.converged
    assert np.array_equal(sched.complete.numpy(), ref["complete"])


def test_credit_dllp_with_adaptive_routing():
    topo = P.with_flit(P.spine_leaf(2),
                       P.FlitConfig("flit256", credit_dllp=True,
                                    rx_credits=16))
    graph = topo.build()
    specs = [P.RequesterSpec(node=r, n_requests=40,
                             targets=list(graph.topo.memories()),
                             issue_interval_ps=500, payload_bytes=944, seed=i)
             for i, r in enumerate(graph.topo.requesters())]
    for strategy in ("ecmp", "adaptive"):
        wl, _, stats = P.route_and_simulate(graph, specs, strategy=strategy,
                                            warmup_frac=0.0, device="cpu")
        assert (wl.requester < 0).any()
        assert float(stats["utility"].max()) <= 1.0 + 1e-9


# ---------------------------------------------------------------------------
# trace streams and chunked streams
# ---------------------------------------------------------------------------

def test_trace_request_stream_through_coupled_pipeline():
    addr, wr, rid = P.request_stream("xsbench", n=250, footprint_lines=256,
                                     n_requesters=2, seed=1, device="cpu")
    stream = tuple(x.numpy() for x in (addr, wr, rid))
    port = _coupled_both(_graphs(n_req=2), stream, 32, 256, 2,
                         max_iters=16)
    assert port.converged and int(port.fabric_lat_ps.max()) > 0
    addr, wr, rid = P.request_stream("silo", n=600, footprint_lines=512,
                                     n_requesters=3, seed=1, device="cpu")
    res = PS.simulate_sf(addr, wr, rid,
                         PS.SFConfig(capacity=64, footprint_lines=512),
                         PS.CacheConfig(capacity=64), n_requesters=3)
    assert int(res.bisnp_events) > 0
    assert 0.2 < float(wr.float().mean()) < 0.7


@pytest.mark.parametrize("fanout", ["chain", "concurrent"])
def test_coherence_stream_chunks_equal_reference(fanout):
    (rg, rspec), (pg, pspec) = _graphs(n_req=2)
    stream = _stream(n=300, seed=8)
    rcfg = RS.SFConfig(capacity=32, policy="fifo", footprint_lines=256)
    pcfg = PS.SFConfig(capacity=32, policy="fifo", footprint_lines=256)
    ref = RC.CoherenceStream(*stream, rcfg, RS.CacheConfig(capacity=32), rg,
                             rspec, chunk=90, n_requesters=2, fanout=fanout,
                             keep_results=True)
    port = PC.CoherenceStream(*_tensors(stream), pcfg,
                              PS.CacheConfig(capacity=32), pg, pspec,
                              chunk=90, n_requesters=2, fanout=fanout,
                              keep_results=True, device="cpu")
    chunks = list(zip(ref, port, strict=True))
    assert len(chunks) == 4 and port.n_done == 300
    for (rh, ri), (ph, pi) in chunks:
        _hops_equal(rh, ph)
        assert np.array_equal(np.asarray(ri), pi.numpy())
    for f in PS.SFState._fields:
        assert np.array_equal(np.asarray(getattr(ref.sf_state, f)),
                              getattr(port.sf_state, f).numpy()), f
    assert [int(r.bisnp_events) for r in ref.sf_results] == \
        [int(r.bisnp_events) for r in port.sf_results]
