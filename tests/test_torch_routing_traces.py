"""PyTorch port, traces, routing and multi-VCS against the JAX reference, at
small sizes on the CPU.

* `traces`: every generator's arrays equal the reference's over all
  `WORKLOADS` and `ARRIVAL_PATTERNS` (the draws are seeded through crc32 on
  both sides); `request_stream` (monolithic, timed, chunked, multi-tenant)
  hands over the same arrays; `save_csv` -> `load_csv` round-trips in both
  packages.
* `route_and_simulate`: oblivious, ECMP and adaptive on a small spine-leaf
  give the reference's route choices, workload tables, schedule and
  `channel_stats`, and so does the credit-DLLP case whose pseudo-rows stay
  outside the route choices.
* `vcs.MultiVCS`: the reference's three multi-VCS tests on the port, and
  the lowering of a flit and a stochastic-reliability VCS equal to the
  reference's.
* The 16-bandwidth bus sweep of ``test_vmapped_bandwidth_sweep_monotone``
  as one `simulate_stacked` call: every member equals the reference's
  ``jax.vmap(simulate)`` member.

Tolerance: exact for every integer, boolean and route choice, and for the
schedules; the float64 stats (`utility`, `efficiency`, `mix_degree`)
within ``rtol=1e-12``.
"""

import numpy as np
import pytest
from _hyp_compat import given, settings, st  # optional-hypothesis shim

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402  (x64 for the reference)
from repro.core import engine as RE  # noqa: E402
from repro.core import routing as RRT  # noqa: E402
from repro.core import traces as RTR  # noqa: E402
from repro.core import vcs as RV  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import routing as PRT  # noqa: E402
from repro_torch.core import traces as PTR  # noqa: E402
from repro_torch.core.vcs import LogicalDevice, MultiVCS  # noqa: E402
from repro_torch.studies.common import StudyLog  # noqa: E402
from test_torch_engine import _schedules_equal  # noqa: E402
from test_torch_lowering import (_graph_tables_equal, _same,  # noqa: E402
                                 _workloads_equal)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_lowering.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _trace_equal(ref, port):
    assert ref.keys() == port.keys()
    for key, val in ref.items():
        if isinstance(val, np.ndarray):
            _same(val, port[key], key)
        elif isinstance(val, float):
            np.testing.assert_allclose(port[key], val, rtol=1e-12)
        else:
            assert port[key] == val, key


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(RTR.WORKLOADS))
def test_generate_equals_reference(name):
    assert PTR.WORKLOADS == RTR.WORKLOADS
    for n, fp, seed in ((1, 16, 0), (3000, 1 << 14, 1), (700, 512, 9)):
        _trace_equal(RTR.generate(name, n=n, footprint_lines=fp, seed=seed),
                     PTR.generate(name, n=n, footprint_lines=fp, seed=seed))
    with pytest.raises(KeyError):
        PTR.generate(name + "x")


@pytest.mark.parametrize("pattern", RTR.ARRIVAL_PATTERNS)
def test_arrival_times_equal_reference(pattern):
    assert PTR.ARRIVAL_PATTERNS == RTR.ARRIVAL_PATTERNS
    for kw in (dict(n=0), dict(n=1), dict(n=5000, seed=3),
               dict(n=700, mean_gap_ps=333, burst_len=7, duty=0.5,
                    period=100)):
        _same(RTR.arrival_times(pattern=pattern, **kw),
              PTR.arrival_times(pattern=pattern, **kw), str(kw))


def test_tenant_mix_and_request_stream_equal_reference():
    _trace_equal(RTR.tenant_mix(["redis", "silo", "btree"], n=2000, seed=5),
                 PTR.tenant_mix(["redis", "silo", "btree"], n=2000, seed=5))
    cases = (dict(name="silo", n=2000, footprint_lines=512, n_requesters=3,
                  seed=1),
             dict(name="redis", n=900, timing="bursty", mean_gap_ps=700),
             dict(name="mix:redis+silo", n=1000, timing="poisson"),
             dict(name="xsbench", n=2500, chunk=1000, n_requesters=2))
    for kw in cases:
        ref = RTR.request_stream(**kw)
        port = PTR.request_stream(**kw, device="cpu")
        if "chunk" in kw:
            ref, port = list(ref), list(port)
            assert len(ref) == len(port) == 3
        else:
            ref, port = [ref], [port]
        for r, p in zip(ref, port):
            assert len(r) == len(p) == (3 if kw.get("timing") is None
                                        and "chunk" not in kw else 4)
            for a, b in zip(r, p):
                _same(a, b, str(kw))


def test_csv_round_trip_in_both_packages(tmp_path):
    for mod, name in ((RTR, "ref.csv"), (PTR, "port.csv")):
        tr = mod.generate("silo", n=300, seed=2)
        path = str(tmp_path / name)
        mod.save_csv(path, tr)
        back = mod.load_csv(path)
        assert np.array_equal(back["addr"], tr["addr"])
        assert np.array_equal(back["is_write"], tr["is_write"])
        assert np.array_equal(back["cycle"], np.arange(300))
        assert back["mix_degree"] == tr["mix_degree"]
        assert back["synthetic"] is False
    ref = RTR.load_csv(str(tmp_path / "ref.csv"))
    port = PTR.load_csv(str(tmp_path / "ref.csv"))
    _trace_equal({k: v for k, v in ref.items() if k != "name"},
                 {k: v for k, v in port.items() if k != "name"})
    assert (tmp_path / "ref.csv").read_text() == \
        (tmp_path / "port.csv").read_text()


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _stats_equal(ref, port):
    assert ref.keys() == port.keys()
    for key in ref:
        a, b = np.asarray(ref[key]), port[key].numpy()
        assert a.dtype == b.dtype, key
        if a.dtype == np.float64:
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
        else:
            assert np.array_equal(a, b), key


def _route_both(mod, strategy, *, flit=None, n=24, **kw):
    topo = mod.spine_leaf(4, n_spines=2, per_leaf=2)
    if flit is not None:
        topo = mod.with_flit(topo, mod.FlitConfig(**flit))
    graph = topo.build()
    specs = [mod.RequesterSpec(node=int(r), n_requests=n,
                               targets=[int(m) for m in topo.memories()],
                               issue_interval_ps=500, seed=i,
                               **({"payload_bytes": 944} if flit else {}))
             for i, r in enumerate(topo.requesters())]
    if mod is P:
        kw["device"] = "cpu"
    return mod.route_and_simulate(graph, specs, strategy=strategy,
                                  header_bytes=64, **kw)


@pytest.mark.parametrize("strategy", RRT.STRATEGIES)
def test_route_and_simulate_equals_reference(strategy):
    assert PRT.STRATEGIES == RRT.STRATEGIES
    wr, sr, cr = _route_both(R, strategy, seed=3)
    log = StudyLog()

    def recorded(hops, channels, issue_ps):
        return log.simulate(strategy, P.simulate, hops, channels, issue_ps)

    wp, sp, cp = _route_both(P, strategy, seed=3, simulate_fn=recorded)
    _workloads_equal(wr, wp)
    _schedules_equal(sr, sp)
    _stats_equal(cr, cp)
    if strategy != "oblivious":
        # the choices spread over both spines
        assert len(set(wp.route_alt.tolist())) > 1
    # every schedule went through the caller's simulate, the last returned
    assert log.runs and log.runs[-1].schedule is sp
    if strategy != "adaptive":
        assert len(log.runs) == 1
    assert set(log.seconds) == {"simulate"}


@pytest.mark.parametrize("strategy", ["ecmp", "adaptive"])
def test_route_and_simulate_credit_dllp_equals_reference(strategy):
    """The case of ``test_credit_dllp_with_adaptive_routing``: DLLP
    pseudo-rows (requester -1) ride after the demand rows and stay outside
    the route choices."""
    flit = dict(mode="flit256", credit_dllp=True, rx_credits=16)
    wr, sr, cr = _route_both(R, strategy, flit=flit, n=20, warmup_frac=0.0)
    wp, sp, cp = _route_both(P, strategy, flit=flit, n=20, warmup_frac=0.0)
    assert (wp.requester < 0).any()
    assert wp.n_demand < len(wp.requester)
    _workloads_equal(wr, wp)
    _schedules_equal(sr, sp)
    _stats_equal(cr, cp)
    assert float(cp["utility"].max()) <= 1.0 + 1e-9


# ---------------------------------------------------------------------------
# multi-VCS (the reference's tests in test_vcs_and_sweeps.py, on the port)
# ---------------------------------------------------------------------------

def test_multivcs_default_binding_and_capacity():
    v = MultiVCS(n_usp=2, devices=4, n_logical_per_device=2)
    v.check_invariants()
    # pooled capacity splits evenly by default
    assert v.visible_capacity(0) + v.visible_capacity(1) == pytest.approx(4.0)


def test_rebinding_moves_capacity_without_recabling():
    v = MultiVCS(n_usp=2, devices=2, n_logical_per_device=2)
    before = v.visible_capacity(0)
    # software-compose: move every logical device to USP 0
    for i in range(len(v.pool)):
        v.bind(i, 0)
    assert v.visible_capacity(0) == pytest.approx(2.0)
    assert v.visible_capacity(0) > before
    assert v.visible_capacity(1) == 0.0
    topo, mapping = v.build_topology()
    g = topo.build()
    # USP 0's host reaches every logical device; USP 1's host reaches none
    h0, h1 = mapping["hosts"]
    for m in mapping["logical"]:
        path = g.route(h0, m)
        assert path[-1] == m
        with pytest.raises(ValueError):
            g.route(h1, m)
    with pytest.raises(ValueError):
        v.bind(0, 2)


@given(st.integers(2, 4), st.integers(1, 3), st.integers(0, 99))
@settings(max_examples=15, deadline=None)
def test_multivcs_invariants_under_random_rebinds(n_usp, n_log, seed):
    rng = np.random.default_rng(seed)
    v = MultiVCS(n_usp=n_usp, devices=3, n_logical_per_device=n_log)
    for _ in range(10):
        v.bind(int(rng.integers(0, len(v.pool))), int(rng.integers(0, n_usp)))
    v.check_invariants()
    total = sum(v.visible_capacity(u) for u in range(n_usp))
    assert total == pytest.approx(3.0)
    topo, mapping = v.build_topology()
    g = topo.build()
    for ld, m in zip(v.pool, mapping["logical"]):
        assert g.route(mapping["hosts"][ld.bound_usp], m)[-1] == m


def _fields(link):
    """A `LinkSpec`'s fields, its `FlitConfig` as a dict of its own (the
    two packages each have their class)."""
    return {k: (vars(v) if hasattr(v, "__dataclass_fields__") else v)
            for k, v in vars(link).items()}


@pytest.mark.parametrize("flit", [
    None, "flit256",
    dict(mode="flit256", ber=1e-5, reliability="stochastic",
         retrain_threshold=2, rel_seed=5)])
def test_multivcs_lowering_equals_reference(flit):
    """`build_topology` with every vPPB link's flit config (the reference's
    ``test_multivcs_flit_passthrough`` and
    ``test_multivcs_threads_stochastic_reliability`` VCS), a pool with an
    unbound logical device and a rebinding, lowered to the same topology,
    graph and workload tables."""
    built = []
    for mod, V, LD in ((R, RV.MultiVCS, RV.LogicalDevice),
                       (P, MultiVCS, LogicalDevice)):
        cfg = mod.FlitConfig(**flit) if isinstance(flit, dict) else flit
        v = V(n_usp=2, devices=2, n_logical_per_device=2, flit=cfg)
        v.pool.append(LD(phys_id=1, fraction=0.0))
        v.bind(3, 0)
        topo, mapping = v.build_topology()
        g = topo.build()
        specs = [mod.RequesterSpec(node=h, n_requests=30,
                                   targets=[m for m in mapping["logical"]
                                            if m is not None and
                                            g.dist[h, m] < (1 << 48)],
                                   issue_interval_ps=700, seed=h)
                 for h in mapping["hosts"]]
        kw = {"device": "cpu"} if mod is P else {}
        built.append((topo, mapping, g,
                      mod.build_workload(g, specs, warmup_frac=0.0, **kw)))
    (tr, mr, gr, wr), (tp, mp, gp, wp) = built
    assert mr == mp
    assert mr["logical"][-1] is None
    assert np.array_equal(tr.kinds, tp.kinds)
    assert [_fields(a) for a in tr.links] == [_fields(b) for b in tp.links]
    _graph_tables_equal(gr, gp)
    _workloads_equal(wr, wp)
    if flit is not None:
        link = ~gp.chan_is_service
        assert (gp.chan_flit_size[link] == 256).all()
        if isinstance(flit, dict):
            assert gp.chan_rel_stochastic[link].all()
            assert (gp.chan_retrain_threshold[link] == 2).all()


# ---------------------------------------------------------------------------
# stacked sweep (test_vmapped_bandwidth_sweep_monotone on simulate_stacked)
# ---------------------------------------------------------------------------

def test_stacked_bandwidth_sweep_equals_vmapped_reference():
    """16 bus bandwidths in one `simulate_stacked` call: every member
    converges, makespans do not rise with bandwidth, and each member equals
    the reference's ``jax.vmap(simulate)`` member."""
    spec = dict(node=0, n_requests=200, targets=[2, 3, 4, 5],
                pattern="uniform", read_ratio=0.5, issue_interval_ps=300,
                seed=1)
    bws = np.linspace(16_000, 128_000, 16).astype(np.int64)

    g = R.single_bus(n_mems=4, bw_MBps=64_000).build()
    wl = R.build_workload(g, [R.RequesterSpec(**spec)], header_bytes=16,
                          warmup_frac=0.0)
    svc = jnp.asarray(g.chan_is_service)

    def one(bw):
        ch = RE.Channels(jnp.where(svc, wl.channels.bw_MBps, bw),
                         wl.channels.turnaround_ps, wl.channels.row_hit_ps,
                         wl.channels.row_miss_ps)
        return RE.simulate(wl.hops, ch, wl.issue_ps)

    ref = jax.vmap(one)(jnp.asarray(bws))

    gp = P.single_bus(n_mems=4, bw_MBps=64_000).build()
    wp = P.build_workload(gp, [P.RequesterSpec(**spec)], header_bytes=16,
                          warmup_frac=0.0, device="cpu")
    svc_p = torch.from_numpy(gp.chan_is_service)
    m = len(bws)
    chans = P.stack_members([wp.channels._replace(bw_MBps=torch.where(
        svc_p, wp.channels.bw_MBps, int(bw))) for bw in bws])
    got = P.simulate_stacked(P.stack_members([wp.hops] * m), chans,
                             torch.stack([wp.issue_ps] * m))
    assert all(got.converged)
    makespans = got.complete.max(dim=1).values
    assert bool((torch.diff(makespans) <= 0).all())
    assert makespans[0] > makespans[-1]
    for i in range(m):
        one_ref = jax.tree_util.tree_map(lambda x: x[i], ref)
        _schedules_equal(one_ref, P.member(got, i))
        assert bool(one_ref.converged) == got.converged[i]
