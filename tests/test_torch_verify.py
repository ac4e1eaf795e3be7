"""PyTorch port, fabric-IR verifier (`core.verify`) against the reference.

Every family of ``tests/test_verify.py`` goes through both verifiers: the
reference's on its JAX tables, the port's on the same tables as CPU tensors
of the same dtypes (built directly, not through `convert`, so the dtype
findings see the corrupted dtype).  The reports must be equal finding for
finding: code, message and row/hop/channel coordinates.  The coherence and
stream families verify reference-built tables carried across with
`convert` (and the reference's ``SFEvents`` as they are).  Lowerings the
port builds itself verify clean, and ``simulate_auto(check="static")``
raises `VerifyError` exactly where the reference's does.  The port's
verifier smoke (`repro_torch.analysis.verify_smoke`) prints what the
reference's does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 for the reference)
from repro.core import engine as RE  # noqa: E402
from repro.core import topology as RT  # noqa: E402
from repro.core import verify as RV  # noqa: E402
from repro.core.coherence_traffic import (CoherenceFabricSpec,  # noqa: E402
                                          coherence_issue, lower_coherence)
from repro.core.devices import RequesterSpec as RSpec  # noqa: E402
from repro.core.devices import build_workload as r_build  # noqa: E402
from repro.core.snoop_filter import (CacheConfig, SFConfig,  # noqa: E402
                                     make_skewed_stream, simulate_sf)
from repro.core.streaming import stream_windows  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import verify as PV  # noqa: E402
from test_verify import C, N, _joins, _rel_tables, tiny  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    """A CPU tensor with the array's own dtype (no dtype enforcement)."""
    return None if x is None else torch.from_numpy(np.array(x))


def _port(cls, src):
    return cls(**{f: _t(getattr(src, f, None)) for f in cls._fields})


def _both(hops, ch, issue, carry=None, **kw):
    ref = RV.verify_workload(hops, ch, issue, carry=carry, **kw)
    port = PV.verify_workload(
        _port(P.Hops, hops), _port(P.Channels, ch), _t(issue),
        carry=None if carry is None else _port(P.StreamCarry, carry), **kw)
    assert port.findings == ref.findings
    assert (port.n_rows, port.n_channels) == (ref.n_rows, ref.n_channels)
    assert port.summary() == ref.summary()
    return port


def _corrupt(field, index, value):
    hops, _, _ = tiny()
    arr = np.asarray(getattr(hops, field)).copy()
    arr[index] = value
    return {field: jnp.asarray(arr)}


def _carry(**over):
    base = dict(depart_ps=jnp.zeros((C,), jnp.int64),
                last_dir=jnp.full((C,), -1, jnp.int8),
                last_row=jnp.full((C,), -2, jnp.int32),
                down_until_ps=jnp.zeros((C,), jnp.int64))
    base.update(over)
    return RE.StreamCarry(**base)


def _rel_case(events):
    extra = np.zeros((N, 2), np.int64)
    retrain = np.zeros((N, 2), np.int64)
    extra[0, 1] = 2 * 256 * 2
    retrain[0, 1] = events * 1_000_000
    return dict(extra_wire_bytes=jnp.asarray(extra),
                retrain_after_ps=jnp.asarray(retrain))


# (hops overrides, verify kwargs, expected codes) — one invariant each
FAMILIES = {
    "clean": ({}, {}, set()),
    "join.cycle": (_joins(jid=[0, 1, 1, 0], jwait=[1, 0, -1, -1],
                          jarity=[2, 2, -1, -1]), {}, {"join.cycle"}),
    "join.arity": (_joins(jid=[0, 0, -1, -1], jwait=[-1, -1, 0, -1],
                          jarity=[-1, -1, 3, -1]), {}, {"join.arity"}),
    "chan.bounds": (_corrupt("channel", (2, 1), C), {}, {"chan.bounds"}),
    "chan.bounds-negative": (_corrupt("channel", (0, 0), -1), {},
                             {"chan.bounds"}),
    "carry.frontier": ({}, dict(carry=_carry(
        depart_ps=jnp.asarray([0, -5, 0], jnp.int64))), {"carry.frontier"}),
    "carry.last_dir": ({}, dict(carry=_carry(
        last_dir=jnp.asarray([-1, 2, 0], jnp.int8))), {"carry.frontier"}),
    "carry.dtype": ({}, dict(carry=_carry(
        depart_ps=jnp.zeros((C,), jnp.int32))), {"carry.depart_ps"}),
    "rel.events": (_rel_case(2), dict(reliability=_rel_tables()),
                   {"rel.events"}),
    "rel.events-admissible": (_rel_case(1), dict(reliability=_rel_tables()),
                              set()),
    "rel.partial": ({"extra_wire_bytes": jnp.zeros((N, 2), jnp.int64)}, {},
                    {"rel.partial"}),
    "dtype.channel": ({"channel": jnp.zeros((N, 2), jnp.int64)}, {},
                      {"dtype.channel"}),
    "dtype.valid": ({"valid": jnp.ones((N, 2), jnp.int8)}, {},
                    {"dtype.valid"}),
    "hop.negative": (_corrupt("nbytes", (1, 0), -1), {}, {"hop.negative"}),
    "join.partial": ({"join_id": jnp.full((N,), -1, jnp.int32)}, {},
                     {"join.partial"}),
    "join.bounds": (_joins(jid=[N, 0, -1, -1], jwait=[-1, -1, 0, -1],
                           jarity=[-1, -1, 1, -1]), {}, {"join.bounds"}),
    "join.depth": (_joins(jid=[0, 0, -1, -1], jwait=[-1, -1, 0, -1],
                          jarity=[-1, -1, 2, -1]), dict(max_rounds=10),
                   {"join.depth"}),
    "shape.issue": ({}, dict(issue=jnp.zeros((N + 1,), jnp.int64)),
                    {"shape.issue"}),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_report_equals_reference(name):
    over, kw, codes = FAMILIES[name]
    kw = dict(kw)
    hops, ch, issue = tiny(**over)
    issue = kw.pop("issue", issue)
    rep = _both(hops, ch, issue, **kw)
    assert set(rep.codes) == codes


def test_monotone_issue_opt_in_equals_reference():
    hops, ch, _ = tiny()
    shuffled = jnp.asarray([3_000, 0, 2_000, 1_000], jnp.int64)
    assert _both(hops, ch, shuffled).ok
    assert set(_both(hops, ch, shuffled, monotone_issue=True).codes) == \
        {"issue.monotone"}


def test_channel_table_findings_equal_reference():
    hops, ch, issue = tiny()
    bad_bw = ch._replace(bw_MBps=jnp.asarray([64_000, 0, 64_000], jnp.int64))
    assert set(_both(hops, bad_bw, issue).codes) == {"chan.table"}
    partial = ch._replace(flit_size=jnp.zeros((C,), jnp.int64))
    assert set(_both(hops, partial, issue).codes) == {"chan.flit"}
    flit = ch._replace(flit_size=jnp.asarray([256, 0, 68], jnp.int64),
                       flit_payload=jnp.asarray([300, 0, 64], jnp.int64),
                       replay_ppm=jnp.zeros((C,), jnp.int64))
    assert set(_both(hops, flit, issue).codes) == {"chan.flit"}
    pair = np.asarray([1, 2, 0])  # not an involution
    assert set(_both(hops, ch, issue, chan_pair=pair).codes) == {"chan.pair"}


def test_assert_valid_raises_with_report():
    hops, ch, issue = tiny(**_corrupt("channel", (0, 0), -1))
    with pytest.raises(PV.VerifyError) as ei:
        PV.assert_valid(_port(P.Hops, hops), _port(P.Channels, ch),
                        _t(issue))
    assert "chan.bounds" in ei.value.report.codes
    assert isinstance(ei.value, ValueError)


@pytest.mark.parametrize("case", ["clean", "chan.bounds", "join.depth",
                                  "carry.frontier"])
def test_simulate_auto_static_raises_where_the_reference_does(case):
    over, kw, _ = FAMILIES[case]
    hops, ch, issue = tiny(**over)
    carry = kw.get("carry")
    rounds = kw.get("max_rounds", 0)
    if case == "chan.bounds":
        hops = hops._replace(channel=jnp.asarray(
            np.where(np.arange(2) == 0, C + 4, np.asarray(hops.channel))
            .astype(np.int32)))
    ropts = RE.SimOptions(check="static", max_rounds=rounds)
    popts = P.SimOptions(check="static", max_rounds=rounds)
    pargs = (P.hops_from_arrays(hops, device="cpu"),
             P.channels_from_arrays(ch, device="cpu"),
             P.issue_from_array(issue, device="cpu"))
    pcarry = None if carry is None else P.carry_from_arrays(carry,
                                                            device="cpu")
    try:
        ref, ref_oracle = RE.simulate_auto(hops, ch, issue, ropts,
                                           carry=carry)
    except RV.VerifyError as e:
        with pytest.raises(PV.VerifyError) as ei:
            P.simulate_auto(*pargs, popts, carry=pcarry)
        assert ei.value.report.findings == e.report.findings
        assert case != "clean"
        return
    assert case == "clean"
    port, port_oracle = P.simulate_auto(*pargs, popts, carry=pcarry)
    assert port_oracle == bool(ref_oracle)
    assert np.array_equal(port.complete.numpy(), np.asarray(ref.complete))


@pytest.mark.parametrize("seed,n", [(3, 50), (11, 173)])
def test_demand_lowering_verifies_clean(seed, n):
    """The port's own lowering (and the reference's) verify clean."""
    for T, spec_cls, build, kw in (
            (P.topology, P.RequesterSpec, P.build_workload,
             dict(device="cpu")),
            (RT, RSpec, r_build, {})):
        graph = T.single_bus(n_mems=3, bw_MBps=64_000).build()
        spec = spec_cls(node=0, n_requests=n, targets=[2, 3, 4],
                        read_ratio=0.5, issue_interval_ps=10_000,
                        payload_bytes=256, seed=seed)
        wl = build(graph, [spec], header_bytes=64, warmup_frac=0.0, **kw)
        assert PV.verify_built(wl, graph).ok


@pytest.mark.parametrize("seed", [0, 9])
def test_stochastic_lowering_verifies_clean(seed):
    flit = P.FlitConfig("flit256", ber=1e-4, reliability="stochastic",
                        rel_seed=seed, retrain_threshold=2,
                        retrain_ps=2_000_000)
    graph = P.with_flit(P.single_bus(n_mems=4, bw_MBps=64_000),
                        flit).build()
    spec = P.RequesterSpec(node=0, n_requests=400, targets=[2, 3, 4, 5],
                           pattern="uniform", read_ratio=0.5,
                           issue_interval_ps=100, payload_bytes=944,
                           seed=seed)
    wl = P.build_workload(graph, [spec], header_bytes=64, warmup_frac=0.0,
                          device="cpu")
    assert int((wl.hops.retrain_after_ps > 0).sum()) > 0
    assert PV.verify_built(wl, graph).ok
    # one corrupted sample: a replay total that is not a whole quantum
    bad = wl.hops.extra_wire_bytes.clone()
    r, h = map(int, torch.nonzero(wl.hops.nbytes > 0)[0])
    bad[r, h] += 1
    wl.hops = wl.hops._replace(extra_wire_bytes=bad)
    assert "rel.replay-quantum" in PV.verify_built(wl, graph).codes


@pytest.mark.parametrize("fanout", ["chain", "concurrent"])
def test_coherence_lowering_through_convert(fanout):
    kinds = [RT.SWITCH, RT.REQUESTER, RT.REQUESTER, RT.MEMORY]
    links = [RT.LinkSpec(i, 0, 64_000, 26_000) for i in (1, 2, 3)]
    graph = RT.Topology(np.asarray(kinds, np.int64), links,
                        name="star").build()
    spec = CoherenceFabricSpec(dev_node=3, req_nodes=(1, 2))
    addr, wr, rid = make_skewed_stream(200, 256, write_ratio=0.3,
                                       n_requesters=2, seed=6)
    cfg = SFConfig(capacity=32, policy="fifo", footprint_lines=256)
    _, ev = simulate_sf(addr, wr, rid, cfg, CacheConfig(capacity=32),
                        n_requesters=2, return_events=True)
    low = lower_coherence(graph, spec, cfg, addr, wr, rid, ev,
                          fanout=fanout)
    ch = RE.make_channels(graph)
    issue = coherence_issue(low, ev.fab_issue_ps)
    kw = dict(sf_events=ev, chan_pair=graph.chan_pair)
    ref = RV.verify_workload(low.hops, ch, issue, **kw)
    port = PV.verify_workload(P.hops_from_arrays(low.hops, device="cpu"),
                              P.channels_from_arrays(ch, device="cpu"),
                              P.issue_from_array(issue, device="cpu"), **kw)
    assert ref.ok and port.ok, port.summary()
    assert port.findings == ref.findings
    # a hit that snoops without a write conflict breaks the SF contract
    hit = np.asarray(ev.cache_hit).astype(bool)
    mask = np.asarray(ev.bisnp_mask).copy()
    mask[np.argmax(hit & ~np.asarray(ev.conflict).astype(bool))] = 1
    bad = ev._replace(bisnp_mask=jnp.asarray(mask))
    kw["sf_events"] = bad
    ref = RV.verify_workload(low.hops, ch, issue, **kw)
    port = PV.verify_workload(P.hops_from_arrays(low.hops, device="cpu"),
                              P.channels_from_arrays(ch, device="cpu"),
                              P.issue_from_array(issue, device="cpu"), **kw)
    assert set(port.codes) == {"sf.hit-snoop"}
    assert port.findings == ref.findings


def test_stream_windows_through_convert():
    graph = RT.single_bus(n_mems=3, bw_MBps=64_000).build()
    spec = RSpec(node=0, n_requests=300, targets=[2, 3, 4], read_ratio=0.5,
                 issue_interval_ps=20_000, payload_bytes=128, seed=2)
    wl = r_build(graph, [spec], header_bytes=64, warmup_frac=0.0)
    ch = P.channels_from_arrays(wl.channels, device="cpu")
    wins = list(stream_windows(wl.hops, np.asarray(wl.issue_ps), 64))
    assert len(wins) > 1
    for h, issue in wins:
        rep = PV.verify_workload(P.hops_from_arrays(h, device="cpu"), ch,
                                 P.issue_from_array(issue, device="cpu"),
                                 monotone_issue=True)
        assert rep.ok
        assert rep.findings == RV.verify_workload(
            h, wl.channels, issue, monotone_issue=True).findings


def test_verify_smoke_prints_what_the_reference_prints(capsys):
    """``python -m repro_torch.analysis.verify_smoke --device cpu``: every
    lowering the port builds verifies clean, and the printout equals
    ``python -m repro.analysis.verify_smoke``'s line for line."""
    from repro.analysis import verify_smoke as RSM
    from repro_torch.analysis import verify_smoke as PSM

    assert PSM.main(device="cpu") == 0
    got = capsys.readouterr().out
    assert RSM.main() == 0
    want = capsys.readouterr().out
    assert got == want
    assert got.splitlines()[-1] == "verify_smoke: clean"
    assert "streaming/windows            ok  (4 windows)" in got
