"""PyTorch port, the snoop filter: `simulate_sf` against the JAX reference.

The same numpy-seeded streams go through the reference's `simulate_sf`
(one ``lax.scan``) and the port's (on the CPU, the plain step loop of
`kernels.sf_scan.ref`, the yardstick of the CUDA kernel): every field of
`SFResult`, `SFEvents` and the final `SFState` is compared, for all six
victim policies, InvBlk lengths 1 to 4 on a finite bus, 1, 2 and 4
requesters, fabric-measured miss latencies, and a chunked run threading
the state.  The reference's own families (`tests/test_snoop_filter.py`:
inclusivity, capacity, the Fig. 14 ordering, InvBlk length 2) run on the
port at cut sizes.  One construction reaches the reference's duplicate
scatter into ``present`` at line ``F - 1``.

Tolerance: exact equality (every quantity is an integer; the bandwidth is
the reference's int64 arithmetic).  Streams are short (n <= 600) and the
configurations few, since the reference compiles its scan once per
configuration.
"""

import numpy as np
import pytest
from _hyp_compat import given, settings, st  # optional-hypothesis shim

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 for the reference)
from repro.core import snoop_filter as RS  # noqa: E402
from repro_torch.core import snoop_filter as PS  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs several worker
    processes side by side)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(capacity, footprint, **kw):
    return (RS.SFConfig(capacity=capacity, footprint_lines=footprint, **kw),
            RS.CacheConfig(capacity=capacity),
            PS.SFConfig(capacity=capacity, footprint_lines=footprint, **kw),
            PS.CacheConfig(capacity=capacity))


def _tensors(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _equal(ref, port, what=""):
    """Field for field, dtype and value, of two NamedTuples."""
    for f in ref._fields:
        want = np.asarray(getattr(ref, f))
        got = getattr(port, f).numpy()
        assert got.dtype == want.dtype, (what, f, got.dtype, want.dtype)
        assert np.array_equal(got, want), (what, f)


def _both(stream, n_req, capacity, footprint, fab=None, **kw):
    """Both scans with events and the final state; asserts they are equal
    and returns the port's ``(result, events, state)``."""
    rs, rc, ps, pc = _cfgs(capacity, footprint, **kw)
    ref = RS.simulate_sf(*(jnp.asarray(x) for x in stream), rs, rc,
                         n_requesters=n_req,
                         fabric_lat_ps=None if fab is None
                         else jnp.asarray(fab),
                         return_events=True, return_state=True)
    port = PS.simulate_sf(*_tensors(*stream), ps, pc, n_requesters=n_req,
                          fabric_lat_ps=None if fab is None
                          else torch.from_numpy(fab),
                          return_events=True, return_state=True)
    for r, p, what in zip(ref, port, ("result", "events", "state")):
        _equal(r, p, what)
    return port


def _skewed(n, footprint, n_req, seed, write_ratio=0.3):
    return tuple(np.asarray(x) for x in RS.make_skewed_stream(
        n, footprint, write_ratio=write_ratio, n_requesters=n_req,
        seed=seed))


@pytest.mark.parametrize("policy,n_req", [
    *((p, 2) for p in PS.POLICIES),
    ("fifo", 1), ("blp", 1), ("lfi", 4), ("mru", 4)])
def test_policies_equal_reference(policy, n_req):
    stream = _skewed(300, 128, n_req, seed=n_req)
    res, ev, _ = _both(stream, n_req, 24, 128,
                       invblk_max=2 if policy == "blp" else 1,
                       policy=policy)
    assert int(res.bisnp_events) > 0
    assert bool(ev.need_victim.any())


@pytest.mark.parametrize("invblk", [1, 2, 3, 4])
def test_invblk_lengths_on_a_finite_bus_equal_reference(invblk):
    stream = tuple(np.asarray(x) for x in RS.make_sequential_stream(
        400, 256, n_requesters=2, write_ratio=0.5, seed=5))
    res, ev, _ = _both(stream, 2, 51, 256, policy="blp", invblk_max=invblk,
                       bus_MBps=12_000, writeback_ps=30_000)
    assert int(ev.invblk_len.max()) == invblk
    assert int(ev.wb_lines.max()) > 0


@pytest.mark.parametrize("policy", ["fifo", "lfi", "blp"])
def test_fabric_latencies_equal_reference(policy):
    """``fabric_lat_ps`` replaces the analytic miss path; decisions stay."""
    stream = _skewed(300, 128, 2, seed=11)
    fab = np.random.default_rng(3).integers(40_000, 900_000, 300)
    res, ev, _ = _both(stream, 2, 24, 128, fab=fab, policy=policy,
                       invblk_max=2 if policy == "blp" else 1)
    miss = ~ev.cache_hit.numpy()
    assert (res.latency_ps.numpy()[miss]
            == 12_000 + fab[miss] + 12_000).all()


def test_chunked_state_equals_monolithic():
    """Threading `SFState` through four chunks equals the monolithic scan
    (both sides), chunk by chunk against the reference's chunked run."""
    stream = _skewed(480, 128, 2, seed=21)
    rs, rc, ps, pc = _cfgs(24, 128, policy="lfi")
    mono = PS.simulate_sf(*_tensors(*stream), ps, pc, n_requesters=2,
                          return_events=True, return_state=True)
    r_state = p_state = None
    lat, issue = [], []
    for lo in range(0, 480, 120):
        part = tuple(x[lo:lo + 120] for x in stream)
        ref = RS.simulate_sf(*(jnp.asarray(x) for x in part), rs, rc,
                             n_requesters=2, return_events=True,
                             init_state=r_state, return_state=True)
        port = PS.simulate_sf(*_tensors(*part), ps, pc, n_requesters=2,
                              return_events=True, init_state=p_state,
                              return_state=True)
        for r, p in zip(ref, port):
            _equal(r, p, f"chunk {lo}")
        r_state, p_state = ref[2], port[2]
        lat.append(port[0].latency_ps)
        issue.append(port[1].fab_issue_ps)
    for f in PS.SFState._fields:
        assert torch.equal(getattr(p_state, f), getattr(mono[2], f)), f
    assert torch.equal(torch.cat(lat), mono[0].latency_ps)
    assert torch.equal(torch.cat(issue), mono[1].fab_issue_ps)


def test_owner_count_equals_reference():
    rng = np.random.default_rng(0)
    masks = np.concatenate([
        rng.integers(-(1 << 31), 1 << 31, 4096).astype(np.int32),
        np.array([0, 1, -1, (1 << 31) - 1, -(1 << 31), 0x55555555],
                 np.int32)])
    want = np.asarray(RS.owner_count(jnp.asarray(masks)))
    got = PS.owner_count(torch.from_numpy(masks))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_present_bit_kept_at_last_line_as_reference():
    """A blp victim run that ends at line ``F - 1`` with InvBlk 4: the
    clipped offsets repeat index ``F - 1``, and the reference's duplicate
    scatter keeps that line's presence bit after the line is cleared (XLA
    on the CPU applies the writes in order).  The port does the same."""
    foot = 8
    # lines 6 and 7 fill the SF; line 0 then evicts the run 6..7 (blp
    # prefers the longer run), then line 6 comes back
    addr = np.array([6, 7, 0, 6], np.int32)
    stream = (addr, np.zeros(4, bool), np.zeros(4, np.int32))
    res, ev, state = _both(stream, 1, 2, foot, policy="blp", invblk_max=4)
    assert ev.invblk_len.tolist() == [0, 0, 2, 0]
    assert bool(ev.need_victim[2])
    # line 7 was cleared and never re-inserted, yet its bit stays set
    assert 7 not in state.sf_tag.tolist()
    assert bool(state.present[7]) and not bool(state.present[1])


def test_kernel_config_limits_raise():
    stream = _tensors(*_skewed(10, 64, 1, seed=0))
    _, _, ps, pc = _cfgs(8, 64, invblk_max=65)
    with pytest.raises(ValueError, match="InvBlk"):
        PS.simulate_sf(*stream, ps, pc)
    _, _, ps, pc = _cfgs(8, 32)
    with pytest.raises(ValueError, match="addresses"):
        PS.simulate_sf(*stream, ps, pc)


# ---------------------------------------------------------------------------
# the reference's own families (tests/test_snoop_filter.py), on the port
# ---------------------------------------------------------------------------

def _run(policy="fifo", n=600, footprint=256, invblk=1, n_req=1,
         write_ratio=0.1, seed=0, bus=0):
    cap = int(0.2 * footprint)
    addr, wr, rid = PS.make_skewed_stream(n, footprint,
                                          write_ratio=write_ratio,
                                          n_requesters=n_req, seed=seed,
                                          device="cpu")
    cfg = PS.SFConfig(capacity=cap, policy=policy, invblk_max=invblk,
                      footprint_lines=footprint, bus_MBps=bus)
    return PS.simulate_sf(addr, wr, rid, cfg, PS.CacheConfig(capacity=cap),
                          n_requesters=n_req)


@given(st.sampled_from(["fifo", "lru", "lifo", "mru", "lfi"]),
       st.integers(0, 100))
@settings(max_examples=4, deadline=None)
def test_inclusivity_invariant(policy, seed):
    """Every line in a requester's cache has a live SF entry listing it as
    an owner."""
    res = _run(policy=policy, n=400, seed=seed, n_req=2)
    sf_tags = res.final_sf_tag.numpy()
    sf_owner = res.final_sf_owner.numpy()
    cache = res.final_cache_tag.numpy()
    for r in range(cache.shape[0]):
        lines = set(int(a) for a in cache[r] if a >= 0)
        owned = set(int(t) for t, o in zip(sf_tags, sf_owner)
                    if t >= 0 and (int(o) >> r) & 1)
        assert not lines - owned, (policy, r, lines - owned)


def test_sf_never_exceeds_capacity_and_unique_tags():
    tags = _run(policy="lifo").final_sf_tag.numpy()
    live = tags[tags >= 0]
    assert len(np.unique(live)) == len(live) <= len(tags)


def test_policy_ordering_matches_paper():
    """Fig. 14 ordering: LIFO/MRU >= LFI >= FIFO~LRU on the skewed stream
    (600 requests over 256 lines; the reference's test takes 6,000 over
    1,024)."""
    out = {p: _run(policy=p) for p in ("fifo", "lru", "lfi", "lifo", "mru")}
    bw = {p: float(r.bandwidth_MBps) for p, r in out.items()}
    inval = {p: int(r.bisnp_events) for p, r in out.items()}
    assert bw["lifo"] >= bw["fifo"]
    assert bw["mru"] >= bw["lru"]
    assert inval["lifo"] <= inval["fifo"]
    assert inval["lfi"] <= inval["fifo"]
    assert abs(bw["fifo"] - bw["lru"]) / bw["fifo"] < 0.05
    assert abs(bw["lifo"] - bw["mru"]) / bw["lifo"] < 0.05


def test_invblk_len2_improves_and_clears_more_lines_per_bisnp():
    def run_len(invblk):
        cap = int(0.2 * 256)
        addr, wr, rid = PS.make_sequential_stream(
            600, 256, n_requesters=2, write_ratio=0.5, seed=5, device="cpu")
        cfg = PS.SFConfig(capacity=cap, policy="blp", invblk_max=invblk,
                          footprint_lines=256, bus_MBps=12_000,
                          writeback_ps=30_000)
        return PS.simulate_sf(addr, wr, rid, cfg,
                              PS.CacheConfig(capacity=cap), n_requesters=2)

    r1, r2 = run_len(1), run_len(2)
    assert int(r2.bisnp_events) < int(r1.bisnp_events)
    assert float(r2.bandwidth_MBps) >= float(r1.bandwidth_MBps)
    lpb1 = int(r1.invalidated_lines) / max(int(r1.bisnp_events), 1)
    lpb2 = int(r2.invalidated_lines) / max(int(r2.bisnp_events), 1)
    assert lpb2 > lpb1


def test_streams_equal_reference():
    """The stream makers draw the reference's numbers."""
    for got, want in ((PS.make_skewed_stream(500, 300, write_ratio=0.2,
                                             n_requesters=3, seed=4,
                                             device="cpu"),
                       RS.make_skewed_stream(500, 300, write_ratio=0.2,
                                             n_requesters=3, seed=4)),
                      (PS.make_sequential_stream(501, 64, n_requesters=3,
                                                 write_ratio=0.4, seed=2,
                                                 device="cpu"),
                       RS.make_sequential_stream(501, 64, n_requesters=3,
                                                 write_ratio=0.4, seed=2))):
        for g, w in zip(got, want):
            assert g.numpy().dtype == np.asarray(w).dtype
            assert np.array_equal(g.numpy(), np.asarray(w))
