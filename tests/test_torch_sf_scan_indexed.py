"""PyTorch port, the snoop-filter scan kernel's algorithm on the CPU.

`kernels.sf_scan.ref.sf_scan_indexed` is the CUDA kernel's step in plain
Python: line-indexed maps of the SF and of each cache row, two-level
bitmaps of the free entries and empty slots, running counts of the free
entries and of requester 0's lines, and a victim search (with the
least-recent slot of a full row) only on the steps that need one, split
into 32 lanes' partials combined as the warp combines them, or, for fifo,
lifo, lru and mru, the end of an order list of the entries by stamp.  With
``check=True`` it asserts after every step that each map, bitmap and count
equals a recount of the arrays.  Here it is held, field for field, against
the plain version (`sf_scan_ref`) and the JAX reference's `simulate_sf` on
the same numpy-seeded streams: all six policies, 1, 2 and 4 requesters
with writes (conflicts on hits), InvBlk 1 to 4 on a finite bus, fabric
latencies, a run chunked in three that threads the state, the order list
from carried states with tied stamps or stamps not below ``seq``, and the
run that ends at line ``F - 1`` (the reference's duplicate scatter into
``present``).  `check_states`, which the kernel's wrapper calls before a
launch, refuses a state the maps cannot hold.

Tolerance: exact equality (every quantity is an integer).  Streams are
short (n <= 600) and the configurations few, since the reference compiles
its scan once per configuration.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 for the reference)
from repro.core import snoop_filter as RS  # noqa: E402
from repro_torch.core import snoop_filter as PS  # noqa: E402
from repro_torch.kernels.sf_scan import ref as SFR  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs several worker
    processes side by side)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# the scan's outputs and the reference's fields that hold them
_OUTS = {"latency": "latency_ps", "cache_hit": "cache_hit",
         "owner_lines": "owner_lines", "cached_lines": "cached_lines"}
_EVENTS = {"fab_issue": "fab_issue_ps", "bisnp_mask": "bisnp_mask",
           "inv_lines": "inv_lines", "wb_lines": "wb_lines",
           "need_victim": "need_victim", "conflict": "conflict",
           "invblk_len": "invblk_len"}


def _skewed(n, footprint, n_req, seed, write_ratio=0.3):
    return tuple(np.asarray(x) for x in RS.make_skewed_stream(
        n, footprint, write_ratio=write_ratio, n_requesters=n_req,
        seed=seed))


def _job(stream, n_req, capacity, footprint, fab=None, state=None, **kw):
    return PS.scan_job(
        *(torch.from_numpy(np.array(x)) for x in stream),
        PS.SFConfig(capacity=capacity, footprint_lines=footprint, **kw),
        PS.CacheConfig(capacity=capacity), n_requesters=n_req,
        fabric_lat_ps=None if fab is None else torch.from_numpy(fab),
        return_events=True, init_state=state, device="cpu")


def _reference(stream, n_req, capacity, footprint, fab=None, state=None,
               **kw):
    """The JAX package's ``(result, events, final state)``."""
    return RS.simulate_sf(
        *(jnp.asarray(x) for x in stream),
        RS.SFConfig(capacity=capacity, footprint_lines=footprint, **kw),
        RS.CacheConfig(capacity=capacity), n_requesters=n_req,
        fabric_lat_ps=None if fab is None else jnp.asarray(fab),
        init_state=None if state is None else RS.SFState(
            *(jnp.asarray(x.numpy()) for x in state)),
        return_events=True, return_state=True)


def _equal_plain(got, want):
    """Two scans' outputs and final states, dtype and value."""
    (g_out, g_state), (w_out, w_state) = got, want
    assert set(g_out) == set(w_out)
    for f in w_out:
        assert g_out[f].dtype == w_out[f].dtype, f
        assert torch.equal(g_out[f], w_out[f]), f
    for field, x, y in zip(SFR.STATE_FIELDS, g_state, w_state):
        assert x.dtype == y.dtype and x.shape == y.shape, field
        assert torch.equal(x, y), field


def _equal_reference(outs, state, ref):
    res, ev, final = ref
    for f, name in _OUTS.items():
        want = np.asarray(getattr(res, name))
        assert outs[f].numpy().dtype == want.dtype, f
        assert np.array_equal(outs[f].numpy(), want), f
    for f, name in _EVENTS.items():
        want = np.asarray(getattr(ev, name))
        assert np.array_equal(outs[f].numpy(), want), f
    for field, x in zip(SFR.STATE_FIELDS, state):
        want = np.asarray(getattr(final, field))
        assert x.numpy().dtype == want.dtype, field
        assert np.array_equal(x.numpy(), want), field


def _check(stream, n_req, capacity, footprint, fab=None, state=None, **kw):
    """`sf_scan_indexed(check=True)` against the plain version and the
    reference; returns its outputs."""
    job = _job(stream, n_req, capacity, footprint, fab=fab, state=state,
               **kw)
    got = SFR.sf_scan_indexed([job], check=True)[0]
    _equal_plain(got, SFR.sf_scan_ref([job])[0])
    _equal_reference(*got, _reference(stream, n_req, capacity, footprint,
                                      fab=fab, state=state, **kw))
    return got[0]


@pytest.mark.parametrize("policy,n_req", [
    ("fifo", 1), ("lru", 2), ("lfi", 4), ("lifo", 2), ("mru", 4),
    ("blp", 2)])
def test_policies_equal_plain_and_reference(policy, n_req):
    outs = _check(_skewed(500, 128, n_req, seed=n_req + 7), n_req, 24, 128,
                  policy=policy, invblk_max=3 if policy == "blp" else 1)
    assert bool(outs["need_victim"].any())
    if n_req > 1:
        # writes while another requester owns the line, some of them hits
        assert bool((outs["conflict"] & outs["cache_hit"]).any())


@pytest.mark.parametrize("invblk", [1, 2, 3, 4])
def test_invblk_on_a_finite_bus_equals_plain_and_reference(invblk):
    stream = tuple(np.asarray(x) for x in RS.make_sequential_stream(
        400, 256, n_requesters=2, write_ratio=0.5, seed=5))
    outs = _check(stream, 2, 51, 256, policy="blp", invblk_max=invblk,
                  bus_MBps=12_000, writeback_ps=30_000)
    assert int(outs["invblk_len"].max()) == invblk


def test_fabric_latencies_equal_plain_and_reference():
    stream = _skewed(400, 128, 2, seed=11)
    fab = np.random.default_rng(3).integers(40_000, 900_000, 400)
    _check(stream, 2, 24, 128, fab=fab, policy="lfi")


def test_chunked_in_three_equals_monolithic_reference():
    """Three scans, each from the state the last one left, against the
    reference's monolithic scan."""
    stream = _skewed(600, 128, 4, seed=4)
    kw = dict(policy="mru")
    ref = _reference(stream, 4, 24, 128, **kw)
    state, parts = None, []
    for lo in range(0, 600, 200):
        job = _job(tuple(x[lo:lo + 200] for x in stream), 4, 24, 128,
                   state=state, **kw)
        got = SFR.sf_scan_indexed([job], check=True)[0]
        _equal_plain(got, SFR.sf_scan_ref([job])[0])
        parts.append(got[0])
        state = PS.SFState(*got[1])
    outs = {f: torch.cat([p[f] for p in parts]) for f in parts[0]}
    _equal_reference(outs, state, ref)


@pytest.mark.parametrize("policy,edit", [
    ("fifo", "tied"), ("lifo", "tied"), ("mru", "tied"),
    ("lru", "seq_not_above")])
def test_order_list_from_a_carried_state(policy, edit):
    """fifo, lifo, lru and mru take their victim from the order list: from
    a carried state whose least (fifo, lru) or greatest (lifo, mru) stamp
    three entries share, the tie goes to the lowest index; from one whose
    ``seq`` is not above every stamp, the steps search instead."""
    stream = _skewed(400, 128, 2, seed=21)
    first = _job(tuple(x[:200] for x in stream), 2, 24, 128, policy=policy)
    state = [x.clone() for x in SFR.sf_scan_ref([first])[0][1]]
    stamp = state[6] if policy in ("lru", "mru") else state[5]
    valid = (state[2] >= 0).nonzero().flatten()
    if edit == "tied":
        ends = stamp[valid]
        stamp[valid[-3:]] = ends.max() if policy in ("lifo", "mru") \
            else ends.min()
    else:
        state[11] = stamp[valid].max().clone()
    outs = _check(tuple(x[200:] for x in stream), 2, 24, 128,
                  state=PS.SFState(*state), policy=policy)
    assert bool(outs["need_victim"].any())


def test_present_bit_kept_at_last_line_as_reference():
    """The blp run 6..7 that line 0 evicts with InvBlk 4 ends at ``F - 1``:
    the clipped offsets repeat index 7, which keeps its presence bit."""
    stream = (np.array([6, 7, 0, 6], np.int32), np.zeros(4, bool),
              np.zeros(4, np.int32))
    outs = _check(stream, 1, 2, 8, policy="blp", invblk_max=4)
    assert outs["invblk_len"].tolist() == [0, 0, 2, 0]


@pytest.mark.parametrize("where", ["sf_entries", "cache_row", "outside"])
def test_state_check_refuses_what_the_maps_cannot_hold(where):
    job = _job(_skewed(50, 64, 2, seed=1), 2, 8, 64)
    state = [x.clone() for x in job.state]
    if where == "sf_entries":
        state[2][:2] = 5          # line 5 in two SF entries
        match = "two SF entries"
    elif where == "cache_row":
        state[0][1, 3:5] = 9      # line 9 in two slots of row 1
        match = "two slots of one cache row"
    else:
        state[2][0] = 64          # a tag past the footprint
        match = "outside"
    bad = job._replace(state=tuple(state))
    with pytest.raises(ValueError, match=match):
        SFR.check_states([job, bad])
    with pytest.raises(ValueError, match=match):
        SFR.sf_scan_indexed([bad])
    # the same line in two rows, or in an SF entry and a cache slot, is fine
    state = [x.clone() for x in job.state]
    state[0][0, 0] = state[0][1, 0] = state[2][0] = 9
    SFR.check_states([job._replace(state=tuple(state))])
