"""PyTorch port, segmented depart scan (`kernels.link_contention`) against
the JAX reference.

* The port's plain `depart_times` (CPU tensors) equals the reference's
  ``depart_times`` with ``impl="ref"`` and ``impl="interpret"`` (the Pallas
  kernel in interpret mode) on the families of ``tests/test_kernels.py``:
  random sorted streams of 1..12 channels (against the reference's
  ``segmented_depart`` at ``blk=128`` too) and the ``(7 << 40)``-offset
  int64 case; plus one long segment, one-item segments and a leading run of
  channel -1.
* `segmented_depart_lookback`, the CPU emulation of the CUDA kernel's
  single-pass look-back scan, equals the plain version at small tile
  shapes, across tile edges, for several seeded patterns of what the
  predecessors have published; `look_back` walks windows of 32 tiles
  nearest first and stops at the first published prefix.
* The CUDA wrapper refuses CPU tensors (the kernel itself is held against
  the plain version in ``test_torch_cuda.py``, on a card).

Tolerance everywhere: exact (int64 picoseconds).
"""

import numpy as np
import pytest
from _hyp_compat import given, settings, st  # optional-hypothesis shim

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 for the reference)
from repro.kernels.link_contention.kernel import segmented_depart  # noqa: E402
from repro.kernels.link_contention.ops import depart_times as jax_depart  # noqa: E402
from repro.kernels.link_contention.ref import segmented_depart_ref as jax_ref  # noqa: E402
from repro_torch.kernels.link_contention import kernel as pkernel  # noqa: E402
from repro_torch.kernels.link_contention.ops import depart_times  # noqa: E402
from repro_torch.kernels.link_contention.ref import (  # noqa: E402
    AGGREGATE, NEG, PREFIX, look_back, random_stream,
    segmented_depart_lookback, segmented_depart_ref)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@given(st.integers(1, 12), st.integers(5, 400), st.integers(0, 2 ** 20),
       st.integers(1, 5))
@settings(max_examples=6, deadline=None)
def test_plain_equals_reference_on_sorted_streams(nseg, k, tmax, seed):
    """The family of test_kernels.py::test_link_contention_property: int32
    streams, the reference's sequential ref and its blocked Pallas kernel
    (interpret mode, blk=128) against the port's plain version."""
    rng = np.random.default_rng(seed)
    chan = np.sort(rng.integers(0, nseg, k)).astype(np.int32)
    arrive = rng.integers(0, max(tmax, 1), k).astype(np.int32)
    order = np.lexsort((arrive, chan))
    chan, arrive = chan[order], arrive[order]
    ser = rng.integers(0, 1000, k).astype(np.int32)
    port = depart_times(*_t(chan, arrive, ser))
    assert port.dtype == torch.int64
    j = [jnp.asarray(a) for a in (chan, arrive, ser)]
    assert np.array_equal(port.numpy(), np.asarray(jax_ref(*j)))
    assert np.array_equal(port.numpy(),
                          np.asarray(segmented_depart(*j, blk=128,
                                                      interpret=True)))


STREAMS = [
    dict(k=500, offset=7 << 40),          # test_depart_times_int64_rebase
    dict(k=300),
    dict(k=257, one_segment=True),
    dict(k=130, singletons=True),
    dict(k=200, lead_minus_one=9),
    dict(k=1),
]


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("case", STREAMS, ids=lambda c: str(c))
def test_depart_times_equals_reference(case, impl):
    kw = dict(case)
    chan, arrive, ser = random_stream(kw.pop("k"), 3, **kw)
    port = depart_times(*_t(chan, arrive, ser))
    ref = jax_depart(*(jnp.asarray(a) for a in (chan, arrive, ser)),
                     impl=impl)
    assert np.array_equal(port.numpy(), np.asarray(ref))
    assert port.numpy().min() >= arrive.min()


def test_depart_times_keeps_int32_channels_and_widens_others():
    chan, arrive, ser = random_stream(100, 4)
    want = depart_times(*_t(chan, arrive, ser))
    for dt in (np.int32, np.int16):
        got = depart_times(*_t(chan.astype(dt), arrive.astype(np.int32),
                               ser.astype(np.int32)))
        assert torch.equal(got, want)


# publication patterns of the look-back emulation: seed 0 publishes no
# early prefix (every look-back walks to a tile with a head)
LOOKBACK_SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", LOOKBACK_SEEDS)
@pytest.mark.parametrize("threads,items", [(1, 1), (2, 1), (4, 2), (8, 4)])
@pytest.mark.parametrize("case", [
    dict(k=1), dict(k=7), dict(k=8), dict(k=9), dict(k=77),
    dict(k=150, one_segment=True), dict(k=150, singletons=True),
    dict(k=150, lead_minus_one=40), dict(k=333, n_chan=3),
    dict(k=300, offset=7 << 40)], ids=lambda c: str(c))
def test_lookback_emulation_equals_plain(case, threads, items, seed):
    """The kernel's single-pass look-back scan on the CPU, at tile sizes
    that put segment edges everywhere relative to thread and tile edges,
    with look-backs over more than one window of 32 tiles."""
    kw = dict(case)
    cols = _t(*random_stream(kw.pop("k"), 11, **kw))
    assert torch.equal(segmented_depart_lookback(*cols, threads=threads,
                                                 items=items, seed=seed),
                       segmented_depart_ref(*cols))


@pytest.mark.parametrize("seed", LOOKBACK_SEEDS)
def test_lookback_emulation_at_kernel_block_shape(seed):
    """The kernel's own tile shape (256 threads x 8 items, warps of 32),
    several tiles and a segment that crosses all of them."""
    cols = _t(*random_stream(3 * 2048 + 5, 5, n_chan=2))
    assert torch.equal(segmented_depart_lookback(*cols, seed=seed),
                       segmented_depart_ref(*cols))


@pytest.mark.parametrize("seed", LOOKBACK_SEEDS)
@pytest.mark.parametrize("threads,items", [(1, 2), (2, 2)])
def test_lookback_emulation_one_segment_over_many_windows(threads, items,
                                                          seed):
    """One segment over 70 tiles: tile 69's look-back crosses two windows
    of 32 when no tile publishes early."""
    cols = _t(*random_stream(70 * threads * items, 8, one_segment=True))
    assert torch.equal(segmented_depart_lookback(*cols, threads=threads,
                                                 items=items, seed=seed),
                       segmented_depart_ref(*cols))


def _sequential_incoming(status, agg_c, agg_m, incl):
    """The incoming depart by walking back one tile at a time."""
    j = len(status) - 1
    while j >= 0 and status[j] != PREFIX:
        j -= 1
    v = NEG if j < 0 else int(incl[j])
    for i in range(j + 1, len(status)):
        v = max(int(agg_c[i]), v + int(agg_m[i]))
    return v


@pytest.mark.parametrize("n,prefix_at,windows", [
    (1, None, 1), (5, 4, 1), (40, 8, 1), (40, 7, 2), (40, 0, 2),
    (70, None, 3), (64, 32, 1), (64, 31, 2), (97, 1, 3)])
def test_look_back_walks_windows_nearest_first(n, prefix_at, windows):
    """`look_back` over ``n`` predecessors whose only prefix is at
    ``prefix_at`` (None: none, so the walk runs past tile 0) reads the
    given number of windows and equals the walk one tile at a time."""
    rng = np.random.default_rng(n)
    status = torch.full((n,), AGGREGATE)
    if prefix_at is not None:
        status[prefix_at] = PREFIX
    agg_c = torch.from_numpy(rng.integers(0, 1 << 30, n))
    agg_m = torch.from_numpy(rng.integers(0, 1000, n))
    incl = torch.from_numpy(rng.integers(0, 1 << 30, n))
    got, walked = look_back(status, agg_c, agg_m, incl)
    assert walked == windows
    assert got == _sequential_incoming(status, agg_c, agg_m, incl)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU tensors raise."""
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.segmented_depart(*_t(*random_stream(16, 0)))
