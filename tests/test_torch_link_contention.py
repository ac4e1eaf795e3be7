"""PyTorch port, segmented depart scan (`kernels.link_contention`) against
the JAX reference.

* The port's plain `depart_times` (CPU tensors) equals the reference's
  ``depart_times`` with ``impl="ref"`` and ``impl="interpret"`` (the Pallas
  kernel in interpret mode) on the families of ``tests/test_kernels.py``:
  random sorted streams of 1..12 channels (against the reference's
  ``segmented_depart`` at ``blk=128`` too) and the ``(7 << 40)``-offset
  int64 case; plus one long segment, one-item segments and a leading run of
  channel -1.
* `segmented_depart_blocked`, the CPU emulation of the CUDA kernel's
  three-phase block decomposition, equals the plain version at small block
  shapes, across block edges.
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
    random_stream, segmented_depart_blocked, segmented_depart_ref)


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


@pytest.mark.parametrize("threads,items", [(1, 1), (2, 1), (4, 2), (8, 4)])
@pytest.mark.parametrize("case", [
    dict(k=1), dict(k=7), dict(k=8), dict(k=9), dict(k=77),
    dict(k=150, one_segment=True), dict(k=150, singletons=True),
    dict(k=150, lead_minus_one=40), dict(k=333, n_chan=3),
    dict(k=300, offset=7 << 40)], ids=lambda c: str(c))
def test_blocked_emulation_equals_plain(case, threads, items):
    """The kernel's three-phase decomposition (block aggregates, one pass
    over them, a re-scan of every block) on the CPU, at block sizes that put
    segment edges everywhere relative to thread and block edges, and with
    more blocks than one carry chunk."""
    kw = dict(case)
    cols = _t(*random_stream(kw.pop("k"), 11, **kw))
    assert torch.equal(segmented_depart_blocked(*cols, threads=threads,
                                                items=items),
                       segmented_depart_ref(*cols))


def test_blocked_emulation_at_kernel_block_shape():
    """The kernel's own block shape (256 threads x 8 items), several blocks
    and a segment that crosses all of them."""
    cols = _t(*random_stream(3 * 2048 + 5, 5, n_chan=2))
    assert torch.equal(segmented_depart_blocked(*cols),
                       segmented_depart_ref(*cols))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU tensors raise."""
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.segmented_depart(*_t(*random_stream(16, 0)))
