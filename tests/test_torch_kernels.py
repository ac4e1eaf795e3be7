"""PyTorch port, serve-round kernel module against the JAX reference.

* `ref.serve_scan_ref` (the plain whole-array Hillis–Steele version) equals
  the reference's sequential ``serve_scan_ref`` on streams of the four map
  shapes the ops wrapper emits, with the sentinel mapped -2**30 -> -2**62,
  and equals a plain numpy sequential loop.
* `ops.serve_round` on CPU tensors equals the reference's
  ``ops.serve_round`` (impl "ref" and "interpret") on sorted round inputs
  from the engine suite's families, cold and warm-seeded, exactly.
* `serve_scan_blocked`, the CPU emulation of the CUDA kernel's three-phase
  block decomposition (block aggregates, one pass over them, a re-scan of
  each block), equals the plain version at small block shapes and at the
  kernel's own.
* The CUDA wrapper refuses CPU tensors (the kernel itself is held against
  the plain version in ``test_torch_cuda.py``, on a card).

Tolerance everywhere: exact (int64 picoseconds).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 for the reference)
from repro.kernels.serve_round import ops as rops  # noqa: E402
from repro.kernels.serve_round.kernel import NEG as NEG_J  # noqa: E402
from repro.kernels.serve_round.ref import serve_scan_ref as jax_scan  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core.engine import _round_inputs  # noqa: E402
from repro_torch.kernels.serve_round import kernel as pkernel  # noqa: E402
from repro_torch.kernels.serve_round import ops as pops  # noqa: E402
from repro_torch.kernels.serve_round.ref import NEG as NEG_T  # noqa: E402
from repro_torch.kernels.serve_round.ref import (random_maps,  # noqa: E402
                                                 serve_scan_blocked,
                                                 serve_scan_ref)
from test_engine import _join_case, _random_case  # noqa: E402
from test_torch_engine import _carry_np, _stochastic  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs several worker
    processes side by side, and torch's default pool (one thread per core
    in each of them) oversubscribes the cores many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def numpy_scan(maps, neg):
    """Sequential application of every map to the running state."""
    d = w = neg
    out = []
    for a00, a01, a10, a11, b0, b1 in zip(*(m.tolist() for m in maps)):
        d, w = (max(a00 + d, a01 + w, b0, neg),
                max(a10 + d, a11 + w, b1, neg))
        out.append(d)
    return np.asarray(out, np.int64)


def _t(maps):
    return [torch.from_numpy(m.copy()) for m in maps]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k,prefix", [(8, 0), (77, 0), (300, 5), (500, 0)])
def test_plain_scan_equals_reference_scan(k, prefix, seed):
    ref = np.asarray(jax_scan(*(jnp.asarray(m.astype(np.int32)) for m in
                                random_maps(k, seed, neg=NEG_J,
                                            prefix=prefix))))
    port = serve_scan_ref(*_t(random_maps(k, seed, prefix=prefix)))
    # the prefix before the first head stays at the sentinel on both sides
    expect = np.where(ref == NEG_J, NEG_T, ref.astype(np.int64))
    assert np.array_equal(port.numpy(), expect)
    assert (port.numpy()[prefix:] >= 0).all()


@pytest.mark.parametrize("k", [1, 63, 64, 65, 1000])
def test_plain_scan_equals_sequential_loop(k):
    maps = random_maps(k, 100 + k, prefix=min(3, k - 1))
    assert np.array_equal(serve_scan_ref(*_t(maps)).numpy(),
                          numpy_scan(maps, NEG_T))


@pytest.mark.parametrize("threads,items", [(1, 1), (2, 1), (4, 2), (8, 4)])
@pytest.mark.parametrize("k,kw", [
    (1, {}), (7, {}), (8, {}), (9, {}), (77, {}), (300, dict(prefix=40)),
    (150, dict(one_segment=True)), (333, dict(prefix=100, one_segment=True)),
])
def test_blocked_emulation_equals_plain(k, kw, threads, items):
    """Block and thread edges everywhere relative to segment heads and to a
    pass-through prefix, and more blocks than one carry chunk."""
    maps = _t(random_maps(k, 50 + k, **kw))
    assert torch.equal(serve_scan_blocked(*maps, threads=threads,
                                          items=items),
                       serve_scan_ref(*maps))


def test_blocked_emulation_at_kernel_block_shape():
    maps = _t(random_maps(3 * 2048 + 5, 9, prefix=2100))
    assert torch.equal(serve_scan_blocked(*maps), serve_scan_ref(*maps))


# ---------------------------------------------------------------------------
# ops.serve_round: one sorted engine round, port vs reference
# ---------------------------------------------------------------------------

def _round_args(hops_j, ch_j, issue, warm_seed=None):
    """Sorted inputs of one round at the contention-free arrivals (and
    after one round, so items have real contention), for both packages."""
    hops = P.hops_from_arrays(hops_j, device="cpu")
    ch = P.channels_from_arrays(ch_j, device="cpu")
    issue_t = P.issue_from_array(issue, device="cpu")
    carry = (None if warm_seed is None else P.carry_from_arrays(
        _carry_np(ch.bw_MBps.shape[0], None, warm_seed), device="cpu"))
    arrive = P.engine._initial_arrive(hops, ch, issue_t)
    arrive, _, _ = P.engine._one_round(hops, ch, issue_t, arrive,
                                       carry=carry)
    _, args = _round_inputs(hops, ch, arrive, carry)
    jdt = (jnp.int32, jnp.bool_, jnp.bool_, jnp.int64, jnp.int8, jnp.int32,
           jnp.int64, jnp.int64, jnp.int64, jnp.int64, jnp.int64, jnp.int64,
           jnp.int8, jnp.int32, jnp.int64)
    jargs = [jnp.asarray(a.numpy()).astype(d) for a, d in zip(args, jdt)]
    assert int(args[3].max() - args[3].min()) < (1 << 29)  # reference span
    return args, jargs


CASES = ([("random", s) for s in range(4)] + [("join", s) for s in range(2)]
         + [("stochastic", 0)])


def _case(name, seed):
    if name == "random":
        hops, ch, issue, _ = _random_case(seed)
    elif name == "join":
        hops, ch, issue = _join_case(seed)
    else:
        hops, ch, issue = _stochastic(3e-4)
    return hops, ch, issue


@pytest.mark.parametrize("warm", [None, 5])
@pytest.mark.parametrize("name,seed", CASES)
def test_serve_round_equals_reference(name, seed, warm):
    args, jargs = _round_args(*_case(name, seed), warm_seed=warm)
    out = pops.serve_round(*args)
    ref = rops.serve_round(*jargs, impl="ref")
    for a, b in zip(out, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name,seed", [("random", 123), ("stochastic", 0)])
def test_serve_round_equals_reference_pallas_interpret(name, seed):
    args, jargs = _round_args(*_case(name, seed), warm_seed=9)
    out = pops.serve_round(*args)
    ref = rops.serve_round(*jargs, impl="interpret")
    for a, b in zip(out, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU tensors raise."""
    maps = _t(random_maps(16, 0))
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.serve_scan(*maps)
