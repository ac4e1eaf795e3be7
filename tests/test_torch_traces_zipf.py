"""PyTorch port, the redis trace's zipf ranks: numpy 2.0.2's sampler on any
numpy build.

The reference draws the redis trace's ranks with ``Generator.zipf``, whose
rejection loop is numpy's own and differs between numpy versions, so the
same seed gives other ranks (and, through the int64 address hash and the
``is_write`` draw that follows, another trace) on another numpy.  The port
draws them with `repro_torch.core.traces._zipf`, numpy 2.0.2's loop on the
generator's doubles:

* it equals ``np.random.default_rng(s).zipf(1.2, n)`` bit for bit, and
  leaves the generator where ``zipf`` leaves it (numpy 2.0.2 here);
* `generate` never calls ``Generator.zipf``;
* the trace of Fig. 18/19's redis replay is pinned by its sha256, made from
  the JAX package's ``repro.core.traces.generate`` with numpy 2.0.2.

Tolerance: exact.
"""

import hashlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import traces as RT  # noqa: E402
from repro_torch.core import traces as PT  # noqa: E402

# sha256 of addr (int64, little-endian) then is_write (one byte each) of
# generate("redis", 3200, 1 << 14, seed=1), made with numpy 2.0.2 by
#   PYTHONPATH=src python3 -c 'import hashlib, numpy as np
#   from repro.core.traces import generate
#   t = generate("redis", 3200, 1 << 14, 1)
#   print(hashlib.sha256(t["addr"].astype("<i8").tobytes()
#                        + t["is_write"].astype(np.uint8).tobytes())
#         .hexdigest())'
REDIS_3200_SEED1 = \
    "22161c03163c664bd147456c1621dc9937be38b917664b9f1c9f441c47ffbcf4"


def _sha(trace):
    return hashlib.sha256(
        np.ascontiguousarray(trace["addr"], "<i8").tobytes()
        + np.ascontiguousarray(trace["is_write"], np.uint8).tobytes()
    ).hexdigest()


@pytest.mark.parametrize("n", [1, 3200, 100_000])
@pytest.mark.parametrize("seed", range(12))
def test_zipf_equals_numpy_and_leaves_the_generator_alike(seed, n):
    mine, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    got = PT._zipf(mine, 1.2, n)
    want = theirs.zipf(1.2, n)
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)
    assert mine.bit_generator.state == theirs.bit_generator.state
    assert np.array_equal(mine.random(8), theirs.random(8))


@pytest.mark.parametrize("a", [1.005, 1.02])
def test_zipf_rejects_where_pow_overflows(a):
    """Near a = 1 the C library's ``pow`` overflows to inf on many draws and
    numpy rejects them; `math.pow` raises there, and the port rejects too."""
    mine, theirs = np.random.default_rng(7), np.random.default_rng(7)
    assert np.array_equal(PT._zipf(mine, a, 2000), theirs.zipf(a, 2000))
    assert mine.bit_generator.state == theirs.bit_generator.state


class _NoZipf:
    """A generator that refuses ``zipf`` and passes the rest on."""

    def __init__(self, gen):
        self._gen = gen

    def __getattr__(self, name):
        if name == "zipf":
            raise AssertionError("Generator.zipf was called")
        return getattr(self._gen, name)


def test_generate_never_calls_generator_zipf(monkeypatch):
    want = PT.generate("redis", 3200, 1 << 14, seed=1)
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a, **kw: _NoZipf(real(*a, **kw)))
    with pytest.raises(AssertionError, match="zipf was called"):
        np.random.default_rng(0).zipf(1.2, 3)
    got = PT.generate("redis", 3200, 1 << 14, seed=1)
    for key in ("addr", "is_write"):
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("name", sorted(PT.WORKLOADS))
def test_generate_equals_reference(name):
    got = PT.generate(name, 3200, 1 << 14, seed=1)
    want = RT.generate(name, 3200, 1 << 14, seed=1)
    assert _sha(got) == _sha(want)
    assert got["mix_degree"] == want["mix_degree"]


def test_redis_trace_is_pinned():
    tr = PT.generate("redis", 3200, 1 << 14, seed=1)
    assert _sha(tr) == REDIS_3200_SEED1
    # the ranks of this trace reach past (2**63 - 1) / 2654435761, so the
    # address hash wraps in int64 as in the reference
    rng = np.random.default_rng(1 + PT.zlib.crc32(b"redis") % 65536)
    assert int(PT._zipf(rng, 1.2, 3200).max()) > (2**63 - 1) // 2654435761
