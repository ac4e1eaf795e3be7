"""PyTorch port, RG-LRU scan kernel module (`kernels.rglru_scan`) and the
RG-LRU block (`models.rglru`) against the JAX reference.

Tolerances:
* the scan's plain version against the reference's ``rglru_scan_ref`` (an
  associative scan) and ``rglru_scan_pallas(interpret=True)``: ``atol =
  rtol = 1e-5`` in float32, the reference suite's own tolerance between its
  kernel and its oracle (the sums are taken in another order);
* `ref.rglru_scan_blocked`, the CPU emulation of the CUDA kernel's chunk
  carries (equal to the kernel bit for bit on the card), against the plain
  version, also at the kernel's chunk and tile edges: bit-equal when one
  chunk covers the sequence, ``1e-5`` otherwise (the chunk carries round
  differently);
* `rglru_block` in prefill and decode, output and cache, against the
  reference's: ``atol = rtol = 5e-2``, the bf16 tolerance the reference
  suite holds its own prefill and forward paths to
  (``tests/test_arch_smoke.py``).  The same inputs give 0.0 on the conv
  state; the measured worst elsewhere is printed by the assertions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.kernels.rglru_scan.kernel import rglru_scan_pallas  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_ref  # noqa: E402
from repro.models import rglru as JRG  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as pkernel  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as pops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    CHUNK, TILE, rglru_scan_blocked, rglru_scan_ref)
from repro_torch.models import rglru as RG  # noqa: E402
from repro_torch.models.convert import fill_module  # noqa: E402

BF16_TOL = 5e-2
SCAN_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def gates(seed, b, s, d):
    """(a, b) as the model draws them: a = exp(8 r log sigmoid(lam)) in
    (0, 1), near 1, and b = sqrt(1 - a^2) * i * x."""
    rng = np.random.default_rng(seed)
    lam = np.linspace(2.2, 6.9, d)
    r = rng.uniform(0, 1, (b, s, d))
    a = np.exp(8.0 * r * -np.log1p(np.exp(-lam)))
    x = rng.normal(0, 1, (b, s, d)) * rng.uniform(0, 1, (b, s, d))
    bb = np.sqrt(np.maximum(1 - a * a, 1e-8)) * x
    return a.astype(np.float32), bb.astype(np.float32)


def close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                               err_msg=f"{what}: max abs err {err}")


def f32(x):
    return np.asarray(x).astype(np.float32)


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,d", [(1, 1, 1), (2, 7, 31), (1, 37, 8),
                                   (3, 64, 16), (2, 100, 33), (1, 257, 5)])
def test_plain_scan_equals_reference(b, s, d):
    a, bb = gates(s * 100 + d, b, s, d)
    want = jax_ref(jnp.asarray(a), jnp.asarray(bb))
    got = rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(bb))
    assert got.dtype == torch.float32
    close(got, want, SCAN_TOL, "plain vs rglru_scan_ref")
    # the same through the op's CPU dispatch
    close(pops.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb)), want,
          SCAN_TOL, "ops vs rglru_scan_ref")


@pytest.mark.parametrize("b,s,d,chunk,d_blk", [(1, 37, 8, 37, 8),
                                               (2, 64, 32, 16, 16),
                                               (1, 96, 24, 32, 8)])
def test_plain_scan_equals_interpreted_kernel(b, s, d, chunk, d_blk):
    a, bb = gates(7 + s, b, s, d)
    want = rglru_scan_pallas(jnp.asarray(a), jnp.asarray(bb), chunk=chunk,
                             d_blk=d_blk, interpret=True)
    close(rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(bb)), want,
          SCAN_TOL, "plain vs rglru_scan_pallas(interpret)")


def test_plain_scan_is_the_sequential_recurrence():
    a, bb = gates(3, 2, 19, 6)
    got = rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(bb)).numpy()
    h = np.zeros((2, 6), np.float32)
    for t in range(19):
        h = a[:, t] * h + bb[:, t]
        assert np.array_equal(got[:, t], h), t


@pytest.mark.parametrize("chunk", [1, 2, 3, 5, 16, 64])
@pytest.mark.parametrize("s", [1, 16, 47])
def test_blocked_emulation_equals_plain(chunk, s):
    a, bb = gates(chunk * 31 + s, 2, s, 9)
    ta, tb = torch.from_numpy(a), torch.from_numpy(bb)
    got = rglru_scan_blocked(ta, tb, chunk)
    want = rglru_scan_ref(ta, tb)
    if chunk >= s:
        assert torch.equal(got, want)
    else:
        close(got, want, SCAN_TOL, f"blocked chunk={chunk}")


@pytest.mark.parametrize("s", [1, CHUNK - 1, CHUNK, CHUNK + 1, TILE - 1,
                               TILE, TILE + 1, 3 * TILE + CHUNK + 5])
def test_blocked_emulation_at_kernel_chunk_and_tile_edges(s):
    """The kernel's chunk (its carries, bit for bit on the card) against the
    plain version, at the chunk and tile edges, on model-like gates."""
    a, bb = gates(s, 2, s, 40)
    ta, tb = torch.from_numpy(a), torch.from_numpy(bb)
    got = rglru_scan_blocked(ta, tb, CHUNK)
    want = rglru_scan_ref(ta, tb)
    if s <= CHUNK:
        assert torch.equal(got, want)
    else:
        close(got, want, SCAN_TOL, f"blocked chunk={CHUNK} s={s}")


def test_cuda_wrapper_refuses_cpu_tensors():
    a = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.rglru_scan_kernel(a, a)
    with pytest.raises(ValueError, match="shape"):
        rglru_scan_ref(a, torch.zeros(1, 4, 2))


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def _block(d, seed):
    jp = JRG.init_rglru(jax.random.key(seed), d)
    port = RG.RGLRU(d, None, device="cpu")
    fill_module(port, jax.tree.map(np.asarray, jp))
    return jp, port


@pytest.mark.parametrize("s", [1, 5, 40])
def test_rglru_block_prefill_and_decode_equal_reference(s):
    d, b = 32, 2
    jp, port = _block(d, s)
    rng = np.random.default_rng(s)
    x = (rng.normal(0, 1, (b, s + 3, d))).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    assert np.array_equal(f32(jx), tx.float().numpy())

    jy, jc = JRG.rglru_block(jp, jx[:, :s], None, mode="prefill")
    ty, tc = RG.rglru_block(port, tx[:, :s], mode="prefill")
    assert ty.dtype == torch.bfloat16 and tc["conv"].dtype == torch.bfloat16
    close(ty.float(), f32(jy), BF16_TOL, "prefill y")
    close(tc["conv"].float(), f32(jc["conv"]), BF16_TOL, "prefill conv")
    close(tc["h"], f32(jc["h"]), BF16_TOL, "prefill h")
    # the forward mode gives the prefill output without a cache
    fy, fc = RG.rglru_block(port, tx[:, :s], mode="forward")
    assert fc is None and torch.equal(fy, ty)

    # three decode steps, each from the reference's own cache on both sides
    # and from the port's carried cache
    carried = tc
    for i in range(3):
        step = slice(s + i, s + i + 1)
        jy, jc_next = JRG.rglru_block(jp, jx[:, step], None, mode="decode",
                                      cache=jc)
        from_ref = {"conv": torch.from_numpy(f32(jc["conv"])).to(
            torch.bfloat16), "h": torch.from_numpy(f32(jc["h"]))}
        for cache in (from_ref, carried):
            ty, tc = RG.rglru_block(port, tx[:, step], mode="decode",
                                    cache=cache)
            close(ty.float(), f32(jy), BF16_TOL, f"decode {i} y")
            close(tc["h"], f32(jc_next["h"]), BF16_TOL, f"decode {i} h")
            close(tc["conv"].float(), f32(jc_next["conv"]), BF16_TOL,
                  f"decode {i} conv")
        carried = tc
        jc = jc_next


def test_causal_conv_equals_reference_exactly():
    """The explicit shifted sum rounds as the reference's, term by term."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 9, 16)).astype(np.float32)
    w = (rng.normal(0, 0.1, (RG.CONV_W, 16))).astype(np.float32)
    st = rng.normal(0, 1, (2, RG.CONV_W - 1, 16)).astype(np.float32)
    bf = jnp.bfloat16
    for state in (None, st):
        jo, js = JRG._causal_conv(
            jnp.asarray(x).astype(bf), jnp.asarray(w).astype(bf),
            None if state is None else jnp.asarray(state).astype(bf))
        to, ts = RG._causal_conv(
            torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(w).to(torch.bfloat16),
            None if state is None else torch.from_numpy(state).to(
                torch.bfloat16))
        close(to.float(), f32(jo), BF16_TOL, "conv out")
        assert np.array_equal(ts.float().numpy(), f32(js))


def test_init_rglru_cache_matches_reference():
    jc = JRG.init_rglru_cache(3, 8)
    tc = RG.init_rglru_cache(3, 8, device="cpu")
    for k in ("conv", "h"):
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype).split(".")[1] == str(jc[k].dtype)
