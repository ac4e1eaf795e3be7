"""PyTorch port, flit-pack kernel module (`kernels.flit_pack`) against the
JAX reference, on the families of ``tests/test_link_layer.py``.

Tolerances:
* ``wire`` (int32): exact.
* ``eff`` (float32) against the reference's ``flit_pack_ref``: within 1 ulp
  (each operation rounds once on both sides; it measures 0 here).
* ``eff`` against ``flit_pack_pallas(interpret=True)``: ``atol=1e-6``, the
  tolerance the reference's own test holds that kernel to against
  ``flit_pack_ref``.  The interpreted kernel contracts ``1 + ppm * 1e-6``
  into a fused multiply-add (one rounding instead of two), which moves its
  result 2-3 ulp off ``flit_pack_ref``; the test shows that this is the
  whole difference (with the scale fused, the port's arithmetic equals the
  interpreted kernel bit for bit).  The port follows ``flit_pack_ref``.
* ``flit_sweep``: ``rtol=1e-6``, because the float32 mean of each cell sums
  in another order than ``jnp.mean``.
"""

import numpy as np
import pytest
from _hyp_compat import given, settings, st  # optional-hypothesis shim

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (x64 for the reference)
from repro.kernels.flit_pack import ops as jops  # noqa: E402
from repro.kernels.flit_pack.kernel import flit_pack_pallas  # noqa: E402
from repro.kernels.flit_pack.ref import flit_pack_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flit_pack import kernel as pkernel  # noqa: E402
from repro_torch.kernels.flit_pack import ops as pops  # noqa: E402
from repro_torch.kernels.flit_pack.ref import flit_pack_ref  # noqa: E402
from repro_torch.core.link_layer import (FLIT_MODES,  # noqa: E402
                                         MAX_REPLAY_PPM)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ulps(a, b):
    """Distance in units in the last place of two float32 arrays of one
    sign (efficiencies are >= 0)."""
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def _points(seed, k, max_pay=1 << 16, max_ppm=1_000_000):
    rng = np.random.default_rng(seed)
    pay = rng.integers(1, max_pay, k).astype(np.int32)
    fsize = rng.choice([0, 68, 256], k).astype(np.int32)
    fpay = np.where(fsize == 68, 64, np.where(fsize == 256, 236, 0)) \
        .astype(np.int32)
    ppm = rng.integers(0, max_ppm, k).astype(np.int32)
    return pay, fsize, fpay, ppm


@given(st.integers(0, 10_000))
@settings(max_examples=6, deadline=None)
def test_plain_equals_reference(seed):
    """test_link_layer.py::test_flit_pack_kernel_matches_ref's family."""
    k = int(np.random.default_rng(seed).integers(1, 5000))
    cols = _points(seed, k)
    wire, eff = flit_pack_ref(*(torch.from_numpy(c) for c in cols))
    w_r, e_r = jax_ref(*(jnp.asarray(c) for c in cols))
    w_k, e_k = flit_pack_pallas(*(jnp.asarray(c) for c in cols),
                                interpret=True)
    assert wire.dtype == torch.int32 and eff.dtype == torch.float32
    assert np.array_equal(wire.numpy(), np.asarray(w_r))
    assert np.array_equal(wire.numpy(), np.asarray(w_k))
    assert ulps(eff.numpy(), e_r).max() <= 1
    np.testing.assert_allclose(eff.numpy(), np.asarray(e_k), rtol=0,
                               atol=1e-6)
    # the interpreted kernel's scale is one fused multiply-add: exact product
    # (float32 x float32 fits float64), one rounding to float32
    pay, _, _, ppm = cols
    fused = (ppm.astype(np.float32).astype(np.float64)
             * np.float64(np.float32(1e-6)) + 1.0).astype(np.float32)
    e_fused = pay.astype(np.float32) / np.maximum(
        wire.numpy().astype(np.float32) * fused, np.float32(1))
    assert ulps(e_fused, e_k).max() == 0


@pytest.mark.parametrize("max_pay,max_ppm", [
    (pops.MAX_PAYLOAD_B + 1, MAX_REPLAY_PPM + 1),   # the whole input range
    (300, 50),                                       # around one flit
])
def test_plain_equals_reference_over_input_range(max_pay, max_ppm):
    cols = _points(7, 4000, max_pay, max_ppm)
    cols[0][:4] = (0, 1, pops.MAX_PAYLOAD_B, 236)
    cols[3][:2] = (0, MAX_REPLAY_PPM)
    wire, eff = flit_pack_ref(*(torch.from_numpy(c) for c in cols))
    w_r, e_r = jax_ref(*(jnp.asarray(c) for c in cols))
    assert np.array_equal(wire.numpy(), np.asarray(w_r))
    assert (wire.numpy() >= 0).all()
    assert ulps(eff.numpy(), e_r).max() <= 1


@pytest.mark.parametrize("mode", FLIT_MODES)
@pytest.mark.parametrize("ber", [0.0, 1e-6, 1e-4])
def test_flit_pack_ops_equal_reference(mode, ber):
    pays = np.asarray([1, 63, 64, 65, 235, 236, 237, 944, 4096, 100_000])
    wire, eff = pops.flit_pack(pays, mode, ber, device="cpu")
    w_r, e_r = jops.flit_pack(pays, mode, ber, impl="ref")
    assert np.array_equal(wire.numpy(), np.asarray(w_r))
    assert ulps(eff.numpy(), e_r).max() <= 1


@pytest.mark.parametrize("pays,modes,bers", [
    ([236, 944], ["flit68", "flit256"], (0.0, 1e-6, 1e-5)),
    ([236], ["flit256"], (0.0, 3e-3, 0.01)),
    ([64, 236, 472, 944, 4096], ["flit68", "flit256"],
     (0.0, 1e-7, 1e-6, 1e-5)),
])
def test_flit_sweep_equals_reference(pays, modes, bers):
    grid = pops.flit_sweep(np.asarray(pays), modes, bers, device="cpu")
    ref = np.asarray(jops.flit_sweep(np.asarray(pays), modes, bers,
                                     impl="ref"))
    assert grid.shape == (len(modes), len(bers))
    assert grid.dtype == torch.float32
    np.testing.assert_allclose(grid.numpy(), ref, rtol=1e-6)
    assert (np.diff(grid.numpy(), axis=1) <= 0).all()


def test_max_payload_guard_equals_reference():
    with pytest.raises(ValueError, match="MAX_PAYLOAD_B"):
        pops.flit_pack(np.asarray([2_100_000_000]), mode="flit256",
                       device="cpu")
    with pytest.raises(ValueError, match="MAX_PAYLOAD_B"):
        pops.flit_sweep(torch.tensor([2_100_000_000]), ["flit256"], (0.0,),
                        device="cpu")
    wire, _ = pops.flit_pack(np.asarray([pops.MAX_PAYLOAD_B]),
                             mode="flit256", device="cpu")
    w_r, _ = jops.flit_pack(np.asarray([pops.MAX_PAYLOAD_B]), mode="flit256",
                            impl="ref")
    assert int(wire[0]) == int(w_r[0]) and 0 < int(wire[0]) < 2 ** 31


def test_entry_points_default_to_the_card():
    """Without ``device="cpu"`` the ops ask for the card, and a machine
    without one raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default path runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        pops.flit_pack(np.asarray([64]))
    with pytest.raises(RuntimeError, match="CUDA"):
        pops.flit_sweep(np.asarray([64]), ["flit256"], (0.0,))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU tensors raise."""
    cols = [torch.from_numpy(c) for c in _points(0, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.flit_pack_kernel(*cols)
