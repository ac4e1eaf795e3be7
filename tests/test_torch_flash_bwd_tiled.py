"""PyTorch port, the flash backward kernel's decomposition on the CPU
(`ref.flash_attention_bwd_tiled`): key tiles whose walk over the group's
query heads and their query tiles is cut into slices, float32 partials
summed in slice order, the dQ walk over the key tiles in range, and P and dS
split hi/lo into bf16 parts as the kernel (``csrc/flash_attention_bwd.cu``)
feeds them to the tensor cores.

Tolerances:
* without the split, against `ref.flash_attention_bwd_plain` on the same
  float32 inputs: ``2e-5`` absolute plus ``1e-5`` relative (the same sums
  in another order), at small tiles and at the kernel's own (64 keys, 64
  query rows), with one slice and with several;
* with the split, on bf16 inputs, against the plain backward: ``1e-4``
  of the largest gradient (each term keeps 2^-17 of its value, as the
  forward's split emulation in `tests/test_torch_flash_attention.py`);
* against ``jax.grad`` of the JAX package's ``flash_attention_ref``
  (``repro/kernels/flash_attention/ref.py``) in float32, the output and
  the log-sum-exp from the port's plain forward: ``1e-4`` of the largest
  gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_ref)
from repro_torch.kernels.flash_attention import ref as FR  # noqa: E402
from test_torch_train_kernels import FLASH_CASES  # noqa: E402

# (bk, bq, head_slices): small tiles, the kernel's tiles, slices that
# split a head's query tiles, and more slices than steps
TILINGS = [(8, 16, 3), (16, 8, 1), (64, 64, 1), (64, 64, 2), (64, 64, 16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(case, seed, bf16=False):
    """q, k, v, do as float32 tensors (bf16 values if ``bf16``), made with
    numpy, with the plain forward's output and base-2 log-sum-exp."""
    b, s, t, kv, g, d, causal, window = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(0, 1, shape).astype(
        np.float32)) for shape in ((b, s, kv * g, d), (b, t, kv, d),
                                   (b, t, kv, d), (b, s, kv * g, d)))
    if bf16:
        q, k, v, do = (x.to(torch.bfloat16).float() for x in (q, k, v, do))
    kw = dict(causal=causal, window=window)
    o, lse = FR.flash_attention_ref(q, k, v, return_lse=True, **kw)
    return (q, k, v, o, do, lse), kw


def _largest_share(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


@pytest.mark.parametrize("bk,bq,slices", TILINGS)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_tiled_backward_equals_plain(case, bk, bq, slices):
    args, kw = _inputs(case, seed=case[1] + bk)
    want = FR.flash_attention_bwd_plain(*args, **kw)
    got = FR.flash_attention_bwd_tiled(*args, bk=bk, bq=bq,
                                       head_slices=slices, split=False, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-5,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_split_backward_equals_plain(case, slices):
    """bf16 inputs, the kernel's tiles and roundings."""
    args, kw = _inputs(case, seed=case[2] + slices, bf16=True)
    want = FR.flash_attention_bwd_plain(*args, **kw)
    got = FR.flash_attention_bwd_tiled(*args, head_slices=slices, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _largest_share(g, w) <= 1e-4, name


@pytest.mark.parametrize("case", FLASH_CASES)
def test_split_backward_equals_jax_grad(case):
    """The emulation at the kernel's tiles and two slices against jax.grad
    of the JAX package's plain attention, in float32."""
    b, s, t, kv, g, d, causal, window = case
    args, kw = _inputs(case, seed=7 * case[5] + s)
    q, k, v, _, do, _ = args
    got = FR.flash_attention_bwd_tiled(*args, head_slices=2, **kw)

    def grouped(x):  # (B, S, H, D) -> (B, KV, G, S, D)
        return jnp.asarray(x.numpy()).reshape(b, s, kv, g, d).transpose(
            0, 2, 3, 1, 4)

    qj, doj = grouped(q), grouped(do)
    kj, vj = (jnp.asarray(x.numpy()).transpose(0, 2, 1, 3) for x in (k, v))

    def loss(qx, kx, vx):
        return jnp.sum(jax_ref(qx, kx, vx, **kw) * doj)

    dqj, dkj, dvj = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    want = (np.asarray(dqj).transpose(0, 3, 1, 2, 4).reshape(b, s, kv * g, d),
            np.asarray(dkj).transpose(0, 2, 1, 3),
            np.asarray(dvj).transpose(0, 2, 1, 3))
    for name, gx, w in zip(("dq", "dk", "dv"), got, want):
        assert _largest_share(gx, torch.from_numpy(np.asarray(
            w, np.float32))) <= 1e-4, name
