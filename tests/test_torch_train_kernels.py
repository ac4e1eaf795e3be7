"""PyTorch port, the kernels' gradients on the CPU: the flash-attention
backward's plain version (`ref.flash_attention_bwd_plain`, FlashAttention-2's
formulas, which the CUDA backward kernel computes) and the RG-LRU scan's
reverse mode (`ref.rglru_scan_bwd_plain`, `ref.rglru_scan_blocked(...,
reverse=True)`), each held against autograd of the plain forward and, for
the scan, against ``jax.grad`` of the reference's associative scan; and the
CPU path of each op's ``torch.autograd.Function`` against ``gradcheck`` at
float64.

Tolerances:
* the flash backward in float32 against autograd through
  `flash_attention_ref` in float32 given the same float32 output: ``2e-5``
  absolute plus ``1e-5`` relative (the same sums in another order);
* ``gradcheck`` at float64 with its defaults (the CPU path computes in
  float64 for float64 inputs);
* the padded head dim (D 8 and 12 padded with zero columns to 16, the
  scores divided by the true D's square root), sliced back, against the
  unpadded call: ``1e-6`` (float32 sums over extra zero columns in another
  blocking);
* mamba2-1.3b's smoke config, whose ``ssd`` layer trains on the CPU
  through `ops.SSDChunk`: the plain forward and the plain backward
  (`ref.ssd_chunk_bwd_plain`, the closed form the CUDA backward kernel
  computes): `transformer.loss_fn` and every gradient leaf against the
  reference run op by op, with the bounds of `tests/test_torch_train.py`;
* the scan's adjoint against autograd of the plain forward, and the
  blocked emulation against the sequential walk: ``1e-5`` of the largest
  value (another order of the chunk carries); against ``jax.grad`` of the
  associative scan: ``1e-5`` of the largest (the reference's tree of
  products rounds otherwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.models import rglru as JRG  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FOPS  # noqa: E402
from repro_torch.kernels.flash_attention import ref as FR  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as ROPS  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as RR  # noqa: E402
from repro_torch.models import rglru as RG  # noqa: E402
from _torch_train_parity import check_loss_and_grads  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# (b, s, t, kv, g, d, causal, window): causal, windowed, non-causal, S < T,
# GQA and MQA, at D 16, 64 and 96
FLASH_CASES = [
    (2, 33, 33, 2, 2, 16, True, 0),
    (1, 40, 40, 1, 4, 16, True, 7),
    (1, 24, 24, 2, 1, 64, False, 0),
    (2, 13, 29, 2, 3, 64, False, 0),
    (1, 17, 30, 1, 2, 96, True, 0),
    (1, 45, 45, 1, 3, 96, True, 16),
    (1, 20, 37, 4, 1, 64, False, 5),
]


def _qkv(case, dtype=torch.float32, seed=0):
    b, s, t, kv, g, d = case[:6]
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, dtype=torch.float64)
                 .to(dtype) for shape in ((b, s, kv * g, d), (b, t, kv, d),
                                          (b, t, kv, d), (b, s, kv * g, d)))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bwd_plain_equals_autograd(case):
    q, k, v, do = _qkv(case)
    kw = dict(causal=case[6], window=case[7])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = FR.flash_attention_ref(*leaves, **kw)
    want = torch.autograd.grad(out, leaves, do)
    o, lse = FR.flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert torch.equal(o, out.detach())
    got = FR.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=2e-5, rtol=1e-5)


# (b, s, t, kv, g, d, causal, window) at the smoke configs' head dims 8
# and 12: GQA, causal, windowed, non-causal, S < T
PAD_CASES = [
    (2, 32, 32, 2, 4, 8, True, 0),
    (1, 30, 30, 1, 3, 8, True, 6),
    (2, 19, 41, 4, 1, 12, False, 0),
    (1, 25, 44, 2, 2, 12, True, 9),
]


@pytest.mark.parametrize("case", PAD_CASES)
def test_flash_bwd_padded_head_dim_equals_unpadded(case):
    """The route the autograd op takes on the card for a bf16 head dim that
    is not a multiple of 16, through the plain versions: q, k, v and dO
    padded with zero columns to `ops.padded_head_dim`, the scores divided by
    the true D's square root (``head_dim``), the LSE and dq, dk, dv of the
    padded call, sliced back, equal to the unpadded call's within ``1e-6``
    (float32 sums over extra zero columns in another blocking), and the
    padded columns' gradients zero."""
    q, k, v, do = _qkv(case, seed=3)
    kw = dict(causal=case[6], window=case[7])
    d = q.shape[-1]
    dp = FOPS.padded_head_dim(d)
    assert dp == 16
    qp, kp, vp, dop = (FOPS.pad_head_dim(x, dp) for x in (q, k, v, do))
    o, lse = FR.flash_attention_ref(q, k, v, return_lse=True, **kw)
    op, lse_p = FR.flash_attention_ref(qp, kp, vp, return_lse=True,
                                       head_dim=d, **kw)
    torch.testing.assert_close(lse_p, lse, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(op[..., :d], o, atol=1e-6, rtol=1e-6)
    want = FR.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    got = FR.flash_attention_bwd_plain(qp, kp, vp, op, dop, lse_p,
                                       head_dim=d, **kw)
    for g, w in zip(got, want):
        assert not g[..., d:].any()
        torch.testing.assert_close(g[..., :d], w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", FLASH_CASES[:4])
def test_flash_lse_is_base2_logsumexp(case):
    q, k, v, _ = _qkv(case)
    kw = dict(causal=case[6], window=case[7])
    b, s, h, d = q.shape
    _, lse = FR.flash_attention_ref(q, k, v, return_lse=True, **kw)
    scores = torch.einsum("bshd,bthd->bhst", q,
                          k.repeat_interleave(h // k.shape[2], 2)) / d ** 0.5
    mask = FR.attention_mask(s, k.shape[1], device=q.device, **kw)
    want = torch.logsumexp(scores.masked_fill(~mask, -torch.inf), -1) \
        / np.log(2.0)
    assert lse.shape == (b, h, s)
    torch.testing.assert_close(lse, want.float(), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("case", [FLASH_CASES[i] for i in (0, 1, 3, 5, 6)])
def test_flash_autograd_function_passes_gradcheck(case):
    """The op under autograd is `FlashAttention` (the plain forward and
    backward on the CPU), and its gradient is the true one at float64."""
    b, s, t, kv, g, d, causal, window = case
    small = (b, min(s, 9), min(t, 12), kv, g, min(d, 16))
    q, k, v, _ = _qkv(small, torch.float64, seed=1)
    leaves = tuple(x.requires_grad_() for x in (q, k, v))
    out = FOPS.flash_attention(*leaves, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.autograd.gradcheck(
        lambda *x: FOPS.flash_attention(*x, causal=causal, window=window),
        leaves)


def test_flash_serving_calls_build_no_graph():
    q, k, v, _ = _qkv(FLASH_CASES[0])
    out = FOPS.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    assert torch.equal(out, FR.flash_attention_ref(q, k, v, causal=True))


@pytest.mark.parametrize("s,bk,bq,causal,window", [
    (64, 16, 8, True, 0), (70, 16, 32, True, 9), (50, 32, 16, False, 0),
    (50, 8, 16, False, 6), (33, 64, 32, True, 2048)])
def test_q_tile_range_covers_every_row_that_sees_the_tile(s, bk, bq, causal,
                                                          window):
    """Every query row that sees a key of a key tile lies in one of the
    query tiles `q_tile_range` walks, and every tile walked holds such a row
    (the mirror of `kv_tile_range`)."""
    mask = FR.attention_mask(s, s, causal=causal, window=window,
                             device="cpu")
    for k0 in range(0, s, bk):
        rows = set(mask[:, k0:k0 + bk].any(1).nonzero()[:, 0].tolist())
        tiles = list(FR.q_tile_range(k0, bk, s, bq, causal=causal,
                                     window=window))
        covered = {r for i0 in tiles for r in range(i0, min(i0 + bq, s))}
        assert rows <= covered
        assert all(rows & set(range(i0, i0 + bq)) for i0 in tiles)


def _gates(shape, seed):
    rng = np.random.default_rng(seed)
    r = rng.random(shape)
    lam = np.linspace(2.2, 6.9, shape[-1])
    a = np.exp(8.0 * r * np.log(1 / (1 + np.exp(-lam))))
    return (torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))


def _close_to_largest(got, want, rel=1e-5):
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= rel * scale


@pytest.mark.parametrize("shape,chunk", [((2, 37, 5), 4), ((1, 300, 3), 16),
                                         ((3, 1, 4), 16), ((1, 16, 2), 16)])
def test_rglru_reverse_equals_autograd(shape, chunk):
    a, b, g = _gates(shape, 0)
    al, bl = a.clone().requires_grad_(), b.clone().requires_grad_()
    h = RR.rglru_scan_ref(al, bl)
    da, db = torch.autograd.grad(h, (al, bl), g)
    lam = RR.rglru_scan_bwd_plain(a, g)
    _close_to_largest(lam, db)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1).detach()
    _close_to_largest(lam * h_prev, da)
    blocked = RR.rglru_scan_blocked(a, g, chunk, reverse=True)
    _close_to_largest(blocked, lam)
    if shape[1] <= chunk:
        assert torch.equal(blocked, lam)
    # the op's autograd function (the CPU path: the sequential walk)
    al, bl = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = ROPS.rglru_scan(al, bl)
    assert type(out.grad_fn).__name__ == "RGLRUScanBackward"
    got_a, got_b = torch.autograd.grad(out, (al, bl), g)
    assert torch.equal(got_b, lam)
    torch.testing.assert_close(got_a, lam * h_prev, rtol=0, atol=0)


def test_rglru_reverse_operands_flip_the_sequence():
    a, _, g = _gates((2, 9, 3), 1)
    ra, rg = RR.reversed_operands(a, g)
    assert torch.equal(ra[:, 0], torch.zeros_like(a[:, 0]))
    assert torch.equal(ra[:, 1:], a[:, 1:].flip(1))
    assert torch.equal(rg, g.flip(1))


def test_rglru_scan_passes_gradcheck():
    a, b, _ = _gates((2, 7, 3), 2)
    leaves = (a.double().requires_grad_(), b.double().requires_grad_())
    out = ROPS.RGLRUScan.apply(*leaves)
    assert out.dtype == torch.float64
    assert torch.autograd.gradcheck(ROPS.RGLRUScan.apply, leaves)


def test_rglru_scan_gradient_equals_jax_grad_of_the_associative_scan():
    """The port's RG-LRU scan block (gates, then the scan through its
    autograd function) differentiated against ``jax.grad`` of
    ``repro.models.rglru.rglru_scan`` (gates, then the associative scan),
    from the same weights and input."""
    d, shape = 6, (2, 23, 6)
    rng = np.random.default_rng(5)
    p = {"w_r": rng.standard_normal((d, d)).astype(np.float32) * d ** -0.5,
         "w_i": rng.standard_normal((d, d)).astype(np.float32) * d ** -0.5,
         "lam": np.linspace(2.2, 6.9, d).astype(np.float32)}
    u = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)

    def jloss(p, u):
        return jnp.sum(JRG.rglru_scan(p, u) * g)

    jgp, jgu = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(u))
    module = RG.RGLRU(d, None, device=torch.device("cpu"))
    with torch.no_grad():
        for name in ("w_r", "w_i"):
            getattr(module, name).copy_(torch.from_numpy(p[name]))
        module.lam.copy_(torch.from_numpy(p["lam"]))
    module.requires_grad_(True)
    ut = torch.from_numpy(u).requires_grad_()
    loss = torch.sum(RG.rglru_scan(module, ut) * torch.from_numpy(g))
    loss.backward()
    for got, want in ((ut.grad, jgu), (module.w_r.grad, jgp["w_r"]),
                      (module.w_i.grad, jgp["w_i"]),
                      (module.lam.grad, jgp["lam"])):
        _close_to_largest(got, torch.from_numpy(np.asarray(want)))


def test_ssd_model_loss_and_gradients_equal_reference(monkeypatch):
    """Each ssd layer's gradient comes from the op's explicit plain
    backward, once a layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.ssd_chunk import ops as SOPS

    calls = []
    plain = SOPS.ssd_chunk_bwd_plain

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(SOPS, "ssd_chunk_bwd_plain", counted)
    check_loss_and_grads("mamba2-1.3b", monkeypatch)
    assert len(calls) == get_smoke_config("mamba2-1.3b").n_layers
