"""PyTorch port, flash attention kernel module (`kernels.flash_attention`)
and the attention block (`models.attention`) against the JAX reference.

Tolerances:
* the plain version against the reference's ``flash_attention_ref`` and
  ``flash_attention_gqa(interpret=True)``, in float32: ``atol = rtol =
  1e-4``, the tolerance of the reference's kernel benchmark
  (``benchmarks/bench_kernels.py``); the sums run in another order;
* `ref.flash_attention_tiled`, the CPU emulation of the CUDA kernels' tile
  walk (dead tiles skipped, online softmax), against the plain version: the
  same ``1e-4``; with ``split=True`` (the tensor-core kernel's roundings:
  the float32 weights split hi/lo into bf16 against V) on bf16 inputs, the
  same ``1e-4`` against the plain version, the reference's
  ``flash_attention_ref`` and its interpreted kernel: the split keeps
  2^-17 of each term;
* the padded head dim (D 8 and 12 padded with zero columns to 16, the
  scores divided by the true D's square root), sliced back, against the
  unpadded call: ``1e-6`` (float32 sums over extra zero columns in another
  blocking);
* `kernels._split.split_bf16`: ``hi + lo`` within 2^-17 of each float32
  value, relative, and equal to a bf16 value;
* the model-layout op against the reference's ``ops.flash_attention(impl=
  "ref")``: ``1e-4`` in float32;
* the port's ``plain_attention`` and ``chunked_attention`` against the
  reference's, and `attention_block` in prefill (prompts shorter and longer
  than the window, and past the reference's 2048-token switch to
  ``chunked_attention``) and decode across the ring wrap: ``atol = rtol =
  5e-2``, the bf16 tolerance the reference suite holds its own paths to
  (``tests/test_arch_smoke.py``).  The port's prefill follows the kernel
  (float32 softmax weights and accumulator), the reference's model rounds
  the weights (plain) or the accumulator (chunked) to bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_gqa)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_ref)
from repro.models import attention as JA  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels._split import split_bf16  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as pkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as pops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as pref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_grouped, flash_attention_tiled, kv_tile_range)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.convert import fill_module  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol,
                               err_msg=f"{what}: max abs err {err}")


def f32(x):
    return np.asarray(x).astype(np.float32)


def grouped(seed, b, kv, g, s, d, t=None):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return (rng.normal(0, 1, (b, kv, g, s, d)).astype(np.float32),
            rng.normal(0, 1, (b, kv, t, d)).astype(np.float32),
            rng.normal(0, 1, (b, kv, t, d)).astype(np.float32))


# (b, kv, g, s, d, causal, window): GQA, MQA, windows, non-causal, ragged S
CASES = [(1, 2, 2, 64, 16, True, 0), (2, 1, 4, 37, 8, True, 0),
         (1, 1, 5, 50, 16, True, 16), (1, 2, 1, 33, 8, False, 0),
         (2, 1, 2, 29, 12, False, 8), (1, 3, 2, 1, 8, True, 0),
         (1, 1, 10, 70, 32, True, 32)]


@pytest.mark.parametrize("b,kv,g,s,d,causal,window", CASES)
def test_plain_equals_reference(b, kv, g, s, d, causal, window):
    q, k, v = grouped(s * 7 + d, b, kv, g, s, d)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window)
    got = flash_attention_grouped(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window)
    assert got.dtype == torch.float32
    close(got, want, F32_TOL, "plain vs flash_attention_ref")


@pytest.mark.parametrize("b,kv,g,s,d,causal,window,qb,kb", [
    (1, 2, 2, 64, 16, True, 0, 16, 32), (2, 1, 4, 37, 8, True, 0, 37, 37),
    (1, 1, 3, 48, 16, True, 16, 16, 16), (1, 2, 1, 32, 8, False, 0, 8, 16)])
def test_plain_equals_interpreted_kernel(b, kv, g, s, d, causal, window, qb,
                                         kb):
    q, k, v = grouped(s + d, b, kv, g, s, d)
    want = flash_attention_gqa(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               q_blk=qb, kv_blk=kb, interpret=True)
    got = flash_attention_grouped(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window)
    close(got, want, F32_TOL, "plain vs flash_attention_gqa(interpret)")


@pytest.mark.parametrize("bq,bk", [(1, 1), (4, 8), (8, 4), (16, 16),
                                   (64, 64)])
@pytest.mark.parametrize("b,kv,g,s,d,causal,window", CASES)
def test_tiled_emulation_equals_plain(b, kv, g, s, d, causal, window, bq,
                                      bk):
    q, k, v = (torch.from_numpy(x) for x in grouped(s * 3 + bq, b, kv, g, s,
                                                    d))
    want = flash_attention_grouped(q, k, v, causal=causal, window=window)
    got = flash_attention_tiled(q, k, v, causal=causal, window=window, bq=bq,
                                bk=bk)
    close(got, want, F32_TOL, f"tiled bq={bq} bk={bk}")


@pytest.mark.parametrize("bq,bk", [(128, 64), (64, 64), (16, 8)])
@pytest.mark.parametrize("b,kv,g,s,d,causal,window", CASES)
def test_split_emulation_equals_plain_and_reference(b, kv, g, s, d, causal,
                                                    window, bq, bk):
    """The tensor-core kernel's roundings (P split hi/lo against V) on bf16
    inputs, at its own tiles (64 keys; 128 query rows, 64 at D 256) and at
    small ones."""
    q, k, v = (f32(jnp.asarray(x).astype(jnp.bfloat16))
               for x in grouped(s * 5 + bq, b, kv, g, s, d))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = flash_attention_tiled(tq, tk, tv, causal=causal, window=window,
                                bq=bq, bk=bk, split=True)
    assert got.dtype == torch.bfloat16
    got32 = flash_attention_tiled(tq.float(), tk.float(), tv.float(),
                                  causal=causal, window=window, bq=bq, bk=bk,
                                  split=True)
    close(got32, flash_attention_grouped(tq.float(), tk.float(), tv.float(),
                                         causal=causal, window=window),
          F32_TOL, f"split bq={bq} bk={bk} vs plain")
    close(got32, jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window), F32_TOL,
          f"split bq={bq} bk={bk} vs flash_attention_ref")


@pytest.mark.parametrize("bq", [128, 64])
@pytest.mark.parametrize("b,kv,g,s,d,causal,window", [
    (1, 2, 2, 192, 16, True, 0), (1, 1, 3, 128, 32, True, 40),
    (2, 1, 2, 192, 16, False, 0), (1, 2, 1, 64, 16, False, 24)])
def test_split_emulation_at_the_kernel_tiles_equals_interpreted_kernel(
        b, kv, g, s, d, causal, window, bq):
    """The tensor-core kernel's walk and roundings at its own tiles (64-key
    tiles; a block of 128 query rows, or 64 at D 256), past several tiles,
    against the reference's Pallas kernel run interpreted at its own
    blocks (S a multiple of them, as it asks; 192 rows leave the emulation
    a ragged 128-row block)."""
    q, k, v = (f32(jnp.asarray(x).astype(jnp.bfloat16))
               for x in grouped(s + bq, b, kv, g, s, d))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = flash_attention_tiled(tq, tk, tv, causal=causal, window=window,
                                bq=bq, bk=64, split=True)
    want = flash_attention_gqa(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               q_blk=64, kv_blk=64, interpret=True)
    close(got, want, F32_TOL, f"split bq={bq} vs flash_attention_gqa")


# (b, kv, g, s, t, d, causal, window) at the smoke configs' head dims 8 and
# 12: GQA, causal, windowed, non-causal, S < T
PAD_CASES = [(2, 2, 4, 32, 32, 8, True, 0), (1, 1, 3, 40, 40, 8, True, 9),
             (2, 4, 1, 19, 45, 12, False, 0), (1, 2, 2, 30, 50, 12, True, 7),
             (1, 1, 2, 33, 33, 12, False, 11)]


@pytest.mark.parametrize("b,kv,g,s,t,d,causal,window", PAD_CASES)
def test_padded_head_dim_equals_unpadded(b, kv, g, s, t, d, causal, window):
    """The autograd op's path on the card for a bf16 head dim that is not a
    multiple of 16: q, k and v padded with zero columns to
    `ops.padded_head_dim`, the scores divided by the true D's square root
    (``head_dim``), the output sliced back.  Through the plain version and
    the split emulation at the kernel's tiles, the output and the base-2
    LSE equal the unpadded call's within ``1e-6`` (float32 sums over the
    extra zero columns, taken in another blocking)."""
    rng = np.random.default_rng(s * 3 + d)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
               for shape in ((b, s, kv * g, d), (b, t, kv, d), (b, t, kv, d)))
    dp = pops.padded_head_dim(d)
    assert dp == 16
    qp, kp, vp = (pops.pad_head_dim(x, dp) for x in (q, k, v))
    assert qp.shape[-1] == dp and not qp[..., d:].any()
    kw = dict(causal=causal, window=window)
    want, lse = pref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    got, lse_p = pref.flash_attention_ref(qp, kp, vp, return_lse=True,
                                          head_dim=d, **kw)
    close(got[..., :d], want, 1e-6, "padded plain")
    assert not got[..., d:].any()
    close(lse_p, lse, 1e-6, "padded lse")
    # without the true D the padded call divides by sqrt(16), not sqrt(d)
    assert not torch.allclose(pref.flash_attention_ref(qp, kp, vp, **kw)[
        ..., :d], want, atol=1e-3)
    gq = pref._grouped(qp.to(torch.bfloat16), kv)
    kt, vt = (x.to(torch.bfloat16).transpose(1, 2) for x in (kp, vp))
    tiled = flash_attention_tiled(gq.float(), kt.float(), vt.float(),
                                  bq=128, bk=64, split=True, head_dim=d, **kw)
    gw = pref._grouped(q.to(torch.bfloat16), kv).float()
    plain = flash_attention_grouped(
        gw, k.to(torch.bfloat16).float().transpose(1, 2),
        v.to(torch.bfloat16).float().transpose(1, 2), **kw)
    close(tiled[..., :d], plain, F32_TOL, "padded split emulation")


@pytest.mark.parametrize("scale", [1.0, 2.0 ** -60, 2.0 ** 60])
def test_hi_lo_split(scale):
    """hi + lo is within 2^-17 of each float32 value, relative, hi and lo
    hold bf16 values, and a bf16 value splits into itself and 0."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, 100_000).astype(np.float32)) * scale
    hi, lo = split_bf16(x)
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert torch.equal(part, part.to(torch.bfloat16).float())
    rel = ((x.double() - hi.double() - lo.double()).abs()
           / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -17
    b = x.to(torch.bfloat16).float()
    hi, lo = split_bf16(b)
    assert torch.equal(hi, b) and not lo.any()


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16),
                                           (False, 0), (False, 12)])
def test_fewer_queries_than_keys(causal, window):
    """S < T (the kernel takes any S <= T): the plain version against the
    reference, and the tile walk against the plain version."""
    q, k, v = grouped(5, 1, 2, 3, 37, 16, t=90)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = flash_attention_grouped(tq, tk, tv, causal=causal, window=window)
    close(got, want, F32_TOL, "plain, S < T")
    close(flash_attention_tiled(tq, tk, tv, causal=causal, window=window,
                                bq=8, bk=16), want, F32_TOL, "tiled, S < T")


def test_dead_tiles_are_skipped():
    """At the slice's shape (S = T = 4096, window 2048, 64 x 64 tiles) the
    walk visits about half of the tiles a dense grid would."""
    s, w, bq, bk = 4096, 2048, 64, 64
    visited = sum(len(kv_tile_range(q0, bq, s, bk, causal=True, window=w))
                  for q0 in range(0, s, bq))
    dense = (s // bq) * (s // bk)
    assert visited == 1584 and visited / dense < 0.4
    # every visited tile holds at least one key some row of the tile sees
    for q0 in range(0, s, bq):
        for j0 in kv_tile_range(q0, bq, s, bk, causal=True, window=w):
            assert j0 <= q0 + bq - 1 and j0 + bk - 1 > q0 - w


@pytest.mark.parametrize("b,s,h,kvh,d,causal,window", [
    (2, 40, 8, 2, 16, True, 0), (1, 33, 4, 1, 8, True, 16),
    (1, 20, 2, 2, 8, False, 0)])
def test_ops_model_layout_equals_reference(b, s, h, kvh, d, causal, window):
    rng = np.random.default_rng(s)
    q = rng.normal(0, 1, (b, s, h, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, kvh, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, kvh, d)).astype(np.float32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                impl="ref")
    got = pops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               window=window)
    close(got, want, F32_TOL, "ops (model layout)")
    # bf16 in, bf16 out
    got16 = pops.flash_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                                   for x in (q, k, v)), causal=causal,
                                 window=window)
    assert got16.dtype == torch.bfloat16
    close(got16.float(), want, BF16_TOL, "ops bf16")


def test_ops_refuse_longer_queries_and_cpu_kernel_launch():
    x = torch.zeros(1, 5, 2, 8)
    with pytest.raises(ValueError, match="S <= T"):
        pops.flash_attention(x, x[:, :4], x[:, :4])
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.flash_attention_kernel(x, x, x)


# ---------------------------------------------------------------------------
# the model's attention functions and block
# ---------------------------------------------------------------------------

def _model_layout(seed, b, s, h, kvh, d):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(0, 1, (b, s, n, d)).astype(np.float32)
            for n in (h, kvh, kvh)]
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrs],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrs])


@pytest.mark.parametrize("window", [None, 24])
def test_plain_and_chunked_attention_equal_reference(window):
    (jq, jk, jv), (tq, tk, tv) = _model_layout(3, 2, 70, 4, 2, 16)
    close(A.plain_attention(tq, tk, tv, window=window).float(),
          f32(JA.plain_attention(jq, jk, jv, window=window)), BF16_TOL,
          "plain_attention")
    close(A.chunked_attention(tq, tk, tv, chunk=32, window=window).float(),
          f32(JA.chunked_attention(jq, jk, jv, chunk=32, window=window)),
          BF16_TOL, "chunked_attention")


def _attn(cfg, jcfg, seed):
    jp = JA.init_attn(jax.random.key(seed), cfg.d_model, cfg.n_heads,
                      cfg.n_kv, cfg.head_dim)
    port = A.Attention(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                       None, device="cpu")
    fill_module(port, jax.tree.map(np.asarray, jp))
    return jp, port


def _x(seed, b, s, d):
    x = np.random.default_rng(seed).normal(0, 1, (b, s, d)).astype(
        np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)


def _pos(b, s, start=0):
    p = np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None],
                        (b, s))
    return jnp.asarray(p), torch.from_numpy(p.copy())


def _check_cache(tc, jc, what):
    close(tc["k"].float(), f32(jc["k"]), BF16_TOL, f"{what} k")
    close(tc["v"].float(), f32(jc["v"]), BF16_TOL, f"{what} v")
    assert np.array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert tc["len"].dtype == torch.int32


@pytest.mark.parametrize("arch,window,s,n_decode", [
    ("recurrentgemma-2b", 16, 9, 12),      # prompt shorter than the ring
    ("recurrentgemma-2b", 16, 23, 12),     # longer: rolled into the ring
    ("llama3-8b", None, 11, 4)])           # GQA, linear cache
def test_attention_block_prefill_and_decode_equal_reference(
        arch, window, s, n_decode):
    cfg = get_smoke_config(arch)
    jcfg = jax_smoke(arch)
    if window is not None:
        cfg = dataclasses.replace(cfg, window=window)
        jcfg = dataclasses.replace(jcfg, window=window)
    jp, port = _attn(cfg, jcfg, s)
    b, max_len = 2, 48
    jx, tx = _x(s, b, s + n_decode, cfg.d_model)
    jpos, tpos = _pos(b, s)
    jy, jc = JA.attention_block(jp, jx[:, :s], jpos, jcfg, mode="prefill",
                                window=window, cache_len=max_len)
    ty, tc = A.attention_block(port, tx[:, :s], tpos, cfg, mode="prefill",
                               window=window, cache_len=max_len)
    close(ty.float(), f32(jy), BF16_TOL, "prefill y")
    _check_cache(tc, jc, "prefill")
    # forward mode: same output, no cache
    fy, fc = A.attention_block(port, tx[:, :s], tpos, cfg, mode="forward",
                               window=window)
    assert fc is None and torch.equal(fy, ty)
    # decode across the ring wrap, each side carrying its own cache
    for i in range(n_decode):
        jpos, tpos = _pos(b, 1, s + i)
        step = slice(s + i, s + i + 1)
        jy, jc = JA.attention_block(jp, jx[:, step], jpos, jcfg,
                                    mode="decode", cache=jc, window=window)
        ty, tc = A.attention_block(port, tx[:, step], tpos, cfg,
                                   mode="decode", cache=tc, window=window)
        close(ty.float(), f32(jy), BF16_TOL, f"decode {i} y")
        _check_cache(tc, jc, f"decode {i}")


@pytest.mark.parametrize("window", [None, 2048])
def test_attention_block_past_the_reference_chunked_switch(window):
    """A 2,100-token prompt: the reference's block takes chunked_attention
    (above 2048 tokens), the port's the flash op, as at every length."""
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                              n_heads=2, window=window or 4096)
    jcfg = dataclasses.replace(jax_smoke("recurrentgemma-2b"), n_heads=2,
                               window=window or 4096)
    jp, port = _attn(cfg, jcfg, 5)
    s = 2100
    jx, tx = _x(11, 1, s, cfg.d_model)
    jpos, tpos = _pos(1, s)
    jy, jc = JA.attention_block(jp, jx, jpos, jcfg, mode="prefill",
                                window=window, cache_len=s + 8)
    ty, tc = A.attention_block(port, tx, tpos, cfg, mode="prefill",
                               window=window, cache_len=s + 8)
    close(ty.float(), f32(jy), BF16_TOL, "prefill y past 2048")
    _check_cache(tc, jc, "prefill past 2048")


def model_size_rehearsal() -> bool:
    """`flash_attention_tiled(split=True)` at the tensor-core kernel's tiles
    (128 query rows, 64 keys) against the plain version at recurrentgemma-
    2b's local-attention shape cut to two query heads (S 4,096, D 256,
    window 2,048, bf16), to the 2 bf16 ulps the card holds the kernel to
    (`test_torch_cuda.bf16_within_ulps`): the check to run on the CPU
    before a card run of a change to the kernel's roundings.  It is kept
    out of the suite for its size: ``PYTHONPATH=src python
    tests/test_torch_flash_attention.py`` prints whether the output is
    within 1 and within 2 ulps."""
    from test_torch_cuda import bf16_within_ulps

    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in grouped(0, 1, 1, 2, 4096, 256))
    got = flash_attention_tiled(q, k, v, causal=True, window=2048, bq=128,
                                bk=64, split=True)
    want = flash_attention_grouped(q, k, v, causal=True, window=2048)
    within = {n: bf16_within_ulps(got, want, n) for n in (1, 2)}
    print(f"within 1 ulp: {within[1]}, within 2 ulps: {within[2]}")
    return within[2]


if __name__ == "__main__":
    raise SystemExit(0 if model_size_rehearsal() else 1)
