"""PyTorch port, SSD chunk scan kernel module (`kernels.ssd_chunk`) and the
SSD block (`models.ssd`) against the JAX reference.

Tolerances:
* the scan's plain version against the reference's ``ssd_chunked`` and
  ``ssd_chunk_pallas(interpret=True)`` on the reference's own input family
  (dt in [0.001, 0.1], A = exp(a_log) in [1, 8]): ``atol = 3e-5``, ``rtol =
  3e-4``, the reference suite's tolerance between its kernel and its oracle
  (``tests/test_kernels.py::test_ssd_chunk_sweep``).  The same holds for
  the final state against ``_final_state`` and, on the CPU, for
  `ref.ssd_chunk_blocked` (the CUDA kernel's three-phase decomposition)
  against the plain version;
* on model-like inputs (dt = softplus of a normal draw, about 0.3 to 2, and
  A up to 16, where the chunk cumsums reach -10^3), the same ``3e-5`` /
  ``3e-4``: at the chunks of 32 and 128 steps used here, the reference's
  ``jnp.cumsum`` and the port's in-order cumsum (`ref.cumsum`) stay that
  close;
* bf16 x, b and c: the output in bf16, one bf16 spacing (``rtol = 2^-7``)
  plus ``atol = 3e-5``, since float32 sums a few ulps apart may round to
  neighbouring bf16 values;
* `ref.ssd_chunk_segmented`, the tensor-core kernel's segments, passes and
  roundings (pass 1's aggregates, the chained hand-off, ``dt`` folded into
  ``M``, every float32 operand split in three bf16 parts), on bf16 inputs:
  y within ``3e-5`` plus ``3e-4`` and one bf16 spacing relative, the final
  state within ``3e-5 / 3e-4``, against the plain version and against the
  reference's ``ssd_chunked`` and ``_final_state``;
* `kernels._split.split_bf16` in three parts gives back every float32
  value of the normal range exactly;
* `ssd_block` in prefill and decode, output and cache, and the conv's
  output, against the reference's: ``atol = rtol = 5e-2``, the bf16
  tolerance the reference suite holds its own prefill and forward paths to
  (``tests/test_arch_smoke.py``).  The conv state is bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels.ssd_chunk.kernel import ssd_chunk_pallas  # noqa: E402
from repro.models import ssd as JSSD  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels._split import split_bf16  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as pkernel  # noqa: E402
from repro_torch.kernels.ssd_chunk import ops as pops  # noqa: E402
from repro_torch.kernels.ssd_chunk.ref import (  # noqa: E402
    ssd_chunk_blocked, ssd_chunk_ref, ssd_chunk_segmented, ssd_final_state)
from repro_torch.models import ssd as SSD  # noqa: E402
from repro_torch.models.convert import fill_module  # noqa: E402

ATOL, RTOL = 3e-5, 3e-4
BF16_TOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def inputs(seed, b, s, h, p, n, *, model_like=False):
    """(x, dt, a_log, b, c) float32 numpy: the reference suite's family, or
    the model's (dt = softplus(N(0, 1)), a_log = log(linspace(1, 16)))."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, s, h, p))
    if model_like:
        dt = np.logaddexp(rng.normal(0, 1, (b, s, h)), 0.0)
        al = np.log(np.linspace(1.0, 16.0, h))
    else:
        dt = rng.uniform(0.001, 0.1, (b, s, h))
        al = np.log(rng.uniform(1, 8, h))
    bm = rng.normal(0, 1, (b, s, n))
    cm = rng.normal(0, 1, (b, s, n))
    return tuple(a.astype(np.float32) for a in (x, dt, al, bm, cm))


def close(got, want, what="", atol=ATOL, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                               err_msg=f"{what}: max abs err {err}")


def f32(x):
    return np.asarray(x).astype(np.float32)


def torch_args(args):
    return tuple(torch.from_numpy(a) for a in args)


def jax_args(args):
    return tuple(jnp.asarray(a) for a in args)


def bf16_args(args):
    """torch (x, dt, a_log, b, c) with x, b and c in bf16, as the model
    calls the scan."""
    return tuple(torch.from_numpy(a) if i in (1, 2) else torch.from_numpy(
        a).to(torch.bfloat16) for i, a in enumerate(args))


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 128, 2, 32, 32, 64), (2, 256, 4, 64, 128, 128), (1, 64, 1, 16, 64, 32),
])
def test_plain_scan_equals_reference_and_interpreted_kernel(b, s, h, p, n,
                                                            chunk):
    """The shapes of tests/test_kernels.py::test_ssd_chunk_sweep."""
    args = inputs(0, b, s, h, p, n)
    got = ssd_chunk_ref(*torch_args(args), chunk=chunk)
    assert got.dtype == torch.float32
    close(got, JSSD.ssd_chunked(*jax_args(args), chunk=chunk),
          "plain vs ssd_chunked")
    close(got, ssd_chunk_pallas(*jax_args(args), chunk=chunk,
                                interpret=True),
          "plain vs ssd_chunk_pallas(interpret)")


@pytest.mark.parametrize("s", [1, 5, 31, 33, 100, 129])
@pytest.mark.parametrize("model_like", [False, True])
def test_plain_scan_ragged_equals_reference(s, model_like):
    """Any S, the tail chunk padded (chunk 32), on both input families; the
    op's CPU dispatch gives the same output and the final state."""
    args = inputs(s, 2, s, 3, 8, 16, model_like=model_like)
    want = JSSD.ssd_chunked(*jax_args(args), chunk=32)
    got = ssd_chunk_ref(*torch_args(args), chunk=32)
    close(got, want, f"plain S={s}")
    y, state = pops.ssd_chunk(*torch_args(args), chunk=32)
    assert torch.equal(y, got)
    close(state, JSSD._final_state(*jax_args(args), chunk=32),
          f"ops state S={s}")


def test_plain_scan_bf16_inputs_equal_reference():
    """x, b and c in bf16: float32 inside, the output in bf16."""
    args = inputs(7, 1, 160, 4, 16, 32, model_like=True)
    bf = [a if i in (1, 2) else f32(jnp.asarray(a).astype(jnp.bfloat16))
          for i, a in enumerate(args)]
    jin = [jnp.asarray(a) if i in (1, 2) else jnp.asarray(a).astype(
        jnp.bfloat16) for i, a in enumerate(args)]
    tin = [torch.from_numpy(a) if i in (1, 2) else torch.from_numpy(
        a).to(torch.bfloat16) for i, a in enumerate(bf)]
    want = JSSD.ssd_chunked(*jin, chunk=128)
    got = ssd_chunk_ref(*tin, chunk=128)
    assert got.dtype == torch.bfloat16
    close(got.float(), f32(want), "bf16 y", rtol=2.0 ** -7)
    close(ssd_final_state(*tin), JSSD._final_state(*jin), "bf16 state")


@pytest.mark.parametrize("s,chunk", [(1, 128), (37, 16), (64, 16),
                                     (300, 128), (129, 128)])
@pytest.mark.parametrize("model_like", [False, True])
def test_final_state_equals_reference(s, chunk, model_like):
    args = inputs(3 * s + chunk, 2, s, 2, 8, 16, model_like=model_like)
    close(ssd_final_state(*torch_args(args), chunk=chunk),
          JSSD._final_state(*jax_args(args), chunk=chunk),
          f"final state S={s} chunk={chunk}")


@pytest.mark.parametrize("chunk,rows", [(4, 2), (8, 4), (16, 16), (32, 8)])
@pytest.mark.parametrize("s", [1, 7, 16, 45])
def test_blocked_emulation_equals_plain(chunk, rows, s):
    """The kernel's decomposition at small block shapes (the last chunk
    ragged; one chunk where S <= chunk), y and the final state."""
    for model_like in (False, True):
        args = torch_args(inputs(chunk * 100 + s, 2, s, 3, 8, 16,
                                 model_like=model_like))
        y, state = ssd_chunk_blocked(*args, chunk=chunk, rows=rows)
        close(y, ssd_chunk_ref(*args, chunk=chunk), f"blocked y ({chunk}, "
              f"{rows}, {s})")
        close(state, ssd_final_state(*args, chunk=chunk),
              f"blocked state ({chunk}, {rows}, {s})")


def _segmented_vs_plain_and_reference(args, chunk, segments, what):
    """`ssd_chunk_segmented` on bf16 x, b and c against the plain version
    and the reference's ``ssd_chunked`` and ``_final_state``."""
    tin = bf16_args(args)
    jin = [jnp.asarray(a) if i in (1, 2) else jnp.asarray(a).astype(
        jnp.bfloat16) for i, a in enumerate(args)]
    y, state = ssd_chunk_segmented(*tin, chunk=chunk, segments=segments)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    rtol = RTOL + 2.0 ** -7
    close(y.float(), ssd_chunk_ref(*tin, chunk=chunk).float(), f"{what} y",
          rtol=rtol)
    close(state, ssd_final_state(*tin, chunk=chunk), f"{what} state")
    close(y.float(), f32(JSSD.ssd_chunked(*jin, chunk=chunk)),
          f"{what} y vs ssd_chunked", rtol=rtol)
    close(state, JSSD._final_state(*jin, chunk=chunk),
          f"{what} state vs _final_state")


@pytest.mark.parametrize("s,chunk", [(1, 128), (7, 16), (45, 16), (129, 128),
                                     (300, 128), (64, 32)])
@pytest.mark.parametrize("model_like", [False, True])
def test_split_emulation_equals_plain_and_reference(s, chunk, model_like):
    """The tensor-core kernel's roundings on bf16 inputs (one chunk, ragged
    tails, many chunks), y and the final state, through its segmented
    emulation at two segments (one where the sequence is one chunk)."""
    args = inputs(11 * s + chunk, 2, s, 3, 8, 16, model_like=model_like)
    _segmented_vs_plain_and_reference(args, chunk, 2, f"split S={s}")


@pytest.mark.parametrize("s", [45, 100])
@pytest.mark.parametrize("segments", [1, 2, 3, 4])
@pytest.mark.parametrize("model_like", [False, True])
def test_segmented_emulation_equals_plain_and_reference(s, segments,
                                                        model_like):
    """Segments of consecutive chunks of 16 steps: S 45 is three chunks, the
    last ragged (four segments asked for: one a chunk); S 100 is seven, so
    the last segment is longer than the first and ends in the ragged chunk
    (bounds 0, 3, 7 / 0, 2, 4, 7 / 0, 1, 3, 5, 7)."""
    args = inputs(7 * s + segments, 2, s, 3, 8, 16, model_like=model_like)
    _segmented_vs_plain_and_reference(args, 16, segments,
                                      f"S={s} T={segments}")


def test_segmented_emulation_hand_off_is_the_walk():
    """Any segment count gives the final state of one segment up to the
    float32 rounding of the decays' product and of the hand-off's sums."""
    tin = bf16_args(inputs(5, 1, 200, 2, 8, 16, model_like=True))
    _, one = ssd_chunk_segmented(*tin, chunk=16, segments=1)
    for segments in (2, 5, 13, 40):
        _, state = ssd_chunk_segmented(*tin, chunk=16, segments=segments)
        close(state, one, f"state T={segments}", atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("bsz,h,s,want", [
    (1, 64, 1, 1), (1, 64, 100, 1), (1, 64, 128, 1), (4, 3, 128, 1),
    (1, 64, 129, 2), (1, 64, 4096, 2), (1, 64, 16_384, 2), (3, 64, 4096, 1),
    (1, 132, 4096, 1), (1, 67, 4096, 1), (1, 33, 4096, 4), (1, 3, 300, 3),
    (2, 4, 4096, 16)])
def test_segment_count_rule(bsz, h, s, want):
    """As many segments as one wave of blocks (one an SM) holds, at most one
    a chunk: one where the sequence is one chunk or B * H alone fills the
    card's SMs; two at mamba2-1.3b's 64 heads at S 4,096 and 16,384."""
    got = pkernel.segment_count(bsz, h, s)
    n_chunks = -(-s // 128)
    assert got == want
    assert 1 <= got <= n_chunks
    assert got == 1 or bsz * h * got <= pkernel.SMS
    assert got == n_chunks or bsz * h * (got + 1) > pkernel.SMS


@pytest.mark.parametrize("scale", [1.0, 2.0 ** -80, 2.0 ** 80])
def test_three_part_split_is_exact(scale):
    """hi + mid + lo gives back each float32 value of the normal range; the
    first two parts alone are within 2^-17 of it."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, 100_000).astype(np.float32)) * scale
    hi, mid, lo = split_bf16(x, 3)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    assert all(torch.equal(t, t.to(torch.bfloat16).float())
               for t in (hi, mid, lo))
    two = split_bf16(x)
    assert torch.equal(two[0], hi) and torch.equal(two[1], mid)
    rel = (x.double() - hi.double() - mid.double()).abs() / x.double().abs()
    assert float(rel.max()) <= 2.0 ** -17


def test_cuda_wrapper_refuses_cpu_tensors():
    args = torch_args(inputs(0, 1, 4, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.ssd_chunk_kernel(*args)
    with pytest.raises(ValueError, match="takes x"):
        ssd_chunk_ref(args[0], args[1], args[2], args[3], args[4][:, :2])


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

CFG = "mamba2-1.3b"


def _block(seed):
    jcfg = jax_smoke(CFG)
    cfg = get_smoke_config(CFG)
    jp = JSSD.init_ssd(jax.random.key(seed), jcfg.d_model,
                       n_heads=jcfg.ssm_heads, head_dim=jcfg.ssm_head_dim,
                       state=jcfg.ssm_state)
    port = SSD.SSD(cfg.d_model, None, n_heads=cfg.ssm_heads,
                   head_dim=cfg.ssm_head_dim, state=cfg.ssm_state,
                   device="cpu")
    fill_module(port, jax.tree.map(np.asarray, jp))
    return jcfg, jp, cfg, port


def test_conv_equals_reference():
    """The shifted sum rounds as the reference's, term by term, then SiLU
    in float32; the conv state is bit-equal."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 9, 24)).astype(np.float32)
    w = rng.normal(0, 0.1, (SSD.CONV_W, 24)).astype(np.float32)
    st = rng.normal(0, 1, (2, SSD.CONV_W - 1, 24)).astype(np.float32)
    bf = jnp.bfloat16
    tb = torch.bfloat16
    for state in (None, st):
        jo, js = JSSD._conv(
            jnp.asarray(x).astype(bf), jnp.asarray(w).astype(bf),
            None if state is None else jnp.asarray(state).astype(bf))
        to, ts = SSD._conv(
            torch.from_numpy(x).to(tb), torch.from_numpy(w).to(tb),
            None if state is None else torch.from_numpy(state).to(tb))
        assert to.dtype == tb
        close(to.float(), f32(jo), "conv out", BF16_TOL, BF16_TOL)
        assert np.array_equal(ts.float().numpy(), f32(js))


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-30, 30, 601), [0.0, 20.5, 88.0]])
    x = x.astype(np.float32)
    got = SSD.softplus(torch.from_numpy(x)).numpy()
    close(got, f32(jax.nn.softplus(jnp.asarray(x))), "softplus", 1e-6, 1e-6)


@pytest.mark.parametrize("s", [1, 5, 40, 150])
def test_ssd_block_prefill_and_decode_equal_reference(s):
    jcfg, jp, cfg, port = _block(s)
    b = 2
    rng = np.random.default_rng(s)
    x = rng.normal(0, 1, (b, s + 3, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)

    jy, jc = JSSD.ssd_block(jp, jx[:, :s], jcfg, mode="prefill")
    ty, tc = SSD.ssd_block(port, tx[:, :s], cfg, mode="prefill")
    assert ty.dtype == torch.bfloat16 and tc["conv"].dtype == torch.bfloat16
    assert tc["h"].dtype == torch.float32
    close(ty.float(), f32(jy), "prefill y", BF16_TOL, BF16_TOL)
    close(tc["conv"].float(), f32(jc["conv"]), "prefill conv", BF16_TOL,
          BF16_TOL)
    close(tc["h"], f32(jc["h"]), "prefill h", BF16_TOL, BF16_TOL)
    fy, fc = SSD.ssd_block(port, tx[:, :s], cfg, mode="forward")
    assert fc is None and torch.equal(fy, ty)

    # three decode steps, from the reference's own cache and from the
    # port's carried one
    carried = tc
    for i in range(3):
        step = slice(s + i, s + i + 1)
        jy, jc_next = JSSD.ssd_block(jp, jx[:, step], jcfg, mode="decode",
                                     cache=jc)
        from_ref = {"conv": torch.from_numpy(f32(jc["conv"])).to(
            torch.bfloat16), "h": torch.from_numpy(f32(jc["h"]))}
        for cache in (from_ref, carried):
            ty, tc = SSD.ssd_block(port, tx[:, step], cfg, mode="decode",
                                   cache=cache)
            close(ty.float(), f32(jy), f"decode {i} y", BF16_TOL, BF16_TOL)
            close(tc["h"], f32(jc_next["h"]), f"decode {i} h", BF16_TOL,
                  BF16_TOL)
            close(tc["conv"].float(), f32(jc_next["conv"]),
                  f"decode {i} conv", BF16_TOL, BF16_TOL)
        carried = tc
        jc = jc_next


def test_init_ssd_cache_matches_reference():
    jcfg = jax_smoke(CFG)
    cfg = get_smoke_config(CFG)
    jc = JSSD.init_ssd_cache(3, jcfg)
    tc = SSD.init_ssd_cache(3, cfg, device="cpu")
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype).split(".")[1] == str(jc[k].dtype)
        assert not bool(tc[k].float().abs().sum())


def test_block_parameters_follow_the_reference():
    """Names, shapes, dtypes, and the deterministic leaves' values (A_log,
    dt_bias, the norm scale) of a block drawn from a generator."""
    jcfg, jp, cfg, _ = _block(0)
    port = SSD.SSD(cfg.d_model, torch.Generator().manual_seed(0),
                   n_heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim,
                   state=cfg.ssm_state, device="cpu")
    leaves = dict(jax.tree_util.tree_leaves_with_path(jp))
    named = dict(port.named_parameters())
    assert sorted(named) == sorted(
        ".".join(k.key for k in path) for path in leaves)
    for path, want in leaves.items():
        got = named[".".join(k.key for k in path)]
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[1] == str(want.dtype)
    for name in ("A_log", "dt_bias", "norm.scale"):
        close(named[name].detach(), f32(jp[name] if "." not in name
                                        else jp["norm"]["scale"]),
              name, 1e-7, 1e-7)


def worst_ratio(got, want, atol, rtol):
    """Largest |got - want| over what ``atol + rtol * |want|`` allows (at
    most 1 passes)."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def model_size_rehearsal() -> bool:
    """`ssd_chunk_segmented` at the kernel's segment count against the plain
    version at mamba2-1.3b's SSD shape (B 1, S 4,096, H 64, P 64, N 128,
    bf16 x, b and c), on both input families, at this file's tolerances:
    the check to run on the CPU before a card run of a change to the
    tensor-core kernel's roundings.  It is
    kept out of the suite for its size (a few GB, about a minute):
    ``PYTHONPATH=src python tests/test_torch_ssd.py`` prints, per family,
    the worst ratio of each difference to what the tolerance allows."""
    ok = True
    for model_like in (False, True):
        args = bf16_args(inputs(0, 1, 4096, 64, 64, 128,
                                model_like=model_like))
        y, state = ssd_chunk_segmented(
            *args, segments=pkernel.segment_count(1, 64, 4096))
        ry = worst_ratio(y.float(), ssd_chunk_ref(*args).float(), ATOL,
                         RTOL + 2.0 ** -7)
        rs = worst_ratio(state, ssd_final_state(*args), ATOL, RTOL)
        print(f"{'model' if model_like else 'reference'} family: y {ry:.3f}"
              f", state {rs:.3f} of the tolerance")
        ok &= ry <= 1 and rs <= 1
    return ok


if __name__ == "__main__":
    raise SystemExit(0 if model_size_rehearsal() else 1)
