"""PyTorch port, the SSD chunk scan at the chunk lengths beside 128 that the
card's kernels take (`kernel.CHUNKS`: 32, 64 and 256), on the CPU against
the JAX package: the kernels' CPU emulations at each length, mamba2-1.3b's
smoke model with that ``ssd_chunk``, and the card's refusal of any other
length.

Each chunk length has its own instance on the card.  A chunk shorter than
128 steps lands in the first rows of the 128-row tiles of the Q = 128
kernels, the other rows zero, so its sums are those of one chunk of Q;
a 256-step chunk is one item of the forward and the walk, and two tiles of
128 rows in the gradient launch, whose (row tile, key tile) pairs put their
partials in two slots added in order (`ref.ssd_chunk_bwd_segmented`).

Tolerances:
* `ref.ssd_chunk_segmented` (the tensor-core forward's roundings) on bf16
  x, b and c, and `ref.ssd_chunk_blocked` (the CUDA-core forward) on
  float32 inputs, against the reference's ``ssd_chunked`` and
  ``_final_state`` at the same chunk length on the reference suite's input
  family: ``SSD_TOL`` (``atol 3e-5``, ``rtol 3e-4``) and, on a bf16 y, one
  bf16 spacing more (``2^-7`` relative), as ``tests/test_torch_ssd.py``
  holds them;
* on the model's family (dt = softplus of a normal draw, A up to 16) the
  emulations against the port's plain version at the same chunk length
  within ``SSD_TOL`` (the bound the card holds the kernels to), and the
  plain version against the reference within ``atol 3e-5`` and
  ``CUMSUM_RTOL[q]``: the reference takes its chunk cumsums with
  ``jnp.cumsum``, the port one float32 add a step in order (`ref.cumsum`,
  the kernels' order); the cumsums grow with the chunk (to about -2 x 10^3
  at 256 steps here), and so does the distance of exp(cs_i - cs_j) between
  the two orders: measured at most 0.42, 1.12 and 6.83 times ``SSD_TOL``
  at 32, 64 and 256 steps on these shapes (2.0 at 128), so the bound is
  ``SSD_TOL`` times ``CUMSUM_SCALE[q]`` = 1, 2 and 10;
* `ref.ssd_chunk_bwd_segmented` (the backward kernels' walk segments, head
  groups and, at 256, tile pairs and slots) on bf16 x, b, c and dy against
  ``jax.vjp`` of ``ssd_chunked`` and ``_final_state`` on the same values in
  float32: each gradient in relative L2 within its ``SSD_BWD_TOL`` (the
  emulation's bound against the plain backward, ``tests/
  test_torch_ssd_bwd.py``) plus ``VJP_REL`` (``VJP_REL_DA`` for da_log),
  that file's bound between the plain backward and the reference's float32
  vjp;
* the smoke model cut to one layer, the port at ``ssd_chunk`` Q (weights
  carried across by `models.convert`) against one reference run (chunk
  256; the reference's function does not depend on its chunk length beyond
  float32 rounding): prefill logits within ``5e-2``
  (``tests/test_torch_mamba.py``), and one training step's loss within
  ``5e-2`` and every gradient leaf within ``5e-2`` in relative L2
  (``tests/_torch_train_parity.py``).  The gradients come from the
  reference compiled without XLA's excess precision (with it, the fusions
  keep float32 where the model rounds to bf16 and move the reference's own
  gradients by up to 18% here; without it, they are within 1.4e-6 of its
  op-by-op run, which takes 16 s on one thread against 2): one run, one
  layer; the logits from its compiled prefill (0.016 from its op-by-op run
  here, logits up to 3.3).
The reference's SSD functions themselves run compiled, one trace a shape.
The 128-step bounds are unchanged.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import ssd as JSSD  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel_bwd as SKB  # noqa: E402
from repro_torch.kernels.ssd_chunk import ops as SOPS  # noqa: E402
from repro_torch.kernels.ssd_chunk import ref as SR  # noqa: E402
from repro_torch.models import convert as CV  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

CHUNKS_OTHER = (32, 64, 256)
H, P, N = 4, 16, 32
SSD_TOL = (3e-5, 3e-4)
SSD_BWD_TOL = {"dx": 4e-3, "ddt": 1e-4, "da_log": 1e-3, "db": 1e-5,
               "dc": 1e-5}
VJP_REL, VJP_REL_DA = 3e-5, 5e-4
CUMSUM_SCALE = {32: 1, 64: 2, 256: 10}
MODEL_TOL = 5e-2
ARCH = "mamba2-1.3b"
NAMES = ("dx", "ddt", "da_log", "db", "dc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def lengths(q):
    """A sequence shorter than a chunk, one chunk, two and a ragged tail."""
    return (q - 3, q, 2 * q + 5)


def inputs(seed, b, s, *, model_like):
    """(x, dt, a_log, b, c, dy, dstate) float64 numpy: the reference suite's
    family (dt in [0.001, 0.1], A in [1, 8]) or the model's (dt =
    softplus(N(0, 1)), a_log = log(linspace(1, 16)))."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, s, H, P))
    if model_like:
        dt = np.logaddexp(rng.normal(0, 1, (b, s, H)), 0.0)
        al = np.log(np.linspace(1.0, 16.0, H))
    else:
        dt = rng.uniform(0.001, 0.1, (b, s, H))
        al = np.log(rng.uniform(1, 8, H))
    return (x, dt, al, rng.normal(0, 1, (b, s, N)),
            rng.normal(0, 1, (b, s, N)), rng.normal(0, 1, (b, s, H, P)),
            rng.normal(0, 1, (b, H, P, N)))


def low(args):
    """torch tensors: x, b, c and dy in bf16 (as the card takes them), dt,
    a_log and dstate float32."""
    out = [torch.from_numpy(np.asarray(a, np.float32)) for a in args]
    return [t.to(torch.bfloat16) if i in (0, 3, 4, 5) else t
            for i, t in enumerate(out)]


def jx(t):
    return jnp.asarray(t.float().numpy())


@functools.lru_cache(maxsize=None)
def reference(q):
    """The reference's (``ssd_chunked``, ``_final_state``) at chunk length
    ``q``, compiled (one function a chunk length, so a shape compiles
    once)."""
    return jax.jit(lambda x, dt, al, b, c: (
        JSSD.ssd_chunked(x, dt, al, b, c, chunk=q),
        JSSD._final_state(x, dt, al, b, c, chunk=q)))


def within(got, want, atol, rtol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), (what, float(np.abs(got - want).max()))


@pytest.mark.parametrize("q", CHUNKS_OTHER)
@pytest.mark.parametrize("model_like", [False, True])
def test_forward_emulations_equal_reference(q, model_like):
    """The tensor-core forward's emulation (two segments) on bf16 inputs and
    the CUDA-core forward's on float32, y and the final state, at chunk
    length ``q``: a sequence shorter than a chunk, one chunk, two chunks and
    a tail; against the reference's ``ssd_chunked`` and ``_final_state`` on
    its input family, and on the model's against the port's plain version,
    which is held to the reference at SSD_TOL times CUMSUM_SCALE."""
    atol, rtol = SSD_TOL
    for s in lengths(q):
        args = low(inputs(q + s, 2, s, model_like=model_like))[:5]
        f32 = [t.float() for t in args]
        ref_y, ref_s = (np.asarray(v) for v in reference(q)(
            *(jx(t) for t in args)))
        if model_like:
            k = CUMSUM_SCALE[q]
            want_y = SR.ssd_chunk_ref(*f32, chunk=q)
            want_s = SR.ssd_final_state(*f32, chunk=q)
            within(want_y, ref_y, k * atol, k * rtol, ("plain y", s))
            within(want_s, ref_s, k * atol, k * rtol, ("plain state", s))
        else:
            want_y, want_s = ref_y, ref_s
        y, state = SR.ssd_chunk_segmented(*args, chunk=q, segments=2)
        assert y.dtype == torch.bfloat16
        within(y.float(), want_y, atol, rtol + 2.0 ** -7, ("segmented y", s))
        within(state, want_s, atol, rtol, ("segmented state", s))
        y, state = SR.ssd_chunk_blocked(*f32, chunk=q,
                                        rows=16 if q > 128 else 32)
        within(y, want_y, atol, rtol, ("blocked y", s))
        within(state, want_s, atol, rtol, ("blocked state", s))


@pytest.mark.parametrize("q", CHUNKS_OTHER)
@pytest.mark.parametrize("model_like", [False, True])
def test_backward_emulation_equals_reference_vjp(q, model_like):
    """The backward kernels' emulation (two walk segments, groups of three
    of the four heads, and at 256 the tile pairs' slots) on bf16 inputs
    against ``jax.vjp`` of the reference's ``ssd_chunked`` and
    ``_final_state`` at chunk length ``q`` on the same values, with dstate,
    over two chunks and a ragged tail: each gradient in relative L2 within
    SSD_BWD_TOL plus VJP_REL."""
    for s in lengths(q)[2:]:
        args = low(inputs(3 * q + s, 2, s, model_like=model_like))
        x, dt, a_log, bm, cm, dy, dstate = args
        got = SR.ssd_chunk_bwd_segmented(*args, chunk=q, segments=2,
                                         group=3)
        _, vjp = jax.vjp(reference(q), *(jx(t) for t in (x, dt, a_log, bm,
                                                          cm)))
        want = vjp((jx(dy), jx(dstate)))
        want = (want[0], want[1], want[2], want[3], want[4])
        for name, g, w in zip(NAMES, got, want):
            w = np.asarray(w, np.float64)
            g = g.double().numpy()
            rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            bound = SSD_BWD_TOL[name] + (VJP_REL_DA if name == "da_log"
                                         else VJP_REL)
            assert rel <= bound, (q, s, name, rel)


@pytest.mark.parametrize("q", CHUNKS_OTHER)
def test_backward_tile_pairs_and_groups_are_one_group(q):
    """On float32 inputs the emulation's walk segments, head groups and (at
    256) tile pairs give the one-segment, one-group gradients up to the
    float32 rounding of the groups' and slots' sums: db and dc within
    ``1e-6`` in relative L2 (``tests/test_torch_ssd_bwd.py``'s bound for
    groups), the rest within ``1e-5`` (its bound for segments)."""
    args = [t.float() for t in low(inputs(q, 1, 2 * q + 5,
                                          model_like=True))]
    one = SR.ssd_chunk_bwd_segmented(*args, chunk=q, segments=1, group=H)
    many = SR.ssd_chunk_bwd_segmented(*args, chunk=q, segments=3, group=1)
    for name, g, w in zip(NAMES, many, one):
        rel = float((g.double() - w.double()).norm()
                    / w.double().norm().clamp_min(1e-30))
        assert rel <= (1e-6 if name in ("db", "dc") else 1e-5), (name, rel)


@pytest.fixture(scope="module")
def smoke_reference():
    """(reference params, tokens, prefill logits, loss, gradients) of
    mamba2-1.3b's smoke config cut to one layer, at chunk 256, on one row
    of 261 tokens (9, 5 and 2 chunks at 32, 64 and 256, the last ragged);
    the gradients compiled without excess precision."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), n_layers=1, ssd_chunk=256)
    params = jax.jit(lambda k: JTF.init_params(jcfg, k))(jax.random.key(0))
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (1, 261)).astype(
        np.int32)
    f = jax.value_and_grad(lambda p, b: JTF.loss_fn(p, jcfg, b),
                           has_aux=True)
    logits, _ = jax.jit(lambda p, t: JTF.prefill(
        p, jcfg, t, max_len=toks.shape[1] + 8))(params, jnp.asarray(toks))
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    (loss, _), grads = jax.jit(f).lower(params, batch).compile(
        compiler_options={"xla_allow_excess_precision": False})(params,
                                                                batch)
    return params, toks, np.asarray(logits, np.float32), float(loss), grads


@pytest.mark.parametrize("q", CHUNKS_OTHER)
def test_smoke_model_at_chunk_equals_reference(q, smoke_reference):
    """mamba2-1.3b's smoke config (one layer) with ``ssd_chunk`` q through
    the port's CPU path: prefill logits and one training step's loss and
    every gradient leaf against the reference's."""
    params, toks, want_logits, want_loss, grads = smoke_reference
    cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=1,
                              ssd_chunk=q)
    model = CV.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    tl, _ = TF.prefill(model, torch.from_numpy(toks), toks.shape[1] + 8)
    within(tl.float(), want_logits, MODEL_TOL, MODEL_TOL,
           ("prefill logits", q))
    model.requires_grad_(True)
    got, _ = TF.loss_fn(model, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(toks)})
    got.backward()
    assert abs(float(got.detach()) - want_loss) <= MODEL_TOL
    tree = CV.grads_to_tree(model)
    for path, want in jax.tree_util.tree_leaves_with_path(grads):
        g = tree
        for k in path:
            g = g[k.key]
        g = g.detach().float().numpy().astype(np.float64)
        want = np.asarray(want).astype(np.float64)
        assert np.all(np.isfinite(g)), path
        rel = np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= MODEL_TOL, (q, jax.tree_util.keystr(path), rel)


@pytest.mark.parametrize("chunk", [16, 100, 127, 512])
def test_card_refuses_other_chunk_lengths(chunk):
    """The card's kernels have an instance for each of `kernel.CHUNKS` and
    refuse any other length (a stated difference: the reference takes any
    chunk length that divides S), before any tensor is looked at; the CPU
    path takes it."""
    assert SK.CHUNKS == (32, 64, 128, 256)
    for q in SK.CHUNKS:
        assert SK.check_chunk(q) == q
    with pytest.raises(ValueError, match=r"\(32, 64, 128, 256\)"):
        SK.check_chunk(chunk)
    args = [torch.from_numpy(np.asarray(a, np.float32))
            for a in inputs(chunk, 1, 40, model_like=False)[:5]]
    for call in (lambda: SK.ssd_chunk_kernel(*args, chunk=chunk),
                 lambda: SKB.ssd_chunk_bwd_kernel(
                     *(t.to(torch.bfloat16) if i in (0, 3, 4) else t
                       for i, t in enumerate(args)),
                     args[0].to(torch.bfloat16), None, None, chunk=chunk)):
        with pytest.raises(ValueError, match="chunks of"):
            call()
    y, state = SOPS.ssd_chunk(*args, chunk=chunk)
    within(y, SR.ssd_chunk_ref(*args, chunk=chunk), 0, 0, "CPU path")


@pytest.mark.parametrize("q", (32, 64, 128, 256))
@pytest.mark.parametrize("bsz,h,s", [(1, 64, 4096), (1, 64, 16_384),
                                     (2, 4, 100), (1, 3, 1)])
def test_launch_shape_rules_follow_the_chunk(q, bsz, h, s):
    """`segment_count`, `walk_segments` and `head_group` at each chunk
    length: at most one segment a chunk; a wave of blocks (a block takes an
    SM at every length; the gradient launch has three tile pairs a chunk at
    256, whose heads' scans halve its groups to four heads)."""
    n_chunks = -(-s // q)
    seg = SK.segment_count(bsz, h, s, q)
    walk = SKB.walk_segments(bsz, h, s, q)
    grp = SKB.head_group(bsz, h, s, q)
    assert 1 <= seg <= n_chunks and 1 <= walk <= n_chunks
    assert seg == 1 or bsz * h * seg <= SK.SMS
    assert 1 <= grp <= min(SKB.GROUP_MAX_BY_CHUNK[q], h)
    assert SKB.pairs(q) == (3 if q == 256 else 1)
    if (bsz, h, s) == (1, 64, 4096):
        assert (seg, walk, grp) == (2, 1, 8 if q < 256 else 4)
