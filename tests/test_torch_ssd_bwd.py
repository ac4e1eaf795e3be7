"""PyTorch port, the SSD chunk scan's gradient on the CPU: the plain
backward (`ref.ssd_chunk_bwd_plain`, the closed form the CUDA backward
kernel computes) against ``jax.vjp`` of the reference's ``ssd_chunked`` and
``_final_state`` and against autograd of the port's plain forward; the CPU
path of `ops.SSDChunk` under ``gradcheck``; and the backward kernels' CPU
emulation (`ref.ssd_chunk_bwd_segmented`: the adjoint walk's segments and
reverse hand-off, the chunk gradients' groups of heads and their sum
orders, three-part splits) against the plain backward.

Tolerances:
* against ``jax.vjp`` of the reference at x64 on float32 inputs (its
  scan's carry is float32: float64 inputs do not trace): the reference
  computes in float32, the plain backward here in float64 on the same
  values, so each gradient is held in relative L2 norm to ``VJP_REL`` (the
  reference's float32 roundings: at most 5.5e-6 measured), da_log, a
  cancellation of row and column sums over every step, to ``VJP_REL_DA``
  (at most 6.5e-5 measured);
* against autograd of `ssd_chunk_ref` / `ssd_final_state` at float64:
  ``1e-10`` in relative L2 (the same function in float64, sums in another
  order);
* ``gradcheck`` at float64 with its defaults;
* `SSD_BWD_TOL`, per gradient in relative L2 norm, for the emulation on
  bf16 x, b, c and dy against the plain backward in float64 on the same
  values; on the card `chip_smoke.py` holds the kernel to the same
  numbers.  They were fixed from the emulation's distance before the
  kernel first ran: dx is returned in bf16 (1.7e-3 of rounding), ddt and
  da_log carry float32 cancellation (at most 1.1e-5 and 1.6e-4 on the model
  family up to mamba2-1.3b's layer), db and dc about 1.2e-6;
* one segment against several, float32 inputs: ``1e-5`` in relative L2
  (the decays' product and the hand-off's sums round otherwise);
* the walk's adjoint after each chunk against the plain backward's in
  float64 on the same bf16 values: ``1e-6`` in relative L2 (float32
  rounding over the walk: at most 7.8e-8 measured);
* one group of heads against several, float32 inputs: db and dc within
  ``1e-6`` in relative L2 (the groups' sums round otherwise: at most 1.5e-7
  measured), the other gradients equal.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.models import ssd as JSSD  # noqa: E402
from repro_torch.kernels.ssd_chunk import ops as pops  # noqa: E402
from repro_torch.kernels.ssd_chunk import ref as SR  # noqa: E402

NAMES = ("dx", "ddt", "da_log", "db", "dc")
SSD_BWD_TOL = {"dx": 4e-3, "ddt": 1e-4, "da_log": 1e-3, "db": 1e-5,
               "dc": 1e-5}
VJP_REL = 3e-5
VJP_REL_DA = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def inputs(seed, b, s, h, p, n, *, model_like=False):
    """(x, dt, a_log, b, c, dy, dstate) float64 numpy: the reference suite's
    family (``tests/test_kernels.py``: dt in [0.001, 0.1], A in [1, 8]) or
    the model's (``tests/test_torch_ssd.py::inputs``: dt = softplus(N(0,
    1)), a_log = log(linspace(1, 16))), and normal adjoints."""
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
    dy = rng.normal(0, 1, (b, s, h, p))
    ds = rng.normal(0, 1, (b, h, p, n))
    return x, dt, al, bm, cm, dy, ds


def rel(got, want):
    got, want = got.double(), want.double()
    norm = float(want.norm())
    diff = float((got - want).norm())
    return diff / norm if norm > 0 else diff


def shares(got, want, tol=SSD_BWD_TOL):
    """Each gradient's relative L2 distance over its tolerance (<= 1
    passes)."""
    return {k: rel(g, w) / tol[k] for k, g, w in zip(NAMES, got, want)}


def t64(args):
    return [torch.from_numpy(np.asarray(a, np.float64)) for a in args]


def bf16_case(args):
    """torch (x, dt, a_log, b, c, dy, dstate) with x, b, c and dy rounded
    to bf16, as the model trains, and the same values in float64."""
    low = [torch.from_numpy(np.asarray(a, np.float32)) for a in args]
    low = [t.to(torch.bfloat16) if i in (0, 3, 4, 5) else t
           for i, t in enumerate(low)]
    return low, [t.double() for t in low]


# ---------------------------------------------------------------------------
# the plain backward against the reference and autograd
# ---------------------------------------------------------------------------

VJP_CASES = [
    # tests/test_kernels.py::test_ssd_chunk_sweep's shapes
    (1, 128, 2, 32, 32, 64, False), (2, 256, 4, 64, 128, 128, False),
    (1, 64, 1, 16, 64, 32, False),
    # the model family, a ragged S, a single chunk, a chunk longer than S
    (2, 100, 3, 8, 16, 32, True), (2, 45, 3, 8, 16, 16, False),
    (2, 45, 3, 8, 16, 16, True), (1, 5, 2, 8, 16, 16, True),
    (2, 129, 2, 16, 16, 128, True)]


@pytest.mark.parametrize("b,s,h,p,n,chunk,model_like", VJP_CASES)
def test_plain_backward_equals_reference_vjp(b, s, h, p, n, chunk,
                                             model_like):
    """dx, ddt, da_log, db and dc of the plain backward (in float64 on the
    same float32 values) against ``jax.vjp`` of the reference's
    ``ssd_chunked`` and ``_final_state`` on float32 inputs, as its suite
    and its model call them, with a nonzero final-state adjoint."""
    args = [a.astype(np.float32) for a in inputs(
        s + 7 * chunk, b, s, h, p, n, model_like=model_like)]

    def f(x, dt, al, bm, cm):
        return (JSSD.ssd_chunked(x, dt, al, bm, cm, chunk=chunk),
                JSSD._final_state(x, dt, al, bm, cm, chunk=chunk))

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in args[:5]))
    want = vjp((jnp.asarray(args[5]), jnp.asarray(args[6])))
    got = SR.ssd_chunk_bwd_plain(*t64(args), chunk=chunk)
    assert all(g.dtype == torch.float64 for g in got)
    for name, g, w in zip(NAMES, got, want):
        w = torch.from_numpy(np.asarray(w, np.float64))
        assert g.shape == w.shape, name
        limit = VJP_REL_DA if name == "da_log" else VJP_REL
        assert rel(g, w) <= limit, (name, rel(g, w))


@pytest.mark.parametrize("s,chunk", [(1, 16), (5, 16), (16, 16), (45, 16),
                                     (100, 32), (129, 128)])
@pytest.mark.parametrize("model_like", [False, True])
@pytest.mark.parametrize("with_dstate", [False, True])
def test_plain_backward_equals_autograd(s, chunk, model_like, with_dstate):
    """The closed form against autograd of the plain forward, both outputs,
    at float64: one step, one chunk, whole chunks, ragged tails."""
    args = t64(inputs(3 * s + chunk, 2, s, 3, 8, 16, model_like=model_like))
    leaves = [a.clone().requires_grad_() for a in args[:5]]
    y = SR.ssd_chunk_ref(*leaves, chunk=chunk)
    state = SR.ssd_final_state(*leaves, chunk=chunk)
    loss = (y * args[5]).sum()
    if with_dstate:
        loss = loss + (state * args[6]).sum()
    want = torch.autograd.grad(loss, leaves)
    got = SR.ssd_chunk_bwd_plain(*args[:6], args[6] if with_dstate else None,
                                 chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert rel(g, w) <= 1e-10, (name, rel(g, w))


@pytest.mark.parametrize("s,chunk", [(21, 8), (6, 8)])
def test_cpu_op_gradcheck(s, chunk):
    """`ops.ssd_chunk` on the CPU is `SSDChunk`, whose backward is the
    plain one: ``gradcheck`` on x, dt, a_log, b and c through y and the
    final state, at float64."""
    x, dt, al, bm, cm, _, _ = inputs(s, 2, s, 2, 3, 4)
    dt = dt * 10
    args = tuple(torch.from_numpy(a).requires_grad_()
                 for a in (x, dt, al, bm, cm))
    y, state = pops.ssd_chunk(*args, chunk=chunk)
    assert type(y.grad_fn).__name__ == "SSDChunkBackward"
    assert y.dtype == state.dtype == torch.float64
    assert torch.autograd.gradcheck(
        lambda *a: pops.ssd_chunk(*a, chunk=chunk), args)


def test_cpu_op_gradients_are_the_plain_backward():
    """bf16 x, b and c as the model calls the op: its gradients are the
    plain backward's, in the inputs' dtypes; without grad it is the plain
    forward."""
    low, _ = bf16_case(inputs(2, 2, 40, 3, 8, 16, model_like=True))
    x, dt, al, bm, cm, dy, ds = low
    leaves = [t.clone().requires_grad_() for t in (x, dt, al, bm, cm)]
    y, state = pops.ssd_chunk(*leaves, chunk=16)
    torch.autograd.backward((y, state), (dy, ds))
    want = SR.ssd_chunk_bwd_plain(x, dt, al, bm, cm, dy, ds, chunk=16)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype == w.dtype
        assert torch.equal(leaf.grad, w)
    with torch.no_grad():
        y2, state2 = pops.ssd_chunk(*leaves, chunk=16)
    assert torch.equal(y2, y.detach()) and torch.equal(state2,
                                                       state.detach())


# ---------------------------------------------------------------------------
# the kernel's emulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [5, 45, 100])
@pytest.mark.parametrize("segments", [1, 2, 3, 9])
@pytest.mark.parametrize("model_like", [False, True])
@pytest.mark.parametrize("h,group", [(3, 8), (6, 4), (4, 3)])
def test_segmented_backward_within_tolerance(s, segments, model_like, h,
                                             group):
    """The kernels' decomposition on bf16 inputs at chunks of 16 (one chunk
    at S 5; three, the last ragged, at S 45; seven at S 100; more segments
    than chunks at 9) and groups of heads (one group of 3; 6 heads in
    groups of 4 and 4 heads in groups of 3, the last group ragged), against
    the plain backward in float64 on the same values, within
    `SSD_BWD_TOL`."""
    low, high = bf16_case(inputs(5 * s + segments + h, 2, s, h, 8, 16,
                                 model_like=model_like))
    got = SR.ssd_chunk_bwd_segmented(*low, chunk=16, segments=segments,
                                     group=group)
    want = SR.ssd_chunk_bwd_plain(*high, chunk=16)
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    share = shares(got, want)
    assert max(share.values()) <= 1, share


@pytest.mark.parametrize("model_like", [False, True])
def test_segmented_backward_at_the_kernel_chunk(model_like):
    """Chunks of 128 steps (the kernel's), P 24 and N 40 (multiples of 8
    that are not of 16), three chunks in two segments."""
    low, high = bf16_case(inputs(3, 2, 300, 2, 24, 40,
                                 model_like=model_like))
    got = SR.ssd_chunk_bwd_segmented(*low, segments=2)
    share = shares(got, SR.ssd_chunk_bwd_plain(*high))
    assert max(share.values()) <= 1, share


def test_reverse_hand_off_is_the_walk():
    """Any segment count gives one segment's gradients up to the float32
    rounding of the decays' product and of the hand-off's sums."""
    args = [torch.from_numpy(np.asarray(a, np.float32))
            for a in inputs(9, 1, 200, 2, 8, 16, model_like=True)]
    one = SR.ssd_chunk_bwd_segmented(*args, chunk=16, segments=1)
    for segments in (2, 5, 13, 40):
        got = SR.ssd_chunk_bwd_segmented(*args, chunk=16, segments=segments)
        for name, g, w in zip(NAMES, got, one):
            assert rel(g, w) <= 1e-5, (segments, name, rel(g, w))


@pytest.mark.parametrize("segments", [1, 2, 3, 9])
@pytest.mark.parametrize("model_like", [False, True])
def test_walk_adjoints_equal_plain(segments, model_like):
    """The walk's R after each chunk (what the kernel writes for the
    gradient launch) against the plain backward's adjoint in float64 on
    the same bf16 values, within 1e-6 in relative L2."""
    low, high = bf16_case(inputs(7 + segments, 2, 100, 3, 8, 16,
                                 model_like=model_like))
    got = SR.ssd_chunk_bwd_segmented(*low, chunk=16, segments=segments,
                                     return_adjoints=True)[-1]
    want = SR.ssd_chunk_bwd_plain(*high, chunk=16, return_adjoints=True)[-1]
    assert got.dtype == torch.float32 and got.shape == want.shape == (
        2, 3, 7, 8, 16)
    assert rel(got, want) <= 1e-6, rel(got, want)


@pytest.mark.parametrize("group", [1, 2, 3, 4, 5])
def test_head_groups_are_one_group(group):
    """Any group size gives one group's gradients: dx, ddt and da_log
    equal (no group touches them), db and dc within the float32 rounding of
    the groups' sums; 6 heads, so every size but 1, 2 and 3 leaves a
    ragged last group."""
    args = [torch.from_numpy(np.asarray(a, np.float32))
            for a in inputs(11, 2, 100, 6, 8, 16, model_like=True)]
    one = SR.ssd_chunk_bwd_segmented(*args, chunk=16, group=6)
    got = SR.ssd_chunk_bwd_segmented(*args, chunk=16, group=group)
    for name, g, w in zip(NAMES, got, one):
        if name in ("db", "dc"):
            assert rel(g, w) <= 1e-6, (name, rel(g, w))
        else:
            assert torch.equal(g, w), name


@pytest.mark.parametrize("bsz,s,h,want", [(1, 4096, 64, 8), (1, 16384, 64, 8),
                                          (1, 1024, 64, 2), (2, 64, 4, 1)])
def test_head_group_fills_the_card(bsz, s, h, want):
    """`kernel_bwd.head_group`: eight heads a block at mamba2-1.3b's layer
    (256 blocks at 4,096 tokens), fewer where the blocks would not fill the
    card's 132 SMs once."""
    from repro_torch.kernels.ssd_chunk import kernel_bwd

    assert kernel_bwd.head_group(bsz, h, s) == want


@pytest.mark.parametrize("bsz,s,h,want", [(1, 4096, 64, 1), (1, 4096, 8, 8),
                                          (2, 64, 4, 1), (1, 300, 16, 3)])
def test_walk_segments_fill_half_the_card(bsz, s, h, want):
    """`kernel_bwd.walk_segments`: as many segments a head as half a wave
    of walk blocks holds (66 on the card's 132 SMs), at most one a chunk."""
    from repro_torch.kernels.ssd_chunk import kernel_bwd

    assert kernel_bwd.walk_segments(bsz, h, s) == want


def test_planted_faults_are_refused(monkeypatch):
    """`SSD_BWD_TOL` refuses the emulation with the final state's adjoint
    dropped (no seed for the reverse walk) and with the u term dropped
    from d cs."""
    low, high = bf16_case(inputs(4, 2, 100, 3, 8, 16, model_like=True))
    want = SR.ssd_chunk_bwd_plain(*high, chunk=16)
    assert max(shares(SR.ssd_chunk_bwd_segmented(
        *low, chunk=16, segments=2), want).values()) <= 1
    no_seed = SR.ssd_chunk_bwd_segmented(*low[:6], None, chunk=16,
                                         segments=2)
    assert max(shares(no_seed, want).values()) > 1
    monkeypatch.setattr(SR, "_dcs", lambda row, col, u, v: (row - col) - v)
    no_u = SR.ssd_chunk_bwd_segmented(*low, chunk=16, segments=2)
    assert max(shares(no_u, want).values()) > 1


def test_backward_wrapper_refuses_cpu_tensors():
    """The backward kernel's wrapper takes CUDA tensors only (the CPU path
    is the op's plain backward)."""
    from repro_torch.kernels.ssd_chunk import kernel_bwd

    low, _ = bf16_case(inputs(0, 1, 8, 2, 8, 16))
    states = torch.zeros(1, 2, 1, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kernel_bwd.ssd_chunk_bwd_kernel(*low, states)


def test_chip_smoke_holds_the_kernel_to_the_same_tolerance():
    """`chip_smoke.py` states `SSD_BWD_TOL` itself (it imports nothing of
    the tests); the two must agree."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_tol", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.SSD_BWD_TOL == SSD_BWD_TOL


def model_size_rehearsal() -> bool:
    """`ssd_chunk_bwd_segmented` at the kernels' walk segments and group
    size against the
    plain backward in float64 at mamba2-1.3b's SSD shape (B 1, S 4,096, H
    64, P 64, N 128; bf16 x, b, c and dy), on both input families: the
    check to run before a card run of a change to the backward kernel's
    roundings.  Kept out of the suite for its size (about 4 GB and 10 s a
    family on four threads): ``PYTHONPATH=src python
    tests/test_torch_ssd_bwd.py`` prints each gradient's share of
    `SSD_BWD_TOL`."""
    from repro_torch.kernels.ssd_chunk.kernel_bwd import (head_group,
                                                          walk_segments)

    ok = True
    for model_like in (False, True):
        low, high = bf16_case(inputs(0, 1, 4096, 64, 64, 128,
                                     model_like=model_like))
        got = SR.ssd_chunk_bwd_segmented(
            *low, segments=walk_segments(1, 64, 4096),
            group=head_group(1, 64, 4096))
        share = shares(got, SR.ssd_chunk_bwd_plain(*high))
        print(f"{'model' if model_like else 'reference'} family: "
              + ", ".join(f"{k} {v:.3f}" for k, v in share.items()))
        ok &= max(share.values()) <= 1
    return ok


def reduced_depth_training(lr: float, layers: int = 2, tokens: int = 256):
    """mamba2-1.3b at full width cut to ``layers`` layers, `Trainer.fit` on
    the CPU (the plain forward and backward) for chip_smoke.py's 10 steps
    of one row at peak lr ``lr``, warmup 2: the losses, to read beside the
    card's full-width run (which does not meet recurrentgemma's loss rule).
    ``PYTHONPATH=src python tests/test_torch_ssd_bwd.py train 1e-3`` prints
    them (about a minute on four threads)."""
    import contextlib
    import dataclasses
    import io

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=layers)
    trainer = Trainer(cfg, TrainConfig(steps=10, peak_lr=lr, warmup_steps=2,
                                       log_every=10, async_ckpt=False),
                      device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        trainer.fit(SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=tokens,
                                           global_batch=1)))
    losses = [round(m["loss"], 3) for m in trainer.metrics_log]
    print(f"{layers} layers, {tokens} tokens, lr {lr}: losses {losses}")
    return losses


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["train"]:
        torch.set_num_threads(4)
        reduced_depth_training(float(sys.argv[2]))
        raise SystemExit(0)
    raise SystemExit(0 if model_size_rehearsal() else 1)
