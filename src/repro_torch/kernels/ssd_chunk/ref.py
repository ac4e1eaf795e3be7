"""Plain PyTorch version of the SSD chunk scan kernels, and CPU emulations
of the two kernels' algorithms.

`ssd_chunk_ref` is the counterpart of ``repro/models/ssd.py::ssd_chunked``
(the oracle ``repro/kernels/ssd_chunk/ref.py`` names for the Pallas kernel),
ported line for line: the sequence padded to whole chunks of ``q =
min(chunk, S)`` steps, ``logA = -exp(a_log) * dt``, the masked segment sums,
the intra-chunk term ``y_diag``, the chunk states, the sequential pass over
the chunks, then the inter-chunk term ``y_off``.  The chunk cumsum of
``logA`` is taken in order, one float32 add a step (`cumsum`), as the CUDA
kernels take it.  `ssd_final_state` ports ``_final_state``: the recurrent
state after the last step.  Shapes:

    x (B, S, H, P)   dt (B, S, H)   a_log (H,)   b, c (B, S, N)

x, b and c may be float32 or bf16, dt and a_log are float32; everything is
computed in float32, y comes back in x's dtype and the state in float32.
The CPU path and the tests use these; on the card they are the yardstick
the kernel is held against.

`ssd_chunk_blocked` runs the CUDA-core kernel's decomposition
(``csrc/ssd_chunk.cu``) with whole-tensor PyTorch: chunks of ``chunk`` steps (the tail chunk zero-padded, as the
kernel masks it), each chunk's state contribution and decay (phase 1), a
walk over the chunks giving each its incoming state and the final state
(phase 2), and each chunk's output, ``y_off`` from the incoming state plus
``y_diag`` over query-row tiles of ``rows`` (phase 3).  With one chunk,
phases 1 and 3 are one pass and phase 2 is skipped.

`ssd_chunk_segmented` runs the tensor-core kernel's decomposition and
arithmetic (``csrc/ssd_chunk_tc.cu``): each head's chunks cut into ``segments`` segments of consecutive
chunks; pass 1, each segment but the last from a zero state (its aggregate
and the product of its chunk decays); the chained hand-off ``inclusive_k =
inclusive_{k-1} D_k + aggregate_k``; pass 2, each segment's chunks in order
from its incoming state: ``y = exp(cs_i) (C state^T) + M x`` with ``dt``
folded into ``M_ij = G_ij exp(cs_i - cs_j) dt_j`` (``G = C B^T``), then
``state = state exp(cs_last) + (x w)^T B`` with ``w_j = dt_j exp(cs_last -
cs_j)``.  Every float32 operand of a product that meets an exact bf16 one
(``M``, ``x w``, the state) is split into three bf16 parts (hi, mid, lo;
`kernels._split.split_bf16`), each part multiplied in float32; each product
is made from zero and added to the other term after it, as the kernel adds
its accumulators on the CUDA cores.
"""

from __future__ import annotations

import torch

from .._split import split_bf16


def _check(x, dt, a_log, b, c):
    if x.dim() != 4 or dt.shape != x.shape[:3] or a_log.shape != x.shape[2:3] \
            or b.dim() != 3 or b.shape[:2] != x.shape[:2] \
            or c.shape != b.shape:
        raise ValueError(
            f"ssd_chunk takes x (B, S, H, P), dt (B, S, H), a_log (H,), b and "
            f"c (B, S, N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{tuple(a_log.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")


def _pad_seq(t, pad):
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


def cumsum(x):
    """Inclusive cumsum over the last axis, one float32 add a step in order:
    the definition itself, and the order the CUDA kernel takes.  The chunk
    cumsums reach -10^3 on the model's inputs, where another order (torch's
    parallel scan on the card, a float64 accumulator on the CPU) moves
    ``exp(cs_i - cs_j)`` by about 1e-4; with one order on both sides the
    kernel and this version agree to the order of their dot products."""
    out = torch.empty_like(x)
    run = x[..., 0]
    out[..., 0] = run
    for k in range(1, x.shape[-1]):
        run = run + x[..., k]
        out[..., k] = run
    return out


def _segsum(cs):
    """(..., Q) cumsums of the log decays -> (..., Q, Q) lower-triangular
    segment sums, -inf above the diagonal (the reference's ``_segsum``,
    given the cumsum it takes first)."""
    q = cs.shape[-1]
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=cs.device))
    return torch.where(mask, seg, torch.tensor(float("-inf"),
                                               device=cs.device))


def _chunked(x, dt, a_log, b, chunk):
    """The chunked operands shared by the output and the final state:
    (xdt (b,c,q,h,p), B (b,c,q,n), cs (b,c,h,q), pad)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    nc = (s + q - 1) // q
    pad = nc * q - s
    x, dt, b = (_pad_seq(t, pad) for t in (x, dt, b))
    dt_c = dt.reshape(bsz, nc, q, h).float()
    b_c = b.reshape(bsz, nc, q, n).float()
    xdt = x.reshape(bsz, nc, q, h, p).float() * dt_c[..., None]
    loga = -torch.exp(a_log.float())[None, None, None, :] * dt_c
    return xdt, b_c, loga.permute(0, 1, 3, 2), pad


def _chunk_states(xdt, b_c, cs):
    """Each chunk's state contribution (b,c,h,p,n) and decay (b,c,h)."""
    decay_rest = torch.exp(cs[..., -1:] - cs)                 # (b,c,h,q)
    xw = xdt * decay_rest.permute(0, 1, 3, 2)[..., None]      # (b,c,q,h,p)
    states = torch.einsum("bcjn,bcjhp->bchpn", b_c, xw)
    return states, torch.exp(cs[..., -1])


def ssd_chunk_ref(x, dt, a_log, b, c, *, chunk: int = 128):
    """Minimal SSD over chunks: y (B, S, H, P) in x's dtype."""
    _check(x, dt, a_log, b, c)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    xdt, b_c, loga_h, pad = _chunked(x, dt, a_log, b, chunk)
    nc, q = xdt.shape[1], xdt.shape[2]
    c_c = _pad_seq(c, pad).reshape(bsz, nc, q, n).float()

    # intra-chunk (diagonal) term
    cs = cumsum(loga_h)                                       # (b,c,h,q)
    big_l = torch.exp(_segsum(cs))                            # (b,c,h,q,q)
    scores = torch.einsum("bcin,bcjn->bcij", c_c, b_c)[:, :, None] * big_l
    y_diag = torch.einsum("bchij,bcjhp->bcihp", scores, xdt)

    # chunk states and the inter-chunk pass
    states, chunk_decay = _chunk_states(xdt, b_c, cs)
    prev = torch.empty_like(states)
    carry = states.new_zeros((bsz, h, p, n))
    for ci in range(nc):
        prev[:, ci] = carry                                   # state before
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]

    # inter-chunk (off-diagonal) term
    decay_in = torch.exp(cs)                                  # (b,c,h,q)
    y_off = torch.einsum("bcin,bchpn->bcihp", c_c, prev) \
        * decay_in.permute(0, 1, 3, 2)[..., None]
    y = (y_diag + y_off).reshape(bsz, nc * q, h, p)[:, :s]
    return y.to(x.dtype)


def ssd_final_state(x, dt, a_log, b, c=None, *, chunk: int = 128):
    """The exact recurrent state after the last step, (B, H, P, N) float32,
    by the same chunk scan (``c`` is not read: the reference's
    ``_final_state`` takes it too)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    xdt, b_c, loga_h, _ = _chunked(x, dt, a_log, b, chunk)
    states, chunk_decay = _chunk_states(xdt, b_c, cumsum(loga_h))
    carry = states.new_zeros((bsz, h, p, n))
    for ci in range(xdt.shape[1]):
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    return carry


def _walk(states, chunk_decay):
    """Phase 2: (each chunk's incoming state, or None for one chunk; the
    final state), from the chunk states (b,c,h,p,n) and decays (b,c,h).
    The CUDA-core kernel overwrites each chunk's contribution with its
    incoming state, in place."""
    if states.shape[1] == 1:
        return None, states[:, 0]
    incoming = torch.empty_like(states)
    carry = torch.zeros_like(states[:, 0])
    for ci in range(states.shape[1]):
        incoming[:, ci] = carry
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    return incoming, carry


def _chunks(x, dt, a_log, b, c, chunk):
    """The inputs in chunks of ``chunk`` steps, the tail chunk's missing
    steps zero (dt = 0: no decay; x = b = c = 0: no contribution): x
    (b,c,q,h,p), dt (b,c,h,q), b and c (b,c,q,n) float32, and the in-order
    chunk cumsums of logA (b,c,h,q)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = (s + chunk - 1) // chunk
    x, dt, b, c = (_pad_seq(t, nc * chunk - s) for t in (x, dt, b, c))
    dt_c = dt.reshape(bsz, nc, chunk, h).float().permute(0, 1, 3, 2)
    cs = cumsum(-torch.exp(a_log.float())[:, None] * dt_c)
    return (x.reshape(bsz, nc, chunk, h, p).float(), dt_c,
            b.reshape(bsz, nc, chunk, n).float(),
            c.reshape(bsz, nc, chunk, n).float(), cs)


def ssd_chunk_segmented(x, dt, a_log, b, c, *, chunk: int = 128,
                        segments: int = 1):
    """The tensor-core kernel's segments, passes and roundings over chunks
    of ``chunk`` steps, at most one segment a chunk: (y in x's dtype, final
    state float32)."""
    _check(x, dt, a_log, b, c)
    bsz, s, h, p = x.shape
    x_c, dt_c, b_c, c_c, cs = _chunks(x, dt, a_log, b, c, chunk)
    nc = x_c.shape[1]
    n_seg = max(1, min(int(segments), nc))
    bounds = [k * nc // n_seg for k in range(n_seg + 1)]
    decay = torch.exp(cs[..., -1])                            # (b,c,h)
    w = dt_c * torch.exp(cs[..., -1:] - cs)                   # (b,c,h,q)
    ecs = torch.exp(cs).permute(0, 1, 3, 2)[..., None]        # (b,c,q,h,1)
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=x.device))
    zero = torch.zeros((), device=x.device)

    def parts(eq, weights, other):
        return sum(torch.einsum(eq, part, other)
                   for part in split_bf16(weights, 3))

    def step(state, ci):
        """The state after chunk ci: state exp(cs_last) + (x w)^T B."""
        xw = x_c[:, ci] * w[:, ci].permute(0, 2, 1)[..., None]  # (b,q,h,p)
        return state * decay[:, ci, :, None, None] + parts(
            "bjhp,bjn->bhpn", xw, b_c[:, ci])

    # pass 1 (each segment but the last, from a zero state) and the chained
    # hand-off: inclusive_k = inclusive_{k-1} D_k + aggregate_k
    start = b_c.new_zeros((bsz, h, p, b_c.shape[-1]))
    incoming = [start]
    for k in range(n_seg - 1):
        agg, prod = start, torch.ones_like(decay[:, 0])
        for ci in range(bounds[k], bounds[k + 1]):
            agg = step(agg, ci)
            prod = prod * decay[:, ci]
        incoming.append(agg if k == 0 else
                        incoming[-1] * prod[..., None, None] + agg)

    # pass 2: y = exp(cs_i) (C state^T) + M x, chunk by chunk from each
    # segment's incoming state
    y = x_c.new_zeros(x_c.shape)
    for k in range(n_seg):
        state = incoming[k]
        for ci in range(bounds[k], bounds[k + 1]):
            g = torch.einsum("bin,bjn->bij", c_c[:, ci], b_c[:, ci])
            seg = cs[:, ci, :, :, None] - cs[:, ci, :, None, :]  # (b,h,i,j)
            m = torch.where(causal, g[:, None] * torch.exp(seg)
                            * dt_c[:, ci, :, None, :], zero)
            y_off = parts("bhpn,bin->bihp", state, c_c[:, ci])
            y[:, ci] = y_off * ecs[:, ci] + parts("bhij,bjhp->bihp", m,
                                                  x_c[:, ci])
            state = step(state, ci)
    y = y.reshape(bsz, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), state


def ssd_chunk_blocked(x, dt, a_log, b, c, *, chunk: int = 128,
                      rows: int = 32):
    """The kernel's three-phase algorithm over chunks of ``chunk`` steps and
    query-row tiles of ``rows``: (y in x's dtype, final state float32)."""
    _check(x, dt, a_log, b, c)
    bsz, s, h, p = x.shape
    x_c, dt_c, b_c, c_c, cs = _chunks(x, dt, a_log, b, c, chunk)
    nc = x_c.shape[1]
    xdt = x_c * dt_c.permute(0, 1, 3, 2)[..., None]           # (b,c,q,h,p)

    # phases 1 and 2: each chunk's state contribution and decay, the walk
    incoming, final = _walk(*_chunk_states(xdt, b_c, cs))

    # phase 3: y_off from the incoming state, then y_diag by row tiles
    ecs = torch.exp(cs).permute(0, 1, 3, 2)                   # (b,c,q,h)
    y = xdt.new_zeros((bsz, nc, chunk, h, p))
    if incoming is not None:
        y[:, 1:] = torch.einsum("bcin,bchpn->bcihp", c_c[:, 1:],
                                incoming[:, 1:]) * ecs[:, 1:, ..., None]
    col = torch.arange(chunk, device=x.device)
    for i0 in range(0, chunk, rows):
        jmax = min(i0 + rows, chunk)
        i1 = jmax
        seg = cs[..., i0:i1, None] - cs[..., None, :jmax]     # (b,c,h,r,j)
        causal = col[None, :jmax] <= col[i0:i1, None]
        g = torch.einsum("bcin,bcjn->bcij", c_c[:, :, i0:i1],
                         b_c[:, :, :jmax])[:, :, None]
        scores = torch.where(causal, torch.exp(seg) * g,
                             torch.zeros((), device=x.device))
        y[:, :, i0:i1] += torch.einsum("bchij,bcjhp->bcihp", scores,
                                       xdt[:, :, :jmax])
    y = y.reshape(bsz, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), final
