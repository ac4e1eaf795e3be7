"""Plain PyTorch version of the SSD chunk scan kernels and of their
gradient, and CPU emulations of the kernels' algorithms.

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
computed in float32 (in float64 for float64 x, so that ``gradcheck``
applies), y comes back in x's dtype and the state in float32.
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

The gradient: `ssd_chunk_bwd_plain` is the closed-form backward of
(`ssd_chunk_ref`, `ssd_final_state`) in whole-tensor PyTorch, the CPU
path's backward and the card's yardstick; `ssd_chunk_bwd_segmented` runs
the backward kernels' decomposition (``csrc/ssd_chunk_bwd.cu``: the adjoint
walk over segments from the last chunk with a reverse hand-off, the
chunk-parallel gradients with dG, dB and dC summed over groups of heads,
the ordered sums; three-part splits, fixed sum orders).
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


def _ct(x):
    """The dtype the plain versions compute in: float64 for float64 ``x``,
    else float32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


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
    ct = _ct(x)
    x, dt, b = (_pad_seq(t, pad) for t in (x, dt, b))
    dt_c = dt.reshape(bsz, nc, q, h).to(ct)
    b_c = b.reshape(bsz, nc, q, n).to(ct)
    xdt = x.reshape(bsz, nc, q, h, p).to(ct) * dt_c[..., None]
    loga = -torch.exp(a_log.to(ct))[None, None, None, :] * dt_c
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
    c_c = _pad_seq(c, pad).reshape(bsz, nc, q, n).to(xdt.dtype)

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
                        segments: int = 1, return_states: bool = False):
    """The tensor-core kernel's segments, passes and roundings over chunks
    of ``chunk`` steps, at most one segment a chunk: (y in x's dtype, final
    state float32), and with ``return_states`` each chunk's incoming state
    (B, H, chunks, P, N) float32 as the kernel writes it for the backward."""
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
    chunk_in = x_c.new_empty((bsz, h, nc, p, b_c.shape[-1]))
    for k in range(n_seg):
        state = incoming[k]
        for ci in range(bounds[k], bounds[k + 1]):
            chunk_in[:, :, ci] = state
            g = torch.einsum("bin,bjn->bij", c_c[:, ci], b_c[:, ci])
            seg = cs[:, ci, :, :, None] - cs[:, ci, :, None, :]  # (b,h,i,j)
            m = torch.where(causal, g[:, None] * torch.exp(seg)
                            * dt_c[:, ci, :, None, :], zero)
            y_off = parts("bhpn,bin->bihp", state, c_c[:, ci])
            y[:, ci] = y_off * ecs[:, ci] + parts("bhij,bjhp->bihp", m,
                                                  x_c[:, ci])
            state = step(state, ci)
    y = y.reshape(bsz, nc * chunk, h, p)[:, :s]
    if return_states:
        return y.to(x.dtype), state, chunk_in
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


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------

def _states_walk(contrib, decay, seed, reverse=False):
    """(b,c,h,p,n) per-chunk terms and (b,c,h) decays -> the carry entering
    each chunk of a walk from ``seed``: ``carry = carry * decay + term``,
    chunk by chunk in order (the forward's states) or from the last chunk
    (``reverse``: the adjoints after each chunk)."""
    out = torch.empty_like(contrib)
    carry = seed
    order = range(contrib.shape[1])
    for ci in (reversed(order) if reverse else order):
        out[:, ci] = carry
        carry = carry * decay[:, ci, :, None, None] + contrib[:, ci]
    return out


def ssd_chunk_bwd_plain(x, dt, a_log, b, c, dy, dstate=None, *,
                        chunk: int = 128, return_adjoints: bool = False):
    """The gradient of (`ssd_chunk_ref`, `ssd_final_state`) by its closed
    form, in whole-tensor PyTorch (float64 for float64 x, else float32): dy
    (B, S, H, P) the output's adjoint, ``dstate`` (B, H, P, N) the final
    state's (None: zero) -> (dx, ddt, da_log, db, dc) in the inputs' dtypes.

    Per batch row, head and chunk of ``q = min(chunk, S)`` steps, with ``a =
    exp(a_log)``, ``l_j = -a dt_j``, ``cs`` the in-order cumsum of ``l``,
    ``G_ij = C_i . B_j``, ``L_ij = exp(cs_i - cs_j)`` for ``i >= j`` (else
    0), ``M_ij = G_ij L_ij dt_j``, ``w_j = dt_j exp(cs_Q - cs_j)``, ``S`` the
    chunk's incoming state and ``R`` the adjoint of the state after it
    (walked from the last chunk, seeded with ``dstate``: ``R_before =
    exp(cs_Q) R + sum_i exp(cs_i) dY_i C_i^T``):

        dx_j  = sum_i M_ij dY_i + w_j (R B_j)
        dM_ij = dY_i . x_j,  dG_ij = dM_ij L_ij dt_j          (i >= j)
        dB_j  = sum_h [sum_i dG_ij C_i + w_j R^T x_j]
        dC_i  = sum_h [sum_j dG_ij B_j + exp(cs_i) S^T dY_i]
        ddt_j = sum_i dM_ij G_ij L_ij + exp(cs_Q - cs_j) (x_j . R B_j)
                - a dl_j
        dcs   = rowsum(T) - colsum(T) + u - v,  T = dM M,
                u_i = exp(cs_i) (dY_i . S C_i),  v_j = w_j (x_j . R B_j),
                dcs_Q += sum_j v_j + exp(cs_Q) <R, S>
        dl    = the reverse cumsum of dcs in the chunk (`cumsum` of the
                flipped steps)
        da_log = sum over rows, chunks and steps of dl l.

    With ``return_adjoints`` it also returns R after each chunk, (B, H,
    chunks, P, N) in the compute dtype."""
    _check(x, dt, a_log, b, c)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} is not x's {tuple(x.shape)}")
    ct = _ct(x)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    nc = (s + q - 1) // q
    pad = nc * q - s
    xc, dyc = (_pad_seq(t, pad).reshape(bsz, nc, q, h, p).to(ct)
               for t in (x, dy))
    bc, cc = (_pad_seq(t, pad).reshape(bsz, nc, q, n).to(ct) for t in (b, c))
    dtc = _pad_seq(dt, pad).reshape(bsz, nc, q, h).to(ct).permute(0, 1, 3, 2)
    a = torch.exp(a_log.to(ct))
    l = -a[:, None] * dtc                                      # (b,c,h,q)
    cs = cumsum(l)
    ecs = torch.exp(cs)
    e = torch.exp(cs[..., -1:] - cs)
    w = dtc * e
    decay = torch.exp(cs[..., -1])                             # (b,c,h)
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    seg = torch.where(causal, cs[..., :, None] - cs[..., None, :], 0.0)
    big_l = torch.where(causal, torch.exp(seg), 0.0)           # (b,c,h,i,j)
    gl = torch.einsum("bcin,bcjn->bcij", cc, bc)[:, :, None] * big_l
    m = gl * dtc[..., None, :]

    zero = xc.new_zeros((bsz, h, p, n))
    big_s = _states_walk(torch.einsum("bchj,bcjhp,bcjn->bchpn", w, xc, bc),
                         decay, zero)
    seed = zero if dstate is None else dstate.to(ct)
    big_r = _states_walk(torch.einsum("bchi,bcihp,bcin->bchpn", ecs, dyc, cc),
                         decay, seed, reverse=True)

    dm = torch.einsum("bcihp,bcjhp->bchij", dyc, xc) * causal
    dg = dm * big_l * dtc[..., None, :]
    rb = torch.einsum("bcjn,bchpn->bcjhp", bc, big_r)          # R B_j
    qv = (xc * rb).sum(-1).permute(0, 1, 3, 2)                 # (b,c,h,j)
    dx = torch.einsum("bchij,bcihp->bcjhp", m, dyc) \
        + w.permute(0, 1, 3, 2)[..., None] * rb
    xr = torch.einsum("bcjhp,bchpn->bchjn", xc, big_r)         # R^T x_j
    db = torch.einsum("bchij,bcin->bcjn", dg, cc) \
        + (w[..., None] * xr).sum(2)
    ys = torch.einsum("bcin,bchpn->bcihp", cc, big_s)          # S C_i
    u = ecs * (dyc * ys).sum(-1).permute(0, 1, 3, 2)
    ds = torch.einsum("bcihp,bchpn->bchin", dyc, big_s)        # S^T dY_i
    dc = torch.einsum("bchij,bcjn->bcin", dg, bc) \
        + (ecs[..., None] * ds).sum(2)

    t = dm * m
    v = w * qv
    dcs = t.sum(-1) - t.sum(-2) + u - v
    dcs[..., -1] += v.sum(-1) + decay * (big_r * big_s).sum((-1, -2))
    dl = cumsum(dcs.flip(-1)).flip(-1)
    ddt = (dm * gl).sum(-2) + e * qv - a[:, None] * dl
    da_log = (dl * l).sum((0, 1, 3))

    dx = dx.reshape(bsz, nc * q, h, p)[:, :s]
    ddt = ddt.permute(0, 1, 3, 2).reshape(bsz, nc * q, h)[:, :s]
    db, dc = (g.reshape(bsz, nc * q, n)[:, :s] for g in (db, dc))
    out = (dx.to(x.dtype), ddt.to(dt.dtype), da_log.to(a_log.dtype),
           db.to(b.dtype), dc.to(c.dtype))
    return out + (big_r.transpose(1, 2),) if return_adjoints else out


def _dcs(row_t, col_t, u, v):
    """d cs of a chunk from its row and column sums of dM M and its u and v
    terms, as the backward kernel adds them."""
    return ((row_t - col_t) + u) - v


def ssd_chunk_bwd_segmented(x, dt, a_log, b, c, dy, dstate=None, *,
                            chunk: int = 128, segments: int = 1,
                            group: int = 8, return_adjoints: bool = False):
    """The backward kernels' decomposition, roundings and sum orders
    (``csrc/ssd_chunk_bwd.cu``) over chunks of ``chunk`` steps,
    ``segments`` segments a head for the walk and ``group`` heads a block
    of the gradients, on bf16 (or float32) x, b, c and dy: (dx in x's dtype,
    ddt, da_log, db and dc float32), and with ``return_adjoints`` the walk's
    R after each chunk, (B, H, chunks, P, N) float32.

    The chunks' incoming states S come from `ssd_chunk_segmented` (the
    forward kernel writes them on request).  1, the walk: each segment but
    the first walks its chunks from the last, from a zero adjoint (pass 1:
    its aggregate and the product of its chunk decays); the hand-off runs
    in reverse, the last segment seeded with ``dstate``: ``inclusive_k =
    inclusive_{k+1} D_k + aggregate_k``; pass 2 gives each chunk's R (the
    adjoint after it, which the kernel writes in float32) and ``<R,
    S>``.  2, the gradients, chunk by chunk and group by group of
    heads (the last group ragged): per head the plain backward's products,
    each float32 operand against an exact bf16 one (R, S, M, dG) split into
    three bf16 parts, w_j and exp(cs_i) applied to their products before
    the rest is added; dG summed over the group's heads in head order,
    then dB = dG_grp^T C + w . (x R) and dC = dG_grp B + exp(cs) . (dY S),
    each head's term added in head order; q_j = B_j . (x R)_j.  A 256-step
    chunk's gradients go by its tiles of 128 rows: the pairs (rows j, keys
    i) = (0, 0), (0, 1) and (1, 1), each as a chunk of 128 with the causal
    mask taken over the chunk and the R and S terms on the diagonal pairs
    only; the pair off the diagonal's dx, dB, ddt's partial and column sums
    (rows of the first tile) and dC and row sums (rows of the second) go in
    a second slot, added after the first.  3, the sums: dB and dC over
    the groups in order; d cs by `_dcs`, its reverse cumsum one add a step
    from the chunk's last step, begun from ``sum v +
    exp(cs_Q) <R, S>``; ddt; da_log's share a (batch row, chunk, head),
    summed over batch rows, then chunks, in order."""
    _check(x, dt, a_log, b, c)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    _, _, states = ssd_chunk_segmented(x, dt, a_log, b, c, chunk=chunk,
                                       segments=segments, return_states=True)
    x_c, dt_c, b_c, c_c, cs = _chunks(x, dt, a_log, b, c, chunk)
    nc = x_c.shape[1]
    dy_c = _pad_seq(dy, nc * chunk - s).reshape(bsz, nc, chunk, h, p).float()
    al = -torch.exp(a_log.float())                             # (h,)
    l = al[:, None] * dt_c                                     # (b,c,h,q)
    ecs = torch.exp(cs)
    e = torch.exp(cs[..., -1:] - cs)
    w = dt_c * e
    decay = torch.exp(cs[..., -1])
    n_seg = max(1, min(int(segments), nc))
    bounds = [k * nc // n_seg for k in range(n_seg + 1)]
    group = max(1, int(group))

    def parts(eq, weights, other):
        return sum(torch.einsum(eq, part, other)
                   for part in split_bf16(weights, 3))

    def r_step(r, ci):
        """The adjoint before chunk ci from the one after it."""
        a_ = dy_c[:, ci] * ecs[:, ci].permute(0, 2, 1)[..., None]
        return r * decay[:, ci, :, None, None] + parts(
            "bihp,bin->bhpn", a_, c_c[:, ci])

    # 1. the walk: pass 1, the reverse hand-off, pass 2
    zero = x_c.new_zeros((bsz, h, p, n))
    incoming = [None] * n_seg
    incoming[-1] = zero if dstate is None else dstate.float()
    for k in range(n_seg - 1, 0, -1):
        agg, prod = zero, torch.ones_like(decay[:, 0])
        for ci in range(bounds[k + 1] - 1, bounds[k] - 1, -1):
            agg = r_step(agg, ci)
            prod = prod * decay[:, ci]
        incoming[k - 1] = incoming[k] * prod[..., None, None] + agg
    adj = x_c.new_empty((bsz, h, nc, p, n))
    for k in range(n_seg):
        r = incoming[k]
        for ci in range(bounds[k + 1] - 1, bounds[k] - 1, -1):
            adj[:, :, ci] = r
            r = r_step(r, ci)
    rs = (adj * states).sum((-1, -2)).permute(0, 2, 1)         # (b,c,h)

    # 2. the gradients, a chunk, tile pair and group of heads at a time: a
    # chunk up to 128 steps is one tile; a 256-step chunk two tiles of 128
    # rows, whose pairs (rows j, keys i) = (0, 0), (0, 1), (1, 1) put their
    # partials in slot ti - tj, the R and S terms on the diagonal only
    groups = [range(g0, min(h, g0 + group)) for g0 in range(0, h, group)]
    tile = min(chunk, 128)
    n_t = chunk // tile
    tile_pairs = [(tj, ti) for tj in range(n_t) for ti in range(tj, n_t)]
    slots = 2 if n_t > 1 else 1
    pos = torch.arange(chunk, device=x.device)
    dxp = x_c.new_zeros((slots,) + x_c.shape)
    rsum, csum, ddtp = (dt_c.new_zeros((slots,) + dt_c.shape)
                        for _ in range(3))
    u, v = (dt_c.new_zeros(dt_c.shape) for _ in range(2))
    dbp = b_c.new_zeros((bsz, len(groups), slots, nc, chunk, n))
    dcp = b_c.new_zeros((bsz, len(groups), slots, nc, chunk, n))
    for ci in range(nc):
        big_r, big_s = adj[:, :, ci], states[:, :, ci]         # (b,h,p,n)
        for tj, ti in tile_pairs:
            jr = slice(tj * tile, (tj + 1) * tile)
            ir = slice(ti * tile, (ti + 1) * tile)
            slot, diag = ti - tj, ti == tj
            xq, bq = x_c[:, ci, jr], b_c[:, ci, jr]            # rows j
            dyq, cq = dy_c[:, ci, ir], c_c[:, ci, ir]          # keys i
            cs_j, cs_i = cs[:, ci, :, jr], cs[:, ci, :, ir]    # (b,h,q)
            dtq, wq, eq = dt_c[:, ci, :, jr], w[:, ci, :, jr], e[:, ci, :, jr]
            ecs_i = ecs[:, ci, :, ir]
            causal = pos[jr][None, :] <= pos[ir][:, None]
            g = torch.einsum("bin,bjn->bij", cq, bq)
            seg = torch.where(causal, cs_i[..., :, None] - cs_j[..., None, :],
                              0.0)
            big_l = torch.where(causal, torch.exp(seg), 0.0)
            gl = g[:, None] * big_l
            m = gl * dtq[..., None, :]
            dm = torch.einsum("bihp,bjhp->bhij", dyq, xq) * causal
            dg = dm * big_l * dtq[..., None, :]
            t = dm * m
            rsum[slot, :, ci, :, ir] = t.sum(-1)
            csum[slot, :, ci, :, jr] = t.sum(-2)
            dd = (dm * gl).sum(-2)
            # J: rows j
            dxs = parts("bhij,bihp->bjhp", m, dyq)
            if diag:
                br = parts("bhpn,bjn->bjhp", big_r, bq)
                dxs = dxs + br * wq.permute(0, 2, 1)[..., None]
                # K: rows j; q_j = B_j . (x R)_j
                xr = parts("bhpn,bjhp->bhjn", big_r, xq)
                qv = (bq[:, None] * xr).sum(-1)                # (b,h,j)
                v[:, ci, :, jr] = wq * qv
                dd = dd + eq * qv
                # I: rows i
                ys = parts("bhpn,bin->bihp", big_s, cq)
                u[:, ci, :, ir] = ecs_i * (dyq * ys).sum(-1).permute(0, 2, 1)
                ds = parts("bhpn,bihp->bhin", big_s, dyq)
            dxp[slot, :, ci, jr] = dxs
            ddtp[slot, :, ci, :, jr] = dd
            for gi, heads in enumerate(groups):
                dg_grp = torch.zeros_like(g)
                for hh in heads:
                    dg_grp = dg_grp + dg[:, hh]
                db_acc = parts("bij,bin->bjn", dg_grp, cq)
                dc_acc = parts("bij,bjn->bin", dg_grp, bq)
                if diag:
                    for hh in heads:
                        db_acc = db_acc + wq[:, hh, :, None] * xr[:, hh]
                        dc_acc = dc_acc + ecs_i[:, hh, :, None] * ds[:, hh]
                dbp[:, gi, slot, ci, jr], dcp[:, gi, slot, ci, ir] = (db_acc,
                                                                      dc_acc)

    # 3. the ordered sums (a second slot adds where the pair off the
    # diagonal wrote, zeros elsewhere)
    db = torch.zeros_like(dbp[:, 0, 0])
    dc = torch.zeros_like(dcp[:, 0, 0])
    for gi in range(len(groups)):
        for sl in range(slots):
            db = db + dbp[:, gi, sl]
            dc = dc + dcp[:, gi, sl]
    row_t, col_t, ddt_part, dx = rsum[0], csum[0], ddtp[0], dxp[0]
    for sl in range(1, slots):
        row_t, col_t = row_t + rsum[sl], col_t + csum[sl]
        ddt_part, dx = ddt_part + ddtp[sl], dx + dxp[sl]
    dcs = _dcs(row_t, col_t, u, v)
    vsum = v[..., 0]
    for j in range(1, chunk):
        vsum = vsum + v[..., j]
    run = vsum + decay * rs
    dl = torch.empty_like(dcs)
    share = torch.zeros_like(run)                              # (b,c,h)
    for j in range(chunk - 1, -1, -1):
        run = run + dcs[..., j]
        dl[..., j] = run
        share = share + run * l[..., j]
    ddt = ddt_part + al[:, None] * dl
    da_log = torch.zeros_like(al)
    for bi in range(bsz):
        for ci in range(nc):
            da_log = da_log + share[bi, ci]
    dx = dx.reshape(bsz, nc * chunk, h, p)[:, :s]
    ddt = ddt.permute(0, 1, 3, 2).reshape(bsz, nc * chunk, h)[:, :s]
    db, dc = (t.reshape(bsz, nc * chunk, n)[:, :s] for t in (db, dc))
    out = (dx.to(x.dtype), ddt, da_log, db, dc)
    return out + (adj,) if return_adjoints else out
