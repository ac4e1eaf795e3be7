"""CPU emulation of the three-phase block scan of the port's CUDA scans.

The scans of `csrc/serve_round.cu` (the map scan, and the fused round's
"last present" lookups) share one structure, because CUDA blocks run in no
order and cannot hand a running state from one block to the next:

  (A) each block of ``threads * items`` items builds one aggregate map: each
      thread composes its ``items`` consecutive maps in order, then the
      block combines the thread aggregates in a pairwise tree (stride 1, 2,
      4, ...: the aggregate of thread ``t`` absorbs that of ``t + stride``;
      ``block_aggregate="tree"``) or takes the last of their inclusive
      Hillis–Steele scan (``"scan"``: the fused serve round, whose phase C
      keeps that scan's exclusive prefixes for its phase E);
  (B) one block turns the block aggregates into each block's incoming
      state.  ``carry="chunks"``: it walks them in chunks of ``threads``,
      an inclusive Hillis–Steele scan of each chunk, whose exclusive
      prefixes applied to the running state give each block its incoming
      state.  ``carry="runs"``: each thread composes a run of
      ``ceil(blocks / threads)`` consecutive aggregates in order, one
      Hillis–Steele scan over the runs, and each thread walks its run from
      its exclusive prefix applied to ``init``;
  (C) each block recomputes its thread aggregates, scans them (one
      Hillis–Steele scan, or warp by warp: `_block_scan`), applies thread
      ``t``'s exclusive prefix to the block's incoming state, and walks its
      own items from there.

`three_phase_scan` runs the same decomposition with whole-tensor PyTorch
operations, vectorised over blocks and threads, composing in the same
grouping and skipping the items past the end as the kernels do.  It needs
no card, so the tests hold the cross-block decomposition against each
kernel's plain version here, at a small block size; the compiled kernels
are held against the plain versions on the card.

A map is a tuple of equal-shape tensors; ``compose(m, p)`` is ``m`` applied
after ``p`` and ``apply(m, v)`` applies ``m`` to a state tuple ``v``, both
elementwise.  ``identity`` and ``init`` are tuples of Python scalars.
"""

from __future__ import annotations

import torch


def _full(like, vals):
    return tuple(torch.full(like.shape, v, dtype=d, device=like.device)
                 for v, d in vals)


def _where(mask, a, b):
    return tuple(torch.where(mask, x, y) for x, y in zip(a, b))


def _shift(x, v):
    """``x`` moved one slot right along the last axis, ``v`` in slot 0."""
    return torch.cat([torch.full(x.shape[:-1] + (1,), v, dtype=x.dtype,
                                 device=x.device), x[..., :-1]], dim=-1)


def _block_scan(agg, identity, compose, warp):
    """(inclusive, exclusive) scans along the last axis, as a block of the
    kernels scans its threads: one Hillis–Steele scan (``warp=None``), or,
    with ``warp`` lanes, Hillis–Steele inside each warp, Hillis–Steele over
    the warp totals, and each warp's exclusive total composed under its
    lanes.  Slot 0 of the exclusive scan holds the identity (never
    applied).  The look-back emulation of ``link_contention`` scans its
    tiles with it too."""
    t = agg[0].shape[-1]
    if warp is None or warp >= t:
        inc = _hillis_steele(agg, identity, compose)
        return inc, tuple(_shift(x, v) for x, v in zip(inc, identity))
    g = t // warp
    lead = agg[0].shape[:-1]
    inner = _hillis_steele(tuple(x.reshape(lead + (g, warp)) for x in agg),
                           identity, compose)
    tot = _hillis_steele(tuple(x[..., -1] for x in inner), identity, compose)
    wp = tuple(_shift(x, v)[..., None].expand(lead + (g, warp))
               for x, v in zip(tot, identity))
    lane0 = torch.arange(warp, device=agg[0].device) == 0
    first_warp = (torch.arange(g, device=agg[0].device) == 0)[:, None]
    before = tuple(_shift(x, v) for x, v in zip(inner, identity))
    inc = _where(first_warp, inner, compose(inner, wp))
    exc = _where(first_warp, before,
                 _where(lane0, wp, compose(before, wp)))
    return (tuple(x.reshape(lead + (t,)) for x in inc),
            tuple(x.reshape(lead + (t,)) for x in exc))


def _hillis_steele(agg, identity, compose):
    """Inclusive scan along the last axis, in the kernels' order: at each
    offset, slot ``t`` becomes ``agg[t] after agg[t - off]``."""
    t = agg[0].shape[-1]
    off = 1
    while off < t:
        prev = tuple(torch.cat([torch.full(x.shape[:-1] + (off,), v,
                                           dtype=x.dtype, device=x.device),
                                x[..., :-off]], dim=-1)
                     for x, v in zip(agg, identity))
        keep = torch.arange(t, device=agg[0].device) < off
        agg = _where(keep, agg, compose(agg, prev))
        off *= 2
    return agg


def _carry_chunks(block_agg, identity, compose, apply, init, threads,
                  dtypes):
    """Phase B by chunks: each block's incoming state, shape (blocks,)."""
    nb = block_agg[0].shape[0]
    dev = block_agg[0].device
    n_chunks = -(-nb // threads)
    cpad = n_chunks * threads - nb
    chunks = tuple(torch.cat([x, torch.full((cpad,), v, dtype=x.dtype,
                                            device=dev)]).view(n_chunks,
                                                               threads)
                   for x, v in zip(block_agg, identity))
    carry = tuple(torch.tensor(v, dtype=d, device=dev)
                  for v, d in zip(init, dtypes[:len(init)]))
    incoming = []
    for ci in range(n_chunks):
        sc, excl = _block_scan(tuple(x[ci] for x in chunks), identity,
                               compose, None)
        cv = tuple(c.expand(threads) for c in carry)
        st = _where(torch.arange(threads, device=dev) == 0, cv,
                    apply(excl, cv))
        incoming.append(st)
        carry = apply(tuple(x[-1] for x in sc), carry)
    return tuple(torch.cat([s[i] for s in incoming])[:nb]
                 for i in range(len(init)))


def _carry_runs(block_agg, identity, compose, apply, init, threads, warp):
    """Phase B by runs: each block's incoming state, shape (blocks,)."""
    nb = block_agg[0].shape[0]
    dev = block_agg[0].device
    per = -(-nb // threads)
    pad = threads * per - nb
    runs = tuple(torch.cat([x, torch.full((pad,), v, dtype=x.dtype,
                                          device=dev)]).view(threads, per)
                 for x, v in zip(block_agg, identity))
    live = (torch.arange(threads * per, device=dev) < nb).view(threads, per)
    a = _full(runs[0][:, 0], tuple((v, x.dtype)
                                   for v, x in zip(identity, block_agg)))
    for j in range(per):
        a = _where(live[:, j], compose(tuple(x[:, j] for x in runs), a), a)
    _, excl = _block_scan(a, identity, compose, warp)
    v0 = tuple(torch.full((threads,), c, dtype=x.dtype, device=dev)
               for c, x in zip(init, block_agg))
    v = _where(torch.arange(threads, device=dev) == 0, v0, apply(excl, v0))
    incoming = []
    for j in range(per):
        incoming.append(v)
        v = _where(live[:, j], apply(tuple(x[:, j] for x in runs), v), v)
    return tuple(torch.stack([s[i] for s in incoming], dim=1).reshape(-1)[:nb]
                 for i in range(len(init)))


def three_phase_scan(maps, identity, compose, apply, init, read, *,
                     threads: int, items: int, carry: str = "chunks",
                     block_aggregate: str = "tree", warp: int | None = None,
                     pass_threads: int | None = None,
                     pass_warp: int | None = None):
    """Inclusive scan of ``maps`` (tuple of (K,) tensors) applied to the
    state ``init``, by the kernels' three-phase block decomposition;
    returns ``read(state)`` after each item, shape (K,) (a tuple of such
    when ``read`` returns a tuple).  ``warp`` sets how a block scans its
    threads (`_block_scan`); ``pass_threads`` and ``pass_warp`` the threads
    of the one-block pass by runs (default ``threads``) and how it scans
    them."""
    k = maps[0].shape[0]
    blk = threads * items
    nb = -(-k // blk)
    dev = maps[0].device
    ident_d = tuple((v, x.dtype) for v, x in zip(identity, maps))
    pad = nb * blk - k

    def padded(x, v):
        return torch.cat([x, torch.full((pad,), v, dtype=x.dtype,
                                        device=dev)]).view(nb, threads, items)

    m = tuple(padded(x, v) for x, v in zip(maps, identity))
    live = (torch.arange(nb * blk, device=dev) < k).view(nb, threads, items)

    def thread_aggregates():
        a = _full(m[0][..., 0], ident_d)
        for j in range(items):
            mj = tuple(x[..., j] for x in m)
            a = _where(live[..., j], compose(mj, a), a)
        return a

    # (A) block aggregates: pairwise tree over the thread aggregates, or
    # the last of their inclusive scan
    agg = thread_aggregates()
    if block_aggregate == "scan":
        block_agg = tuple(x[:, -1] for x in _block_scan(
            agg, identity, compose, warp)[0])
    else:
        stride = 1
        while stride < threads:
            lo = tuple(x[:, 0::2 * stride].clone() for x in agg)
            hi = tuple(x[:, stride::2 * stride] for x in agg)
            new = compose(hi, lo)
            agg = tuple(x.clone() for x in agg)
            for x, y in zip(agg, new):
                x[:, 0::2 * stride] = y
            stride *= 2
        block_agg = tuple(x[:, 0] for x in agg)
    if carry == "runs":
        block_in = _carry_runs(block_agg, identity, compose, apply, init,
                               pass_threads or threads, pass_warp)
    else:
        block_in = _carry_chunks(block_agg, identity, compose, apply, init,
                                 threads, tuple(x.dtype for x in maps))

    # (C) each block re-scans its items from its incoming state
    _, texcl = _block_scan(thread_aggregates(), identity, compose, warp)
    v = tuple(s[:, None].expand(nb, threads) for s in block_in)
    first = torch.arange(threads, device=dev) == 0
    v = _where(first, v, apply(texcl, v))
    out = []
    for j in range(items):
        mj = tuple(x[..., j] for x in m)
        v = _where(live[..., j], apply(mj, v), v)
        out.append(read(v))
    if isinstance(out[0], tuple):
        return tuple(torch.stack(o, dim=-1).reshape(-1)[:k]
                     for o in zip(*out))
    return torch.stack(out, dim=-1).reshape(-1)[:k]
