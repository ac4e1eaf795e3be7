"""CPU emulation of the three-phase block scan of the port's CUDA scans.

`csrc/serve_round.cu` and `csrc/link_contention.cu` share one structure,
because CUDA blocks run in no order and cannot hand a running state from one
block to the next:

  (A) each block of ``threads * items`` items builds one aggregate map: each
      thread composes its ``items`` consecutive maps in order, then the
      block combines the thread aggregates in a pairwise tree (stride 1, 2,
      4, ...: the aggregate of thread ``t`` absorbs that of ``t + stride``);
  (B) one block walks the block aggregates in chunks of ``threads``: an
      inclusive Hillis–Steele scan of the chunk, whose exclusive prefixes
      applied to the running state give each block its incoming state;
  (C) each block recomputes its thread aggregates, scans them
      (Hillis–Steele), applies thread ``t``'s exclusive prefix to the
      block's incoming state, and walks its own items from there.

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


def three_phase_scan(maps, identity, compose, apply, init, read, *,
                     threads: int, items: int):
    """Inclusive scan of ``maps`` (tuple of (K,) tensors) applied to the
    state ``init``, by the kernels' three-phase block decomposition;
    returns ``read(state)`` after each item, shape (K,)."""
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

    # (A) block aggregates: pairwise tree over the thread aggregates
    agg = thread_aggregates()
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

    # (B) one block: incoming state of every block, chunk by chunk
    n_chunks = -(-nb // threads)
    cpad = n_chunks * threads - nb
    chunks = tuple(torch.cat([x, torch.full((cpad,), v, dtype=x.dtype,
                                            device=dev)]).view(n_chunks,
                                                               threads)
                   for x, v in zip(block_agg, identity))
    state_dtypes = tuple(x.dtype for x in maps)[:len(init)]
    carry = tuple(torch.tensor(v, dtype=d, device=dev)
                  for v, d in zip(init, state_dtypes))
    incoming = []
    for ci in range(n_chunks):
        sc = _hillis_steele(tuple(x[ci] for x in chunks), identity, compose)
        excl = tuple(torch.cat([torch.full((1,), v, dtype=x.dtype,
                                           device=dev), x[:-1]])
                     for x, v in zip(sc, identity))
        cv = tuple(c.expand(threads) for c in carry)
        st = _where(torch.arange(threads, device=dev) == 0, cv,
                    apply(excl, cv))
        incoming.append(st)
        carry = apply(tuple(x[-1] for x in sc), carry)
    block_in = tuple(torch.cat([s[i] for s in incoming])[:nb]
                     for i in range(len(init)))

    # (C) each block re-scans its items from its incoming state
    tsc = _hillis_steele(thread_aggregates(), identity, compose)
    texcl = tuple(torch.cat([torch.full((nb, 1), v, dtype=x.dtype,
                                        device=dev), x[:, :-1]], dim=1)
                  for x, v in zip(tsc, identity))
    v = tuple(s[:, None].expand(nb, threads) for s in block_in)
    first = torch.arange(threads, device=dev) == 0
    v = _where(first, v, apply(texcl, v))
    out = []
    for j in range(items):
        mj = tuple(x[..., j] for x in m)
        v = _where(live[..., j], apply(mj, v), v)
        out.append(read(v))
    return torch.stack(out, dim=-1).reshape(-1)[:k]
