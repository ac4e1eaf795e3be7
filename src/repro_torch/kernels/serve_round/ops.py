"""Public wrapper: one engine serve round -> (max,+) affine-scan dispatch.

`core.engine._one_round` hands this wrapper the *sorted* per-item tensors of
one fixpoint round (items lexsorted by (channel, arrival, flat index), with
per-channel table gathers and seed gathers already done).  The wrapper

  1. runs the **static pre-pass** (`serve_maps`, plain PyTorch on the
     tensors' device): the direction / DRAM row each item reacts to is the
     direction/row of the last *serving* (row-managed) item before it in its
     channel segment — a property of the ordering alone, resolved with
     exclusive running-max index gathers.  The turnaround gap and row
     hit/miss penalty then fold into per-item constants, and
     ``s = ser + row_extra`` is each item's total occupancy;
  2. builds each item's (max,+) affine map over the channel state
     ``v = (depart, down_until)`` — serving items advance ``depart`` (and
     ``down`` when they carry a retrain interval), link-down markers only
     raise ``down``, everything else is the identity — and folds the
     carried seed state into segment heads (which then kill the incoming
     state, making the scan unsegmented);
  3. runs the scan: the CUDA kernel (`kernel.serve_scan`) when the tensors
     lie on the card, the plain version (`ref.serve_scan_ref`) when they
     lie on the CPU.  On the card it launches the kernel or raises; nothing
     falls back.

Everything stays int64 with ``NEG = -2**62``, so unlike the JAX wrapper
(int32 rebased to the round's minimum arrival, 2**29 ps span contract) there
is no span limit.  Times are still taken relative to the round's minimum
arrival and the seeds clamped as the reference does — both exact — so the
maps equal the reference's in value.

Returns the engine's masked per-item ``(start, depart, retrain_stall)``
triple in int64 picoseconds; non-serving items pass through at their
arrival with zero stall.
"""

from __future__ import annotations

import torch

from .kernel import serve_scan
from .ref import NEG, serve_scan_ref


def serve_maps(chan, serving, marker, arrive, direction, row, ser, turn,
               rhit, rmiss, retrain, sd_dep, sd_dir, sd_row, sd_down):
    """The static pre-pass of one sorted serve round.

    Inputs as `serve_round`.  Returns ``(maps, aux)``: the six (K,) int64
    map components (times relative to ``base``, the round's minimum
    arrival), and ``aux = (base, s, gap, head)`` for `finish_round`."""
    k = chan.shape[0]
    dev = chan.device
    idx = torch.arange(k, device=dev)
    active = serving | marker
    dirn = direction.long()
    sdir = sd_dir.long()
    row = row.long()

    def prev_ix(mask):
        # index of the last item before me satisfying mask (-1 = none)
        inc = torch.cummax(torch.where(mask, idx, -1), dim=0).values
        return torch.cat([inc.new_full((1,), -1), inc[:-1]])

    def in_seg(p):
        return (p >= 0) & (chan[p.clamp_min(0)] == chan)

    p_act = prev_ix(active)
    p_srv = prev_ix(serving)
    p_row = prev_ix(serving & (row >= 0))
    head = active & ~in_seg(p_act)
    eff_dir = torch.where(in_seg(p_srv), dirn[p_srv.clamp_min(0)], sdir)
    eff_row = torch.where(in_seg(p_row), row[p_row.clamp_min(0)],
                          sd_row.long())

    gap = torch.where((eff_dir != -1) & (dirn != eff_dir), turn, 0)
    rx = torch.where(row >= 0, torch.where(row == eff_row, rhit, rmiss), 0)
    s = ser + rx

    # times relative to the round's min arrival.  Seed clamps: a depart
    # seed below (base - turn) / a down seed below base can never bind
    # (every start is >= arrive >= base), so clamping is exact
    base = arrive.min()
    arr = arrive - base
    sdep = torch.maximum(sd_dep, base - turn) - base
    sdwn = torch.clamp_min(sd_down, base) - base

    neg = torch.full_like(arr, NEG)
    zero = torch.zeros_like(arr)
    rp = torch.where(retrain > 0, retrain, neg)  # NEG = no retrain

    # serving map: depart' = max(arr+s, depart+gap+s, down+s);
    #              down'   = max(down, depart' + retrain?)
    m00, m01, c0 = gap + s, s, arr + s
    m10 = torch.clamp_min(m00 + rp, NEG)
    m11 = torch.clamp_min(torch.clamp_min(s + rp, 0), NEG)
    c1 = torch.clamp_min(c0 + rp, NEG)
    # marker: depart' = depart; down' = max(down, arr + retrain)
    m00 = torch.where(serving, m00, zero)
    m01 = torch.where(serving, m01, neg)
    c0 = torch.where(serving, c0, neg)
    m10 = torch.where(serving, m10, neg)
    m11 = torch.where(serving, m11, zero)
    c1 = torch.where(serving, c1, torch.where(marker, arr + retrain, neg))
    # heads fold the seed state into c and kill the incoming state — this
    # is what de-segments the scan
    h0 = torch.maximum(torch.maximum(m00 + sdep, m01 + sdwn), c0)
    h1 = torch.maximum(torch.maximum(m10 + sdep, m11 + sdwn), c1)
    c0 = torch.where(head, torch.clamp_min(h0, NEG), c0)
    c1 = torch.where(head, torch.clamp_min(h1, NEG), c1)
    m00 = torch.where(head, neg, m00)
    m01 = torch.where(head, neg, m01)
    m10 = torch.where(head, neg, m10)
    m11 = torch.where(head, neg, m11)
    return (m00, m01, m10, m11, c0, c1), (base, s, gap, head)


def finish_round(d_rel, arrive, serving, sd_dep, aux):
    """Masked ``(start, depart, stall)`` from the scanned depart states."""
    base, s, gap, head = aux
    d = d_rel + base
    # stall = grant delay the down-until clock added on top of contention
    eff_dep = torch.where(head, sd_dep, torch.cat([sd_dep[:1], d[:-1]]))
    start = d - s
    out_start = torch.where(serving, start, arrive)
    out_depart = torch.where(serving, d, arrive)
    out_stall = torch.where(
        serving, start - torch.maximum(arrive, eff_dep + gap), 0)
    return out_start, out_depart, out_stall


def serve_round(chan, serving, marker, arrive, direction, row, ser, turn,
                rhit, rmiss, retrain, sd_dep, sd_dir, sd_row, sd_down):
    """One sorted serve round.  All inputs (K,) on one device: ``chan``
    int64 sorted with invalid items in a trailing dummy segment;
    ``serving``/``marker`` bool item classes; ``arrive``/``ser``/``turn``/
    ``rhit``/``rmiss``/``retrain``/``sd_dep``/``sd_down`` int64 ps;
    ``direction``/``sd_dir`` int8; ``row``/``sd_row`` int32.  ``sd_*`` are the
    per-item gathered channel seed frontiers (cold: 0 / -1 / -2 / 0).
    Returns int64 ``(start, depart, stall)``."""
    if chan.shape[0] == 0:
        return arrive, arrive, torch.zeros_like(arrive)
    maps, aux = serve_maps(chan, serving, marker, arrive, direction, row,
                           ser, turn, rhit, rmiss, retrain, sd_dep, sd_dir,
                           sd_row, sd_down)
    if arrive.is_cuda:
        d_rel = serve_scan(*maps)
    else:
        d_rel = serve_scan_ref(*maps)
    return finish_round(d_rel, arrive, serving, sd_dep, aux)
