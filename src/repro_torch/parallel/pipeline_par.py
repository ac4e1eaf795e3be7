"""Pipeline parallelism: the GPipe microbatch schedule over a 'stage' mesh
axis, in one process.

The counterpart of ``repro/parallel/pipeline_par.py``.  The reference runs
one pipeline stage per device under ``shard_map`` and hands activations to
the next stage with ``ppermute``.  Its schedule runs S + M - 1 ticks (S
stages, M microbatches); at tick t stage s holds microbatch t - s, and the
steady state keeps all stages busy — the standard bubble fraction
(S-1)/(S+M-1) shrinks with M.

Here the stages run one after another on the caller's device, tick by
tick: within a tick each stage takes the microbatch it holds, and the
``ppermute`` becomes a rotation of the stage buffers (stage s's output is
stage s+1's input at the next tick).  Unlike the reference, only the
(stage, microbatch) pairs that the schedule makes valid run: the
reference's bubble ticks compute on a copy of microbatch M - 1 and throw
the result away, which on one device is only waste, so the outputs are the
same.  Each microbatch goes through the same stage functions on the same
inputs as in sequential application, so the result equals it bit for bit
when ``stage_fn`` is deterministic.
"""

from __future__ import annotations

import torch


def pipeline_forward(stage_fn, params_per_stage, x, *, mesh, n_microbatches,
                     stage_axis: str = "stage"):
    """Run x (B, ...) through ``mesh.shape[stage_axis]`` stage_fns pipelined
    over microbatches.

    params_per_stage: a sequence with one entry per stage, each passed to
    ``stage_fn(params, x_mb)`` as it is.  x is split into n_microbatches
    along batch; ``stage_fn`` keeps a microbatch's shape, and the output
    has x's shape.
    """
    n_stages = mesh.shape[stage_axis]
    m = n_microbatches
    if len(params_per_stage) != n_stages:
        raise ValueError(f"{len(params_per_stage)} stage parameter sets for "
                         f"{n_stages} stages")
    if x.shape[0] % m:
        raise ValueError(f"a batch of {x.shape[0]} does not split into "
                         f"{m} microbatches")
    xs = x.reshape(m, x.shape[0] // m, *x.shape[1:])
    held = [None] * n_stages        # the input each stage holds
    outs = [None] * m
    for t in range(n_stages + m - 1):
        ys = [None] * n_stages
        for s in range(n_stages):
            if 0 <= t - s < m:
                ys[s] = stage_fn(params_per_stage[s],
                                 xs[t] if s == 0 else held[s])
        # the last stage records microbatch t - (S - 1)
        if t >= n_stages - 1:
            outs[t - (n_stages - 1)] = ys[-1]
        # hand activations to the next stage
        held = [None] + ys[:-1]
    return torch.stack(outs).reshape(x.shape)
