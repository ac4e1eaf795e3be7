"""AdamW with float32 master weights and moments.

The counterpart of ``repro/optim/adamw.py``.  Parameters may live in bf16;
the optimizer keeps float32 master copies and the two moments, clips the
global gradient norm, corrects the moments' bias and writes the new master
weights back into the parameters in their own dtype.  The arithmetic is the
reference's, operation for operation in float32.

Where the reference maps pure functions over pytrees, the port keys every
leaf by parameter name (``model.named_parameters()``) and updates the
state and the parameters in place, one leaf at a time: the float32
temporaries of one leaf are all the update adds to the state, which matters
at recurrentgemma-2b's 3.1 B parameters (37 GB of state).  `state_axes`
gives every state leaf's sharding spec (ZeRO: the parameters' layout), as
the reference's does, for the dry-run stand-in (`launch.dryrun`); one card
still shards nothing, so the state lives whole on the parameters' device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor    # int32 scalar
    m: dict               # name -> float32 tensor
    v: dict
    master: dict


def init(params: dict) -> AdamWState:
    """Zero moments and float32 master copies of ``params`` (name ->
    tensor), on each parameter's device."""
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32,
                         device=next(iter(params.values())).device),
        m={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()},
        v={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()},
        master={n: p.detach().float().clone() for n, p in params.items()})


def state_axes(param_axes_tree) -> AdamWState:
    """Sharding specs for every state leaf (ZeRO: same layout as params).
    Expects the parameters' PartitionSpecs keyed by name (from
    `parallel.sharding.param_specs`)."""
    from ..parallel.sharding import P

    return AdamWState(step=P(), m=param_axes_tree, v=param_axes_tree,
                      master=param_axes_tree)


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum over every leaf of its squared float32 values."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


@torch.no_grad()
def update(state: AdamWState, grads: dict, params: dict, *, lr, b1=0.9,
           b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0):
    """One AdamW step; returns (params, new state, metrics).  ``grads`` and
    ``params`` are keyed as the state; each gradient is cast to float32 one
    leaf at a time.  The state's tensors and the parameters are updated in
    place (the returned ones are the same objects)."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0)
    step = state.step + 1
    sf = step.float()
    c1 = 1.0 - b1 ** sf
    c2 = 1.0 - b2 ** sf
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v, w = state.m[name], state.v[name], state.master[name]
        m.mul_(b1).add_((1 - b1) * g)            # b1 m + (1 - b1) g
        v.mul_(b2).add_((1 - b2) * g * g)        # b2 v + (1 - b2) g g
        w.sub_(lr * ((m / c1) / (torch.sqrt(v / c2) + eps)
                     + weight_decay * w))
        p.copy_(w)
    return params, AdamWState(step, state.m, state.v, state.master), {
        "grad_norm": gnorm}
