"""Mixture-of-Experts MLP: token-choice top-k with group capacity dispatch.

The counterpart of ``repro/models/moe.py``.  The semantics are the
reference's, step for step:

  * tokens are taken in groups of ``group_size`` (all of them if fewer); a
    token count that does not split into whole groups is refused;
  * router logits in float32, softmax, top-k (ties to the lower expert
    index, as ``lax.top_k``), the k gates renormalised to sum to one;
  * each expert takes at most ``cap = min(max(int(k * tg / E * cf), 1),
    tg)`` (token, choice) pairs a group; a pair's slot is its rank among the
    group's pairs to that expert in token-major, then choice-major order,
    and pairs at or past ``cap`` are dropped.  So a token's result depends
    on the other tokens of its group (a decode tick's slots share one
    group);
  * the expert products run over every expert's whole ``cap``-slot buffer,
    empty slots included, as plain batched products (the reference computes
    them outside any Pallas kernel);
  * the combine weights are the gates rounded to bf16; the Switch aux loss
    ``E * sum(frac_tokens * frac_probs)`` over the top-1 choices.

The reference dispatches and combines with one-hot einsums; the port
gathers and scatters by index instead.  Each buffer slot holds at most one
token, so the dispatch is exact either way, and the combine is a bf16
product (float32 sums, one rounding) of a token's kept products and its
bf16 gates, as the einsum is (summed in another order).  Nothing here
reads a value back to the host.  `route` is the routing step on its own,
so that a caller can count the dropped pairs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .layers import DTYPE, _normal, param, silu


class MoE(nn.Module):
    """``router`` float32 (d, E); ``wi_gate``, ``wi_up`` (E, d, f) and
    ``wo`` (E, f, d) bf16."""

    def __init__(self, d: int, f: int, n_experts: int, gen, *, device):
        super().__init__()
        self.router = param(_normal(gen, (d, n_experts), d ** -0.5,
                                    torch.float32, device=device))
        self.wi_gate = param(_normal(gen, (n_experts, d, f), d ** -0.5,
                                     device=device))
        self.wi_up = param(_normal(gen, (n_experts, d, f), d ** -0.5,
                                   device=device))
        self.wo = param(_normal(gen, (n_experts, f, d), f ** -0.5,
                                device=device))


def moe_axes(expert_sharding: str):
    """expert_sharding: 'expert' (E over model) or 'ffn' (d_ff over model)."""
    if expert_sharding == "expert":
        e, f = "experts", "expert_mlp"
    else:
        e, f = None, "mlp"
    return {"router": ("embed", None),
            "wi_gate": (e, "embed", f), "wi_up": (e, "embed", f),
            "wo": (e, f, "embed")}


@dataclass(frozen=True)
class Routing:
    """Where a group's (token, choice) pairs go.  probs (G, tg, E) float32;
    gates (G, tg, K) float32, renormalised; experts and slots (G, tg, K)
    int64; keep (G, tg, K) bool (slot < cap)."""

    probs: torch.Tensor
    gates: torch.Tensor
    experts: torch.Tensor
    slots: torch.Tensor
    keep: torch.Tensor
    cap: int


def groups(t: int, group_size: int) -> tuple[int, int]:
    """(groups, tokens a group) for ``t`` tokens; refuses a count that is
    not a whole number of groups (the reference asserts it)."""
    tg = min(group_size, t)
    g = t // tg
    if g * tg != t:
        raise ValueError(
            f"moe_mlp takes whole groups of {group_size} tokens (or fewer "
            f"tokens than one group): {t} tokens is not a multiple of "
            f"{tg}")
    return g, tg


def capacity(top_k: int, tg: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert has in a group of ``tg`` tokens."""
    return min(max(int(top_k * tg / n_experts * capacity_factor), 1), tg)


def _one_hot(idx, n):
    """(..., n) bool one-hot of ``idx`` by comparison (``F.one_hot`` reads
    the largest index back to the host, a sync on the card)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def route(router, xt, *, top_k: int, capacity_factor: float) -> Routing:
    """The routing of grouped tokens ``xt`` (G, tg, d)."""
    g, tg, _ = xt.shape
    e = router.shape[1]
    probs = torch.softmax(xt.float() @ router, dim=-1)
    # a stable descending sort: equal probabilities keep the lower index
    # first, as lax.top_k does
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = order.values[..., :top_k]
    experts = order.indices[..., :top_k]
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    cap = capacity(top_k, tg, e, capacity_factor)
    # a pair's slot: the pairs to its expert before it in the group, in
    # token-major, choice-major order (a scan along the pairs, each
    # expert's row innermost)
    flat = experts.reshape(g, 1, tg * top_k)
    onehot = _one_hot(flat[:, 0], e).transpose(1, 2)       # (G, E, n)
    before = torch.cumsum(onehot, dim=-1) - onehot.long()
    slots = before.gather(1, flat).reshape(g, tg, top_k)
    return Routing(probs, gates, experts, slots, slots < cap, cap)


def moe_mlp(p: MoE, x, *, top_k: int, capacity_factor: float = 1.25,
            group_size: int = 512):
    """x: (B, S, D) bf16 -> (B, S, D) bf16, aux loss (float32 scalar)."""
    b, s, d = x.shape
    e = p.router.shape[1]
    g, tg = groups(b * s, group_size)
    xt = x.reshape(g, tg, d)
    r = route(p.router, xt, top_k=top_k, capacity_factor=capacity_factor)
    cap = r.cap
    # each expert's buffer of its groups' slots, (E, G * cap, d): a kept
    # pair goes to its slot, a dropped pair to a spare last row that
    # nothing reads
    row = (r.experts * g + torch.arange(g, device=x.device)[:, None, None]) \
        * cap + r.slots
    spare = e * g * cap
    buf = x.new_zeros((spare + 1, d))
    buf[torch.where(r.keep, row, spare).reshape(-1)] = \
        xt[:, :, None, :].expand(g, tg, top_k, d).reshape(-1, d)
    xe = buf[:spare].view(e, g * cap, d)
    # the expert products over every expert's whole buffer
    h = silu(torch.bmm(xe, p.wi_gate)) * torch.bmm(xe, p.wi_up)
    ye = torch.bmm(h, p.wo).view(spare, d)
    # combine: a token's kept products times its gates rounded to bf16,
    # summed in float32 and rounded once (a dropped pair weighs 0)
    picked = ye[torch.where(r.keep, row, 0).reshape(-1)].view(
        g * tg, top_k, d)
    w = torch.where(r.keep, r.gates, 0.0).to(DTYPE).view(g * tg, 1, top_k)
    y = torch.bmm(w, picked)
    frac_tokens = _one_hot(r.experts[..., 0], e).float().mean(dim=(0, 1))
    frac_probs = r.probs.mean(dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)
    return y.reshape(b, s, d), aux
