"""PyTorch port, qwen3-moe-30b-a3b's routing at its published widths
against the JAX reference on the CPU: the first two of its 48 layers
(d_model 2,048, 32 query heads over 4 KV heads, 128 experts of width 768,
top 8, capacity factor 1.25, the 151,936-token vocabulary), the port's
seeded weights (the distribution the card's run draws from) carried
across to the reference bit for bit, one 512-token prompt (one routing
group: 40 slots an expert).  About 9 GB of host memory, 40 s.

The smoke-size tests cannot see a fault that only shows at full width,
such as one that makes a prompt's hidden states alike across tokens (in
attention, the norms or the router's input): that moves the share of
(token, choice) pairs that fit their expert's capacity.  Here each layer's
MoE input, expert choices, capacity slots and kept share are held to
the reference's (up to near ties, which the two sides' bf16 roundings
move), and the reference's kept share by layer is printed (``pytest
-s``).

The port's attention is rounded as the reference's (`plain_attention`),
as in `tests/test_torch_moe.py`: routing is discrete, and the flash
kernel's float32 softmax weights move near-tied expert choices.  The
reference's routing is its `moe_mlp` lines 59-76, written out in jnp
over the MoE input it recorded.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import convert as CV  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
LAYERS = 2
TOKENS = 512
TOL = 5e-2
# the port's kept share of a layer against the reference's: a near tie
# that moves a choice moves the slots of the pairs after it
SHARE_TOL = 1e-2


def reference_routing(x, router, top_k, capacity_factor):
    """The reference's routing of one group x (tg, d), as `moe_mlp` writes
    it: (expert ids (tg, K), slots (tg, K), keep (tg, K))."""
    tg, e = x.shape[0], router.shape[1]
    probs = jax.nn.softmax(x.astype(jnp.float32) @ router, axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    cap = min(max(int(top_k * tg / e * capacity_factor), 1), tg)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32).reshape(tg * top_k, e)
    pos = ((jnp.cumsum(onehot, axis=0) - onehot) * onehot).sum(-1)
    pos = pos.reshape(tg, top_k)
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < cap)


def reference_params(model):
    """The port's parameters as the reference's tree: the layers' leaves
    stacked, bf16 bit patterns carried over (one leaf at a time, so that
    the host holds about one copy of the weights on each side)."""
    def host(x):
        x = x.detach()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()

    def leaf(*xs):
        arr = np.stack([host(x) for x in xs]) if len(xs) > 1 \
            else host(xs[0])
        if xs[0].dtype == torch.bfloat16:
            arr = arr.view(jnp.bfloat16)
        return jnp.array(arr)

    (key,) = {key for key, _ in model.keys}
    return {"stages": {key: jax.tree.map(leaf, *[CV._module_tree(b)
                                                for b in model.layers])},
            "embed": jax.tree.map(leaf, CV._module_tree(model.embed)),
            "final_norm": jax.tree.map(leaf,
                                       CV._module_tree(model.final_norm))}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_full_width_routing_equals_reference(monkeypatch):
    jcfg = dataclasses.replace(jax_config(ARCH), n_layers=LAYERS)
    cfg = dataclasses.replace(get_config(ARCH), n_layers=LAYERS)
    model = TF.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    params = reference_params(model)
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab, (1, TOKENS)).astype(np.int32)
    k, cf = cfg.moe.top_k, cfg.moe.capacity_factor

    ref_inputs = []
    moe_mlp = JMOE.moe_mlp

    def ref_spy(p, x, **kw):
        ref_inputs.append((np.asarray(x[0].astype(jnp.float32)),
                           np.asarray(p["router"])))
        return moe_mlp(p, x, **kw)

    port_routes = []
    route = MOE.route

    def port_spy(router, xt, **kw):
        port_routes.append((xt[0].float().numpy(), route(router, xt, **kw)))
        return port_routes[-1][1]

    with monkeypatch.context() as m:
        m.setattr(JMOE, "moe_mlp", ref_spy)
        with jax.disable_jit():
            JTF.prefill(params, jcfg, jnp.asarray(toks), max_len=TOKENS)
    del params
    with monkeypatch.context() as m:
        m.setattr(MOE, "route", port_spy)
        m.setattr(A, "flash_attention",
                  lambda q, kk, v, causal=True, window=0: A.plain_attention(
                      q, kk, v, causal=causal, window=window or None))
        with torch.no_grad():
            TF.prefill(model, torch.from_numpy(toks), TOKENS)
    assert len(ref_inputs) == len(port_routes) == LAYERS

    shares, first = [], TOKENS
    for layer, ((jx, router), (tx, r)) in enumerate(
            zip(ref_inputs, port_routes)):
        # the tokens before the first one routed otherwise in an earlier
        # layer have the reference's MoE input (a token routed otherwise
        # moves the later tokens' attention in the next layer)
        close = np.isclose(tx, jx, atol=TOL, rtol=TOL).all(axis=-1)
        off = np.nonzero(~close[:first])[0]
        assert not len(off), (f"layer {layer}: MoE input off at {len(off)} "
                              f"tokens, from {off[:10].tolist()}")
        probs = np.asarray(jax.nn.softmax(
            jnp.asarray(jx) @ router, axis=-1))
        idx, pos, keep = reference_routing(jnp.asarray(jx), router, k, cf)
        assert r.cap == 40
        experts = r.experts[0].numpy()
        # there, an expert choice differs only at a near tie (the two
        # experts' probabilities within the bf16 tolerance of each other:
        # the two sides' inputs and float32 products differ in their last
        # bits)
        moved = (experts != idx) & (np.arange(TOKENS) < first)[:, None]
        t, c = np.nonzero(moved)
        gap = np.abs(probs[t, experts[t, c]] - probs[t, idx[t, c]]) \
            / probs[t, idx[t, c]]
        assert (gap < TOL).all(), (layer, gap)
        routed_otherwise = np.nonzero((experts != idx).any(-1))[0]
        if len(routed_otherwise):
            first = min(first, int(routed_otherwise[0]))
        # slots (so kept pairs) as the reference's before the first token
        # routed otherwise
        same = (experts == idx).all(-1) & (np.arange(TOKENS) < first)
        np.testing.assert_array_equal(r.slots[0].numpy()[same], pos[same],
                                      err_msg=f"layer {layer}: slots")
        share = float(r.keep.float().mean())
        assert abs(share - float(keep.mean())) <= SHARE_TOL, (
            layer, share, float(keep.mean()))
        shares.append(float(keep.mean()))
    print(f"{ARCH} full width, {TOKENS}-token prompt, the reference's kept "
          f"share of (token, choice) pairs by layer: {shares}")
