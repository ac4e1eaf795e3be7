"""PyTorch port, the MoE block (`repro_torch.models.moe`) and the MoE models
(qwen3-moe-30b-a3b, grok-1-314b) at smoke size against the JAX reference,
with the reference's weights carried across by `models.convert`.

Tolerances:
* `moe_mlp`'s output within 2 bf16 spacings of the reference's (both sum a
  token's kept expert products in float32 and round once, in another
  order), its aux loss at ``1e-6`` relative; a token whose every choice was
  dropped is exactly zero on both sides;
* the models' prefill and decode logits at ``5e-2`` (atol and rtol), the
  bf16 tolerance of the reference's own suite;
* the port's `Server` against the reference's: equal greedy tokens up to a
  near tie, as `tests/test_torch_model.py` holds the dense models.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.runtime.server import Request as JRequest  # noqa: E402
from repro.runtime.server import Server as JServer  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import convert as CV  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.runtime.server import Request, Server  # noqa: E402

TOL = 5e-2
D, F, E, K = 32, 48, 8, 2
MOE_ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def f32(x):
    return np.asarray(x).astype(np.float32)


def bf16(x):
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16))


def port(x):
    """A bf16 tensor of a bf16 numpy array (through float32, exact)."""
    return torch.from_numpy(f32(x)).to(torch.bfloat16)


def both_moe(router=None):
    """(reference params, port module) holding the same weights."""
    params = JMOE.init_moe(jax.random.key(0), D, F, E)
    if router is not None:
        params["router"] = jnp.asarray(router, jnp.float32)
    module = MOE.MoE(D, F, E, None, device=torch.device("cpu"))
    CV.fill_module(module, jax.tree.map(np.asarray, params))
    return params, module


def run_both(params, module, x, **kw):
    jy, jaux = JMOE.moe_mlp(params, jnp.asarray(x), top_k=K, **kw)
    ty, taux = MOE.moe_mlp(module, port(x), top_k=K, **kw)
    return (f32(jy), float(jaux)), (ty.float().numpy(), float(taux))


def within_bf16_spacings(got, want, n):
    mag = np.maximum(np.abs(got), np.abs(want))
    spacing = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -6))) - 7)
    return float(np.max(np.abs(got - want) / spacing)) <= n


@pytest.mark.parametrize("case", ["dropless", "dropping"])
def test_moe_mlp_equals_reference(case):
    """Dropless (cf 8, one group of 48 tokens: cap 48) and dropping (cf
    0.25, two groups of 16: cap 1, most pairs dropped)."""
    params, module = both_moe()
    rng = np.random.default_rng(5)
    if case == "dropless":
        x, kw = bf16(rng.normal(0, 1, (2, 24, D))), dict(capacity_factor=8.0)
    else:
        x, kw = bf16(rng.normal(0, 1, (2, 16, D))), dict(
            capacity_factor=0.25, group_size=16)
    (jy, jaux), (ty, taux) = run_both(params, module, x, **kw)
    assert ty.shape == jy.shape
    assert within_bf16_spacings(ty, jy, 2), float(np.abs(ty - jy).max())
    assert abs(taux - jaux) <= 1e-6 * abs(jaux), (taux, jaux)
    g, tg = MOE.groups(x.shape[0] * x.shape[1], kw.get("group_size", 512))
    r = MOE.route(module.router, port(x.reshape(g, tg, D)), top_k=K,
                  capacity_factor=kw["capacity_factor"])
    dropped = ~r.keep.any(dim=-1).reshape(-1).numpy()
    if case == "dropless":
        assert r.cap == tg and bool(r.keep.all())
    else:
        assert r.cap == 1 and dropped.sum() > 0
        # each expert keeps at most cap pairs a group, in token order
        for gi in range(g):
            kept = r.experts[gi][r.keep[gi]]
            assert len(set(kept.tolist())) == len(kept)
    assert np.all(ty.reshape(-1, D)[dropped] == 0)
    assert np.all(jy.reshape(-1, D)[dropped] == 0)


def test_moe_ties_go_to_the_lower_expert():
    """A zero router gives every expert the same probability: both sides
    pick experts 0 .. K-1, as lax.top_k breaks ties."""
    params, module = both_moe(router=np.zeros((D, E), np.float32))
    x = bf16(np.random.default_rng(6).normal(0, 1, (1, 8, D)))
    r = MOE.route(module.router, port(x), top_k=K, capacity_factor=8.0)
    assert r.experts.reshape(-1, K).tolist() == [[0, 1]] * 8
    (jy, jaux), (ty, taux) = run_both(params, module, x,
                                      capacity_factor=8.0)
    assert within_bf16_spacings(ty, jy, 2)
    assert abs(taux - jaux) <= 1e-6 * abs(jaux)


def test_moe_refuses_a_partial_group():
    """24 tokens in groups of 16: the reference asserts, the port raises a
    ValueError naming the rule."""
    params, module = both_moe()
    x = bf16(np.random.default_rng(7).normal(0, 1, (2, 12, D)))
    with pytest.raises(AssertionError):
        JMOE.moe_mlp(params, jnp.asarray(x), top_k=K, group_size=16)
    with pytest.raises(ValueError, match="whole groups of 16"):
        MOE.moe_mlp(module, port(x), top_k=K, group_size=16)


def test_full_width_capacity():
    """qwen3-moe-30b-a3b at full width: 40 slots an expert in a 512-token
    prefill group, 1 in a 4-slot decode tick."""
    cfg = get_config("qwen3-moe-30b-a3b")
    args = (cfg.moe.top_k, cfg.moe.n_experts, cfg.moe.capacity_factor)
    assert MOE.capacity(args[0], 512, *args[1:]) == 40
    assert MOE.capacity(args[0], 4, *args[1:]) == 1
    assert MOE.groups(4096, cfg.moe_group) == (8, 512)
    assert MOE.groups(300, cfg.moe_group) == (1, 300)
    with pytest.raises(ValueError):
        MOE.groups(600, cfg.moe_group)


@functools.lru_cache(maxsize=None)
def _models(arch, seed=1):
    """(reference config, reference params, port config, port model), made
    once per architecture (no test changes them)."""
    jcfg = jax_smoke(arch)
    params = jax.jit(lambda key: JTF.init_params(jcfg, key))(
        jax.random.key(seed))
    cfg = get_smoke_config(arch)
    model = CV.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return jcfg, params, cfg, model


def close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=what)


def reference_rounding(q, k, v, causal=True, window=0):
    """The reference model's attention (`plain_attention`: softmax weights
    rounded to bf16) in place of the flash kernel's float32 weights."""
    return A.plain_attention(q, k, v, causal=causal, window=window or None)


@pytest.fixture
def rounded_as_reference(monkeypatch):
    monkeypatch.setattr(A, "flash_attention", reference_rounding)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_equals_reference(arch, rounded_as_reference):
    """A 40-token prefill of two rows and three teacher-forced decode steps
    after it, each side carrying its own cache, against the reference run
    op by op, with the port's attention rounded as the reference's; the
    cache after them too.  Routing is discrete: where a token's K-th and
    (K+1)-th router probabilities nearly tie, the kernel's float32 softmax
    weights (the known difference of the dense models) can pick another
    expert, and that token's logits then differ by far more than ``5e-2``;
    `test_kernel_rounding_moves_routing_only_at_near_ties` holds the
    kernel's path to this one."""
    jcfg, params, cfg, model = _models(arch)
    n, b, max_len = 40, 2, 64
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab, (b, n + 3)).astype(np.int32)
    tl, tc = TF.prefill(model, torch.from_numpy(toks[:, :n]), max_len)
    with jax.disable_jit():
        jl, jc = JTF.prefill(params, jcfg, jnp.asarray(toks[:, :n]),
                             max_len=max_len)
        close(tl.float(), f32(jl), f"{arch} prefill logits")
        for i in range(3):
            tok = toks[:, n + i:n + i + 1]
            pos = np.full((b, 1), n + i, np.int32)
            jl, jc = JTF.decode_step(params, jcfg, jc, jnp.asarray(tok),
                                     jnp.asarray(pos))
            tl, tc = TF.decode_step(model, tc, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
            close(tl.float(), f32(jl), f"{arch} decode {i} logits")
            assert not bool(torch.isnan(tl).any())
    port = CV.cache_to_numpy(cfg, tc)
    for key, sub in jc["stages"].items():
        for leaf in ("k", "v", "len"):
            close(port["stages"][key]["attn"][leaf],
                  f32(sub["attn"][leaf]), f"{arch} cache {key}.{leaf}")


def _routed_forward(model, toks, monkeypatch, *, as_reference):
    """forward's logits (S, V) of one row, and each MoE layer's routing."""
    calls = []
    route = MOE.route

    def spy(router, xt, **kw):
        calls.append(route(router, xt, **kw))
        return calls[-1]

    with monkeypatch.context() as m:
        m.setattr(MOE, "route", spy)
        if as_reference:
            m.setattr(A, "flash_attention", reference_rounding)
        logits = TF.forward(model, torch.from_numpy(toks[None]))
    return logits[0].float().numpy(), calls


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_kernel_rounding_moves_routing_only_at_near_ties(arch, monkeypatch):
    """The port's own path (the flash kernel's float32 softmax weights)
    against the same model rounded as the reference, over 48 tokens: every
    expert choice that differs was a near tie (its K-th and (K+1)-th
    probabilities within 0.02: the smoke routers' probabilities are close
    to uniform, so such ties are common), and the tokens before the first
    one routed otherwise hold at ``5e-2`` (a token routed otherwise in one
    layer moves the later tokens' attention in the next)."""
    _, _, cfg, model = _models(arch)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, 48).astype(
        np.int32)
    got, routes = _routed_forward(model, toks, monkeypatch,
                                  as_reference=False)
    want, ref_routes = _routed_forward(model, toks, monkeypatch,
                                       as_reference=True)
    k = cfg.moe.top_k
    first = len(toks)
    for r, q in zip(routes, ref_routes):
        moved = (torch.sort(r.experts[0], dim=-1).values
                 != torch.sort(q.experts[0], dim=-1).values).any(dim=-1)
        if bool(moved.any()):
            top = torch.sort(r.probs[0], dim=-1, descending=True).values
            gap = (top[:, k - 1] - top[:, k])[moved]
            assert float(gap.max()) < 0.02, gap
            first = min(first, int(moved.nonzero()[0]))
    assert first > 0
    close(got[:first], want[:first], f"{arch} logits before token {first}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_server_equals_reference_server_up_to_near_ties(
        arch, rounded_as_reference):
    """Three greedy requests through two slots on each side (the decode
    tick's two tokens are one MoE group on both), the port's attention
    rounded as the reference's (see `test_moe_model_equals_reference`).
    The first token that differs is held to the reference run op by op:
    the compiled reference drops bf16 roundings its source writes, which
    can move a near-tied expert choice of its own."""
    jcfg, params, cfg, model = _models(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 40, 17)]
    n_new, max_len = 8, 64
    jreqs = [JRequest(rid=i, prompt=p, max_new=n_new)
             for i, p in enumerate(prompts)]
    JServer(jcfg, params, slots=2, max_len=max_len).run(jreqs)
    preqs = [Request(rid=i, prompt=p, max_new=n_new)
             for i, p in enumerate(prompts)]
    Server(model, slots=2, max_len=max_len).run(preqs)
    for jr, pr, prompt in zip(jreqs, preqs, prompts):
        assert len(jr.out) == len(pr.out) == n_new
        diff = [i for i, (a, b) in enumerate(zip(jr.out, pr.out)) if a != b]
        if not diff:
            continue
        k = diff[0]
        seq = np.concatenate([prompt, np.asarray(jr.out[:k], np.int32)])
        with jax.disable_jit():
            row = f32(JTF.forward(params, jcfg,
                                  jnp.asarray(seq[None]))[0])[0, -1]
        top = float(row.max())
        assert top - float(row[pr.out[k]]) <= 2 * (TOL + TOL * abs(top)), (
            f"{arch} request {jr.rid}: token {k} differs beyond a near tie")
