"""PyTorch port, the encoder-decoder and VLM-stub families at smoke size
against the JAX reference, with the reference's weights carried across by
`models.convert`: whisper-base (the encoder `_run_encoder`, cross attention
with its ``xattn`` cache, prefill and decode) and phi-3-vision-4.2b (patch
embeddings in place of the first ``vision_patches`` token embeddings), and
the refusals both packages share.

Tolerance ``5e-2`` (atol and rtol), the bf16 tolerance of the reference's
own suite; the port's encoder and cross attention keep the flash kernel's
float32 softmax weights, where the reference's ``plain_attention`` rounds
them to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.runtime.server import Request as JRequest  # noqa: E402
from repro.runtime.server import Server as JServer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import convert as CV  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.runtime.server import Request, Server  # noqa: E402

TOL = 5e-2
B, MAX_LEN = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def f32(x):
    return np.asarray(x).astype(np.float32)


def close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                               err_msg=f"{what}: max abs err {err}")


def close_trees(port_tree, ref_tree, what):
    ref_tree = jax.tree.map(f32, ref_tree)
    paths = jax.tree_util.tree_leaves_with_path(ref_tree)
    assert len(paths) == len(jax.tree.leaves(port_tree)), what
    for path, want in paths:
        got = port_tree
        for k in path:
            got = got[k.key]
        close(got, want, f"{what} {jax.tree_util.keystr(path)}")


def _models(arch):
    jcfg = jax_smoke(arch)
    params = jax.jit(lambda key: JTF.init_params(jcfg, key))(
        jax.random.key(2))
    cfg = get_smoke_config(arch)
    model = CV.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def whisper():
    return _models("whisper-base")


@pytest.fixture(scope="module")
def phi3v():
    return _models("phi-3-vision-4.2b")


def frames(cfg, n, seed=0):
    """(n, frames or patches, D) bf16 embeddings, as numpy float32 (exact
    bf16 values) and as the port's bf16 tensor."""
    x = np.random.default_rng(seed).normal(0, 1, (B, n, cfg.d_model))
    x = f32(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16))
    return x, torch.from_numpy(x).to(torch.bfloat16)


def teacher_forced(jcfg, params, cfg, model, toks, n, fe_np, fe):
    """Prefill ``n`` tokens with the frontend embeddings on both sides, then
    three decode steps fed the true next token, each side carrying its own
    cache; returns both final caches."""
    tl, tc = TF.prefill(model, torch.from_numpy(toks[:, :n]), MAX_LEN,
                        frontend_embeds=fe)
    jl, jc = jax.jit(lambda p, t, e: JTF.prefill(
        p, jcfg, t, max_len=MAX_LEN, frontend_embeds=e))(
            params, jnp.asarray(toks[:, :n]),
            jnp.asarray(fe_np).astype(jnp.bfloat16))
    close(tl.float(), f32(jl), f"{cfg.name} prefill logits")
    close_trees(CV.cache_to_numpy(cfg, tc), jc, f"{cfg.name} prefill cache")
    step = jax.jit(lambda p, c, t, q: JTF.decode_step(p, jcfg, c, t, q))
    for i in range(3):
        tok = toks[:, n + i:n + i + 1]
        pos = np.full((B, 1), n + i, np.int32)
        jl, jc = step(params, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = TF.decode_step(model, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos))
        close(tl.float(), f32(jl), f"{cfg.name} decode {i} logits")
        assert not bool(torch.isnan(tl).any())
    return tc, jc


def test_whisper_encoder_equals_reference(whisper):
    jcfg, params, cfg, model = whisper
    fe_np, fe = frames(cfg, cfg.enc_frames)
    want = JTF._run_encoder(params, jcfg,
                            jnp.asarray(fe_np).astype(jnp.bfloat16))
    got = TF._run_encoder(model, fe)
    assert got.dtype == torch.bfloat16
    close(got.float(), f32(want), "encoder output")


def test_whisper_prefill_and_decode_equal_reference(whisper):
    """A 12-token decoder prompt against the 16 encoder frames: prefill
    logits and the whole cache (self-attention k, v, len and the ``xattn``
    keys and values), three decode steps, the cache after them."""
    jcfg, params, cfg, model = whisper
    fe_np, fe = frames(cfg, cfg.enc_frames, seed=1)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab, (B, 15)).astype(np.int32)
    tc, jc = teacher_forced(jcfg, params, cfg, model, toks, 12, fe_np, fe)
    close_trees(CV.cache_to_numpy(cfg, tc), jc, "cache after decode")
    assert set(tc[0]) == {"attn", "xattn"}


def test_whisper_prefill_and_decode_agree_with_forward(whisper):
    _, _, cfg, model = whisper
    _, fe = frames(cfg, cfg.enc_frames, seed=3)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, 14)))
    full = TF.forward(model, toks, frontend_embeds=fe)
    pre, cache = TF.prefill(model, toks[:, :10], MAX_LEN, frontend_embeds=fe)
    close(pre[:, 0].float(), full[:, 9].float(), "prefill vs forward")
    for i in range(10, 14):
        logits, cache = TF.decode_step(
            model, cache, toks[:, i:i + 1],
            torch.full((B, 1), i, dtype=torch.int32))
        if i < 13:
            close(logits[:, 0].float(), full[:, i].float(),
                  f"decode {i} vs forward")


def test_whisper_refusals_pinned_on_both_packages(whisper):
    """Neither package's slot server serves whisper (the reference's
    prefills with no frame embeddings and dies in `_run_encoder`), and an
    encoder-decoder prefill without frame embeddings is refused on both;
    a decoder prompt longer than the encoder's frames, which the port once
    refused, runs its cross attention in blocks of T queries and equals the
    reference's prefill and decode."""
    jcfg, params, cfg, model = whisper
    prompt = np.arange(1, 6, dtype=np.int32)
    with pytest.raises(AttributeError):
        JServer(jcfg, params, slots=2, max_len=MAX_LEN).run(
            [JRequest(rid=0, prompt=prompt, max_new=2)])
    with pytest.raises(ValueError, match="reference's Server cannot"):
        Server(model, slots=2, max_len=MAX_LEN)
    with pytest.raises(AttributeError):
        JTF.prefill(params, jcfg, jnp.asarray(prompt[None]), MAX_LEN)
    with pytest.raises(ValueError, match="frontend_embeds"):
        TF.prefill(model, torch.from_numpy(prompt[None]), MAX_LEN)
    fe_np, fe = frames(cfg, cfg.enc_frames)
    n = 2 * cfg.enc_frames + 3
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab, (B, n + 3)).astype(np.int32)
    teacher_forced(jcfg, params, cfg, model, toks, n, fe_np, fe)


def test_phi3v_prefill_and_decode_equal_reference(phi3v):
    """A 20-token prompt whose first 8 embeddings are patch embeddings,
    three decode steps, the cache after them."""
    jcfg, params, cfg, model = phi3v
    fe_np, fe = frames(cfg, cfg.vision_patches, seed=4)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab, (B, 23)).astype(np.int32)
    tc, jc = teacher_forced(jcfg, params, cfg, model, toks, 20, fe_np, fe)
    close_trees(CV.cache_to_numpy(cfg, tc), jc, "cache after decode")
    # the patches replace the prompt's first embeddings: the tokens there
    # do not matter
    other = toks[:, :20].copy()
    other[:, :cfg.vision_patches] = 0
    a, _ = TF.prefill(model, torch.from_numpy(toks[:, :20]), MAX_LEN,
                      frontend_embeds=fe)
    b, _ = TF.prefill(model, torch.from_numpy(other), MAX_LEN,
                      frontend_embeds=fe)
    assert torch.equal(a, b)


def test_phi3v_short_prompt_refused_on_both_packages(phi3v):
    """A prompt shorter than ``vision_patches`` with patch embeddings: the
    reference fails in RoPE (the embeddings outnumber the positions), the
    port raises a ValueError saying why."""
    jcfg, params, cfg, model = phi3v
    fe_np, fe = frames(cfg, cfg.vision_patches)
    toks = np.ones((B, cfg.vision_patches - 3), np.int32)
    with pytest.raises(TypeError):
        JTF.prefill(params, jcfg, jnp.asarray(toks), MAX_LEN,
                    frontend_embeds=jnp.asarray(fe_np).astype(jnp.bfloat16))
    with pytest.raises(ValueError, match="patch embeddings"):
        TF.prefill(model, torch.from_numpy(toks), MAX_LEN,
                   frontend_embeds=fe)


def test_phi3v_server_equals_reference_server(phi3v):
    """Both servers serve phi-3-vision on its tokens alone (no patch
    embeddings); greedy tokens equal up to a near tie, as
    `tests/test_torch_model.py` holds the dense models."""
    jcfg, params, cfg, model = phi3v
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 30, 12)]
    jreqs = [JRequest(rid=i, prompt=p, max_new=6)
             for i, p in enumerate(prompts)]
    JServer(jcfg, params, slots=2, max_len=MAX_LEN).run(jreqs)
    preqs = [Request(rid=i, prompt=p, max_new=6)
             for i, p in enumerate(prompts)]
    Server(model, slots=2, max_len=MAX_LEN).run(preqs)
    for jr, pr, prompt in zip(jreqs, preqs, prompts):
        diff = [i for i, (a, b) in enumerate(zip(jr.out, pr.out)) if a != b]
        if not diff:
            continue
        k = diff[0]
        seq = np.concatenate([prompt, np.asarray(jr.out[:k], np.int32)])
        row = f32(JTF.forward(params, jcfg, jnp.asarray(seq[None]))[0])[0, -1]
        top = float(row.max())
        assert top - float(row[pr.out[k]]) <= 2 * (TOL + TOL * abs(top)), (
            f"request {jr.rid}: token {k} differs beyond a near tie")
