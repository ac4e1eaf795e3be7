"""PyTorch port, the serving slice as a whole on recurrentgemma-2b's smoke
config (5 layers: one (rglru, rglru, attn_local) period and a 2-block rglru
tail; window 32) against the JAX reference, with the reference's weights
carried across by `models.convert`; and the dense ``attn`` models (llama3-8b,
phi3-mini-3.8b, granite-20b, command-r-plus-104b) at smoke size, prefill and
decode logits.

Tolerances:
* logits and caches of `prefill` (a 48-token prompt, longer than the window)
  and of six teacher-forced `decode_step`s against the reference's: ``atol =
  rtol = 5e-2``, the bf16 tolerance the reference suite holds its own
  prefill, decode and forward paths to (``tests/test_arch_smoke.py``); the
  port's prefill attention keeps float32 softmax weights where the
  reference model rounds them to bf16.  The decode steps are held against
  the reference run op by op (see that test);
* the port's `prefill` and `decode_step` against its own `forward`: the
  same ``5e-2``, as the reference's suite does for its own;
* `Server` against the port's own manual loop: token for token (one
  implementation, one device);
* the port's `Server` against the reference's `Server`, greedy: equal tokens
  up to the first difference, and there the reference's logits must rank
  the port's token within the comparison tolerance of their top
  (``2 * (atol + rtol * |top logit|)``), so that the difference is a near
  tie flipped by bf16 rounding and not a wrong model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.runtime.server import Request as JRequest  # noqa: E402
from repro.runtime.server import Server as JServer  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.models import convert as CV  # noqa: E402
from repro_torch.models import layers as TFL  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.runtime.server import Request, Server  # noqa: E402

ARCH = "recurrentgemma-2b"
TOL = 5e-2
B, S, MAX_LEN = 2, 48, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (see test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def both():
    """(reference config, reference params, port config, port model)."""
    jcfg = jax_smoke(ARCH)
    params = JTF.init_params(jcfg, jax.random.key(0))
    cfg = get_smoke_config(ARCH)
    model = CV.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(
        0, jax_smoke(ARCH).vocab, (B, S + 6)).astype(np.int32)


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


def test_layer_order_and_sizes_follow_the_reference(both):
    jcfg, params, cfg, model = both
    assert [k for k, _ in model.keys] == [
        "b0_rglru", "b1_rglru", "b2_attn_local", "t0_rglru", "t1_rglru"]
    n_ref = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    full = get_config(ARCH)
    kinds = [k.split("_", 1)[1] for k, _ in TF.layer_keys(full)]
    assert len(kinds) == 26 and kinds.count("rglru") == 18 \
        and kinds.count("attn_local") == 8


def test_prefill_logits_and_cache_equal_reference(both, tokens):
    jcfg, params, cfg, model = both
    toks = tokens[:, :S]
    jl, jc = jax.jit(lambda p, t: JTF.prefill(p, jcfg, t, max_len=MAX_LEN))(
        params, jnp.asarray(toks))
    tl, tc = TF.prefill(model, torch.from_numpy(toks), MAX_LEN)
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == (B, 1,
                                                             cfg.vocab)
    close(tl.float(), f32(jl), "prefill logits")
    close_trees(CV.cache_to_numpy(cfg, tc), jc, "prefill cache")


def test_teacher_forced_decode_equals_reference(both, tokens):
    """Prefill, then six decode steps each fed the true next token, each
    side carrying its own cache; logits at every step and the final cache
    against the reference run op by op (``jax.disable_jit``), which rounds
    to bf16 after every operation as the source is written and as the port
    does.  XLA's compiled CPU code fuses elementwise chains and drops some of
    those roundings; the prefill test above holds the port to the compiled
    reference too."""
    jcfg, params, cfg, model = both
    tl, tc = TF.prefill(model, torch.from_numpy(tokens[:, :S]), MAX_LEN)
    with jax.disable_jit():
        jl, jc = JTF.prefill(params, jcfg, jnp.asarray(tokens[:, :S]),
                             max_len=MAX_LEN)
        close(tl.float(), f32(jl), "prefill logits (op by op)")
        for i in range(6):
            tok = tokens[:, S + i:S + i + 1]
            pos = np.full((B, 1), S + i, np.int32)
            jl, jc = JTF.decode_step(params, jcfg, jc, jnp.asarray(tok),
                                     jnp.asarray(pos))
            tl, tc = TF.decode_step(model, tc, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
            close(tl.float(), f32(jl), f"decode {i} logits")
            assert not bool(torch.isnan(tl).any())
    close_trees(CV.cache_to_numpy(cfg, tc), jc, "cache after decode")


def test_decode_blocks_equal_reference_op_by_op_exactly(both, tokens):
    """From the same input and the same cache, every block's decode step
    equals the reference's `_apply_block` run op by op, bit for bit: the
    port rounds where the source does (`layers.silu` included)."""
    jcfg, params, cfg, model = both
    _, jc = JTF.prefill(params, jcfg, jnp.asarray(tokens[:, :S]),
                        max_len=MAX_LEN)
    tc = CV.cache_from_numpy(cfg, jax.tree.map(np.asarray, jc),
                             device="cpu")
    pos = np.full((B, 1), S, np.int32)
    jx = JL.embed(params["embed"], jnp.asarray(tokens[:, S:S + 1]))
    with jax.disable_jit():
        for blk, (key, period), cache in zip(model.layers, model.keys, tc):
            pick = (lambda t: t["tail"][key]) if period is None else (
                lambda t: jax.tree.map(lambda a: a[period],
                                       t["stages"][key]))
            want, _, _ = JTF._apply_block(
                pick(params), blk.kind, jx, jnp.asarray(pos), jcfg,
                mode="decode", cache=pick(jc))
            got, _ = TF._apply_block(
                blk, torch.from_numpy(f32(jx)).to(torch.bfloat16),
                torch.from_numpy(pos), cfg, mode="decode", cache=cache)
            assert np.array_equal(got.float().numpy(), f32(want)), key
            jx = want


def test_mlp_equals_reference_exactly(both):
    jcfg, params, cfg, model = both
    x = np.random.default_rng(2).normal(0, 1, (B, 9, cfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    blk = model.layers[0]
    want = JL.mlp(jax.tree.map(lambda a: a[0],
                               params["stages"]["b0_rglru"]["mlp"]), jx)
    got = TFL.mlp(blk.mlp, torch.from_numpy(f32(jx)).to(torch.bfloat16))
    assert np.array_equal(got.float().numpy(), f32(want))


def test_prefill_and_decode_agree_with_forward(both, tokens):
    """The port's own consistency, as test_arch_smoke checks the
    reference's: prefill's last logits and one decode step equal the
    teacher-forced forward at those positions."""
    _, _, cfg, model = both
    toks = torch.from_numpy(tokens[:, :S])
    full = TF.forward(model, toks)
    assert tuple(full.shape) == (B, S, cfg.vocab)
    cut = S - 8
    pre, cache = TF.prefill(model, toks[:, :cut], MAX_LEN)
    close(pre[:, 0].float(), full[:, cut - 1].float(), "prefill vs forward")
    logits, _ = TF.decode_step(model, cache, toks[:, cut:cut + 1],
                               torch.full((B, 1), cut, dtype=torch.int32))
    close(logits[:, 0].float(), full[:, cut].float(), "decode vs forward")


def _manual(model, prompt, n_new, max_len):
    logits, cache = TF.prefill(model, torch.from_numpy(prompt[None]),
                               max_len)
    toks = [int(torch.argmax(logits[0, -1]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        logits, cache = TF.decode_step(
            model, cache, torch.tensor([[toks[-1]]], dtype=torch.int32),
            torch.tensor([[pos]], dtype=torch.int32))
        toks.append(int(torch.argmax(logits[0, -1])))
        pos += 1
    return toks


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in (5, 40, 17)]


def test_server_batched_greedy_matches_manual_decode(both):
    _, _, cfg, model = both
    prompts = _prompts(cfg.vocab)
    srv = Server(model, slots=2, max_len=MAX_LEN, temperature=0.0)
    reqs = [Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts)]
    stats = srv.run(reqs)
    assert stats["generated"] >= sum(r.max_new for r in reqs) - len(reqs)
    assert len(stats["prefill_ms"]) == 3 and stats["decode_ms"]
    for r, p in zip(reqs, prompts):
        assert r.done and r.out[:6] == _manual(model, p, 6, MAX_LEN), r.rid


def test_server_slot_reuse(both):
    _, _, cfg, model = both
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 4).astype(
        np.int32), max_new=3) for i in range(5)]
    srv = Server(model, slots=2, max_len=32)
    srv.run(reqs)
    assert all(r.done for r in reqs)
    assert all(len(r.out) >= 3 for r in reqs)


def test_server_temperature_sampling_is_seeded(both):
    _, _, cfg, model = both
    outs = []
    for _ in range(2):
        reqs = [Request(rid=i, prompt=p, max_new=4)
                for i, p in enumerate(_prompts(cfg.vocab))]
        Server(model, slots=2, max_len=MAX_LEN, temperature=1.0,
               seed=5).run(reqs)
        outs.append([r.out for r in reqs])
        assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)
    assert outs[0] == outs[1]


def test_server_tokens_equal_reference_server_up_to_near_ties(both):
    jcfg, params, cfg, model = both
    prompts = _prompts(cfg.vocab)
    n_new = 8
    jreqs = [JRequest(rid=i, prompt=p, max_new=n_new)
             for i, p in enumerate(prompts)]
    JServer(jcfg, params, slots=2, max_len=MAX_LEN,
            temperature=0.0).run(jreqs)
    preqs = [Request(rid=i, prompt=p, max_new=n_new)
             for i, p in enumerate(prompts)]
    Server(model, slots=2, max_len=MAX_LEN, temperature=0.0).run(preqs)
    for jr, pr, prompt in zip(jreqs, preqs, prompts):
        assert len(jr.out) == len(pr.out) == n_new
        diff = [i for i, (a, b) in enumerate(zip(jr.out, pr.out)) if a != b]
        if not diff:
            continue
        k = diff[0]
        # the reference's logits at step k, after the common prefix
        seq = np.concatenate([prompt, np.asarray(jr.out[:k], np.int32)])
        ref_logits, _, _ = JTF.forward(params, jcfg,
                                       jnp.asarray(seq[None]))
        row = f32(ref_logits)[0, -1]
        top = float(row.max())
        margin = 2 * (TOL + TOL * abs(top))
        assert top - float(row[pr.out[k]]) <= margin, (
            f"request {jr.rid}: first difference at token {k} is not a near "
            f"tie (reference top {top}, port's token scores "
            f"{float(row[pr.out[k]])}, tolerance {margin})")


DENSE_ARCHS = ["llama3-8b", "phi3-mini-3.8b", "granite-20b",
               "command-r-plus-104b"]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_attn_model_equals_reference(arch):
    """The dense ``attn`` models at smoke size, the reference's weights
    carried across: the logits of a 40-token prefill and of three
    teacher-forced decode steps after it, each side carrying its own cache,
    against the compiled reference at ``5e-2`` (measured: at most 0.91 of
    the tolerance).  Global attention goes through `flash_attention` with
    window 0 here and through ``plain_attention`` in the reference.  The
    reference runs compiled (the op-by-op run takes about 15 s a model on
    one CPU thread)."""
    jcfg = jax_smoke(arch)
    params = jax.jit(lambda key: JTF.init_params(jcfg, key))(
        jax.random.key(1))
    cfg = get_smoke_config(arch)
    model = CV.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    n = 40
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab, (B, n + 3)).astype(np.int32)
    tl, tc = TF.prefill(model, torch.from_numpy(toks[:, :n]), MAX_LEN)
    jl, jc = jax.jit(lambda p, t: JTF.prefill(p, jcfg, t, max_len=MAX_LEN))(
        params, jnp.asarray(toks[:, :n]))
    close(tl.float(), f32(jl), f"{arch} prefill logits")
    step = jax.jit(lambda p, c, t, q: JTF.decode_step(p, jcfg, c, t, q))
    for i in range(3):
        tok = toks[:, n + i:n + i + 1]
        pos = np.full((B, 1), n + i, np.int32)
        jl, jc = step(params, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = TF.decode_step(model, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos))
        close(tl.float(), f32(jl), f"{arch} decode {i} logits")
        assert not bool(torch.isnan(tl).any())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_unported_block_kinds_raise(arch):
    """Every architecture builds, prefills and decodes at smoke size (whisper
    with frame embeddings, phi-3-vision with patch embeddings): no block
    kind of any configuration is left unported, and only a kind no
    configuration has raises, naming it."""
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    model = TF.init_params(cfg, gen, device="cpu")
    fe = None
    if cfg.enc_layers or cfg.vision_patches:
        n = cfg.enc_frames if cfg.enc_layers else cfg.vision_patches
        fe = torch.randn((1, n, cfg.d_model), generator=gen).to(
            torch.bfloat16)
    toks = torch.zeros(1, 9, dtype=torch.int64)
    logits, cache = TF.prefill(model, toks, 16, frontend_embeds=fe)
    assert [set(c) for c in cache] == [set(c) for c in TF.init_cache(
        cfg, 1, 16, device="cpu")]
    logits, _ = TF.decode_step(model, cache, toks[:, :1],
                               torch.full((1, 1), 9, dtype=torch.int32))
    assert not bool(torch.isnan(logits).any())
    bogus = f"{cfg.pattern[0]}_bogus"
    with pytest.raises(ValueError, match=bogus):
        TF.Block(bogus, cfg, gen, device=torch.device("cpu"))


def test_cache_layout_and_conversion_roundtrip(both, tokens):
    jcfg, params, cfg, model = both
    ref = jax.tree.map(f32, JTF.init_cache(jcfg, 3, MAX_LEN))
    port = TF.init_cache(cfg, 3, MAX_LEN, device="cpu")
    close_trees(CV.cache_to_numpy(cfg, port), ref, "init_cache")
    _, tc = TF.prefill(model, torch.from_numpy(tokens[:, :S]), MAX_LEN)
    back = CV.cache_from_numpy(cfg, CV.cache_to_numpy(cfg, tc), device="cpu")
    for a, b in zip(tc, back):
        for name in a:
            for leaf in a[name]:
                assert a[name][leaf].dtype == b[name][leaf].dtype
                assert torch.equal(a[name][leaf], b[name][leaf])


def test_params_from_numpy_refuses_a_short_tree(both):
    jcfg, params, cfg, _ = both
    tree = jax.tree.map(np.asarray, params)
    del tree["tail"]["t1_rglru"]["mlp"]["wo"]
    with pytest.raises(ValueError, match="lacks"):
        CV.params_from_numpy(cfg, tree, device="cpu")


def divergence_report() -> dict:
    """Worst absolute logit differences between the port and the reference
    on this file's inputs (the numbers ROADMAP Queue 3 records):
    ``python tests/test_torch_model.py`` prints them."""
    jcfg = jax_smoke(ARCH)
    params = JTF.init_params(jcfg, jax.random.key(0))
    cfg = get_smoke_config(ARCH)
    model = CV.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab, (B, S + 6)).astype(np.int32)

    def reference(compiled):
        pf = lambda p, t: JTF.prefill(p, jcfg, t, max_len=MAX_LEN)  # noqa
        st = lambda p, c, t, q: JTF.decode_step(p, jcfg, c, t, q)  # noqa
        if compiled:
            pf, st = jax.jit(pf), jax.jit(st)
        l, c = pf(params, jnp.asarray(toks[:, :S]))
        out = [f32(l)]
        for i in range(6):
            l, c = st(params, c, jnp.asarray(toks[:, S + i:S + i + 1]),
                      jnp.asarray(np.full((B, 1), S + i, np.int32)))
            out.append(f32(l))
        return out

    compiled = reference(True)
    with jax.disable_jit():
        op_by_op = reference(False)
    tl, tc = TF.prefill(model, torch.from_numpy(toks[:, :S]), MAX_LEN)
    port = [tl.float().numpy()]
    for i in range(6):
        tl, tc = TF.decode_step(model, tc,
                                torch.from_numpy(toks[:, S + i:S + i + 1]),
                                torch.full((B, 1), S + i, dtype=torch.int32))
        port.append(tl.float().numpy())

    def worst(a, b):
        return max(float(np.abs(x - y).max()) for x, y in zip(a, b))

    return {"prefill_vs_compiled": worst(port[:1], compiled[:1]),
            "decode_vs_compiled": worst(port[1:], compiled[1:]),
            "prefill_vs_op_by_op": worst(port[:1], op_by_op[:1]),
            "decode_vs_op_by_op": worst(port[1:], op_by_op[1:]),
            "reference_compiled_vs_op_by_op": worst(compiled, op_by_op),
            "largest_logit": float(max(np.abs(x).max() for x in compiled))}


if __name__ == "__main__":
    torch.set_num_threads(1)
    for key, value in divergence_report().items():
        print(f"{key}: {value}")


def test_port_model_stack_imports_no_ml_dtypes():
    """The model stack takes bf16 arrays through float32 and never imports
    ``ml_dtypes`` (nor JAX or the reference; test_torch_lowering.py scans
    for those): by source, and in a fresh interpreter."""
    import ast
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    for path in sorted((src / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert all(n.split(".")[0] != "ml_dtypes" for n in names), path
    code = ("import sys\n"
            "import repro_torch.models.convert, repro_torch.runtime.server\n"
            "import repro_torch.launch.serve\n"
            "assert 'ml_dtypes' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=str(src)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
