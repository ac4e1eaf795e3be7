"""PyTorch port, the training substrate against the JAX reference on the
CPU: AdamW (`optim.adamw`), the LR schedules, gradient compression, the
data pipeline, checkpoints, the `Trainer` and the training launchers.

Tolerances:
* one `adamw.update` from a carried state: the grad norm within ``1e-5``
  relative (a float32 sum of 18,000 squares in another order: 2.3e-6
  measured), so the clip scale too; the float32 moments and master weights
  within ``1e-5`` relative plus ``1e-5`` of the leaf's largest value (a
  moment near zero is a difference of terms), the parameters as the master
  weights plus, for bf16, one spacing (a master weight may round to either
  side of a tie)
  (the same float32 operations on that scale);
* the schedules: ``1e-7`` relative (float32, the same operations);
* the data sources' tokens and the deterministic parts of the compression
  (the int8 scale and rounding of given noise, the top-k mask, the
  residuals): bit for bit;
* the `Trainer` on llama3-8b's smoke config, 5 steps from the reference's
  weights and AdamW state against the reference `Trainer` on
  ``make_host_mesh()``: losses within ``1e-2`` absolute and grad norms
  within ``1e-2`` relative (bf16 training; the measured gaps are 2e-3 and
  2e-3), the learning rates exactly;
* a checkpoint round trip and a resumed run (2 steps, a checkpoint, 2 more
  in a fresh trainer) against 4 uninterrupted steps: bit for bit;
* the elastic mesh plans (`runtime.elastic`): field for field.
"""

import contextlib
import io
import os
import runpy
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.optim import grad_compress as JGC  # noqa: E402
from repro.optim import schedules as JS  # noqa: E402
from repro.runtime import elastic as JE  # noqa: E402
from repro.runtime import trainer as JT  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import pipeline as D  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import convert as CV  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim import grad_compress as GC  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.runtime.trainer import TrainConfig, Trainer  # noqa: E402
from repro_torch.studies import quickstart, train_small_lm  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "llama3-8b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def f64(x):
    return np.asarray(x).astype(np.float64)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------

def test_adamw_update_equals_reference():
    jcfg, cfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    params = jax.jit(lambda k: JTF.init_params(jcfg, k))(jax.random.key(2))
    rng = np.random.default_rng(7)

    def grads():
        return jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape) * 0.3, jnp.float32).astype(p.dtype),
            params)

    state = JA.init(params)
    for _ in range(2):      # moments that are not zero
        params, state, _ = JA.update(state, grads(), params, lr=1e-2)
    g = grads()
    model = CV.params_from_numpy(cfg, np_tree(params), device="cpu")
    pstate = CV.adamw_from_numpy(model, np_tree(state))
    assert int(pstate.step) == 2
    lr = schedules.warmup_cosine(pstate.step, peak_lr=1e-2, warmup_steps=1,
                                 total_steps=10)
    jlr = JS.warmup_cosine(state.step, peak_lr=1e-2, warmup_steps=1,
                           total_steps=10)
    want_p, want_s, want_m = JA.update(state, g, params, lr=jlr)
    named = dict(model.named_parameters())
    _, got_s, got_m = adamw.update(pstate, CV.tree_to_named(model, np_tree(g)),
                                   named, lr=lr)
    assert abs(float(got_m["grad_norm"]) - float(want_m["grad_norm"])) <= \
        1e-5 * float(want_m["grad_norm"])
    got = CV.adamw_to_numpy(model, got_s)
    assert got["step"] == int(want_s.step) == 3
    for field in ("m", "v", "master"):
        for path, want in jax.tree_util.tree_leaves_with_path(
                getattr(want_s, field)):
            leaf = got[field]
            for k in path:
                leaf = leaf[k.key]
            assert leaf.dtype == np.float32
            want = np.asarray(want)
            np.testing.assert_allclose(
                leaf, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()),
                err_msg=field)
    new = CV.params_to_tree(model)
    for path, want in jax.tree_util.tree_leaves_with_path(want_p):
        leaf = new
        for k in path:
            leaf = leaf[k.key]
        want = np.asarray(want)
        assert str(leaf.dtype).split(".")[1] == want.dtype.name
        w, g = f64(want), f64(leaf.detach().float().numpy())
        mag = np.maximum(np.abs(w), np.abs(g))
        # as the master weights, plus for bf16 one spacing: a master weight
        # may round to either side of a tie
        allow = 1e-5 * (mag + np.abs(w).max())
        if want.dtype.name == "bfloat16":
            allow += 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= allow), path


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 37, 100, 150])
def test_schedules_equal_reference(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    want = float(JS.warmup_cosine(jnp.int32(step), **kw))
    got = schedules.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-7 * max(abs(want), 1e-30)
    assert float(schedules.constant(torch.tensor(step), **kw)) == float(
        JS.constant(jnp.int32(step), **kw))


def test_adamw_decreases_quadratic():
    w = {"w": torch.ones(16, dtype=torch.bfloat16)}
    st = adamw.init(w)
    for _ in range(200):
        x = w["w"].float().requires_grad_()
        loss = torch.sum((x - 3.0) ** 2)
        (g,) = torch.autograd.grad(loss, x)
        w, st, _ = adamw.update(st, {"w": g}, w, lr=0.05, weight_decay=0.0)
    assert float(torch.sum((w["w"].float() - 3.0) ** 2)) < 0.2


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_int8_quantization_of_given_noise_equals_reference():
    key = jax.random.key(3)
    x = jax.random.normal(jax.random.key(4), (300,), jnp.float32)
    q, scale = JGC.quantize_int8(x, key)
    noise = jax.random.uniform(key, x.shape, minval=-0.5, maxval=0.5)
    got_q, got_scale = GC.quantize_int8(torch.from_numpy(np.asarray(x)),
                                        noise=torch.from_numpy(
                                            np.asarray(noise)))
    assert float(got_scale) == float(scale)
    assert np.array_equal(got_q.numpy(), np.asarray(q))
    assert np.array_equal(GC.dequantize_int8(got_q, got_scale).numpy(),
                          np.asarray(JGC.dequantize_int8(q, scale)))
    residual = jnp.asarray(np.random.default_rng(1).standard_normal(300),
                           jnp.float32) * 0.01
    (jq, js), jres = JGC.compress_with_feedback(x, residual, key)
    (tq, ts), tres = GC.compress_with_feedback(
        torch.from_numpy(np.asarray(x)), torch.from_numpy(
            np.asarray(residual)), method="int8",
        noise=torch.from_numpy(np.asarray(jax.random.uniform(
            key, x.shape, minval=-0.5, maxval=0.5))))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(tres.numpy(), np.asarray(jres))


def test_topk_and_ratio_equal_reference():
    x = np.random.default_rng(2).standard_normal((40, 25)).astype(np.float32)
    js, jm = JGC.topk_sparsify(jnp.asarray(x), 0.1)
    ts, tm = GC.topk_sparsify(torch.from_numpy(x), 0.1)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    res = np.random.default_rng(3).standard_normal((40, 25)).astype(
        np.float32)
    (jp, _), jr = JGC.compress_with_feedback(
        jnp.asarray(x), jnp.asarray(res), None, method="topk")
    (tp, _), tr = GC.compress_with_feedback(
        torch.from_numpy(x), torch.from_numpy(res), method="topk")
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    for m in ("int8", "topk"):
        assert GC.compression_ratio(m) == JGC.compression_ratio(m)
    assert np.array_equal(GC.decompress((tp, None), "topk").numpy(),
                          np.asarray(JGC.decompress((jp, None), "topk")))


def test_int8_error_feedback_converges():
    """With error feedback, the accumulated compressed signal tracks the
    true gradient sum (residual stays bounded), as the reference's suite
    holds its own."""
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(512, generator=gen) * 0.1
    residual = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(30):
        payload, residual = GC.compress_with_feedback(g, residual, gen,
                                                      method="int8")
        total = total + GC.decompress(payload, "int8")
    err = float(torch.linalg.norm(total - 30 * g) /
                torch.linalg.norm(30 * g))
    assert err < 0.01, err
    assert float(residual.abs().max()) < float(g.abs().max())


def test_topk_error_feedback_preserves_signal():
    g = torch.randn(1024, generator=torch.Generator().manual_seed(1))
    residual = torch.zeros_like(g)
    sent = torch.zeros_like(g)
    for _ in range(40):
        payload, residual = GC.compress_with_feedback(
            g, residual, method="topk", topk_frac=0.1)
        sent = sent + GC.decompress(payload, "topk")
    rel = float(torch.linalg.norm(sent - 40 * g) / torch.linalg.norm(40 * g))
    assert rel < 0.2, rel


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shard,n_shards", [(0, 0, 1), (3, 1, 2),
                                                 (5, 3, 4)])
def test_synthetic_tokens_equal_reference(seed, shard, n_shards):
    jc = JD.DataConfig(vocab=300, seq_len=24, global_batch=8, seed=seed)
    tc = D.DataConfig(vocab=300, seq_len=24, global_batch=8, seed=seed)
    js = JD.SyntheticLM(jc, shard=shard, n_shards=n_shards)
    ts = D.SyntheticLM(tc, shard=shard, n_shards=n_shards)
    for step in (0, 1, 7, 123):
        want, got = js.batch(step), ts.batch(step)
        assert got["tokens"].dtype == torch.int32
        assert np.array_equal(got["tokens"].numpy(),
                              np.asarray(want["tokens"]))
        assert np.array_equal(got["labels"].numpy(),
                              np.asarray(want["labels"]))


@pytest.mark.parametrize("workload,shard", [("silo", 0), ("redis", 1)])
def test_trace_tokens_equal_reference(workload, shard):
    jc = JD.DataConfig(vocab=512, seq_len=32, global_batch=4, seed=2)
    tc = D.DataConfig(vocab=512, seq_len=32, global_batch=4, seed=2)
    js = JD.make_source("trace", jc, workload=workload, shard=shard)
    ts = D.make_source("trace", tc, workload=workload, shard=shard)
    for step in (0, 3, 50):
        assert np.array_equal(ts.batch(step)["tokens"].numpy(),
                              np.asarray(js.batch(step)["tokens"]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=gen),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": torch.randn(3, generator=gen).to(torch.bfloat16)},
            "state": adamw.init({"w": torch.randn(5, generator=gen)})}


def _empty_like(tree):
    if isinstance(tree, dict):
        return {k: _empty_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_empty_like(v) for v in tree))
    return torch.zeros_like(tree)


def _leaves(tree):
    return [x for _, x in ckpt._items(tree)]


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t)
    restored, step = ckpt.restore(str(tmp_path), _empty_like(t))
    assert step == 7
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = os.path.join(str(tmp_path), "step_000000007", "manifest.json")
    import json

    leaves = json.load(open(manifest))["leaves"]
    assert leaves["['nested']['c']"]["dtype"] == "bfloat16"
    assert "['state'].master['w']" in leaves


def test_checkpoint_integrity_detects_corruption(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    payload = os.path.join(str(tmp_path), "step_000000001", "arrays.npz")
    raw = bytearray(open(payload, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(payload, "wb").write(bytes(raw))
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), _empty_like(_tree()))


def test_checkpoint_gc_and_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, _tree(), keep_last=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    kept = sorted(os.listdir(tmp_path))
    assert len([d for d in kept if d.startswith("step_")]) == 2
    assert not [d for d in kept if d.startswith(".tmp")]


def test_checkpoint_async_copies_before_returning(tmp_path):
    t = _tree()
    want = t["a"].clone()
    ckpt.save(str(tmp_path), 9, t, blocking=False)
    t["a"].add_(1.0)        # the caller goes on updating in place
    for _ in range(200):
        if ckpt.latest_step(str(tmp_path)) == 9:
            break
        time.sleep(0.05)
    assert ckpt.latest_step(str(tmp_path)) == 9
    restored, _ = ckpt.restore(str(tmp_path), _empty_like(_tree()))
    assert torch.equal(restored["a"], want)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def test_trainer_tracks_reference_trainer():
    jcfg, cfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    kw = dict(steps=5, peak_lr=1e-2, warmup_steps=2, log_every=100)
    jt = JT.Trainer(jcfg, JT.TrainConfig(**kw), make_host_mesh())
    params, opt = jt.init_state(3)
    carried = np_tree(params), np_tree(opt)
    with contextlib.redirect_stdout(io.StringIO()):
        jt.fit(JD.SyntheticLM(JD.DataConfig(vocab=jcfg.vocab, seq_len=32,
                                            global_batch=4)), params, opt)
    model = CV.params_from_numpy(cfg, carried[0], device="cpu")
    model.requires_grad_(True)
    tt = Trainer(cfg, TrainConfig(**kw), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        out, _ = tt.fit(D.SyntheticLM(D.DataConfig(
            vocab=cfg.vocab, seq_len=32, global_batch=4)), model,
            CV.adamw_from_numpy(model, carried[1]))
    assert out is model
    assert len(tt.metrics_log) == len(jt.metrics_log) == 5
    for want, got in zip(jt.metrics_log, tt.metrics_log):
        assert got["lr"] == want["lr"]
        assert abs(got["loss"] - want["loss"]) <= 1e-2
        assert abs(got["xent"] - want["xent"]) <= 1e-2
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            1e-2 * want["grad_norm"]
    assert tt.metrics_log[-1]["loss"] < tt.metrics_log[0]["loss"]


def test_microbatches_accumulate_the_mean_gradient():
    """Two microbatches of half the batch give the gradient of the whole
    batch's mean loss (float32, summed in another order)."""
    cfg = get_smoke_config(ARCH)
    src = D.SyntheticLM(D.DataConfig(vocab=cfg.vocab, seq_len=16,
                                     global_batch=4))
    runs = []
    for mb in (1, 2):
        tr = Trainer(cfg, TrainConfig(steps=1, microbatches=mb, peak_lr=0.0,
                                      log_every=100), device="cpu")
        model, opt = tr.init_state(1)
        seen = {}
        update = adamw.update

        def spy(state, grads, params, **kw):
            seen.update({k: g.float().clone() for k, g in grads.items()})
            return update(state, grads, params, **kw)

        adamw.update = spy
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                tr.fit(src, model, opt)
        finally:
            adamw.update = update
        runs.append((seen, tr.metrics_log[0]))
    (g1, m1), (g2, m2) = runs
    assert abs(m1["loss"] - m2["loss"]) <= 1e-2
    for k in g1:
        num = float((g1[k] - g2[k]).norm())
        assert num <= 5e-2 * max(float(g1[k].norm()), 1e-6), k


def test_resume_is_bit_equal(tmp_path):
    """2 steps, a checkpoint, a stop; a fresh trainer resumes from it for 2
    more: the losses and the parameters equal 4 uninterrupted steps bit for
    bit."""
    cfg = get_smoke_config(ARCH)
    src = D.SyntheticLM(D.DataConfig(vocab=cfg.vocab, seq_len=16,
                                     global_batch=2))

    def trainer(d):
        return Trainer(cfg, TrainConfig(steps=4, peak_lr=1e-2,
                                        warmup_steps=1, ckpt_dir=d,
                                        ckpt_every=2, async_ckpt=False,
                                        log_every=100), device="cpu")

    class Stop(Exception):
        pass

    class Cut:
        def batch(self, step):
            if step == 2:
                raise Stop
            return src.batch(step)

    with contextlib.redirect_stdout(io.StringIO()):
        whole = trainer("")
        model_a, _ = whole.fit(src)
        first = trainer(str(tmp_path))
        with pytest.raises(Stop):
            first.fit(Cut())
        assert ckpt.latest_step(str(tmp_path)) == 2
        second = trainer(str(tmp_path))
        model_b, _ = second.fit(src)
    assert [m["loss"] for m in first.metrics_log + second.metrics_log] == \
        [m["loss"] for m in whole.metrics_log]
    for a, b in zip(model_a.parameters(), model_b.parameters()):
        assert torch.equal(a, b)
    assert ckpt.latest_step(str(tmp_path)) == 4


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_train_launcher_runs_on_the_cpu(capsys):
    tr = LT.main(["--preset", "smoke", "--steps", "3", "--batch", "2",
                  "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={get_smoke_config(ARCH).name} params~")
    assert out[0].endswith("device=cpu")
    assert out[-1].startswith("loss: first=") and out[-1].endswith("steps=3")
    assert len(tr.metrics_log) == 3
    assert LT.PRESET_100M.params_count() == pytest.approx(1.1e8, rel=0.2)


def test_train_launcher_refuses_model_parallelism():
    with pytest.raises(SystemExit):
        LT.main(["--model-par", "2", "--device", "cpu"])


def test_train_small_lm_smoke_resumes(tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    train_small_lm.main(["--preset", "smoke", "--steps", "3",
                         "--ckpt-dir", d, "--device", "cpu"])
    assert ckpt.latest_step(d) == 3
    # relaunched with more steps, it resumes at step 3
    train_small_lm.main(["--preset", "smoke", "--steps", "5",
                         "--ckpt-dir", d, "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[-1].endswith("steps=2")
    assert ckpt.latest_step(d) == 5


def test_quickstart_prints_the_reference_example_on_the_cpu(monkeypatch):
    """The port's quickstart against ``examples/quickstart.py``: the fabric
    section and the autotuner section print the same lines; the training
    section prints the trainer's lines (the two frameworks draw other
    weights, so its losses differ)."""
    monkeypatch.setattr(JT.Trainer, "fit", lambda self, src: None)
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        runpy.run_path(os.path.join(ROOT, "examples", "quickstart.py"),
                       run_name="__main__")
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        quickstart.main("cpu")
    want, got = want.getvalue().splitlines(), got.getvalue().splitlines()
    fabric = want[:want.index("") + 1]
    tune = want[want.index("== autotuner: llama3-8b train_4k on a 16x16 "
                           "v5e pod =="):]
    assert got[:len(fabric)] == fabric
    assert got[-len(tune):] == tune
    steps = got[len(fabric) + 1:-len(tune) - 1]
    assert [s.split()[:2] for s in steps] == [["step", "0"], ["step", "10"],
                                              ["step", "20"]]


# ---------------------------------------------------------------------------
# elastic mesh plans
# ---------------------------------------------------------------------------

def plan_fields(plan):
    return (plan.shape, plan.axes, plan.usable_devices, plan.dropped_devices)


@pytest.mark.parametrize("prefer_pods", (1, 2, 4))
@pytest.mark.parametrize("model_cap", (8, 16))
def test_choose_mesh_equals_reference(prefer_pods, model_cap):
    for n in range(1, 1101):
        kw = dict(model_cap=model_cap, prefer_pods=prefer_pods)
        assert plan_fields(elastic.choose_mesh(n, **kw)) == \
            plan_fields(JE.choose_mesh(n, **kw)), n


@pytest.mark.parametrize("old_n, now_n, kw", [
    (256, 256, {}), (512, 300, {"prefer_pods": 2}), (256, 129, {}),
    (64, 1000, {"model_cap": 8, "prefer_pods": 4}), (1, 1, {})])
def test_resize_plan_equals_reference(old_n, now_n, kw):
    got = elastic.resize_plan(elastic.choose_mesh(old_n, **kw), now_n, **kw)
    want = JE.resize_plan(JE.choose_mesh(old_n, **kw), now_n, **kw)
    assert set(got) == set(want)
    for f in ("old", "new"):
        assert plan_fields(got[f]) == plan_fields(want[f]), f
    assert got["action"] == want["action"] and got["steps"] == want["steps"]
