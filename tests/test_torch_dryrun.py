"""PyTorch port, the dry-run stand-in (`launch.dryrun`), the roofline
(`launch.roofline`) and the hillclimbs (`launch.hillclimb`) on the CPU.

* The stand-in's statuses over all 80 cells (its ``meta`` count stubbed:
  sizing alone) equal ``shape_applicable``'s, the reference's included:
  the 16 skips are the eight full-attention architectures' ``long_500k``
  on both meshes, as tests/test_dryrun_artifacts.py requires; its CLI ends
  ``ok=64 skipped=16 error=0``.
* A smoke config's prefill FLOPs equal the count written out here from the
  config (the matrix products of the plain ops), exactly; its train FLOPs
  count the forward, the checkpoint's recompute and the backward.
* The ``seq="model"`` override turns each model-axis all-reduce into a
  reduce-scatter plus an all-gather; ``long_500k`` (batch 1) shards no
  batch axis.
* The roofline's `corrected`, `analyze_cell`, `_note` and `render_table`
  equal the reference's on synthetic records (one with a ``period`` and
  ``n_periods`` 8), and `fabric_crosscheck` on the CPU equals the
  reference's on a small synthetic list, exactly.
* Each hillclimb experiment's hypothesis, tag, config change and rule
  override equal the reference's (read in a subprocess: importing the
  reference's dry-run sets a 512-device ``XLA_FLAGS``).
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (x64 for the reference, as its suite)
from repro.configs import shape_applicable as jax_applicable  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,  # noqa: E402
                                 get_smoke_config, shape_applicable)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hillclimb as H  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402
from repro_torch.parallel.sharding import ShardingRules  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def sized_only(monkeypatch):
    """The stand-in without its meta run: every step counts (1, 1)."""
    monkeypatch.setattr(D, "step_counts", lambda cfg, shape: (1, 1))


# ---------------------------------------------------------------------------
# the dry-run stand-in
# ---------------------------------------------------------------------------

def test_statuses_equal_shape_applicable(sized_only, tmp_path, capsys):
    out = tmp_path / "dry.json"
    D.main(["--all", "--out", str(out)])
    assert capsys.readouterr().out.rstrip().endswith(
        "dryrun summary: ok=64 skipped=16 error=0")
    recs = json.loads(out.read_text())
    assert len(recs) == len(ARCH_IDS) * len(SHAPES) * 2
    full_attention = [a for a in ARCH_IDS if not get_config(a).sub_quadratic]
    assert len(full_attention) == 8
    for key, rec in recs.items():
        arch, shape, mesh = key.split("|")
        ok, why = shape_applicable(get_config(arch), SHAPES[shape])
        assert (ok, why) == jax_applicable(jax_config(arch), SHAPES[shape])
        assert ok == (not (shape == "long_500k" and arch in full_attention))
        assert rec["mesh"] == ("16x16" if mesh == "single" else "2x16x16")
        if not ok:
            assert rec["status"] == "skipped" and rec["reason"] == why
            continue
        assert rec["status"] == "ok", rec
        assert rec["memory"]["peak_per_device_gib"] > 0, key
        assert rec["memory"]["temp_bytes"] is None
        assert rec["n_periods"] == get_config(arch).n_periods
        assert "period" not in rec and "collectives_once" in rec


def prefill_flops(cfg, b, s):
    """Matrix-product FLOPs of the port's prefill of an ``attn`` stack:
    each layer's q, k, v and o projections, the plain attention's S x S
    scores and their product with v (every pair, masked or not), the
    gated MLP's three products, and the last position's logits."""
    t = b * s
    h, kv, hd, d, f = cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.d_model, \
        cfg.d_ff
    layer = (2 * t * d * (h + 2 * kv) * hd + 2 * t * h * hd * d
             + 2 * (2 * b * h * s * s * hd) + 3 * 2 * t * d * f)
    return cfg.n_layers * layer + 2 * b * d * cfg.vocab


def test_smoke_prefill_flops_equal_written_count():
    cfg = get_smoke_config("llama3-8b")
    shape = SHAPES["prefill_32k"]
    flops, nbytes = D.step_counts(cfg, shape)
    assert flops == prefill_flops(cfg, shape.global_batch, shape.seq_len)
    rec = D.lower_cell("llama3-8b", "prefill_32k", False, cfg_override=cfg)
    # a batch of 32 over 16 data shards, and the 16-way model axis
    assert rec["flops_once"] * 256 == flops
    assert rec["bytes_once"] * 256 == nbytes and nbytes > 0


def test_train_counts_forward_recompute_and_backward():
    """At smoke size train_4k's matrix products are the forward's, the
    checkpoint's recompute of each layer, and the backward's two products
    a forward product, less and plus what the plain ops make of it: the
    recompute stops after the last op whose output the backward keeps (so
    the MLP's ``wo`` product is not run again), the plain attention
    backward recomputes the S x S scores (five attention products to the
    forward's two), and the logits of the whole sequence are made once
    and differentiated twice."""
    cfg = get_smoke_config("llama3-8b")
    train, _ = D.step_counts(cfg, SHAPES["train_4k"])
    b, s = SHAPES["train_4k"].global_batch, SHAPES["train_4k"].seq_len
    fwd = prefill_flops(cfg, b, s) - 2 * b * cfg.d_model * cfg.vocab
    logits = 2 * b * s * cfg.d_model * cfg.vocab
    scores = 2 * b * cfg.n_heads * s * s * cfg.head_dim
    wo = 2 * b * s * cfg.d_ff * cfg.d_model
    assert train == 4 * fwd + 3 * logits + cfg.n_layers * (scores - wo)


def test_seq_parallel_turns_all_reduces_into_rs_plus_ag(sized_only):
    base = D.lower_cell("command-r-plus-104b", "prefill_32k", False)
    sp = D.lower_cell("command-r-plus-104b", "prefill_32k", False,
                      rules=ShardingRules().with_overrides(seq="model"))
    b, c = base["collectives_once"], sp["collectives_once"]
    n, nbytes = b["all-reduce"]
    assert n == 2 * get_config("command-r-plus-104b").n_layers
    assert "all-reduce" not in c
    assert c["reduce-scatter"] == [n, nbytes // 16]
    assert c["all-gather"] == [b["all-gather"][0] + n,
                               b["all-gather"][1] + nbytes]
    # train: forward and backward, and the FSDP gradients' reduce-scatters
    base = D.lower_cell("mamba2-1.3b", "train_4k", True)
    sp = D.lower_cell("mamba2-1.3b", "train_4k", True,
                      rules=ShardingRules().with_overrides(seq="model"))
    b, c = base["collectives_once"], sp["collectives_once"]
    n, nbytes = b["all-reduce"]
    assert n == 2 * get_config("mamba2-1.3b").n_layers
    assert "all-reduce" not in c
    assert c["reduce-scatter"] == [b["reduce-scatter"][0] + n,
                                   b["reduce-scatter"][1] + nbytes // 16]


def test_long_500k_shards_no_batch_axis():
    recs = [D.lower_cell("mamba2-1.3b", "long_500k", mp) for mp in
            (False, True)]
    flops, nbytes = D.step_counts(get_config("mamba2-1.3b"),
                                  SHAPES["long_500k"])
    for rec in recs:
        assert rec["status"] == "ok"
        # the model axis alone splits a batch of 1
        assert rec["flops_once"] * 16 == flops
        assert rec["bytes_once"] * 16 == nbytes
    # nothing of the cell's leaves shards over the pod axis
    assert recs[0]["memory"] == recs[1]["memory"]


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

def synthetic_records():
    return {
        "a": {"arch": "llama3-8b", "shape": "train_4k", "status": "ok",
              "flops_once": 3.1e15, "bytes_once": 4.4e12,
              "collectives_once": {"all-gather": [450, 1876164608],
                                   "all-reduce": [128, 68719476736]},
              "memory": {"argument_bytes": 415195140,
                         "peak_per_device_gib": 0.387}, "n_periods": 32},
        "b": {"arch": "recurrentgemma-2b", "shape": "decode_32k",
              "status": "ok", "flops_once": 2.5e9, "bytes_once": 3.0e9,
              "collectives_once": {"all-reduce": [3, 98304]},
              "period": {"flops": 1.5e9, "bytes": 2.0e9,
                         "collectives": {"all-reduce": [2, 65536],
                                         "all-gather": [4, 1 << 20]}},
              "memory": {"argument_bytes": 4_200_000_000,
                         "peak_per_device_gib": 3.9}, "n_periods": 8},
        "c": {"arch": "mamba2-1.3b", "shape": "prefill_32k", "status": "ok",
              "flops_once": 1.1e13, "bytes_once": 4.6e11,
              "collectives_once": {"all-to-all": [96, 3145728000000]},
              "memory": {"argument_bytes": 33_000_000,
                         "peak_per_device_gib": 0.7}, "n_periods": 48},
        "d": {"arch": "llama3-8b", "shape": "long_500k",
              "status": "skipped", "reason": "x"},
    }


def test_roofline_equals_reference_on_synthetic_records():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.ICI_LINK, R.CHIPS) == \
        (JR.PEAK_FLOPS, JR.HBM_BW, JR.ICI_LINK, JR.CHIPS)
    recs = synthetic_records()
    cells, want = [], []
    for key, rec in recs.items():
        if rec["status"] == "ok":
            assert R.corrected(rec) == JR.corrected(rec), key
        cells.append(R.analyze_cell(key, rec))
        want.append(JR.analyze_cell(key, rec))
        assert cells[-1] == want[-1], key
    assert cells[-1] is None
    assert {c["dominant"] for c in cells if c} == {"compute", "memory",
                                                   "collective"}
    assert R.render_table(cells) == JR.render_table(want)
    for dom in ("compute_s", "memory_s", "collective_s"):
        for shape in ("train_4k", "decode_32k", "long_500k"):
            assert R._note(dom, None, None, SHAPES[shape]) == \
                JR._note(dom, None, None, SHAPES[shape])


def test_fabric_crosscheck_on_cpu_equals_reference():
    cells = [R.analyze_cell(k, r) for k, r in synthetic_records().items()]
    cells = [c for c in cells if c]
    got = R.fabric_crosscheck(cells, top_n=2, device="cpu")
    assert got == JR.fabric_crosscheck(cells, top_n=2)
    assert len(got) == 2 and all(g["esf_engine"] for g in got)


# ---------------------------------------------------------------------------
# the hillclimbs
# ---------------------------------------------------------------------------

REFERENCE_EXPERIMENTS = r"""
import dataclasses, json
from repro.launch import hillclimb as H
out = {}
for name, (arch, shape, gen) in H.CELLS.items():
    its = []
    for hyp, kw in gen():
        cfg = kw.get("cfg_override")
        rules = kw.get("rules")
        its.append([hyp, kw["tag"],
                    None if cfg is None else dataclasses.asdict(cfg),
                    None if rules is None else rules.rules])
    out[name] = [arch, shape, its]
print("EXPERIMENTS", json.dumps(out))
"""


def test_hillclimb_experiments_equal_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE_EXPERIMENTS],
                       capture_output=True, text=True, timeout=300, env=env)
    line = [ln for ln in r.stdout.splitlines()
            if ln.startswith("EXPERIMENTS ")]
    assert line, r.stdout + r.stderr
    want = json.loads(line[0].split(" ", 1)[1])
    got = {}
    for name, (arch, shape, gen) in H.CELLS.items():
        its = []
        for hyp, kw in gen():
            cfg, rules = kw.get("cfg_override"), kw.get("rules")
            its.append([hyp, kw["tag"],
                        None if cfg is None else dataclasses.asdict(cfg),
                        None if rules is None else rules.rules])
        got[name] = [arch, shape, its]
    # through JSON, as the reference's side came (tuples become lists)
    assert json.loads(json.dumps(got)) == want
